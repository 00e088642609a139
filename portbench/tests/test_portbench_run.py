"""A whole run of a cell made up for the tests (a configuration, a mix
and its limits added as new files only), on the CPU with the card's look
skipped: the result line's keys, ``correct`` on the sound program, and
``correct`` false with the timed path broken underneath."""

import json
import time

import pytest
import torch

from conftest import TINY_CONFIG, TINY_LIMITS, TINY_TRAFFIC, add_cell
from portbench.harness import main, spec
from portbench.reference.dense import NUMBERS

SEED = 2 ** 31 + 99


def run(root, cell, seconds=0.5):
    c = spec.load_cell(cell, root=root)
    return main.run(c, SEED, seconds, False, t0=time.perf_counter(),
                    device="cpu")


def test_result_line_keys_and_a_sound_run(tiny_cell):
    root, cell = tiny_cell
    r = run(root, cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "check"]
    assert r["correct"] is True
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"prefill_tok_s", "peak_mem_gib", "setup_s"}
    assert all(m["value"] > 0 or name == "peak_mem_gib"
               for name, m in r["metrics"].items())
    assert r["metrics"]["prefill_tok_s"]["unit"] == "tokens/s"
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert set(r["check"]) == {"top_gap", "logit_err"}
    for c in r["check"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


def test_a_w8a8_config_added_as_files_runs(bench_copy):
    cell = add_cell(bench_copy, "tinygelu",
                    {**TINY_CONFIG, "quant": "w8a8",
                     "hidden_act": "gelu_pytorch_tanh"},
                    TINY_TRAFFIC, TINY_LIMITS)
    r = run(bench_copy, cell)
    assert r["correct"] is True


def _patch_forward(monkeypatch, alter):
    from repro_torch.models.model import Model
    original = Model.forward

    def forward(self, params, tokens, **kw):
        logits, aux = original(self, params, tokens, **kw)
        return alter(logits), aux
    monkeypatch.setattr(Model, "forward", forward)


def test_an_altered_token_fails(tiny_cell, monkeypatch):
    def alter(logits):
        out = logits.clone()
        wrong = (int(out[0, -1].argmax()) + 1) % out.shape[-1]
        out[0, -1, wrong] = out[0, -1].max() + 1.0
        return out
    _patch_forward(monkeypatch, alter)
    r = run(*tiny_cell)
    assert r["correct"] is False
    assert r["check"]["top_gap"]["value"] > r["check"]["top_gap"]["limit"]


def test_an_answer_left_unchanged_fails(tiny_cell, monkeypatch):
    first = []

    def alter(logits):
        if not first:
            first.append(logits.clone())
        return first[0].clone()
    _patch_forward(monkeypatch, alter)
    r = run(*tiny_cell)
    assert r["correct"] is False


def test_a_non_finite_answer_counts_as_failed(tiny_cell, monkeypatch):
    _patch_forward(monkeypatch,
                   lambda logits: torch.full_like(logits, float("nan")))
    r = run(*tiny_cell)
    assert r["correct"] is False and r["failed"] == r["attempted"]


def test_the_window_lasts_its_seconds_and_ends_on_a_request(tiny_cell):
    root, cell = tiny_cell
    c = spec.load_cell(cell, root=root)
    st = main.set_up(c, SEED, "cpu")
    win = main.serve_window(st, 0.3)
    assert win.seconds >= 0.3
    assert win.requests[-1].sent < win.start + 0.3
    assert win.tokens == sum(r.length for r in win.requests)


def test_sample_holds_the_longest(tiny_cell):
    root, cell = tiny_cell
    c = spec.load_cell(cell, root=root)
    st = main.set_up(c, SEED, "cpu")
    win = main.serve_window(st, 0.0, requests=st.schedule.take(8))
    assert [r.length for r in win.requests] == \
        [s for s, _ in main.traffic.Schedule(c.traffic, SEED).take(8)]
    idx = main.sample(win.requests, 4, SEED)
    assert len(set(idx)) == 4
    assert win.requests[idx[0]].length == max(r.length for r in win.requests)
    assert idx == main.sample(win.requests, 4, SEED)


@pytest.mark.parametrize("name", ["phi4-w4a8.prefill-long"])
def test_the_cells_load(name):
    c = spec.load_cell(name)
    assert c.model.n_layers == 32 and c.model.head_dim == 128
    assert c.limits["limits"] and set(c.limits["limits"]) <= set(NUMBERS)
    assert {m["name"] for m in c.end_to_end} == {"prefill_tok_s",
                                                 "peak_mem_gib", "setup_s"}
    assert all(m["moves"] == "prefill_tok_s" for m in c.per_layer)


def test_end_to_end_metrics_of_a_window():
    reqs = [main.Request(100, 0, 1.0 + i, 1.5 + i, torch.zeros(1))
            for i in range(20)]
    win = main.Window(start=1.0, requests=reqs)
    assert main.end_to_end("prefill_tok_s", win, 3.0, 0) == \
        pytest.approx(2000 / 19.5)
    assert main.end_to_end("ttft_p95_ms", win, 3.0, 0) == \
        pytest.approx(500.0)
    assert main.end_to_end("peak_mem_gib", win, 3.0, 2 ** 31) == 2.0
    assert main.end_to_end("setup_s", win, 3.0, 0) == 3.0
    with pytest.raises(KeyError):
        main.end_to_end("no_such_metric", win, 3.0, 0)
