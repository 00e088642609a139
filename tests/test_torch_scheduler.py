"""The port's continuous batcher (``repro_torch.serving.scheduler``),
mirroring ``tests/test_scheduler.py`` for the dense family on the CPU:
batched serving equals isolated serving (bf16 KV), the int8 KV cache
keeps the reference's agreement bound (>= 0.6 of the greedy tokens), a
request admitted mid-flight reuses a slot cleanly, every request
completes at ``submit_iter + P + G - 1``, and a cut-off run raises.

The batcher's request bookkeeping is the reference's; its steps go
through the port's ``Model.decode_step`` with per-slot positions.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.models.model import Model
from repro_torch.serving.scheduler import ContinuousBatcher, Request


def _model(arch):
    model = Model(reduced(get_config(arch)), device="cpu")
    return model, model.init(torch.Generator("cpu").manual_seed(0))


def _single(model, params, prompt, max_new, max_seq, kv_quant=False):
    """One request alone through scalar-position decode."""
    caches = model.init_cache(1, max_seq, kv_quant=kv_quant)
    logits = None
    for i, t in enumerate(prompt):
        logits, caches = model.decode_step(params, caches,
                                           torch.tensor([[int(t)]]), i)
    out, pos = [], len(prompt)
    tok = int(logits[0, 0].argmax())
    for _ in range(max_new):
        out.append(tok)
        logits, caches = model.decode_step(params, caches,
                                           torch.tensor([[tok]]), pos)
        pos += 1
        tok = int(logits[0, 0].argmax())
    return out


def test_batched_equals_isolated():
    model, params = _model("starcoder2-7b")
    cfg = model.cfg
    max_seq = 24
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=list(rng.integers(0, cfg.vocab, size=n)),
                    max_new=g)
            for i, (n, g) in enumerate([(3, 4), (5, 3), (2, 5)])]
    # 2 slots, 3 requests -> queuing + slot reuse exercised
    bat = ContinuousBatcher(model, params, n_slots=2, max_seq=max_seq)
    for r in reqs:
        bat.submit(r)
    done = bat.run()
    assert len(done) == 3 and all(r.done for r in done)
    for r in reqs:
        assert r.generated == _single(model, params, r.prompt, r.max_new,
                                      max_seq), r.rid


def test_batcher_with_int8_kv():
    model, params = _model("starcoder2-7b")
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=list(rng.integers(0, model.cfg.vocab,
                                                    size=4)),
                    max_new=3) for i in range(2)]
    bat = ContinuousBatcher(model, params, n_slots=2, max_seq=16,
                            kv_quant=True)
    assert bat.caches["k"].dtype == torch.int8
    for r in reqs:
        bat.submit(r)
    done = bat.run()
    assert len(done) == 2
    for r in done:
        ref = _single(model, params, r.prompt, r.max_new, 16, kv_quant=True)
        # int8 KV: allow small divergence on near-tie logits
        agree = np.mean(np.asarray(r.generated) == np.asarray(ref))
        assert agree >= 0.6, (r.generated, ref)


def test_mid_flight_admission():
    """A request admitted while another is mid-generation."""
    model, params = _model("phi4-mini-3.8b")
    r1 = Request(rid=1, prompt=[5, 6, 7, 8, 9], max_new=4)
    r2 = Request(rid=2, prompt=[1, 2], max_new=2)
    bat = ContinuousBatcher(model, params, n_slots=1, max_seq=24)
    bat.submit(r1)
    bat.submit(r2)                      # must wait for the single slot
    done = bat.run()
    assert [r.rid for r in done] == [1, 2]
    assert r2.generated == _single(model, params, r2.prompt, r2.max_new, 24)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_completion_iteration_contract(kv_quant):
    """Every request completes at submit_iter + P + G - 1, with queuing
    and slot reuse (8 requests on 3 slots)."""
    model, params = _model("phi4-mini-3.8b")
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i,
                    prompt=list(rng.integers(0, model.cfg.vocab,
                                             size=int(rng.integers(2, 6)))),
                    max_new=int(rng.integers(1, 5))) for i in range(8)]
    bat = ContinuousBatcher(model, params, n_slots=3, max_seq=32,
                            kv_quant=kv_quant)
    for r in reqs:
        bat.submit(r)
    done = bat.run()
    assert sorted(r.rid for r in done) == list(range(8))
    for r in done:
        assert len(r.generated) == r.max_new
        assert r.complete_iter == r.submit_iter + len(r.prompt) \
            + r.max_new - 1, r.rid
        assert all(0 <= t < model.cfg.vocab for t in r.generated)
    assert max(r.submit_iter for r in done) > 0       # some waited


def test_idle_iterations_advance_the_clock():
    model, params = _model("phi4-mini-3.8b")
    bat = ContinuousBatcher(model, params, n_slots=2, max_seq=8)
    bat.step()
    bat.step()
    assert bat.it == 2 and not bat.busy
    r = Request(rid=0, prompt=[3, 4], max_new=2)
    bat.submit(r)
    bat.run()
    assert (r.submit_iter, r.complete_iter) == (2, 5)


def test_run_raises_when_max_iters_cuts_it_short():
    model, params = _model("phi4-mini-3.8b")
    bat = ContinuousBatcher(model, params, n_slots=1, max_seq=16)
    for i in range(2):
        bat.submit(Request(rid=i, prompt=[1, 2, 3], max_new=4))
    with pytest.raises(RuntimeError, match="max_iters=3"):
        bat.run(max_iters=3)
    assert len(bat.queue) == 1 and bat.busy


def test_batcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(reduced(get_config("phi4-mini-3.8b")))
