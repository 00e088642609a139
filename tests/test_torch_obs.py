"""The port's telemetry layer (``repro_torch.obs``) against the reference's.

The cases of the reference's ``tests/test_obs.py`` run against the port's
``obs``: span nesting, the async handles, the disabled no-op path, the
ring bound, the Chrome-trace and JSONL exporters, the metrics registry,
and the instrumented sweep and search, whose results are byte-identical
with tracing on and off.  The report renders the same text as the
reference's from the same spans and metrics.  The one change to the
reference is the profiler mirror: ``torch_annotations`` puts every span
into ``torch.profiler`` ranges, and a telemetry dict naming the
reference's ``jax_annotations`` is refused.

The port's own additions: the serving forward's spans (their tree, and
logits bit for bit the same with tracing on and off), the tracer's epoch
on the wall clock that ``torch.profiler`` stamps its events with, and the
attribution of a trace's kernels to the spans that launched them
(``repro_torch.obs.attribution``).
"""

import json

import numpy as np
import pytest
import torch

from repro import obs as R_OBS
from repro_torch import obs
from repro_torch.core.accelerator import design_space_soa
from repro_torch.core.dse import ExploreSpec, run
from repro_torch.core.dse_batch import _sweep_chunked
from repro_torch.core.synthesis import PersistentSynthesisCache
from repro_torch.core.workloads import get_workload
from repro_torch.obs import attribution
from repro_torch.obs import trace as T_TRACE

CHUNK = 16
GRID = dict(glb_kbs=(64, 256), bws=(8.0, 16.0, 32.0, 64.0))
CPU = "cpu"


def _reset():
    for o in (obs, R_OBS):
        o.disable()
        o.configure(enabled=False, reset=True)
        o.reset_metrics()


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Tracing off and a fresh ring + registry around every test, in both
    packages (their state is process-global)."""
    _reset()
    yield
    _reset()


def _space():
    return design_space_soa(chunk_size=CHUNK, **GRID)


# ---------------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------------

def test_span_nesting_and_ordering():
    obs.configure(enabled=True)
    with obs.span("outer", a=1):
        with obs.span("inner"):
            pass
        with obs.span("inner2") as sp:
            sp.set(extra="x")
    spans = obs.get_tracer().spans()
    by_name = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["inner", "inner2", "outer"]
    assert by_name["outer"].parent_id is None
    assert by_name["outer"].depth == 0
    for child in ("inner", "inner2"):
        assert by_name[child].parent_id == by_name["outer"].span_id
        assert by_name[child].depth == 1
    assert by_name["inner2"].attrs["extra"] == "x"
    assert by_name["outer"].attrs["a"] == 1
    for s in spans:
        assert s.dur_s >= 0.0 and s.cpu_dur_s >= 0.0
    assert by_name["inner"].t0_s >= by_name["outer"].t0_s


def test_span_status_on_exception():
    obs.configure(enabled=True)
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("x")
    (sp,) = obs.get_tracer().spans("boom")
    assert sp.status == "error"


def test_async_start_end_handles():
    obs.configure(enabled=True)
    h1 = obs.span_start("kernel", chunk=0)
    h2 = obs.span_start("kernel", chunk=1)
    obs.span_end(h2, status="ok", n=5)
    obs.span_end(h1)
    spans = obs.get_tracer().spans("kernel")
    assert [s.attrs["chunk"] for s in spans] == [1, 0]
    assert spans[0].attrs["n"] == 5
    assert all(s.depth == 0 for s in spans)


def test_disabled_path_is_noop():
    assert not obs.is_enabled()
    a = obs.span("x")
    b = obs.span("y", attr=1)
    assert a is b
    with a as sp:
        sp.set(ignored=True)
    assert obs.span_start("x") is None
    obs.span_end(None)
    assert obs.get_tracer().spans() == []


def test_ring_bound_evicts_oldest():
    obs.configure(enabled=True, ring_size=4)
    for i in range(10):
        with obs.span("s", i=i):
            pass
    tr = obs.get_tracer()
    assert [s.attrs["i"] for s in tr.spans()] == [6, 7, 8, 9]
    assert tr.n_recorded == 10 and tr.n_evicted == 6
    obs.configure(enabled=False, ring_size=65536)


def test_configured_scoping_restores_prior_state(tmp_path):
    with obs.configured(None):
        assert not obs.is_enabled()
    with obs.configured(True):
        assert obs.is_enabled()
    assert not obs.is_enabled()
    with obs.configured({"jsonl_path": tmp_path / "t.jsonl"}):
        assert obs.is_enabled()
        with obs.span("inside"):
            pass
    assert not obs.is_enabled()
    assert len(obs.load_jsonl(tmp_path / "t.jsonl")) == 1


def test_jax_annotations_refused_with_its_counterpart():
    with pytest.raises(ValueError, match="torch_annotations"):
        with obs.configured({"jax_annotations": True}):
            pass
    assert not obs.is_enabled()
    for bad in ({"jax_annotations": True}, "yes"):
        with pytest.raises(ValueError, match="telemetry"):
            ExploreSpec.mixed("vgg16", telemetry=bad)


def test_torch_annotations_mirror_spans_into_the_profiler():
    """Context and async spans both become ``torch.profiler`` ranges."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.configured({"torch_annotations": True}):
            with obs.span("outer.stage"):
                torch.ones(4).sum()
            h = obs.span_start("async.stage")
            torch.ones(4).sum()
            obs.span_end(h)
    names = [e.name for e in prof.events()]
    assert "outer.stage" in names and "async.stage" in names
    assert not obs.is_enabled()
    assert T_TRACE._STATE["torch_annotation"] is None


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def test_chrome_trace_schema_and_content(tmp_path):
    obs.configure(enabled=True)
    with obs.span("parent", k="v"):
        with obs.span("child"):
            pass
    path = tmp_path / "trace.json"
    doc = obs.export_chrome_trace(path)
    assert obs.validate_chrome_trace(doc) == []
    reloaded = json.loads(path.read_text())
    assert obs.validate_chrome_trace(reloaded) == []
    assert R_OBS.validate_chrome_trace(reloaded) == []
    events = {e["name"]: e for e in reloaded["traceEvents"]}
    assert set(events) == {"parent", "child"}
    for e in events.values():
        assert e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0
    assert events["parent"]["args"]["k"] == "v"
    assert (events["child"]["args"]["parent_id"]
            == events["parent"]["args"]["span_id"])
    assert (events["child"]["ts"] + events["child"]["dur"]
            <= events["parent"]["ts"] + events["parent"]["dur"] + 1e-3)


@pytest.mark.parametrize("doc", [
    {}, {"traceEvents": "nope"},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": -1.0, "pid": 1,
                      "tid": 0}]},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 1.0, "dur": 2.0,
                      "pid": 1, "tid": 0}]}])
def test_validate_chrome_trace_as_reference(doc):
    assert obs.validate_chrome_trace(doc) == R_OBS.validate_chrome_trace(doc)


def test_jsonl_roundtrip_and_truncation_tolerance(tmp_path):
    path = tmp_path / "events.jsonl"
    obs.configure(enabled=True, jsonl_path=path)
    for i in range(3):
        with obs.span("chunk", i=i):
            pass
    obs.disable()
    rows = obs.load_jsonl(path)
    assert [r["attrs"]["i"] for r in rows] == [0, 1, 2]
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"name": "torn", "attrs": {"i": 3')
    assert [r["attrs"]["i"] for r in obs.load_jsonl(path)] == [0, 1, 2]
    # the reference's reader replays the port's log
    assert R_OBS.load_jsonl(path) == obs.load_jsonl(path)


def test_jsonl_nonserializable_attrs_degrade(tmp_path):
    path = tmp_path / "events.jsonl"
    obs.configure(enabled=True, jsonl_path=path)
    with obs.span("np_attrs", n=np.int64(7), f=np.float64(0.5),
                  arr=np.arange(2)):
        pass
    obs.disable()
    (row,) = obs.load_jsonl(path)
    assert row["attrs"]["n"] == 7 and row["attrs"]["f"] == 0.5


# ---------------------------------------------------------------------------
# metrics registry and report
# ---------------------------------------------------------------------------

def _fill_registry(o):
    reg = o.get_registry()
    reg.inc("a.count")
    reg.inc("a.count", 4)
    reg.set("a.gauge", 2.5)
    for v in (1.0, 3.0):
        reg.observe("a.hist", v)
    reg.inc("synth_cache.hits", 30)
    reg.inc("synth_cache.misses", 10)
    reg.inc("sweep.configs", 1000)
    reg.inc("sweep.wall_s", 2.0)
    reg.inc("sweep.synth_s", 1.5)
    reg.inc("sweep.kernel_wait_s", 0.75)
    reg.inc("sweep.kernel_busy_s", 0.5)
    reg.observe("sweep.inflight", 2)
    reg.inc("explore.requested_evals", 50)
    reg.inc("explore.kernel_evals", 40)
    reg.inc("explore.memo_hits", 10)
    reg.inc("explore.eval_seconds", 0.5)


def test_registry_instruments_and_snapshot():
    _fill_registry(obs)
    _fill_registry(R_OBS)
    snap = obs.snapshot()
    assert snap == R_OBS.snapshot()
    assert snap["a.count"] == 5 and snap["a.gauge"] == 2.5
    assert (snap["a.hist.count"], snap["a.hist.sum"], snap["a.hist.min"],
            snap["a.hist.max"], snap["a.hist.mean"]) == (2, 4.0, 1.0, 3.0,
                                                         2.0)
    assert list(snap) == sorted(snap)
    json.dumps(snap)
    reg = obs.get_registry()
    assert reg.counter("a.count") is reg.counter("a.count")
    obs.reset_metrics()
    assert obs.snapshot() == {}


def _fixed_spans(o):
    """The same spans in ``o``'s tracer, with fixed durations."""
    o.configure(enabled=True, reset=True)
    durs = {"sweep.synthesize": 0.25, "sweep.kernel": 0.125,
            "sweep.reduce": 0.0625}
    for name, dur in durs.items():
        for i in range(3):
            with o.span(name, chunk=i):
                pass
    with pytest.raises(RuntimeError):
        with o.span("sweep.reduce", chunk=9):
            raise RuntimeError("x")
    tr = o.get_tracer()
    for k, sp in enumerate(tr.spans()):
        sp.dur_s = durs[sp.name] * (1 + k % 3)
    o.disable()
    return tr


def test_summarize_and_render_text_equal_reference():
    r_tr, t_tr = _fixed_spans(R_OBS), _fixed_spans(obs)
    _fill_registry(obs)
    metrics = obs.snapshot()
    got = obs.summarize(tracer=t_tr, metrics=metrics)
    ref = R_OBS.summarize(tracer=r_tr, metrics=metrics)
    assert got == ref
    assert obs.render_text(got) == R_OBS.render_text(ref)
    assert got["derived"]["synth_cache_hit_rate"] == pytest.approx(0.75)
    assert got["derived"]["sweep_configs_per_s"] == pytest.approx(500.0)
    assert got["spans"]["sweep.reduce"]["errors"] == 1
    assert "sweep.synthesize" in obs.render_text(got)


# ---------------------------------------------------------------------------
# instrumentation: no behavior change, consistent totals
# ---------------------------------------------------------------------------

def _sweep_once(**kw):
    cache = PersistentSynthesisCache()
    res = _sweep_chunked(get_workload("vgg16"), _space(), device=CPU,
                         chunk_size=CHUNK, cache=cache, save_cache=False,
                         **kw)
    return res, {"hits": cache.hits, "misses": cache.misses}


def _same_front(a, b):
    assert (a.n_configs, a.n_chunks) == (b.n_configs, b.n_chunks)
    for m in b.front_metrics:
        assert a.front_metrics[m].tobytes() == b.front_metrics[m].tobytes()
    for k in b.front_soa:
        assert a.front_soa[k].tobytes() == b.front_soa[k].tobytes()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_bit_identity_telemetry_on_vs_off(depth):
    ref, ref_acct = _sweep_once(prefetch_depth=depth)
    obs.configure(enabled=True, reset=True)
    try:
        on, on_acct = _sweep_once(prefetch_depth=depth)
    finally:
        obs.disable()
    assert on_acct == ref_acct
    _same_front(on, ref)
    names = {s.name for s in obs.get_tracer().spans()}
    assert {"sweep_chunked", "sweep.pull", "sweep.synthesize",
            "sweep.dispatch", "sweep.kernel", "sweep.reduce"} <= names


def test_sweep_metrics_always_on():
    res, acct = _sweep_once()
    snap = obs.snapshot()
    assert snap["sweep.chunks"] == res.n_chunks
    assert snap["sweep.configs"] == res.n_configs
    assert snap["sweep.wall_s"] == pytest.approx(res.timings["wall_s"])
    assert snap["sweep.kernel_busy_s"] == pytest.approx(
        res.timings["kernel_busy_s"])
    assert snap["synth_cache.hits"] == acct["hits"]
    assert snap["synth_cache.misses"] == acct["misses"]
    assert snap["sweep.inflight.count"] == res.n_chunks
    assert obs.get_tracer().spans() == []


def test_wall_s_flushed_on_injected_failure():
    from repro_torch.runtime.fault_tolerance import InjectedFailure
    with pytest.raises(InjectedFailure):
        _sweep_chunked(get_workload("vgg16"), _space(), device=CPU,
                       chunk_size=CHUNK, fail_at={2: 1})
    snap = obs.snapshot()
    assert snap["sweep.failures"] == 1
    assert snap["sweep.wall_s"] > 0.0
    assert snap["sweep.chunks"] == 2


def test_resumed_run_totals_consistent(tmp_path):
    from repro_torch.runtime.dse_checkpoint import resume_sweep
    wl = get_workload("vgg16")
    ref = _sweep_chunked(wl, _space(), device=CPU, chunk_size=CHUNK)
    obs.reset_metrics()
    res = resume_sweep(wl, _space, checkpoint_dir=str(tmp_path),
                       checkpoint_every=1, chunk_size=CHUNK, device=CPU,
                       fail_at={2: 1})
    assert res.timings["restarts"] == 1
    snap = obs.snapshot()
    assert snap["sweep.restarts"] == 1
    assert snap["sweep.failures"] == 1
    assert snap["checkpoint.saves"] >= 2
    assert snap["checkpoint.restores"] >= 1
    assert ref.n_chunks <= snap["sweep.chunks"] <= ref.n_chunks + 1
    assert (ref.n_configs <= snap["sweep.configs"]
            <= ref.n_configs + CHUNK)
    assert (res.n_chunks, res.n_configs) == (ref.n_chunks, ref.n_configs)


def test_root_span_error_status_on_failure():
    from repro_torch.runtime.fault_tolerance import InjectedFailure
    obs.configure(enabled=True, reset=True)
    try:
        with pytest.raises(InjectedFailure):
            _sweep_chunked(get_workload("vgg16"), _space(), device=CPU,
                           chunk_size=CHUNK, fail_at={1: 1})
    finally:
        obs.disable()
    (root,) = obs.get_tracer().spans("sweep_chunked")
    assert root.status == "error" and root.attrs["wall_s"] > 0.0


def test_evaluator_reset_stats_and_registry():
    from repro_torch.explore.search import Evaluator
    from repro_torch.explore.space import space_for_workload
    space = space_for_workload("vgg16")
    ev = Evaluator(space, "vgg16", device=CPU)
    g = space.random_population(8, np.random.default_rng(0))
    obs.configure(enabled=True, reset=True)
    ev.evaluate(g)
    obs.disable()
    (sp,) = obs.get_tracer().spans("explore.evaluate")
    assert (sp.attrs["n"], sp.attrs["kernel"], sp.attrs["memo_hits"]) == (
        8, 8, 0)
    assert ev.stats()["requested_evals"] == 8
    ev.reset_stats()
    assert ev.stats()["requested_evals"] == ev.stats()["memo_hits"] == 0
    F1 = ev.evaluate(g)
    assert ev.stats()["memo_hits"] == 8
    assert np.array_equal(F1, Evaluator(space, "vgg16",
                                        device=CPU).evaluate(g))
    snap = obs.snapshot()
    assert snap["explore.requested_evals"] == 24
    assert snap["explore.memo_hits"] == 8
    assert snap["explore.kernel_evals"] == 16


@pytest.mark.parametrize("method,span_name", [
    ("random", "random_search.batch"),
    ("nsga2", "nsga2.generation"),
    ("successive_halving", "successive_halving.rung")])
def test_search_spans_and_identity(tmp_path, method, span_name):
    """Each engine records its spans under telemetry, and its result is
    byte-identical to the same search with tracing off."""
    kw = dict(method=method, budget=48, seed=3)
    if method == "nsga2":
        kw["pop_size"] = 16
    off = run(ExploreSpec.mixed("vgg16", **kw), device=CPU)
    on = run(ExploreSpec.mixed("vgg16", telemetry={
        "jsonl_path": tmp_path / "run.jsonl"}, **kw), device=CPU)
    assert not obs.is_enabled()
    assert on.genomes.tobytes() == off.genomes.tobytes()
    assert on.front_objectives.tobytes() == off.front_objectives.tobytes()
    assert on.history == off.history
    names = {r["name"] for r in obs.load_jsonl(tmp_path / "run.jsonl")}
    assert {span_name, "explore.evaluate"} <= names
    if method == "nsga2":                   # two generations a run
        assert obs.snapshot()["nsga2.generations"] == 4


def test_explore_spec_telemetry_on_a_chunked_sweep(tmp_path):
    feed = lambda: _space()                          # noqa: E731
    spec = dict(chunk_size=CHUNK, use_cache=False)
    off = run(ExploreSpec.single("vgg16", feed(), **spec), device=CPU)
    on = run(ExploreSpec.single("vgg16", feed(), telemetry=True, **spec),
             device=CPU)
    _same_front(on, off)
    assert not obs.is_enabled()
    assert len(obs.get_tracer().spans("sweep.kernel")) == on.n_chunks


# ---------------------------------------------------------------------------
# the serving forward's spans, their clock, and the kernels they launched
# ---------------------------------------------------------------------------

def _tiny_w4a8(n_layers=2):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(
        reduced(get_config("phi4-mini-3.8b"), n_layers=n_layers),
        quant="w4a8_pow2")
    model = Model(cfg, device=CPU)
    params = model.init(torch.Generator(CPU).manual_seed(0), quantize=True)
    tokens = torch.randint(0, cfg.vocab, (1, 12),
                           generator=torch.Generator(CPU).manual_seed(1))
    return model, params, tokens


def test_forward_span_tree():
    """One root a call; a layer's 7 projections each with one activation
    quantization and one output cast, 2 norms, 2 RoPEs."""
    model, params, tokens = _tiny_w4a8()
    obs.configure(enabled=True, reset=True)
    model.forward(params, tokens, last_only=True)
    obs.disable()
    spans = obs.get_tracer().spans()
    by_id = {s.span_id: s for s in spans}
    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == "model.forward"
    assert root.attrs == {"batch": 1, "tokens": 12}
    assert {s.root_id for s in spans} == {root.span_id}

    def children(sp, name=None):
        return [s for s in spans if s.parent_id == sp.span_id
                and (name is None or s.name == name)]

    assert [s.name for s in sorted(children(root), key=lambda s: s.t0_s)] \
        == ["model.embed", "model.layer", "model.layer", "model.logits"]
    layers = children(root, "model.layer")
    assert sorted(sp.attrs["index"] for sp in layers) == [0, 1]
    for layer in layers:
        (att,) = children(layer, "attn.self")
        (mlp,) = children(layer, "common.mlp")
        assert len(children(layer, "common.rms_norm")) == 2
        assert len(children(att, "common.rope")) == 2
        dots = children(att, "qlinear.serve_dot") + children(
            mlp, "qlinear.serve_dot")
        assert len(dots) == 7
        for dot in dots:
            assert sorted(s.name for s in children(dot)) == [
                "qlinear.act_quant", "qlinear.out_cast"]
    for s in spans:
        parent = by_id.get(s.parent_id)
        assert s.end_ns >= s.start_ns
        if parent is not None:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            assert s.depth == parent.depth + 1
    (logits,) = children(root, "model.logits")
    assert [s.name for s in children(logits)] == ["common.rms_norm"]


def test_forward_bit_identical_and_silent_with_tracing_off():
    model, params, tokens = _tiny_w4a8()
    off, _ = model.forward(params, tokens)
    assert obs.get_tracer().spans() == []
    assert obs.get_tracer().n_recorded == 0
    obs.configure(enabled=True, reset=True)
    on, _ = model.forward(params, tokens)
    obs.disable()
    assert torch.equal(on, off)
    assert obs.get_tracer().n_recorded > 0
    again, _ = model.forward(params, tokens)
    assert torch.equal(again, off)


def test_span_on_the_profilers_clock():
    """A span's start and end on the wall clock bracket the profiler's own
    stamp of the range it mirrors into, and ``time.time_ns`` stamps taken
    around it."""
    import time
    from torch.profiler import ProfilerActivity, profile
    obs.configure(enabled=True, reset=True, torch_annotations=True)
    tr = obs.get_tracer()
    assert isinstance(tr.epoch_ns, int) and isinstance(tr.epoch_unix_ns, int)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        before = time.time_ns()
        with obs.span("clock.probe"):
            torch.ones(64).sum()
        after = time.time_ns()
    obs.disable()
    (sp,) = tr.spans("clock.probe")
    start, end = tr.unix_ns(sp.start_ns), tr.unix_ns(sp.end_ns)
    slack = 200_000         # the clocks' reads and drift, well above both
    assert before - slack <= start <= end <= after + slack
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "clock.probe"]
    assert start - slack <= ev.start_ns() <= end + slack
    assert sp.t0_s == pytest.approx(sp.start_ns / 1e9)
    assert sp.dur_s == pytest.approx((sp.end_ns - sp.start_ns) / 1e9)


def test_reset_reads_the_epoch_again():
    tr = obs.get_tracer()
    first = (tr.epoch_ns, tr.epoch_unix_ns)
    obs.configure(enabled=False, reset=True)
    assert tr.epoch_ns > first[0] and tr.epoch_unix_ns >= first[1]


def _wall(name, a, b, sid, root):
    return attribution.WallSpan(name, a, b, sid, root)


def _synthetic():
    """A forward from 0 to 100: a layer 10-90 holding a serve_dot 20-50
    (its act_quant 22-30) and a norm 60-70; a second root 200-220."""
    spans = [_wall("model.forward", 0, 100, 1, 1),
             _wall("model.layer", 10, 90, 2, 1),
             _wall("qlinear.serve_dot", 20, 50, 3, 1),
             _wall("qlinear.act_quant", 22, 30, 4, 1),
             _wall("common.rms_norm", 60, 70, 5, 1),
             _wall("model.forward", 200, 220, 6, 6)]
    kernels = [attribution.Kernel(name, 1000 + i * 10, 1000 + i * 10 + d,
                                  launch)
               for i, (name, d, launch) in enumerate([
                   ("a", 4, 25),      # act_quant, inside serve_dot
                   ("b", 2, 40),      # serve_dot itself
                   ("c", 3, 65),      # rms_norm
                   ("d", 1, 80),      # the layer
                   ("e", 5, 5),       # the forward
                   ("f", 7, 150),     # between the roots: unattributed
                   ("g", 6, None),    # no launch in the trace
                   ("h", 8, 210)])]   # the second root
    return spans, kernels


def test_attribution_innermost_span_wins():
    spans, kernels = _synthetic()
    names = [None if s is None else s.name
             for s in attribution.owners(kernels, spans)]
    assert names == ["qlinear.act_quant", "qlinear.serve_dot",
                     "common.rms_norm", "model.layer", "model.forward",
                     None, None, "model.forward"]
    st = attribution.Stretches(spans)
    assert [(a, b, s.name) for a, b, s in st.stretches][:4] == [
        (0, 10, "model.forward"), (10, 20, "model.layer"),
        (20, 22, "qlinear.serve_dot"), (22, 30, "qlinear.act_quant")]
    assert st.at(30).name == "qlinear.serve_dot"     # an end is open
    assert st.at(100) is None and st.at(-1) is None
    assert st.split(45, 205) == {"qlinear.serve_dot": 5, "model.layer": 30,
                                 "common.rms_norm": 10, "model.forward": 15,
                                 None: 100}


def test_attribution_counts_unattributed_and_refuses_evicted():
    spans, kernels = _synthetic()
    got = attribution.seconds_by_span(kernels, spans)
    assert got == pytest.approx({
        "qlinear.act_quant": 4e-9, "qlinear.serve_dot": 2e-9,
        "common.rms_norm": 3e-9, "model.layer": 1e-9,
        "model.forward": 13e-9, None: 13e-9})
    assert attribution.seconds_by_span(kernels, spans, n_evicted=1) is None
    assert attribution.seconds_by_span(kernels, []) is None


class _Event:
    """A ``torch.profiler`` kineto event's surface, for a canned trace."""

    def __init__(self, name, device, start, dur, corr, annotation=False):
        self._v = (name, device, start, dur, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        import types
        return types.SimpleNamespace(name=self._v[1])

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_attribution_reads_kernels_and_their_launches():
    import types
    events = [
        _Event("cudaLaunchKernel", "CPU", 100, 5, 7),
        _Event("cuLaunchKernelEx", "CPU", 120, 5, 8),
        _Event("cudaMemcpyAsync", "CPU", 140, 5, 9),
        _Event("void k2<float>(float*)", "CUDA", 900, 30, 8),
        _Event("void k1(int)", "CUDA", 500, 20, 7),
        _Event("Memcpy DtoH (Device -> Pinned)", "CUDA", 950, 10, 9),
        _Event("model.layer", "CUDA", 400, 700, 0, annotation=True),
        _Event("orphan", "CUDA", 1000, 4, 0),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert attribution.kernels(prof) == [
        attribution.Kernel("void k1(int)", 500, 520, 100),
        attribution.Kernel("void k2<float>(float*)", 900, 930, 120),
        attribution.Kernel("orphan", 1000, 1004, None)]


def test_wall_spans_from_the_tracer():
    obs.configure(enabled=True, reset=True)
    with obs.span("outer"):
        with obs.span("inner"):
            pass
    obs.disable()
    tr = obs.get_tracer()
    inner, outer = attribution.wall_spans()
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.root_id == outer.root_id == outer.span_id
    assert outer.start_ns == tr.unix_ns(tr.spans("outer")[0].start_ns)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns

