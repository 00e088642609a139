"""The port's serving-fleet simulator against the JAX package's.

``repro_torch.serving.fleet_sim.simulate_fleet(..., device="cpu")`` runs
the fleet kernel's plain torch version (the FIFO walk, vectorized over
candidates); ``simulate_fleet_scalar`` is the reference's event-driven
oracle, copied.  Both must equal the reference's ``simulate_fleet`` on
its numpy backend (and on its jitted jax backend) bit for bit: the
stamps are integers once the float64 arrival iterations are fixed, and
``metrics()`` is the reference's own numpy arithmetic.  The port's
``ContinuousBatcher`` must reproduce the port simulator's stamps exactly,
as the reference's batcher reproduces the reference simulator's.
"""

import numpy as np
import pytest
import torch

from repro.serving import fleet_sim as RF
from repro.serving import traffic as RT
from repro_torch.kernels import fleet_sim as K
from repro_torch.serving import fleet_sim as TF
from repro_torch.serving import traffic as TT

# a latency spread matching the paper design space (~0.02-0.9 s/iter)
STEPS = np.array([0.02, 0.05, 0.11, 0.23, 0.45, 0.88])
ETOK = np.array([0.4, 0.55, 0.8, 1.1, 1.9, 3.2])
PRESETS = sorted(TT.TRAFFIC_PRESETS)


def _traces(name_or_arrays):
    """The same trace in both packages."""
    if isinstance(name_or_arrays, str):
        return (RT.resolve_traffic(name_or_arrays),
                TT.resolve_traffic(name_or_arrays))
    return (RT.TrafficTrace(*name_or_arrays),
            TT.TrafficTrace(*name_or_arrays))


def _assert_same(got, want, *, metrics: bool = True):
    assert got.n_iters == want.n_iters and got.n_slots == want.n_slots
    for f in ("submit_iter", "comp_iter", "active_iters", "step_s",
              "e_token_j"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    if metrics:
        mg, mw = got.metrics(), want.metrics()
        assert mg.keys() == mw.keys()
        for k in mw:
            assert mg[k].tobytes() == mw[k].tobytes(), k
        assert got.latency_s.tobytes() == want.latency_s.tobytes()


def _ragged(seed: int, n: int = 20):
    rng = np.random.default_rng(seed)
    return ("ragged", np.sort(rng.uniform(0, 3.0, n)),
            np.concatenate([rng.integers(1, 3, n // 2),
                            rng.integers(40, 90, n - n // 2)]
                           ).astype(np.int64),
            np.concatenate([rng.integers(1, 2, n // 2),
                            rng.integers(30, 60, n - n // 2)]
                           ).astype(np.int64))


# ---------------------------------------------------------------------------
# the port's routes == the reference's numpy simulator (bit for bit)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("n_slots", [1, 3, 8, K.MAX_REGISTER_SLOTS + 1])
def test_presets_equal_reference(preset, n_slots):
    r_tr, t_tr = _traces(preset)
    want = RF.simulate_fleet(STEPS, ETOK, r_tr, n_slots=n_slots,
                             backend="numpy")
    got = TF.simulate_fleet(STEPS, ETOK, t_tr, n_slots=n_slots,
                            device="cpu")
    assert got.backend == "cpu"
    _assert_same(got, want)
    for i, (s, e) in enumerate(zip(STEPS, ETOK)):
        one = TF.simulate_fleet_scalar(s, e, t_tr, n_slots=n_slots)
        ref = RF.simulate_fleet_scalar(s, e, r_tr, n_slots=n_slots)
        assert one.backend == "scalar"
        _assert_same(one, ref)
        assert np.array_equal(one.comp_iter[0], got.comp_iter[i])
        assert one.active_iters[0] == got.active_iters[i]


@pytest.mark.parametrize("max_iters", [0, 1, 7, 30, 100])
def test_truncated_equals_reference(max_iters):
    r_tr, t_tr = _traces("steady")
    want = RF.simulate_fleet(STEPS, ETOK, r_tr, n_slots=2,
                             max_iters=max_iters, backend="numpy")
    got = TF.simulate_fleet(STEPS, ETOK, t_tr, n_slots=2,
                            max_iters=max_iters, device="cpu")
    _assert_same(got, want)
    for i, (s, e) in enumerate(zip(STEPS, ETOK)):
        ref = RF.simulate_fleet_scalar(s, e, r_tr, n_slots=2,
                                       max_iters=max_iters)
        one = TF.simulate_fleet_scalar(s, e, t_tr, n_slots=2,
                                       max_iters=max_iters)
        _assert_same(one, ref)


def test_jax_backend_equals_the_port(jax_usable):
    """The reference's jitted fori_loop (the route the fleet kernel
    replaces) gives the port's stamps and metrics bit for bit."""
    if not jax_usable:
        pytest.skip("jax backend unusable")
    for preset in PRESETS:
        r_tr, t_tr = _traces(preset)
        want = RF.simulate_fleet(STEPS, ETOK, r_tr, n_slots=4,
                                 backend="jax")
        got = TF.simulate_fleet(STEPS, ETOK, t_tr, n_slots=4, device="cpu")
        _assert_same(got, want)


@pytest.mark.parametrize("seed", [11, 12])
def test_ragged_trace_equals_reference(seed):
    r_tr, t_tr = _traces(_ragged(seed))
    want = RF.simulate_fleet(STEPS, ETOK, r_tr, n_slots=3, backend="numpy")
    got = TF.simulate_fleet(STEPS, ETOK, t_tr, n_slots=3, device="cpu")
    _assert_same(got, want)
    for i, (s, e) in enumerate(zip(STEPS, ETOK)):
        one = TF.simulate_fleet_scalar(s, e, t_tr, n_slots=3)
        assert np.array_equal(one.submit_iter[0], got.submit_iter[i])
        assert np.array_equal(one.comp_iter[0], got.comp_iter[i])
        assert one.active_iters[0] == got.active_iters[i]


@pytest.mark.parametrize("seed", range(8))
def test_random_traces_and_steps_equal_reference(seed):
    """Seeded random traces, steps (down to 1 ms, long horizons), slot
    counts on both sides of the register limit and serving windows."""
    rng = np.random.default_rng(1000 + seed)
    n_req = int(rng.integers(1, 60))
    arrays = ("rand", np.sort(rng.uniform(0, rng.uniform(0.1, 10), n_req)),
              rng.integers(1, 30, n_req).astype(np.int64),
              rng.integers(1, 30, n_req).astype(np.int64),
              float(rng.uniform(0.2, 5.0)))
    r_tr, t_tr = _traces(arrays)
    steps = np.exp(rng.uniform(np.log(1e-3), np.log(2.0), 40))
    etok = rng.uniform(0.1, 3.0, 40)
    n_slots = int(rng.choice([1, 2, 5, 8, 16, 19]))
    max_iters = [None, int(rng.integers(1, 400))][seed % 2]
    want = RF.simulate_fleet(steps, etok, r_tr, n_slots=n_slots,
                             max_iters=max_iters, backend="numpy")
    got = TF.simulate_fleet(steps, etok, t_tr, n_slots=n_slots,
                            max_iters=max_iters, device="cpu")
    _assert_same(got, want)
    i = int(rng.integers(0, 40))
    one = TF.simulate_fleet_scalar(steps[i], etok[i], t_tr, n_slots=n_slots,
                                   max_iters=max_iters)
    assert np.array_equal(one.comp_iter[0], got.comp_iter[i])
    assert one.active_iters[0] == got.active_iters[i]


# ---------------------------------------------------------------------------
# edge cases: empty, overload, the hand-computed example, validation
# ---------------------------------------------------------------------------

def test_empty_trace_and_no_candidates():
    arrays = ("empty", np.zeros(0), np.zeros(0, np.int64),
              np.zeros(0, np.int64))
    r_tr, t_tr = _traces(arrays)
    got = TF.simulate_fleet(STEPS, ETOK, t_tr, device="cpu")
    _assert_same(got, RF.simulate_fleet(STEPS, ETOK, r_tr,
                                        backend="numpy"))
    m = got.metrics()
    assert (m["slo_attainment"] == 1.0).all()
    assert (m["throughput_tps"] == 0.0).all()
    assert (m["p99_latency_s"] == 0.0).all()
    _assert_same(TF.simulate_fleet_scalar(0.1, 1.0, t_tr),
                 RF.simulate_fleet_scalar(0.1, 1.0, r_tr))
    none = TF.simulate_fleet(np.zeros(0), np.zeros(0), "quick",
                             device="cpu")
    assert none.n_candidates == 0 and none.submit_iter.shape == (0, 16)
    _assert_same(none, RF.simulate_fleet(np.zeros(0), np.zeros(0), "quick",
                                         backend="numpy"))


def test_overload_poisons_percentiles():
    """A hard serving window leaves stragglers unserved: the latency
    percentiles go to +inf and attainment drops, as in the reference."""
    got = TF.simulate_fleet(np.array([0.5]), np.array([1.0]),
                            "interactive", n_slots=1, max_iters=10,
                            device="cpu")
    want = RF.simulate_fleet(np.array([0.5]), np.array([1.0]),
                             "interactive", n_slots=1, max_iters=10,
                             backend="numpy")
    _assert_same(got, want)
    m = got.metrics()
    assert m["served_frac"][0] < 1.0
    assert np.isinf(m["p99_latency_s"][0])
    assert m["slo_attainment"][0] < 1.0
    assert np.isfinite(m["throughput_tps"][0])
    one = TF.simulate_fleet_scalar(0.5, 1.0, "interactive", n_slots=1,
                                   max_iters=10)
    assert np.array_equal(one.comp_iter, got.comp_iter)


def test_hand_computed_tiny_example():
    """2 requests, 2 slots, step = 1 s: stamps and metrics by hand."""
    trace = TT.TrafficTrace("tiny", np.array([0.0, 0.0]),
                            np.array([1, 2], np.int64),
                            np.array([2, 2], np.int64), slo_s=2.5)
    res = TF.simulate_fleet(np.array([1.0]), np.array([2.0]), trace,
                            n_slots=2, device="cpu")
    # svc = P + G - 1 = [2, 3]; both admitted at k = 0
    assert np.array_equal(res.submit_iter[0], [0, 0])
    assert np.array_equal(res.comp_iter[0], [2, 3])
    assert res.active_iters[0] == 3
    m = res.metrics()
    assert np.array_equal(res.latency_s[0], [2.0, 3.0])
    assert m["slo_attainment"][0] == 0.5
    assert m["throughput_tps"][0] == pytest.approx(5 / 3)
    # 3 active iterations x 2 slots x 2 J / 5 served tokens
    assert m["energy_per_token_j"][0] == pytest.approx(12 / 5)


def test_input_validation_as_reference():
    for kw, match in ((dict(step_s=np.array([0.1, 0.2]),
                            e_token_j=np.array([1.0])), "matching 1-D"),
                      (dict(step_s=np.array([0.0]),
                            e_token_j=np.array([1.0])), "finite and > 0"),
                      (dict(step_s=np.array([np.inf]),
                            e_token_j=np.array([1.0])), "finite and > 0"),
                      (dict(step_s=np.array([0.1]),
                            e_token_j=np.array([1.0]), n_slots=0),
                       "n_slots")):
        with pytest.raises(ValueError, match=match):
            RF.simulate_fleet(traffic="quick", backend="numpy", **kw)
        with pytest.raises(ValueError, match=match):
            TF.simulate_fleet(traffic="quick", device="cpu", **kw)
    # a step so small the arrival iterations overflow int32
    for fn, dev in ((RF.simulate_fleet, dict(backend="numpy")),
                    (TF.simulate_fleet, dict(device="cpu"))):
        with pytest.raises(ValueError, match="arrival horizon overflows"):
            fn(np.array([1e-12, 0.1]), np.ones(2), "steady", **dev)
    with pytest.raises(TypeError, match="TrafficTrace"):
        TF.simulate_fleet(STEPS, ETOK, 42, device="cpu")


def test_simulate_fleet_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TF.simulate_fleet(STEPS, ETOK, "quick")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TF.simulate_fleet(STEPS, ETOK, "quick", device="cuda:0")


def test_fleet_metrics_and_span_as_reference():
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    reg = obs_metrics.get_registry()
    before = reg.snapshot().get("fleet.simulations", 0)
    with obs_trace.configured(True):
        res = TF.simulate_fleet(STEPS, ETOK, "quick", n_slots=2,
                                device="cpu")
        spans = obs_trace.get_tracer().spans("fleet.simulate")
    assert spans and spans[-1].attrs["backend"] == "cpu"
    assert spans[-1].attrs["n_iters"] == res.n_iters
    snap = reg.snapshot()
    assert snap["fleet.simulations"] == before + 1
    assert snap["fleet.served_frac"] == float(res.served.mean())
    assert snap["fleet.slo_attainment"] == float(
        res.metrics()["slo_attainment"].mean())


# ---------------------------------------------------------------------------
# the kernel's wrapper on the CPU: its plain version, and its refusals
# ---------------------------------------------------------------------------

def _kernel_inputs(preset="bursty", n=50, seed=3):
    tr = TT.resolve_traffic(preset)
    step = np.random.default_rng(seed).uniform(0.01, 0.9, n)
    arr, svc = tr.arrival_s, tr.service_iters
    drain = int(np.ceil(arr.max() / step.min())) + int(svc.sum()) + 1
    return (torch.from_numpy(step), torch.from_numpy(arr),
            torch.from_numpy(svc)), drain


@pytest.mark.parametrize("n_slots", [1, 4, 16, 17])
def test_wrapper_takes_the_plain_version_on_the_cpu(n_slots):
    (step, arr, svc), drain = _kernel_inputs()
    before = K.launches
    got = K.fleet_stamps(step, arr, svc, n_slots, drain)
    want = RF._simulate_numpy(
        RF._arrival_iters(step.numpy(), arr.numpy()), svc.numpy(),
        n_slots, drain)
    assert K.launches == before           # no kernel on the CPU
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and np.array_equal(g.numpy(), w)


def test_wrapper_checks_its_operands():
    (step, arr, svc), drain = _kernel_inputs()
    for args, match in (
            ((step[:, None], arr, svc, 8, drain), "1-D"),
            ((step, arr[:-1], svc, 8, drain), "arrivals but"),
            ((step.float(), arr, svc, 8, drain), "float64"),
            ((step, arr, svc.int(), 8, drain), "int64"),
            ((step, arr, svc, 0, drain), "n_slots"),
            ((step, arr, svc, 8, 0), "horizon"),
            ((step, arr, svc, 8, 2 ** 31), "horizon"),
            ((step[:0], arr, svc, 8, drain), "at least one"),
            ((step[::2], arr, svc, 8, drain), "contiguous")):
        with pytest.raises(ValueError, match=match):
            K.fleet_stamps(*args)
    with pytest.raises(ValueError, match="neither CPU nor CUDA"):
        K.fleet_stamps(step.to("meta"), arr.to("meta"), svc.to("meta"), 8,
                       drain)


# ---------------------------------------------------------------------------
# the port's ContinuousBatcher is the golden reference of the iteration
# contract
# ---------------------------------------------------------------------------

def test_batcher_reproduces_fleet_sim_stamps():
    """Real batcher submissions paced by arrival iteration: its submit /
    complete stamps equal the port simulator's bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import Model
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    rng = np.random.default_rng(5)
    n_req, n_slots, step_s = 7, 2, 1.0
    trace = TT.TrafficTrace(
        "golden",
        np.sort(rng.uniform(0, 6.0, n_req)),
        rng.integers(1, 4, n_req).astype(np.int64),
        rng.integers(1, 4, n_req).astype(np.int64))
    sim = TF.simulate_fleet(np.array([step_s]), np.array([1.0]), trace,
                            n_slots=n_slots, device="cpu")
    cfg = reduced(get_config("starcoder2-7b"))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    bat = ContinuousBatcher(model, params, n_slots=n_slots, max_seq=16)
    reqs = [Request(rid=i,
                    prompt=list(rng.integers(0, cfg.vocab,
                                             trace.prompt_tokens[i])),
                    max_new=int(trace.decode_tokens[i]))
            for i in range(n_req)]
    arrive = np.ceil(trace.arrival_s / step_s).astype(int)
    submitted = 0
    for _ in range(10000):
        while submitted < n_req and arrive[submitted] <= bat.it:
            bat.submit(reqs[submitted])
            submitted += 1
        if submitted == n_req and not bat.busy:
            break
        bat.step()
    assert len(bat.completed) == n_req
    assert np.array_equal([r.submit_iter for r in reqs], sim.submit_iter[0])
    assert np.array_equal([r.complete_iter for r in reqs], sim.comp_iter[0])
