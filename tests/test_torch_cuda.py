"""The port's CUDA kernels on the card: the sweep kernel (and the
mixed-precision sweeps and searches that launch it), the serving-fleet
simulator's kernel, the two quantized matmuls of the serving path (also
on depth-cut mamba2 and zamba2 at full width), the int8-KV decode
attention and flash attention; the MoE family's routes and combine on
reduced moonshot; and the vlm and audio families' routes on reduced
llama-3.2-vision and whisper, with flash at their cross-attention
shapes; the grad rule that keeps the kernels (no backward) off the
autograd graph (ROADMAP C.13); and the checkpointed, restarting train
loop with int8 gradient compression, restored across devices; and the
dry run's op count of a step on the card, with its kernels launching,
against the same step's count under fake tensors.

Every test here is marked ``cuda`` and skips on a host without a card.
The file imports only the port (no jax, nothing of ``repro``), so it runs
where the JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The sweep kernel is held against its plain PyTorch version on the card
and against the port's exact float64 CPU path, whose bit-identity to the
JAX package's numpy kernel the CPU tests pin.  The fleet kernel's stamps
are integers: it must equal its plain version bit for bit.  The matmul kernels sum
exactly in int32, so they must equal their plain versions bit for bit,
in every regime and at every split of k.
The decode-attention kernel is held to its plain version at 1e-5 x
max|out| (the reference's kernel-vs-oracle bound; its float operations
follow the plain version's order, also across the splits of S, so 0 is
expected and the split tests ask for equality), flash attention at 1e-5
(float32, 3xTF32 on the tensor cores) and 2e-2 (bf16).
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core import dse as TD
from repro_torch.core import dse_batch as TB
from repro_torch.core.accelerator import design_space_soa
from repro_torch.core.pe import PEType, pe_spec
from repro_torch.core.synthesis import synthesize_soa
from repro_torch.core.workloads import get_workload
from repro_torch.kernels import _workspace as WS
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import sweep_kernel as K
from repro_torch.kernels import w4a8_matmul as W4
from repro_torch.kernels import w8a8_matmul as W8

RTOL = 1e-6
CPU = torch.device("cpu")
QUICK = dict(glb_kbs=(64, 128, 256, 512),
             bws=tuple(np.linspace(2.0, 64.0, 64)))
WORKLOADS = ("vgg16", "resnet34", "resnet50")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _cfg_lay(n: int, workloads=("vgg16",), seed: int = 0):
    soa = next(iter(design_space_soa(**QUICK)))
    idx = np.random.default_rng(seed).choice(len(soa["pe_rows"]), n)
    soa = {k: v[idx] for k, v in soa.items()}
    wbs = [TB._workload_batch(get_workload(w)) for w in workloads]
    cfg, _ = TB._make_cfg_lay(soa, synthesize_soa(soa), wbs[0])
    lay = {k: np.concatenate([w.arrays[k] for w in wbs])[None, :]
           for k in wbs[0].arrays}
    bounds, s = [], 0
    for w in wbs:
        bounds.append((s, s + len(w)))
        s += len(w)
    return cfg, lay, tuple(bounds)


def _mixed(cfg: dict, n_layers: int, seed: int) -> dict:
    specs = [pe_spec(t) for t in PEType]
    a = np.random.default_rng(seed).integers(
        0, len(specs), size=(len(cfg["pe_rows"]), n_layers))
    return dict(cfg,
                act_bits=np.array([s.act_bits for s in specs])[a],
                weight_bits=np.array([s.weight_bits for s in specs])[a],
                mac_energy_pj=np.array([s.mac_energy_pj for s in specs])[a])


def _rel(got, want) -> float:
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    assert g.shape == w.shape
    return float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "mixed", "segments"])
def test_kernel_matches_plain_and_exact(cuda_device, case):
    if case == "segments":
        cfg, lay, bounds = _cfg_lay(1000, WORKLOADS, seed=1)
    else:
        cfg, lay, _ = _cfg_lay(777, seed=2)
        bounds = None
    if case == "mixed":
        cfg = _mixed(cfg, lay["r"].shape[1], seed=3)
    before = K.launches
    dcfg = TB._cfg_to_device(cfg, cuda_device, exact=False)
    got = K.sweep_aggregates(dcfg, TB._lay_to_device(lay, CPU, False),
                             bounds=bounds)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    plain = K.sweep_aggregates_ref(
        dcfg, TB._lay_to_device(lay, cuda_device, False), bounds=bounds)
    ecfg, elay = TB._to_device_inputs(cfg, lay, CPU, exact=True)
    totals = TB._sweep_kernel(ecfg, elay, exact=True, outputs="layer_totals")
    exact = TB._segment_aggregates(totals, ecfg, elay,
                                   bounds or ((0, lay["r"].shape[1]),),
                                   exact=True)
    for k in TB.AGGREGATE_OUTPUTS:
        g = got[k].cpu().numpy()
        assert got[k].device.type == "cuda"
        assert _rel(g, plain[k].cpu().numpy()) <= RTOL, k
        # the float32 policy's own distance from the exact path bounds
        # the kernel's (it exceeds 1e-6 on some ResNet segments)
        want = exact[k][0] if bounds is None else exact[k]
        plain_err = _rel(plain[k].cpu().numpy(), want.numpy())
        assert _rel(g, want.numpy()) <= max(RTOL, plain_err + RTOL), k


@pytest.mark.cuda
def test_wrapper_raises_on_bad_launch_inputs(cuda_device):
    cfg, lay, _ = _cfg_lay(8)
    dcfg = TB._cfg_to_device(cfg, cuda_device, exact=False)
    with pytest.raises(ValueError, match="host data"):
        K.sweep_aggregates(dcfg, TB._lay_to_device(lay, cuda_device, False))
    with pytest.raises(ValueError, match="is on"):
        K.sweep_aggregates(dict(dcfg, area_mm2=dcfg["area_mm2"].cpu()),
                           TB._lay_to_device(lay, CPU, False))


@pytest.mark.cuda
def test_run_on_card_matches_exact(cuda_device):
    exact = TD.run(TD.ExploreSpec.single("vgg16"), device="cpu")
    before = K.launches
    agg = TD.run(TD.ExploreSpec.single("vgg16", outputs="aggregates"),
                 device=cuda_device)
    assert K.launches == before + 1
    points = TD.run(TD.ExploreSpec.single("vgg16"), device=cuda_device)
    want = exact.headline_ratios()
    for got in (points.headline_ratios(),
                TD.DSEResult("vgg16", [TD.DSEPoint(c, agg.result_view(i))
                                       for i, c in enumerate(agg.configs)])
                .headline_ratios()):
        for k, v in want.items():
            assert abs(got[k] / v - 1.0) <= RTOL, k


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_chunked_front_on_card_matches_exact(cuda_device, depth):
    wl = get_workload("vgg16")
    want = TB._sweep_chunked(wl, design_space_soa(**QUICK), device="cpu",
                             chunk_size=4096)
    before = K.launches
    got = TB._sweep_chunked(wl, design_space_soa(**QUICK),
                            device=cuda_device, chunk_size=4096,
                            prefetch_depth=depth)
    assert K.launches == before + got.n_chunks
    assert got.n_configs == want.n_configs
    assert [c.name() for c in got.front_configs()] \
        == [c.name() for c in want.front_configs()]


def _edge_segments(cfg, segs: str):
    """VGG-16's layers cut into one-layer segments, tiled into one segment
    of MAX_SEGMENT_LAYERS layers, or the ragged W = 3 concatenation."""
    if segs == "ragged_w3":
        return _cfg_lay(len(cfg["pe_rows"]), WORKLOADS, seed=4)[1:]
    wb = TB._workload_batch(get_workload("vgg16"))
    if segs == "one_layer":
        lay = {k: v[None, :] for k, v in wb.arrays.items()}
        return lay, tuple((j, j + 1) for j in range(len(wb)))
    reps = K.MAX_SEGMENT_LAYERS // len(wb)
    lay = {k: np.tile(v, reps)[None, :] for k, v in wb.arrays.items()}
    return lay, ((0, K.MAX_SEGMENT_LAYERS),)


@pytest.mark.cuda
@pytest.mark.parametrize("segs", ["one_layer", "longest", "ragged_w3"])
@pytest.mark.parametrize("n", [1, 255, 257, 32768])
def test_kernel_grid_and_edge_shapes_on_card(cuda_device, n, segs):
    """The grid the C entry reports is the planner's, and the kernel holds
    to its plain version at the planner's edge shapes (the longest
    segment takes more than 48 KB of shared memory)."""
    soa = next(iter(design_space_soa(**QUICK)))
    idx = np.random.default_rng(n).choice(len(soa["pe_rows"]), n)
    soa = {k: v[idx] for k, v in soa.items()}
    cfg, _ = TB._make_cfg_lay(soa, synthesize_soa(soa),
                              TB._workload_batch(get_workload("vgg16")))
    lay, bounds = _edge_segments(cfg, segs)
    dcfg = TB._cfg_to_device(cfg, cuda_device, exact=False)
    got = K.sweep_aggregates(dcfg, TB._lay_to_device(lay, CPU, False),
                             bounds=bounds)
    torch.cuda.synchronize()
    p = K.plan(n, bounds)
    assert K.last_grid == (p.blocks, K.THREADS, p.smem)
    plain = K.sweep_aggregates_ref(
        dcfg, TB._lay_to_device(lay, cuda_device, False), bounds=bounds)
    for k in TB.AGGREGATE_OUTPUTS:
        g = got[k].cpu().numpy()
        assert g.shape == (len(bounds), n) and np.isfinite(g).all(), k
        assert _rel(g, plain[k].cpu().numpy()) <= RTOL, k


@pytest.mark.cuda
def test_large_glb_takes_integer_division_on_card(cuda_device):
    """GLBs of 16 MB and more lie outside the reciprocal division's domain
    (8 MB, ``kGlbHalfMax``): those cells divide with C++ '/' and still
    match the exact path, as the 8 MB cells beside them do."""
    soa = next(iter(design_space_soa(glb_kbs=(8192, 16384, 65536, 131072),
                                     bws=(2.0, 25.6))))
    wbs = [TB._workload_batch(get_workload(w)) for w in WORKLOADS]
    cfg, _ = TB._make_cfg_lay(soa, synthesize_soa(soa), wbs[0])
    lay = {k: np.concatenate([w.arrays[k] for w in wbs])[None, :]
           for k in wbs[0].arrays}
    bounds = _cfg_lay(1, WORKLOADS)[2]
    dcfg = TB._cfg_to_device(cfg, cuda_device, exact=False)
    got = K.sweep_aggregates(dcfg, TB._lay_to_device(lay, CPU, False),
                             bounds=bounds)
    plain = K.sweep_aggregates_ref(
        dcfg, TB._lay_to_device(lay, cuda_device, False), bounds=bounds)
    ecfg, elay = TB._to_device_inputs(cfg, lay, CPU, exact=True)
    totals = TB._sweep_kernel(ecfg, elay, exact=True, outputs="layer_totals")
    exact = TB._segment_aggregates(totals, ecfg, elay, bounds, exact=True)
    for k in TB.AGGREGATE_OUTPUTS:
        g = got[k].cpu().numpy()
        assert _rel(g, plain[k].cpu().numpy()) <= RTOL, k
        plain_err = _rel(plain[k].cpu().numpy(), exact[k].numpy())
        assert _rel(g, exact[k].numpy()) <= max(RTOL, plain_err + RTOL), k


@pytest.mark.cuda
def test_stream_copies_its_layer_table_once(cuda_device):
    K._TABLES.clear()
    got = TB._sweep_chunked(get_workload("vgg16"), design_space_soa(**QUICK),
                            device=cuda_device, chunk_size=4096)
    assert got.n_chunks > 1 and len(K._TABLES) == 1


# ------------------------------------------------- quantized matmuls

QMM = {"w8a8": (OPS.w8a8_matmul, W8, 1), "w4a8": (OPS.w4a8_matmul, W4, 2)}


def _search_genomes(suite, n, seed):
    from repro_torch.explore.space import space_for_workloads
    space = space_for_workloads(suite)
    soa, assign = space.decode(space.random_population(
        n, np.random.default_rng(seed)))
    return soa, space.split_assign(assign)


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", ["aggregates", "full"])
@pytest.mark.parametrize("n", [1, 64, 200])
def test_sweep_mixed_on_card_matches_exact(cuda_device, outputs, n):
    """The mixed sweep on the card (aggregates: the kernel, one launch;
    full: the plain expressions) against the exact CPU path."""
    soa, (assign,) = _search_genomes(("vgg16",), n, seed=n)
    wl = get_workload("vgg16")
    want = TB._sweep_mixed(wl, soa, assign, device="cpu")
    before = K.launches
    got = TB._sweep_mixed(wl, soa, assign, device=cuda_device,
                          outputs=outputs)
    assert K.launches == before + (outputs == "aggregates")
    for k in TB.AGGREGATE_OUTPUTS:
        assert _rel(got[k], want[k]) <= RTOL, k
    assert np.array_equal(got["area_mm2"], want["area_mm2"])


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [None, 1, 2])
@pytest.mark.parametrize("n", [7, 64])
def test_sweep_mixed_many_on_card_matches_exact(cuda_device, n, prefix):
    """W = 3 in one launch, also on the successive-halving prefixes that
    cut every segment to one or two layers; the ResNet segments held to
    the float32 policy's own distance from the exact path (ROADMAP
    C.1)."""
    from repro_torch.core.workloads import Workload
    wls = [get_workload(w) for w in WORKLOADS]
    soa, assigns = _search_genomes(WORKLOADS, n, seed=n)
    if prefix is not None:
        wls = [Workload(name=w.name, layers=w.layers[:prefix]) for w in wls]
        assigns = [a[:, :prefix] for a in assigns]
    want = TB._sweep_mixed_many(wls, soa, assigns, device="cpu")
    before = K.launches
    got = TB._sweep_mixed_many(wls, soa, assigns, device=cuda_device)
    assert K.launches == before + 1
    combined, bounds = TB._workload_batch_many(tuple(wls))
    cfg, lay = TB._make_cfg_lay(soa, synthesize_soa(soa), combined)
    cfg = TB.mixed_assign_cfg(cfg, np.concatenate(assigns, axis=1))
    plain = K.sweep_aggregates_ref(
        TB._cfg_to_device(cfg, cuda_device, exact=False),
        TB._lay_to_device(lay, cuda_device, exact=False), bounds=bounds)
    for k in TB.AGGREGATE_OUTPUTS:
        assert got[k].shape == (3, n)
        assert _rel(got[k], plain[k].cpu().numpy()) <= RTOL, k
        plain_err = _rel(plain[k].cpu().numpy(), want[k])
        assert _rel(got[k], want[k]) <= max(RTOL, plain_err + RTOL), k


@pytest.mark.cuda
def test_golden_front_on_card(cuda_device):
    """tests/golden_coexplore_many.json on the card: genomes identical,
    one kernel launch per evaluation chunk.  The objectives come from
    float32 aggregates, so they are held at the float32 policy's 1e-6
    (the exact CPU path holds the golden's 1e-9, test_torch_explore)."""
    import json
    import pathlib
    golden = json.loads((pathlib.Path(__file__).parent
                         / "golden_coexplore_many.json").read_text())
    spec = TD.ExploreSpec.many(
        golden["workloads"], precision="mixed", preset=golden["preset"],
        budget=golden["budget"], seed=golden["seed"],
        pop_size=golden["pop_size"])
    before = K.launches
    res = TD.run(spec, device=cuda_device)
    assert K.launches - before == res.stats["chunks"] >= 8
    assert res.stats["device"].startswith("cuda")
    want_g = res.space.unpack_genomes(
        np.array(golden["front_genomes_u16"], dtype=np.uint16))
    assert np.array_equal(res.genomes, want_g)
    assert _rel(res.front_objectives,
                np.array(golden["front_objectives"])) <= RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["random", "nsga2",
                                    "successive_halving"])
def test_search_on_card_launches_once_a_chunk(cuda_device, method):
    """Each evaluation chunk is one kernel launch, and every front row of
    the card's search re-evaluated on the exact CPU path is within 1e-6
    (accuracy_noise equal: it is host arithmetic)."""
    from repro_torch.explore.search import SEARCH_METHODS, Evaluator
    from repro_torch.explore.space import space_for_workload
    space = space_for_workload("vgg16")
    before = K.launches
    res = SEARCH_METHODS[method](space, "vgg16", 200, seed=3,
                                 device=cuda_device, chunk_size=48)
    assert K.launches - before == res.stats["chunks"] >= 5
    exact = Evaluator(space, "vgg16", res.objectives, device="cpu")
    F = exact.evaluate(res.genomes)
    assert _rel(res.front_objectives[:, :2], F[:, :2]) <= RTOL
    assert np.array_equal(res.front_objectives[:, 2], F[:, 2])


# ---------------------------------------------------------------------------
# the serving-fleet simulator's kernel
# ---------------------------------------------------------------------------

def _fleet_case(n, preset, seed, device):
    from repro_torch.serving.traffic import resolve_traffic
    trace = resolve_traffic(preset)
    step = np.random.default_rng(seed).uniform(0.005, 0.9, n)
    drain = (int(np.ceil(trace.arrival_s.max() / step.min()))
             + int(trace.service_iters.sum()) + 1)
    args = tuple(torch.from_numpy(a).to(device) for a in
                 (step, trace.arrival_s, trace.service_iters))
    return args, drain


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 32768])
@pytest.mark.parametrize("n_slots", [1, 3, 8, 16, 17, 40])
def test_fleet_kernel_equals_plain_bit_for_bit(cuda_device, n, n_slots):
    """The fleet kernel's stamps equal its plain version's on the card,
    at slot counts in registers and past them (the workspace path), with
    the drain horizon and a window that cuts."""
    from repro_torch.kernels import fleet_sim as FK
    for preset, seed in (("steady", n), ("bursty", n + 1),
                         ("interactive", n + 2)):
        args, drain = _fleet_case(n, preset, seed, cuda_device)
        for n_iters in (drain, max(1, drain // 7)):
            before = FK.launches
            got = FK.fleet_stamps(*args, n_slots, n_iters)
            assert FK.launches == before + 1
            want = FK.fleet_stamps_ref(*args, n_slots, n_iters)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.shape == w.shape and g.dtype == torch.int64
                assert torch.equal(g, w)
            blocks, threads, slots = FK.last_grid
            assert (blocks, threads) == (-(-n // FK.THREADS), FK.THREADS)
            assert slots == (0 if n_slots > FK.MAX_REGISTER_SLOTS
                             else max(1, 1 << (n_slots - 1).bit_length()))


@pytest.mark.cuda
def test_simulate_fleet_on_card_equals_cpu(cuda_device):
    """simulate_fleet on the card (the kernel) and on the CPU (the plain
    version): identical stamps and metrics, and the scalar oracle's."""
    from repro_torch.serving.fleet_sim import (simulate_fleet,
                                               simulate_fleet_scalar)
    step = np.random.default_rng(4).uniform(0.01, 0.9, 500)
    etok = np.random.default_rng(5).uniform(0.1, 3.0, 500)
    for preset in ("steady", "bursty", "interactive", "quick"):
        for max_iters in (None, 50):
            a = simulate_fleet(step, etok, preset, n_slots=8,
                               max_iters=max_iters, device=cuda_device)
            b = simulate_fleet(step, etok, preset, n_slots=8,
                               max_iters=max_iters, device="cpu")
            assert (a.backend, b.backend) == ("cuda", "cpu")
            for f in ("submit_iter", "comp_iter", "active_iters"):
                assert np.array_equal(getattr(a, f), getattr(b, f))
            ma, mb = a.metrics(), b.metrics()
            for k in ma:
                assert ma[k].tobytes() == mb[k].tobytes(), k
            for i in (0, 137, 499):
                one = simulate_fleet_scalar(step[i], etok[i], preset,
                                            n_slots=8, max_iters=max_iters)
                assert np.array_equal(one.comp_iter[0], a.comp_iter[i])
                assert one.active_iters[0] == a.active_iters[i]


@pytest.mark.cuda
def test_fleet_kernel_refuses_cpu_tensors_and_mixed_devices(cuda_device):
    from repro_torch.kernels import fleet_sim as FK
    args, drain = _fleet_case(64, "steady", 0, cuda_device)
    with pytest.raises(ValueError, match="share one device"):
        FK.fleet_stamps(args[0], args[1].cpu(), args[2], 8, drain)
    before = FK.launches
    cpu = FK.fleet_stamps(*(a.cpu() for a in args), 8, drain)
    assert FK.launches == before                # the plain version
    got = FK.fleet_stamps(*args, 8, drain)
    assert all(torch.equal(g.cpu(), c) for g, c in zip(got, cpu))


@pytest.mark.cuda
def test_serving_search_on_card_launches_both_kernels(cuda_device):
    """A serving search on the card: one sweep-kernel and one fleet-kernel
    launch per evaluation chunk, finite front objectives."""
    from repro_torch.explore.search import nsga2
    from repro_torch.explore.space import space_for_workload
    from repro_torch.kernels import fleet_sim as FK
    space = space_for_workload("vgg16")
    k0, f0 = K.launches, FK.launches
    res = nsga2(space, "vgg16", 192, seed=5, pop_size=32, chunk_size=40,
                device=cuda_device, traffic="quick", n_slots=4)
    chunks = res.stats["chunks"]
    assert K.launches - k0 == FK.launches - f0 == chunks >= 5
    assert res.stats["traffic"] == "quick" and res.stats["n_slots"] == 4
    assert np.isfinite(res.front_objectives).all()


# ---------------------------------------------------------------------------
# the PPA models and the preemption-safe runtime on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_ppa_fit_on_card_matches_cpu(cuda_device):
    """The suite on the paper's 720 points: the card picks the CPU's
    (degree, lambda) for every model, its predictions and CV errors agree
    to float64 solve rounding (1e-9), and it meets the Fig. 2 bars."""
    from repro_torch.core.accelerator import design_space
    from repro_torch.core.ppa_model import TARGETS, fit_ppa_suite
    cfgs = list(design_space())
    by_type = {t: [c for c in cfgs if c.pe_type == t] for t in PEType}
    card, card_stats = fit_ppa_suite(by_type, device=cuda_device)
    cpu, cpu_stats = fit_ppa_suite(by_type, device="cpu")
    for key, c in card_stats.items():
        h = cpu_stats[key]
        assert (c["degree"], c["lam"]) == (h["degree"], h["lam"]), key
        for m in ("cv_rmse", "r2", "mape"):
            assert _rel(c[m], h[m]) <= 1e-9, (key, m)
        assert c["r2"] > 0.97 and c["mape"] < 0.10, key
    got, want = card.predict_batch(cfgs), cpu.predict_batch(cfgs)
    for t in TARGETS:
        assert _rel(got[t], want[t]) <= 1e-9, t
    one = card.models[PEType.INT16]["power_mw"]
    assert one.coef.device.type == "cuda"
    assert _rel(one.predict(cfgs[:5], "cpu"), one.predict(cfgs[:5])) <= 1e-9


def _same_stream(got, want):
    assert (got.n_configs, got.n_chunks) == (want.n_configs, want.n_chunks)
    for m in want.front_metrics:
        assert got.front_metrics[m].tobytes() == \
            want.front_metrics[m].tobytes(), m
    for k in want.front_soa:
        assert got.front_soa[k].tobytes() == want.front_soa[k].tobytes(), k


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_resumed_card_stream_equals_uninterrupted(cuda_device, tmp_path,
                                                  depth):
    """Injected failures and snapshots on the card: the resumed front and
    cache accounting equal the uninterrupted card run's bit for bit, and
    every chunk of every attempt launched the kernel."""
    from repro_torch.core.synthesis import PersistentSynthesisCache
    from repro_torch.runtime.dse_checkpoint import resume_sweep
    wl = get_workload("vgg16")
    feed = lambda: design_space_soa(**QUICK)        # noqa: E731
    ref_cache = PersistentSynthesisCache()
    want = TB._sweep_chunked(wl, feed(), device=cuda_device,
                             chunk_size=1024, cache=ref_cache,
                             prefetch_depth=depth)
    cache = PersistentSynthesisCache()
    before = K.launches
    got = resume_sweep(wl, feed, checkpoint_dir=str(tmp_path),
                       checkpoint_every=3, fail_at={2: 1, 9: 2},
                       cache=cache, chunk_size=1024, device=cuda_device,
                       prefetch_depth=depth)
    assert got.timings["restarts"] == 3
    assert K.launches - before >= got.n_chunks
    _same_stream(got, want)
    assert (cache.hits, cache.misses) == (ref_cache.hits, ref_cache.misses)


@pytest.mark.cuda
def test_watchdog_redispatches_on_the_card(cuda_device, monkeypatch):
    """Chunks stalled on the card (a spin kernel queued ahead of each)
    miss the deadline: each is launched again on the card (launches =
    chunks + re-dispatches), and the front equals the run without a
    deadline."""
    wl = get_workload("vgg16")
    want = TB._sweep_chunked(wl, design_space_soa(**QUICK),
                             device=cuda_device, chunk_size=1024)
    real = TB._dispatch_chunk

    def late(cfg, klay, device):
        torch.cuda._sleep(20_000_000)          # ~10 ms
        return real(cfg, klay, device)
    monkeypatch.setattr(TB, "_dispatch_chunk", late)
    before = K.launches
    with pytest.warns(RuntimeWarning, match="watchdog deadline"):
        got = TB._sweep_chunked(wl, design_space_soa(**QUICK),
                                device=cuda_device, chunk_size=1024,
                                prefetch_depth=1, chunk_deadline_s=1e-6)
    t = got.timings
    assert 0 < t["watchdog_redispatches"] <= got.n_chunks
    assert t["abandoned_finalizers"] == t["watchdog_redispatches"]
    assert K.launches - before == got.n_chunks + t["watchdog_redispatches"]
    _same_stream(got, want)


@pytest.mark.cuda
def test_card_finalize_waits_within_its_deadline(cuda_device):
    """The card's finalize polls its event: a generous deadline returns
    the results, which equal the blocking wait's."""
    wl = get_workload("vgg16")
    soa = next(iter(design_space_soa(**QUICK)))
    cfg, _ = TB._make_cfg_lay(soa, synthesize_soa(soa),
                              TB._workload_batch(wl))
    klay = TB._lay_to_device(
        {k: v[None, :] for k, v in TB._workload_batch(wl).arrays.items()},
        CPU, exact=False)
    a = TB._dispatch_chunk(cfg, klay, cuda_device)(timeout=30.0)
    b = TB._dispatch_chunk(cfg, klay, cuda_device)()
    for k in TB.AGGREGATE_OUTPUTS:
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.cuda
@pytest.mark.parametrize("fail_at", [{0: 1}, {3: 1, 6: 2}])
def test_resumed_card_search_equals_uninterrupted(cuda_device, tmp_path,
                                                  fail_at):
    from repro_torch.explore.search import nsga2
    from repro_torch.explore.space import space_for_workload
    from repro_torch.runtime.dse_checkpoint import resume_search
    space = space_for_workload("vgg16")
    want = nsga2(space, "vgg16", 256, pop_size=32, seed=4,
                 device=cuda_device)
    got = resume_search(space, "vgg16", 256, pop_size=32, seed=4,
                        device=cuda_device, checkpoint_dir=str(tmp_path),
                        checkpoint_every=2, fail_at_generation=fail_at)
    assert got.stats["restarts"] == sum(fail_at.values())
    assert np.array_equal(got.genomes, want.genomes)
    assert got.front_objectives.tobytes() == want.front_objectives.tobytes()
    assert got.all_objectives.tobytes() == want.all_objectives.tobytes()
    assert got.history == want.history


@pytest.mark.cuda
def test_telemetry_on_card_leaves_the_stream_identical(cuda_device):
    from repro_torch import obs
    wl = get_workload("vgg16")
    want = TB._sweep_chunked(wl, design_space_soa(**QUICK),
                             device=cuda_device, chunk_size=1024)
    obs.configure(enabled=True, reset=True)
    try:
        got = TB._sweep_chunked(wl, design_space_soa(**QUICK),
                                device=cuda_device, chunk_size=1024)
    finally:
        obs.configure(enabled=False, reset=False)
    _same_stream(got, want)
    kernels = obs.get_tracer().spans("sweep.kernel")
    assert len(kernels) == got.n_chunks
    assert all(sp.attrs["device"].startswith("cuda") for sp in kernels)
    obs.configure(enabled=False, reset=True)

def _qmm_operands(m, k, n, pack, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k // pack, n),
                                      dtype=np.int8))
    xs = torch.tensor(rng.uniform(1e-3, 1e-1), dtype=torch.float32)
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-1, (1, n))
                          .astype(np.float32))
    return tuple(t.to(device) for t in (x, w, xs, ws))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(QMM))
@pytest.mark.parametrize("seed", range(6))
def test_qmatmul_kernel_equals_plain_on_random_shapes(cuda_device, mode,
                                                      seed):
    fn, mod, pack = QMM[mode]
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(1, 40))
    k = 2 * int(rng.integers(1, 2500))
    n = int(rng.integers(1, 3000))
    ops = _qmm_operands(m, k, n, pack, seed, cuda_device)
    before = mod.launches
    got = fn(*ops, impl="kernel")
    assert mod.launches == before + 1
    want = fn(*ops, impl="ref")
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, want), (m, k, n)
    assert torch.equal(fn(*ops, impl="auto"), got)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(QMM))
def test_qmatmul_kernel_on_the_decode_shapes(cuda_device, mode):
    fn, _, pack = QMM[mode]
    for k, n in ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072)):
        ops = _qmm_operands(4, k, n, pack, k + n, cuda_device)
        assert torch.equal(fn(*ops, impl="kernel"), fn(*ops, impl="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(QMM))
def test_qmatmul_kernel_route_refuses_cpu_tensors(cuda_device, mode):
    fn, _, pack = QMM[mode]
    ops = _qmm_operands(4, 64, 32, pack, 0, CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*ops, impl="kernel")
    assert fn(*ops, impl="auto").device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["w8a8", "w4a8_pow2"])
def test_reduced_decode_kernel_equals_plain(cuda_device, quant):
    """A reduced phi4-mini decoded on the card through the kernels and
    through their plain versions gives identical logits and caches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(reduced(get_config("phi4-mini-3.8b")),
                              quant=quant)
    kern = Model(cfg, device=cuda_device, impl="kernel")
    plain = Model(cfg, device=cuda_device, impl="ref")
    params = kern.init(torch.Generator(cuda_device).manual_seed(0),
                       quantize=True)
    ck, cp = kern.init_cache(2, 6), plain.init_cache(2, 6)
    tokens = torch.randint(0, cfg.vocab, (2, 6), device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(1))
    for i in range(6):
        lk, ck = kern.decode_step(params, ck, tokens[:, i:i + 1], i)
        lp, cp = plain.decode_step(params, cp, tokens[:, i:i + 1], i)
        assert torch.equal(lk, lp)
    assert torch.equal(ck["k"], cp["k"]) and torch.equal(ck["v"], cp["v"])


@pytest.mark.cuda
def test_serve_reduced_on_the_card(cuda_device):
    from repro_torch.launch.serve import serve
    before = W8.launches
    res = serve("phi4-mini-3.8b", batch=2, prompt_len=3, gen=4,
                quantize=True, device=cuda_device)
    # 7 steps x 2 layers x 7 projections
    assert W8.launches - before == 7 * 2 * 7
    toks = res["tokens"]
    assert toks.device.type == "cuda" and tuple(toks.shape) == (2, 4)
    assert 0 <= int(toks.min()) and int(toks.max()) < 256


# ------------------------------------- SSM and hybrid (mamba2, zamba2)

def _ssm_models(arch, device, **cut):
    """Full-width ``arch`` with its depth cut, W8A8 quantized params from
    a seed, a kernel-route and a plain-route model."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch), **cut)
    kern = Model(cfg, device=device, impl="kernel")
    plain = Model(cfg, device=device, impl="ref")
    params = kern.init(torch.Generator(device).manual_seed(0),
                       quantize=True)
    return cfg, kern, plain, params


@pytest.mark.cuda
@pytest.mark.parametrize("arch,cut,per_step", [
    ("mamba2-130m", dict(n_layers=2), 4),
    ("zamba2-1.2b", dict(n_layers=2, shared_attn_every=2), 2 * 2 + 7)])
def test_ssm_decode_kernel_equals_plain(cuda_device, arch, cut, per_step):
    """Teacher-forced decode of a depth-cut mamba2 / zamba2 through the
    W8A8 kernels and through their plain versions: logits and every cache
    identical, ``per_step`` W8A8 launches a step."""
    cfg, kern, plain, params = _ssm_models(arch, cuda_device, **cut)
    ck, cp = kern.init_cache(2, 5), plain.init_cache(2, 5)
    tokens = torch.randint(0, cfg.vocab, (2, 5), device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(1))
    for i in range(5):
        before = W8.launches_dp4a
        lk, ck = kern.decode_step(params, ck, tokens[:, i:i + 1], i)
        assert W8.launches_dp4a - before == per_step
        lp, cp = plain.decode_step(params, cp, tokens[:, i:i + 1], i)
        assert torch.equal(lk, lp)
    assert ck.keys() == cp.keys()
    for name in ck:
        assert torch.equal(ck[name], cp[name]), name


@pytest.mark.cuda
def test_mamba2_forward_kernel_equals_plain(cuda_device):
    """The chunked forward at 2 x 1024 (two SSD chunks; projections on the
    tensor-core regime, in_proj at the unaligned n = 3352) equals the
    plain route bit for bit."""
    cfg, kern, plain, params = _ssm_models("mamba2-130m", cuda_device,
                                           n_layers=2)
    tokens = torch.randint(0, cfg.vocab, (2, 1024), device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(2))
    before = W8.launches_tc
    lk, _ = kern.forward(params, tokens)
    assert W8.launches_tc - before == 2 * 2
    lp, _ = plain.forward(params, tokens)
    assert torch.isfinite(lk).all() and torch.equal(lk, lp)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(768, 3352), (1536, 768), (2048, 8384),
                                 (4096, 2048)])
def test_w8a8_at_the_ssm_projection_shapes(cuda_device, k, n):
    """mamba2's and zamba2's in/out projections in both regimes."""
    for m in (4, 4096):
        ops = _qmm_operands(m, k, n, 1, k + n + m, cuda_device)
        assert W8.plan(m, k, n).regime == ("tc" if m >= W8.TC_MIN_M
                                           else "dp4a")
        got = OPS.w8a8_matmul(*ops, impl="kernel")
        assert torch.equal(got, OPS.w8a8_matmul(*ops, impl="ref")), (m, k, n)


# ------------------------------------------- W8A8 regimes (redesign)

def _int_mm(x, w):
    """``torch._int_mm`` on the W8A8 operands: m padded to 32 and k, n to
    multiples of 8 with zeros, the weight column-major."""
    import torch.nn.functional as F
    m, k = x.shape
    n = w.shape[1]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    xp = F.pad(x, (0, kp - k, 0, mp - m))
    wp = F.pad(w, (0, np_ - n, 0, kp - k)).t().contiguous().t()
    return torch._int_mm(xp, wp)[:m, :n]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_w8a8_tensor_core_regime_equals_plain_on_ragged_shapes(cuda_device,
                                                               seed):
    rng = np.random.default_rng(500 + seed)
    m = int(rng.integers(W8.TC_MIN_M, 701))
    k = 2 * int(rng.integers(1, 1500))
    n = 2 * int(rng.integers(1, 1500)) + 1
    assert W8.plan(m, k, n).regime == "tc"
    ops = _qmm_operands(m, k, n, 1, seed, cuda_device)
    before = (W8.launches_tc, W8.launches_dp4a)
    got = OPS.w8a8_matmul(*ops, impl="kernel")
    assert (W8.launches_tc, W8.launches_dp4a) == (before[0] + 1, before[1])
    want = OPS.w8a8_matmul(*ops, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want), (m, k, n)


@pytest.mark.cuda
def test_w8a8_tensor_core_regime_at_the_prefill_shapes(cuda_device):
    for k, n in ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072)):
        x, w, xs, ws = _qmm_operands(4096, k, n, 1, k + n, cuda_device)
        got = OPS.w8a8_matmul(x, w, xs, ws, impl="kernel")
        assert torch.equal(got, OPS.w8a8_matmul(x, w, xs, ws, impl="ref"))
        lib = _int_mm(x, w).to(torch.float32) * xs * ws.reshape(-1)
        assert torch.equal(got, lib), (k, n)


@pytest.mark.cuda
def test_w8a8_split_k_across_split_counts(cuda_device):
    """m 1-16 at shapes whose plans split k 1 to 30-odd ways: equal to the
    plain version, and again on a second call (the workspace the splits
    meet in is left zeroed)."""
    shapes = [(1, 96, 40), (3, 130, 257), (4, 3072, 1024), (4, 3072, 8192),
              (7, 8192, 3072), (8, 1000, 999), (13, 4096, 300),
              (16, 3072, 3072), (16, 64, 33000)]
    splits = set()
    for i, (m, k, n) in enumerate(shapes):
        p = W8.plan(m, k, n)
        assert p.regime == "dp4a"
        splits.add(p.splits)
        ops = _qmm_operands(m, k, n, 1, 900 + i, cuda_device)
        want = OPS.w8a8_matmul(*ops, impl="ref")
        before = W8.launches_dp4a
        for _ in range(2):
            got = OPS.w8a8_matmul(*ops, impl="kernel")
            torch.cuda.synchronize()
            assert torch.equal(got, want), (m, k, n, p.splits)
        assert W8.launches_dp4a == before + 2
    assert len(splits) >= 5 and 1 in splits and max(splits) > 16
    assert not W8.workspace(cuda_device, 1).any()


@pytest.mark.cuda
def test_w8a8_split_k_on_two_streams_at_once(cuda_device):
    """Split-k products queued on two streams together each meet in their
    own stream's workspace: both equal the plain version, call after
    call, and both workspaces are left zeroed."""
    m, k, n = 4, 8192, 3072
    assert W8.plan(m, k, n).splits > 1
    ops = [_qmm_operands(m, k, n, 1, 950 + i, cuda_device) for i in range(2)]
    wants = [OPS.w8a8_matmul(*o, impl="ref") for o in ops]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                gots[i].append(OPS.w8a8_matmul(*ops[i], impl="kernel"))
    torch.cuda.synchronize()
    bufs = []
    for i, st in enumerate(streams):
        assert all(torch.equal(g, wants[i]) for g in gots[i]), i
        with torch.cuda.stream(st):
            bufs.append(W8.workspace(cuda_device, 1))
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    assert not bufs[0].any() and not bufs[1].any()


@pytest.mark.cuda
def test_w8a8_entry_refuses_a_plan_it_cannot_hold(cuda_device):
    """The C entry checks what the planner hands it: a workspace shorter
    than its grid's sums and counters, or a row tile it has no kernel
    for, fails the launch instead of writing past the buffer."""
    m, k, n = 4, 3072, 1024
    p = W8.plan(m, k, n)
    assert p.splits > 1
    x, w, xs, ws = _qmm_operands(m, k, n, 1, 7, cuda_device)
    short = torch.zeros(p.workspace - 1, dtype=torch.int32,
                        device=cuda_device)
    for buf, row_tile in ((short, p.row_tile),
                          (W8.workspace(cuda_device, p.workspace), 5)):
        with pytest.raises(RuntimeError, match="launch failed"):
            W8.launch_qmatmul("w8a8_matmul", "qappa_w8a8_matmul", x, w, xs,
                              ws, m, k, n, (buf, buf.numel(), 0, row_tile,
                                            p.splits))
    assert not short.any()


# --------------------------------------- W4A8 split-k (redesign)

def _w4a8_launch(ops, m, k, n, buf, row_tile, splits):
    """The W4A8 C entry with an explicit row tile and split count; checks
    that the entry reports that launch's grid (columns / 128, row tiles,
    splits)."""
    info = (ctypes.c_int * 3)(-1, -1, -1)
    out = W8.launch_qmatmul(
        "w4a8_matmul", "qappa_w4a8_matmul", *ops, m, k, n,
        (buf, 0 if buf is None else buf.numel(), row_tile, splits, info))
    assert list(info) == [-(-n // 128), -(-m // row_tile), splits]
    return out


def _valid_splits(k):
    """Split counts the kernel takes for k: ceil(quads / splits) quads
    each, none empty."""
    nq = -(-k // 4)
    return [s for s in range(1, nq + 1) if -(-nq // -(-nq // s)) == s]


@pytest.mark.cuda
def test_w4a8_split_k_across_forced_split_counts(cuda_device):
    """The split-k regime at split counts from 1 to one quad a split, k
    ragged to 2 mod 4 among them: equal to the plain version, again on a
    second call, with the workspace left zeroed."""
    shapes = [(1, 96, 40), (3, 130, 257), (4, 3072, 1024), (8, 1002, 999),
              (13, 4098, 300), (16, 64, 1000)]
    for i, (m, k, n) in enumerate(shapes):
        ops = _qmm_operands(m, k, n, 2, 1100 + i, cuda_device)
        want = OPS.w4a8_matmul(*ops, impl="ref")
        p = W4.plan(m, k, n)
        assert p.regime == "splitk"
        valid = _valid_splits(k)
        counts = sorted({1, 2, 3, p.splits, valid[len(valid) // 2],
                         valid[-1]} & set(valid))
        buf = torch.zeros(m * n + -(-m // p.row_tile) * -(-n // 128),
                          dtype=torch.int32, device=cuda_device)
        for splits in counts:
            for _ in range(2):
                got = _w4a8_launch(ops, m, k, n, buf, p.row_tile, splits)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (m, k, n, splits)
            assert not buf.any(), (m, k, n, splits)
        assert len(counts) >= 3 and max(counts) == -(-k // 4)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_w4a8_split_k_on_ragged_shapes(cuda_device, seed):
    """m 1-16 with k = 2 mod 4 and n of any residue, through the wrapper:
    the split-k regime, bit for bit the plain version."""
    rng = np.random.default_rng(1200 + seed)
    m = int(rng.integers(1, 17))
    k = 4 * int(rng.integers(0, 1500)) + 2
    n = int(rng.integers(1, 3000))
    ops = _qmm_operands(m, k, n, 2, seed, cuda_device)
    before = W4.launches
    got = OPS.w4a8_matmul(*ops, impl="kernel")
    assert W4.launches == before + 1
    p = W4.plan(m, k, n)
    assert W4.last_grid == (-(-n // 128), -(-m // p.row_tile), p.splits)
    torch.cuda.synchronize()
    assert torch.equal(got, OPS.w4a8_matmul(*ops, impl="ref")), (m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(17, 1030, 777), (17, 512, 1000),
                                   (64, 3072, 1024), (700, 1026, 333),
                                   (4096, 8192, 3072)])
def test_w4a8_split_k_above_16_rows(cuda_device, m, k, n):
    """Ragged and prefill m on 16-row tiles, split or not as the plan
    says: bit for bit the plain version, with the grid the plan gives."""
    ops = _qmm_operands(m, k, n, 2, m + k, cuda_device)
    p = W4.plan(m, k, n)
    got = OPS.w4a8_matmul(*ops, impl="kernel")
    assert W4.last_grid == (-(-n // 128), -(-m // 16), p.splits)
    assert torch.equal(got, OPS.w4a8_matmul(*ops, impl="ref"))


@pytest.mark.cuda
def test_w4a8_all_plus_and_minus_128_at_k_8192(cuda_device):
    """Every code +128 (0x77) or every code -128 (0xff): the magnitude that
    does not fit a signed byte, at the longest phi4 k.  x rows of 127, of
    -128 and random: |sum| <= 128 * 128 * 8192 = 2^27."""
    m, k, n = 4, 8192, 3072
    rng = np.random.default_rng(5)
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    x[0], x[1] = 127, -128
    xs = torch.tensor(0.01, device=cuda_device)
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-1, n).astype(np.float32)
                          ).to(cuda_device)
    xt = torch.from_numpy(x).to(cuda_device)
    for byte, sign in ((0x77, 1), (-1, -1)):           # 0xff as int8
        w = torch.full((k // 2, n), byte, dtype=torch.int8,
                       device=cuda_device)
        got = OPS.w4a8_matmul(xt, w, xs, ws, impl="kernel")
        want = OPS.w4a8_matmul(xt, w, xs, ws, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got, want), sign
        acc = sign * 128 * torch.from_numpy(x.astype(np.int64)).sum(1)
        assert int(acc[0]) == sign * 127 * 128 * k
        exact = ((acc.to(torch.float32) * 2.0 ** -7)[:, None]
                 .to(cuda_device) * xs * ws)
        assert torch.equal(got, exact), sign


@pytest.mark.cuda
def test_w4a8_split_k_on_two_streams_at_once(cuda_device):
    """Split-k products queued on two streams together each meet in their
    own stream's workspace: both equal the plain version, call after
    call, and both workspaces are left zeroed."""
    m, k, n = 4, 8192, 3072
    assert W4.plan(m, k, n).splits > 1
    ops = [_qmm_operands(m, k, n, 2, 1150 + i, cuda_device)
           for i in range(2)]
    wants = [OPS.w4a8_matmul(*o, impl="ref") for o in ops]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                gots[i].append(OPS.w4a8_matmul(*ops[i], impl="kernel"))
    torch.cuda.synchronize()
    bufs = []
    for i, st in enumerate(streams):
        assert all(torch.equal(g, wants[i]) for g in gots[i]), i
        with torch.cuda.stream(st):
            bufs.append(WS.workspace(cuda_device, 1))
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    assert not bufs[0].any() and not bufs[1].any()


@pytest.mark.cuda
def test_w4a8_entry_refuses_a_plan_it_cannot_hold(cuda_device):
    """The C entry checks what the planner hands it: a workspace shorter
    than its grid's sums and counters, a row tile it has no kernel for,
    or a split count that leaves a split empty fails the launch instead of
    writing past the buffer."""
    m, k, n = 4, 3072, 1024
    p = W4.plan(m, k, n)
    assert p.regime == "splitk" and p.splits > 1
    ops = _qmm_operands(m, k, n, 2, 7, cuda_device)
    short = torch.zeros(p.workspace - 1, dtype=torch.int32,
                        device=cuda_device)
    full = WS.workspace(cuda_device, p.workspace)
    nq = k // 4
    empty = next(s for s in range(2, nq) if s not in _valid_splits(k))
    for buf, row_tile, splits in (
            (short, p.row_tile, p.splits), (full, 5, p.splits),
            (full, 32, 1), (None, p.row_tile, p.splits),
            (full, p.row_tile, empty)):
        with pytest.raises(RuntimeError, match="launch failed"):
            _w4a8_launch(ops, m, k, n, buf, row_tile, splits)
    assert not short.any()


# ------------------------------------------------------------ attention

def _decode_operands(b, kvh, rep, hd, S, seed, device):
    g = torch.Generator("cpu").manual_seed(seed)
    q = torch.randn((b, kvh, rep, hd), generator=g)
    kq = torch.randint(-127, 128, (b, S, kvh, hd), generator=g,
                       dtype=torch.int32).to(torch.int8)
    vq = torch.randint(-127, 128, (b, S, kvh, hd), generator=g,
                       dtype=torch.int32).to(torch.int8)
    ks = torch.rand((b, S, kvh), generator=g) * 0.02 + 1e-3
    vs = torch.rand((b, S, kvh), generator=g) * 0.02 + 1e-3
    return [t.to(device) for t in (q, kq, vq, ks, vs)]


def _scaled_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_decode_kernel_matches_plain_on_random_shapes(cuda_device, seed):
    from repro_torch.kernels import w8a8_decode as D
    rng = np.random.default_rng(200 + seed)
    b, kvh = int(rng.integers(1, 5)), int(rng.integers(1, 9))
    rep = int(rng.choice([1, 3, 4, 8, 16]))
    hd = int(rng.choice([20, 64, 128, 256]))
    bs = int(rng.choice([16, 64, 512]))
    S = bs * int(rng.integers(1, 5))
    ops_ = _decode_operands(b, kvh, rep, hd, S, seed, cuda_device)
    pos = torch.from_numpy(rng.integers(0, S, b).astype(np.int32))
    pos[0] = 0
    pos[-1] = S - 1
    pos = pos.to(cuda_device)
    for block in (bs, S):
        before = D.launches
        got = OPS.w8a8_decode_attention(*ops_, pos, bs=block, impl="kernel")
        assert D.launches == before + 1
        want = OPS.w8a8_decode_attention(*ops_, pos, bs=block, impl="ref")
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        assert _scaled_err(got, want) <= 1e-5, (b, kvh, rep, hd, S, block)
    q_q, factor = D.quantize_q(ops_[0])
    for dt in (torch.float32, torch.bfloat16):
        got = OPS.w8a8_decode_attention_body(q_q, factor, *ops_[1:], pos,
                                             bs=S, out_dtype=dt,
                                             impl="kernel")
        want = OPS.w8a8_decode_attention_body(q_q, factor, *ops_[1:], pos,
                                              bs=S, out_dtype=dt, impl="ref")
        assert got.dtype == dt
        assert _scaled_err(got, want) <= (1e-5 if dt == torch.float32
                                          else 1e-2)


@pytest.mark.cuda
def test_decode_kernel_errors_raise(cuda_device, monkeypatch, tmp_path):
    """A ragged S raises as the TPU entry does; a launch the C side
    refuses (a K cache off 4-byte alignment) and a failed build raise
    instead of falling back."""
    from repro_torch.kernels import _build
    q, kq, vq, ks, vs = _decode_operands(1, 2, 3, 64, 128, 0, cuda_device)
    with pytest.raises(ValueError, match="divisible by the block size"):
        OPS.w8a8_decode_attention(q, kq, vq, ks, vs, 5, bs=96,
                                  impl="kernel")
    flat = torch.zeros(kq.numel() + 1, dtype=torch.int8, device=cuda_device)
    shifted = flat[1:].view(kq.shape)
    shifted.copy_(kq)
    with pytest.raises(RuntimeError, match="launch failed"):
        OPS.w8a8_decode_attention(q, shifted, vq, ks, vs, 5, bs=64,
                                  impl="kernel")
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "w8a8_decode.cu").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        OPS.w8a8_decode_attention(q, kq, vq, ks, vs, 5, bs=64,
                                  impl="kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 3, 4, 64, 64, 64),           # one split
    (8, 32, 1, 32, 256, 256),        # two splits
    (4, 8, 3, 128, 4096, 4096),      # phi4 serving: nine splits
    (4, 8, 3, 128, 4096, 512),       # bs < S: splits of whole blocks
    (1, 1, 16, 256, 8192, 8192),     # 128 splits
    (2, 3, 8, 20, 1536, 96),         # hd not a multiple of 16
    (4, 16, 1, 128, 4096, 4096),     # moonshot serving: MHA, rep 1
    (4, 8, 4, 128, 4096, 4096),      # phi3.5-moe serving: rep 4
])
def test_decode_split_across_s_equals_plain_bit_for_bit(cuda_device, shape):
    """Split counts 1, 2 and many, with per-slot positions inside the
    first split, one before, on and one past a split boundary, and at
    S - 1: bit for bit equal to the plain version, twice in a row (the
    workspace the splits meet in is left zeroed), one counted call each."""
    from repro_torch.kernels import w8a8_decode as D
    b, kvh, rep, hd, S, bs = shape
    p = D.plan(b, kvh, rep, hd, S, bs)
    assert p.blocks >= min(132, b * kvh * -(-S // p.split_keys))
    keys = p.split_keys
    q, kq, vq, ks, vs = _decode_operands(b, kvh, rep, hd, S, S + rep,
                                         cuda_device)
    q_q, factor = D.quantize_q(q)
    marks = [0, 3, keys - 1, keys, keys + 1, S // 2, S - 1]
    for j in range(len(marks)):
        pos = torch.tensor([min(marks[(j + i) % len(marks)], S - 1)
                            for i in range(b)], dtype=torch.int32,
                           device=cuda_device)
        want = D.w8a8_decode_attention_body_ref(q_q, factor, kq, vq, ks, vs,
                                                pos, bs=bs)
        for _ in range(2):
            before = (D.launches, D.kernel_launches)
            got = D.w8a8_decode_attention_body(q_q, factor, kq, vq, ks, vs,
                                               pos, bs=bs)
            torch.cuda.synchronize()
            assert (D.launches, D.kernel_launches) == (before[0] + 1,
                                                       before[1] + 3)
            assert D.last_grid == (b * kvh, p.splits)
            assert torch.equal(got, want), (shape, p.splits, pos.tolist())
    assert not WS.workspace(cuda_device, 1).any()


@pytest.mark.cuda
def test_decode_split_on_two_streams_at_once(cuda_device):
    """Split decode calls queued on two streams together meet in their
    own stream's workspace: both equal the plain version, call after call,
    and both workspaces are left zeroed."""
    from repro_torch.kernels import w8a8_decode as D
    b, kvh, rep, hd, S = 4, 8, 3, 128, 2048
    assert D.plan(b, kvh, rep, hd, S, S).splits > 1
    sets, wants = [], []
    for i in range(2):
        q, kq, vq, ks, vs = _decode_operands(b, kvh, rep, hd, S, 960 + i,
                                             cuda_device)
        q_q, factor = D.quantize_q(q)
        pos = torch.tensor([S - 1, 700, 5, 1500], dtype=torch.int32,
                           device=cuda_device)
        sets.append((q_q, factor, kq, vq, ks, vs, pos))
        wants.append(D.w8a8_decode_attention_body_ref(*sets[i], bs=S))
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                gots[i].append(D.w8a8_decode_attention_body(*sets[i], bs=S))
    torch.cuda.synchronize()
    bufs = []
    for i, st in enumerate(streams):
        assert all(torch.equal(g, wants[i]) for g in gots[i]), i
        with torch.cuda.stream(st):
            bufs.append(WS.workspace(cuda_device, 1))
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    assert not bufs[0].any() and not bufs[1].any()


def _qkv(b, h, sq, sk, d, dtype, seed, device):
    g = torch.Generator("cpu").manual_seed(seed)
    return [torch.randn((b, h, s, d), generator=g).to(dtype).to(device)
            for s in (sq, sk, sk)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_flash_kernel_matches_plain_on_random_shapes(cuda_device, seed):
    from repro_torch.kernels import flash_attention as F
    rng = np.random.default_rng(300 + seed)
    b, h = int(rng.integers(1, 3)), int(rng.integers(1, 5))
    sk = int(rng.integers(1, 600))
    sq = int(rng.integers(1, sk + 1))
    d = int(rng.choice([16, 32, 64, 128, 256]))
    causal = bool(rng.integers(0, 2)) or sq < sk
    window = None if rng.integers(0, 2) else int(rng.integers(1, 200))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = _qkv(b, h, sq, sk, d, dtype, seed, cuda_device)
        before = F.launches
        got = OPS.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="kernel")
        assert F.launches == before + 1
        want = OPS.flash_attention(q, k, v, causal=causal, window=window,
                                   impl="ref")
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, (b, h, sq, sk, d, causal, window, dtype, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_bf16_tensor_core_route_on_random_shapes(cuda_device, d):
    """Every head dim on the bf16 route: windows, sq < sk and ragged
    tails, at the bf16 bound; each launch counted on that route."""
    from repro_torch.kernels import flash_attention as F
    assert d in F.HEAD_DIMS
    rng = np.random.default_rng(700 + d)
    for _ in range(3):
        b, h = int(rng.integers(1, 3)), int(rng.integers(1, 4))
        sk = int(rng.integers(1, 700))
        sq = int(rng.integers(1, sk + 1))
        causal = bool(rng.integers(0, 2)) or sq < sk
        window = None if rng.integers(0, 2) else int(rng.integers(1, 300))
        q, k, v = _qkv(b, h, sq, sk, d, torch.bfloat16, int(sk), cuda_device)
        before = (F.launches, F.launches_tc, F.launches_f32)
        got = OPS.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="kernel")
        assert (F.launches, F.launches_tc, F.launches_f32) == (
            before[0] + 1, before[1] + 1, before[2])
        want = OPS.flash_attention(q, k, v, causal=causal, window=window,
                                   impl="ref")
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2e-2, (b, h, sq, sk, d, causal, window, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_float32_3xtf32_route_on_random_shapes(cuda_device, d):
    """Every head dim on the float32 route (3xTF32 on the tensor cores):
    windows, sq < sk and ragged tails, at the float32 bound of 1e-5;
    each launch counted on that route."""
    from repro_torch.kernels import flash_attention as F
    rng = np.random.default_rng(800 + d)
    for _ in range(3):
        b, h = int(rng.integers(1, 3)), int(rng.integers(1, 4))
        sk = int(rng.integers(1, 1300))
        sq = int(rng.integers(1, sk + 1))
        causal = bool(rng.integers(0, 2)) or sq < sk
        window = None if rng.integers(0, 2) else int(rng.integers(1, 400))
        q, k, v = _qkv(b, h, sq, sk, d, torch.float32, int(sk) + d,
                       cuda_device)
        before = (F.launches, F.launches_tc, F.launches_f32)
        got = OPS.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="kernel")
        assert (F.launches, F.launches_tc, F.launches_f32) == (
            before[0] + 1, before[1], before[2] + 1)
        want = OPS.flash_attention(q, k, v, causal=causal, window=window,
                                   impl="ref")
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == q.shape
        err = float((got - want).abs().max())
        assert err <= 1e-5, (b, h, sq, sk, d, causal, window, err)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_is_not_built_for(cuda_device):
    q, k, v = _qkv(1, 2, 8, 8, 24, torch.float32, 0, cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        OPS.flash_attention(q, k, v, impl="kernel")
    q, k, v = _qkv(1, 2, 8, 8, 32, torch.float32, 0, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        OPS.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), impl="kernel")


def _reduced_model(quant, device, impl):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(reduced(get_config("phi4-mini-3.8b")),
                              quant=quant)
    return Model(cfg, device=device, impl=impl)


@pytest.mark.cuda
def test_reduced_int8_kv_decode_kernel_equals_plain(cuda_device):
    """Per-slot positions through both routes of a reduced phi4-mini:
    identical int8 caches and logits."""
    kern = _reduced_model("w8a8", cuda_device, "kernel")
    plain = _reduced_model("w8a8", cuda_device, "ref")
    params = kern.init(torch.Generator(cuda_device).manual_seed(0),
                       quantize=True)
    ck, cp = kern.init_cache(3, 16, kv_quant=True), \
        plain.init_cache(3, 16, kv_quant=True)
    offs = torch.tensor([0, 4, 9], dtype=torch.int32, device=cuda_device)
    tokens = torch.randint(0, kern.cfg.vocab, (3, 6), device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(1))
    for i in range(6):
        lk, ck = kern.decode_step(params, ck, tokens[:, i:i + 1], offs + i)
        lp, cp = plain.decode_step(params, cp, tokens[:, i:i + 1], offs + i)
        assert torch.equal(lk, lp), i
    for name in ck:
        assert torch.equal(ck[name], cp[name]), name


@pytest.mark.cuda
def test_reduced_forward_and_batcher_on_the_card(cuda_device):
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import w8a8_decode as D
    from repro_torch.serving.scheduler import ContinuousBatcher, Request
    kern = _reduced_model("w8a8", cuda_device, "auto")
    plain = _reduced_model("w8a8", cuda_device, "ref")
    params = kern.init(torch.Generator(cuda_device).manual_seed(0),
                       quantize=True)
    tokens = torch.randint(0, kern.cfg.vocab, (2, 77), device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(2))
    before = F.launches
    got, _ = kern.forward(params, tokens)
    assert F.launches == before + kern.cfg.n_layers
    want, _ = plain.forward(params, tokens)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2
    bat = ContinuousBatcher(kern, params, n_slots=2, max_seq=32,
                            kv_quant=True)
    reqs = [Request(rid=i, prompt=[3 + i, 5, 7], max_new=3)
            for i in range(3)]
    for r in reqs:
        bat.submit(r)
    before = D.launches
    done = bat.run()
    assert D.launches - before == bat.it * kern.cfg.n_layers
    for r in done:
        assert r.complete_iter == r.submit_iter + 3 + 3 - 1


def _gemma3(device, impl, **over):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(reduced(get_config("gemma3-4b")), **over)
    return Model(cfg, device=device, impl=impl)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_reduced_gemma3_kernel_route_equals_plain(cuda_device, kv_quant):
    """Reduced gemma3 (window 8, a global layer every 2nd, 4 layers):
    per-slot positions past the ring's wrap through both routes, identical
    logits and caches (ring and global); the forward's flash launches, one
    a layer, windowed on the local layers, within 2e-2 of the plain
    route (dense below 2048 tokens)."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import w8a8_decode as D
    kern = _gemma3(cuda_device, "kernel", n_layers=4)
    plain = _gemma3(cuda_device, "ref", n_layers=4)
    params = kern.init(torch.Generator(cuda_device).manual_seed(0),
                       quantize=True)
    ck = kern.init_cache(3, 32, kv_quant=kv_quant)
    cp = plain.init_cache(3, 32, kv_quant=kv_quant)
    assert ck["k_local"].shape[2] == 8
    offs = torch.tensor([0, 4, 9], dtype=torch.int32, device=cuda_device)
    tokens = torch.randint(0, kern.cfg.vocab, (3, 20), device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(1))
    before = D.launches
    for i in range(20):
        lk, ck = kern.decode_step(params, ck, tokens[:, i:i + 1], offs + i)
        lp, cp = plain.decode_step(params, cp, tokens[:, i:i + 1], offs + i)
        assert torch.equal(lk, lp), i
    assert D.launches - before == (20 * 4 if kv_quant else 0)
    for name in ck:
        assert torch.equal(ck[name], cp[name]), name
    before = (F.launches, F.launches_windowed)
    got, _ = kern.forward(params, tokens)
    assert (F.launches - before[0], F.launches_windowed - before[1]) == (4, 2)
    want, _ = plain.forward(params, tokens)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_ring_decode_equals_slice_branch_on_the_card(cuda_device,
                                                     monkeypatch, kv):
    """One local layer at gemma3's head shape (kvh 4, rep 2, hd 256), a
    ring of 64 against a cache of 160 read through the slice branch, on
    the kernel route, per-slot positions past the wrap: the attention
    outputs (the input of ``wo``) within 1e-5 x max|out| (int8) or the
    bf16 bound of 2e-2, and equal before the wrap."""
    from repro_torch.models import attention as A
    from repro_torch.quant.qlinear import qdot
    model = _gemma3(cuda_device, "kernel", d_model=512, n_heads=8,
                    n_kv_heads=4, head_dim=256)
    lp = model.init(torch.Generator(cuda_device).manual_seed(0),
                    quantize=True)["layers"][0]
    cores = []

    def recording(t, w, *a, **k):
        if w is lp["wo"]:
            cores.append(t.float())
        return qdot(t, w, *a, **k)
    monkeypatch.setattr(A, "qdot", recording)
    b, W, S = 4, 64, 160
    cfg = model.cfg

    def caches(n):
        dt = torch.int8 if kv == "int8" else torch.bfloat16
        kvc = [torch.zeros((b, n, 4, 256), dtype=dt, device=cuda_device)
               for _ in "kv"]
        sc = [torch.zeros((b, n, 4), device=cuda_device) for _ in "kv"] \
            if kv == "int8" else None
        return kvc, sc
    (rk, rv), rs = caches(W)
    (fk, fv), fs = caches(S)
    offs = torch.tensor([0, 5, 11, 23], device=cuda_device)
    g = torch.Generator(cuda_device).manual_seed(2)
    for i in range(S - 23):
        x = torch.randn((b, 1, cfg.d_model), generator=g,
                        device=cuda_device).to(torch.bfloat16)
        cores.clear()
        for c, sc in (((rk, rv), rs), ((fk, fv), fs)):
            A.decode_self_attention(x, lp, cfg, *c, offs + i,
                                    policy=model.policy, static_window=W,
                                    kv_scales=sc, impl="kernel")
        ring, full = cores
        err = float((ring - full).abs().max())
        if i + 23 < W:
            assert torch.equal(ring, full), i
        bound = 1e-5 * float(full.abs().max()) if kv == "int8" else 2e-2
        assert err <= bound, (i, err)


# ------------------------------------------- the MoE family (moonshot)

def _moonshot(device, impl, **over):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(reduced(get_config("moonshot-v1-16b-a3b")),
                              **over)
    return Model(cfg, device=device, impl=impl)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_reduced_moonshot_kernel_route_equals_plain(cuda_device, monkeypatch,
                                                    kv_quant):
    """Reduced moonshot (64 experts, top-6, MHA: the decode kernel at rep
    1), W8A8: per-slot decode through both routes gives identical logits
    and caches (the router, dispatch, expert products and combine are the
    same torch ops on both); the forward launches 4 W8A8 products and one
    flash call a layer, and with the plain attention swapped in equals
    the plain route bit for bit."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import w8a8_decode as D
    from repro_torch.models import attention as A
    over = dict(n_experts=64, top_k=6, n_layers=3)
    kern = _moonshot(cuda_device, "kernel", **over)
    plain = _moonshot(cuda_device, "ref", **over)
    assert kern.cfg.n_heads == kern.cfg.n_kv_heads
    params = kern.init(torch.Generator(cuda_device).manual_seed(0),
                       quantize=True)
    ck = kern.init_cache(4, 24, kv_quant=kv_quant)
    cp = plain.init_cache(4, 24, kv_quant=kv_quant)
    offs = torch.tensor([0, 3, 5, 9], dtype=torch.int32, device=cuda_device)
    tokens = torch.randint(0, kern.cfg.vocab, (4, 12), device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(1))
    before = (W8.launches, D.launches)
    for i in range(12):
        lk, ck = kern.decode_step(params, ck, tokens[:, i:i + 1], offs + i)
        lp, cp = plain.decode_step(params, cp, tokens[:, i:i + 1], offs + i)
        assert torch.equal(lk, lp), i
    assert W8.launches - before[0] == 12 * 3 * 4
    assert D.launches - before[1] == (12 * 3 if kv_quant else 0)
    for name in ck:
        assert torch.equal(ck[name], cp[name]), name
    before = (W8.launches_tc, F.launches_tc)
    got, aux = kern.forward(params, tokens)
    assert (W8.launches_tc - before[0], F.launches_tc - before[1]) == (12, 3)
    want, want_aux = plain.forward(params, tokens)
    assert bool(torch.isfinite(got).all()) and float(aux) > 0
    real = A.attend
    monkeypatch.setattr(A, "attend", lambda q, k, v, **kw: real(
        q, k, v, **dict(kw, impl="ref")))
    mixed, mixed_aux = kern.forward(params, tokens)
    assert torch.equal(mixed, want) and torch.equal(mixed_aux, want_aux)


@pytest.mark.cuda
def test_moe_ffn_on_the_card_is_deterministic(cuda_device):
    """``moe_ffn`` at a prefill's shapes (T = 4096, 64 experts, top-6, C
    = 480), twice on the card: identical bytes (the combine sums in a
    fixed order, no atomics); and the combine alone on the card equals
    the CPU's bit for bit on the same expert outputs."""
    from repro_torch.models import moe as M
    from repro_torch.quant.policy import policy_for
    cfg = _moonshot(cuda_device, "auto", n_experts=64, top_k=6,
                    d_model=256, d_ff=128).cfg
    g = torch.Generator(cuda_device).manual_seed(0)
    p = {"router": torch.randn((256, 64), generator=g, device=cuda_device)
         * 0.1,
         "w_experts_gate": torch.randn((64, 256, 128), generator=g,
                                       device=cuda_device) / 16,
         "w_experts_in": torch.randn((64, 256, 128), generator=g,
                                     device=cuda_device) / 16,
         "w_experts_out": torch.randn((64, 128, 256), generator=g,
                                      device=cuda_device) / 11}
    x = torch.randn((1, 4096, 256), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    pol = policy_for("bf16")
    a, aux_a = M.moe_ffn(x, p, cfg, policy=pol, train=False)
    b, aux_b = M.moe_ffn(x, p, cfg, policy=pol, train=False)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(aux_a, aux_b)
    _, experts, _ = M.topk_route(x[0], p["router"], 64, 6)
    cap = M.capacity(4096, 64, 6, 1.25)
    assert cap == 480
    order, slot, keep = M.dispatch(experts, 64, cap)
    gates = torch.rand((4096, 6), generator=g, device=cuda_device)
    out_buf = torch.randn((64, cap, 256), generator=g,
                          device=cuda_device).to(torch.bfloat16)
    card = M.combine(out_buf, order, slot, keep, gates)
    cpu = M.combine(out_buf.cpu(), order.cpu(), slot.cpu(), keep.cpu(),
                    gates.cpu())
    assert torch.equal(card.cpu().view(torch.int16), cpu.view(torch.int16))


def _cross_family(device, arch, impl, **over):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    return Model(cfg, device=device, impl=impl)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-medium"])
def test_reduced_cross_family_swapped_attention_equals_plain(
        cuda_device, monkeypatch, arch):
    """Reduced llama-3.2-vision (4 layers, a cross layer every 2nd) and
    whisper (2 + 2 layers), W8A8, a ragged context of 37 tokens: the
    kernel route launches flash for every cross-attention (one token a
    decode step) and, in the forward, every self-attention and the
    encoder's; each application within 2e-2 of the plain attention; with
    the plain attention swapped in, the context caches, teacher-forced
    decode (logits and every cache) and the forward equal the plain route
    bit for bit."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch.serve import fill_ctx_caches
    from repro_torch.models import attention as A
    over = dict(n_ctx_tokens=37, n_layers=4 if "vision" in arch else 2)
    kern = _cross_family(cuda_device, arch, "kernel", **over)
    plain = _cross_family(cuda_device, arch, "ref", **over)
    cfg = kern.cfg
    n_cross = len(kern.init_cache(1, 1)["ctx_k"])
    params = kern.init(torch.Generator(cuda_device).manual_seed(0),
                       quantize=True)
    g = torch.Generator(cuda_device).manual_seed(1)
    ctx = torch.randn((3, 37, cfg.d_model), generator=g,
                      device=cuda_device) * 0.02
    tokens = torch.randint(0, cfg.vocab, (3, 10), generator=g,
                           device=cuda_device)
    real = A.attend
    errs = []

    def swapped(q, k, v, **kw):
        got = real(q, k, v, **kw)
        want = real(q, k, v, **dict(kw, impl="ref"))
        errs.append(float((got.float() - want.float()).abs().max()))
        return want
    before = F.launches
    ck = fill_ctx_caches(kern, params, kern.init_cache(3, 10), ctx)
    enc_apps = cfg.encoder_layers
    assert F.launches - before == enc_apps
    monkeypatch.setattr(A, "attend", swapped)
    cs = fill_ctx_caches(kern, params, kern.init_cache(3, 10), ctx)
    monkeypatch.setattr(A, "attend", real)
    cp = fill_ctx_caches(plain, params, plain.init_cache(3, 10), ctx)
    for name in ("ctx_k", "ctx_v"):
        assert torch.equal(cs[name], cp[name]), name
    for i in range(10):
        tok = tokens[:, i:i + 1]
        before = F.launches_tc
        lk, ck = kern.decode_step(params, ck, tok, i)
        assert F.launches_tc - before == n_cross
        assert bool(torch.isfinite(lk).all())
        monkeypatch.setattr(A, "attend", swapped)
        ls, cs = kern.decode_step(params, cs, tok, i)
        monkeypatch.setattr(A, "attend", real)
        lp, cp = plain.decode_step(params, cp, tok, i)
        assert torch.equal(ls, lp), i
    for name in cp:
        assert torch.equal(cs[name], cp[name]), name
    before = F.launches
    got, _ = kern.forward(params, tokens, ctx=ctx)
    assert F.launches - before == enc_apps + cfg.n_layers + n_cross
    assert bool(torch.isfinite(got).all())
    want, _ = plain.forward(params, tokens, ctx=ctx)
    monkeypatch.setattr(A, "attend", swapped)
    mixed, _ = kern.forward(params, tokens, ctx=ctx)
    assert torch.equal(mixed, want)
    assert max(errs) <= 2e-2, max(errs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (4, 64, 1, 1601, 128, False),     # llama-3.2-vision decode, cross
    (4, 16, 1, 1500, 64, False),      # whisper decode, cross
    (4, 16, 448, 1500, 64, False),    # whisper's 448-token forward, cross
    (1, 64, 4096, 1601, 128, False),  # the vlm forward, cross
    (4, 16, 1500, 1500, 64, True),    # whisper's encoder (causal, C.11)
    (2, 3, 1, 65, 16, False),         # sq 1, one key past a tile
])
def test_flash_at_the_cross_attention_shapes(cuda_device, shape):
    """bf16 flash at the vlm and audio paths' shapes (sq = 1, ragged key
    counts 1601 = 25 x 64 + 1 and 1500, non-causal) within 2e-2 of its
    plain version; at the vlm forward's shape also the float32 route (its
    float32 context keys and values) within 1e-5."""
    from repro_torch.kernels import flash_attention as F
    b, h, sq, sk, d, causal = shape
    dtypes = ((torch.bfloat16, 2e-2),)
    if sq == 4096:
        dtypes += ((torch.float32, 1e-5),)
    for dtype, tol in dtypes:
        q, k, v = _qkv(b, h, sq, sk, d, dtype, sq + sk, cuda_device)
        got = OPS.flash_attention(q, k, v, causal=causal, impl="kernel")
        want = OPS.flash_attention(q, k, v, causal=causal, impl="ref")
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol, (shape, dtype, err)


@pytest.mark.cuda
def test_attend_meets_mixed_dtypes_in_float32(cuda_device):
    """A bf16 q against float32 k, v (the vlm forward's context under
    W8A8) runs the float32 kernel and returns bf16, within 2e-2 of the
    plain route's float32 attention."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.models import attention as A
    g = torch.Generator("cpu").manual_seed(5)
    q = torch.randn((2, 33, 8, 128), generator=g).to(torch.bfloat16)
    k, v = (torch.randn((2, 401, 8, 128), generator=g) for _ in range(2))
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    before = (F.launches_f32, F.launches_tc)
    got = A.attend(q, k, v, causal=False, impl="kernel")
    assert (F.launches_f32 - before[0], F.launches_tc - before[1]) == (1, 0)
    want = A.attend(q, k, v, causal=False, impl="ref")
    assert got.dtype == want.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


# ------------------------------------------ the grad rule (ROADMAP C.13)

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attend_under_grad_takes_the_plain_route(cuda_device, dtype):
    """Under grad the kernels (no backward) stay off the graph: ``attend``
    takes the dense route and its gradient is the CPU's; under
    ``no_grad`` it launches flash; ``impl="kernel"`` under grad raises."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as A
    g = torch.Generator("cpu").manual_seed(3)
    q, k, v = (torch.randn((2, 40, 4, 16), generator=g).to(dtype)
               for _ in range(3))
    outs = {}
    for dev in (cuda_device, CPU):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        before = FA.launches
        out = A.attend(*leaves)
        assert FA.launches == before and out.grad_fn is not None
        out.float().square().sum().backward()
        outs[dev.type] = [t.grad.float().cpu() for t in leaves]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    with torch.no_grad():
        before = FA.launches
        A.attend(*(t.to(cuda_device) for t in (q, k, v)))
        assert FA.launches == before + 1
    qq = q.to(cuda_device).transpose(1, 2).contiguous().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        OPS.flash_attention(qq, qq.detach(), qq.detach(), impl="kernel")


@pytest.mark.cuda
def test_qat_loss_gradients_on_the_card_match_the_cpu(cuda_device):
    """Reduced phi4-mini's W8A8 QAT loss: no kernel launch under grad,
    every leaf's gradient within 5e-3 of its largest magnitude of the
    CPU's (measured on an H100 80GB HBM3 at 700 W: 5.6e-4, ``w_down``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.model import Model
    from repro_torch.models.tree import tree_map
    from repro_torch.optim.adamw import leaves
    cfg = reduced(get_config("phi4-mini-3.8b"))
    params = Model(cfg, device="cpu").init(
        torch.Generator("cpu").manual_seed(0))
    batch = SyntheticLM(DataConfig(cfg.vocab, 16, 2)).batch(0, "cpu")
    grads = {}
    for dev in (cuda_device, CPU):
        tree = tree_map(lambda p: p.detach().to(dev).requires_grad_(True),
                        params)
        before = (FA.launches, W8.launches)
        Model(cfg, device=dev).loss(
            tree, {k: t.to(dev) for k, t in batch.items()}).backward()
        assert (FA.launches, W8.launches) == before
        grads[dev.type] = [(p, t.grad.cpu()) for p, t, _ in leaves(tree)]
    for (path, a), (_, b) in zip(grads["cuda"], grads["cpu"]):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 5e-3, (path, err)


@pytest.mark.cuda
def test_restarted_train_on_the_card_equals_uninterrupted(cuda_device,
                                                          tmp_path):
    """Reduced mamba2 under W8A8 QAT with int8 gradient compression on the
    card: a run with two injected failures gives every step's loss and
    every leaf of its final checkpoint bit for bit as the uninterrupted
    run; the card's checkpoint restores on the CPU and the CPU's on the
    card, each leaf on ``like``'s device."""
    from repro_torch.checkpoint import checkpoint as CK
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.launch.train import train
    from repro_torch.models.model import Model
    from repro_torch.models.tree import tree_flatten
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression
    kw = dict(steps=6, batch=2, seq_len=16, ckpt_every=2,
              grad_compression=True, log_every=100)
    clean = train("mamba2-130m", ckpt_dir=str(tmp_path / "a"),
                  device=cuda_device, **kw)
    faulty = train("mamba2-130m", ckpt_dir=str(tmp_path / "b"),
                   fail_at={3: 1, 5: 1}, device=cuda_device, **kw)
    assert [s for s, _ in faulty] == [0, 1, 2, 2, 3, 4, 4, 5]
    assert dict(faulty) == dict(clean)
    cpu = train("mamba2-130m", ckpt_dir=str(tmp_path / "c"), device="cpu",
                **kw)

    def like(device):
        params = Model(reduced(get_config("mamba2-130m")),
                       device="cpu").init(torch.Generator("cpu")
                                          .manual_seed(1))
        state = {"params": params, "opt": adamw.init(params),
                 "err": compression.init_error_state(params)}
        leaves, treedef = tree_flatten(state)
        return treedef.unflatten([t.to(device) if torch.is_tensor(t) else t
                                  for t in leaves])
    a = CK.restore(str(tmp_path / "a"), 5, like(CPU))
    b = CK.restore(str(tmp_path / "b"), 5, like(CPU))
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y)
    assert all(t.device.type == "cpu"
               for t in tree_flatten(a)[0] if torch.is_tensor(t))
    c = CK.restore(str(tmp_path / "c"), 5, like(cuda_device))
    assert all(t.device.type == "cuda"
               for t in tree_flatten(c)[0] if torch.is_tensor(t))
    assert c["opt"].step == 6
    assert max(abs(x - y) / abs(y)
               for (_, x), (_, y) in zip(clean[:2], cpu[:2])) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw,kernels", [
    ("d_small", dict(serve_quant=True, kv_quant=True),
     {"w8a8_matmul", "w8a8_decode_attention"}),
    ("d_small", dict(serve_quant=True, mode="w4a8_pow2"), {"w4a8_matmul"}),
    ("p_small", dict(serve_quant=True),
     {"w8a8_matmul", "flash_attention"})])
def test_dry_run_count_equals_the_card_run(cuda_device, monkeypatch, shape,
                                           kw, kernels):
    """Reduced phi4-mini through ``launch.dryrun.run_cell(measure=True)``:
    the step counted on the card with its kernels launching equals its
    dry run under fake tensors field by field, and every kernel call of
    the count is a launch."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: reduced(get_config(arch)))
    monkeypatch.setattr(dryrun, "ONE_CARD_SHAPES", {
        "d_small": ShapeConfig("d_small", 64, 4, "decode"),
        "p_small": ShapeConfig("p_small", 64, 1, "prefill")})
    monkeypatch.setattr(dryrun, "MEASURE_ITERS", 2)
    rec = dryrun.run_cell("phi4-mini-3.8b", shape, measure=True,
                          out_dir=None, **kw)
    m = rec["measured"]
    assert rec["status"] == "ok" and m["card_count_equal"]
    by_kernel = rec["stats"]["by_kernel"]
    assert set(by_kernel) == kernels
    for name, k in by_kernel.items():
        assert m["kernel_launches"][name] == k["calls"] > 0
    assert m["measured_s"] > 0 and m["measured_fraction"] > 0
