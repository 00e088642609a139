"""The port's co-exploration search against the JAX package's.

Genome space and Pareto tools are copies: on the same
inputs they must give the reference's outputs bit for bit.  The tier-0
noise table is measured in float32 torch from the reference's seeded
draws and must equal the reference's table (bit-identical expected, 1e-6
relative allowed).  With ``device="cpu"`` the sweep runs the exact policy,
so fixed-seed searches must reproduce the reference's numpy-backend
genomes, populations and objectives exactly, and the golden many-workload
front of ``tests/golden_coexplore_many.json`` to 1e-9.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dse as RD
from repro.core.workloads import ConvLayer as RConv
from repro.core.workloads import Workload as RWorkload
from repro.explore import accuracy as RA
from repro.explore import objectives as RO
from repro.explore import pareto as RP
from repro.explore import search as RS
from repro.explore import space as RSp
from repro.quant import quantizers as RQ
from repro_torch.core import dse as TD
from repro_torch.core.workloads import ConvLayer as TConv
from repro_torch.core.workloads import Workload as TWorkload
from repro_torch.explore import accuracy as TA
from repro_torch.explore import objectives as TO
from repro_torch.explore import pareto as TP
from repro_torch.explore import search as TS
from repro_torch.explore import space as TSp
from repro_torch.quant import quantizers as TQ

GOLDEN = pathlib.Path(__file__).parent / "golden_coexplore_many.json"
SUITE = ("vgg16", "resnet34", "resnet50")


def _tiny(conv, workload):
    """Small workloads (as the reference's explore tests use), one set
    per package."""
    return (
        workload("wlA", (conv("c1", 58, 58, 64, 64),
                         conv("c2", 30, 30, 64, 128, 3, 3, 2),
                         conv("fc", 1, 1, 512, 1000, 1, 1))),
        workload("wlB", (conv("c1", 114, 114, 32, 64),
                         conv("fc", 1, 1, 256, 100, 1, 1))),
        workload("wlC", (conv("c1", 226, 226, 3, 64),
                         conv("c2", 56, 56, 64, 64),
                         conv("c3", 28, 28, 64, 128),
                         conv("fc", 1, 1, 128, 10, 1, 1))))


R_TINY = _tiny(RConv, RWorkload)
T_TINY = _tiny(TConv, TWorkload)


# ---------------------------------------------------------------------------
# quantizers and the tier-0 table
# ---------------------------------------------------------------------------

SPECS = [("int", 16, None), ("int", 8, None), ("int", 4, 0), ("int", 8, 1),
         ("pow2", None, None), ("pow2", None, 0),
         ("pow2_2term", None, None), ("pow2_2term", None, 1),
         ("none", None, None)]


@pytest.mark.parametrize("kind,bits,axis", SPECS)
def test_quantize_dequantize_equals_reference(kind, bits, axis):
    x = np.random.default_rng(11).normal(size=(64, 96)).astype(np.float32)
    want = np.asarray(RQ.quantize_dequantize(
        jnp.asarray(x), RQ.FakeQuantSpec(kind, bits, axis)))
    got = TQ.quantize_dequantize(torch.from_numpy(x),
                                 TQ.FakeQuantSpec(kind, bits, axis)).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(kind="ternary"), dict(kind="pow2", bits=8),
    dict(kind="int", bits=1), dict(kind="none", bits=4)])
def test_fake_quant_spec_refuses_as_reference(kwargs):
    with pytest.raises(ValueError) as want:
        RQ.FakeQuantSpec(**kwargs)
    with pytest.raises(ValueError) as got:
        TQ.FakeQuantSpec(**kwargs)
    assert str(got.value) == str(want.value)
    spec = TQ.FakeQuantSpec("int", 8, axis=1)
    assert spec.per_channel and spec.resolved_axis == 1
    assert TQ.FakeQuantSpec("pow2", per_channel=True).resolved_axis == 0


def test_noise_table_equals_reference():
    want = RO.mode_noise_table()
    TO.reset_sqnr_table()
    got = TO.mode_noise_table()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.array_equal(got, want)        # bit-identical on this host
    assert TO.mode_noise_table() is got     # measured once
    assert TA.ProxyAccuracy().digest() == RA.ProxyAccuracy().digest()
    pinned = TA.ProxyAccuracy()
    pinned.restore_state({"mode_table": got * 2})
    assert pinned.digest() != TA.ProxyAccuracy().digest()


def test_accuracy_scores_equal_reference():
    a = np.random.default_rng(12).integers(0, 4, size=(50, 16))
    macs = np.random.default_rng(13).integers(1, 10 ** 9, size=16)
    assert np.array_equal(TO.quant_noise(a, macs), RO.quant_noise(a, macs))
    table = np.random.default_rng(14).random((16, 4))
    assert np.array_equal(TA._mac_weighted(table, a, macs),
                          RA._mac_weighted(table, a, macs))
    for tier in (0, 1, 2):
        assert TA._table_digest(tier, table) == RA._table_digest(tier, table)
    spec = TA.AccuracySpec(floor_db=(20, 30))
    for s in (spec, TA.AccuracySpec.parse("proxy")):
        assert isinstance(TA.resolve_accuracy(s), TA.ProxyAccuracy)
    assert TA.resolve_accuracy(spec).floor_db == (20.0, 30.0)
    for bad in ("proxy:x", "calibrated", "oracle:m"):
        with pytest.raises(ValueError, match="bad accuracy spec"):
            TA.AccuracySpec.parse(bad)


# ---------------------------------------------------------------------------
# copies: space, pareto, traffic
# ---------------------------------------------------------------------------

def _spaces():
    return [(RSp.space_for_workload("vgg16"),
             TSp.space_for_workload("vgg16")),
            (RSp.space_for_workloads(SUITE), TSp.space_for_workloads(SUITE)),
            (RSp.space_for_workloads(R_TINY),
             TSp.space_for_workloads(T_TINY)),
            (RSp.CoExploreSpace(n_layers=5, glb_kbs=(64, 128), bws=(6.4,)),
             TSp.CoExploreSpace(n_layers=5, glb_kbs=(64, 128), bws=(6.4,)))]


@pytest.mark.parametrize("which", range(4))
def test_space_copy_bit_identical(which):
    r, t = _spaces()[which]
    assert (t.genome_width, t.hw_levels, t.size()) \
        == (r.genome_width, r.hw_levels, r.size())
    rr, tr = np.random.default_rng(15), np.random.default_rng(15)
    g = r.random_population(300, rr)
    assert np.array_equal(t.random_population(300, tr), g)
    assert np.array_equal(t.mutate(g, tr, 0.3), r.mutate(g, rr, 0.3))
    assert np.array_equal(t.crossover(g, g[::-1], tr),
                          r.crossover(g, g[::-1], rr))
    assert t.genome_keys(g) == r.genome_keys(g)
    for a, b in zip(t.decode(g)[0].values(), r.decode(g)[0].values()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(t.decode(g)[1], r.decode(g)[1])
    bad = g.copy()
    bad[::7, 0] = 99
    bad[1::7, -1] = 0
    assert np.array_equal(t.valid_mask(bad), r.valid_mask(bad))
    fp32_modes = g.copy()
    fp32_modes[:, 5:] = 0                 # FP32 layers on any hardware
    assert np.array_equal(t.repair(fp32_modes), r.repair(fp32_modes))
    packed = t.pack_genomes(g)
    assert packed.dtype == np.uint16
    assert np.array_equal(t.unpack_genomes(packed), g)
    with pytest.raises(ValueError, match="invalid genome"):
        t.decode(bad)


def test_pareto_copy_bit_identical():
    rng = np.random.default_rng(16)
    for k in (1, 2, 3, 4):
        F = np.round(rng.random((400, k)), 2)
        assert np.array_equal(TP.pareto_mask_k(F), RP.pareto_mask_k(F))
        assert np.array_equal(TP.nondominated_sort(F),
                              RP.nondominated_sort(F))
        front = F[RP.pareto_mask_k(F)]
        assert np.array_equal(TP.crowding_distance(front),
                              RP.crowding_distance(front))
        ref = RP.reference_point(F)
        assert np.array_equal(TP.reference_point(F), ref)
        assert TP.hypervolume(F[:60], ref) == RP.hypervolume(F[:60], ref)
        eps = RP.epsilon_from_reference(ref, F.min(axis=0), 0.05)
        assert np.array_equal(
            TP.epsilon_from_reference(ref, F.min(axis=0), 0.05), eps)
        ra, ta = RP.EpsilonDominanceArchive(eps), TP.EpsilonDominanceArchive(
            eps)
        g = np.arange(len(F))[:, None]
        assert ta.add(g, F) == ra.add(g, F)
        assert np.array_equal(ta.genomes, ra.genomes)
        assert np.array_equal(ta.objectives, ra.objectives)


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def _agg(w: int | None, n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shape = (n,) if w is None else (w, n)
    return {"perf_per_area": rng.random(shape) * 100,
            "energy_j": rng.random(shape) * 1e-2,
            "latency_s": rng.random(shape), "area_mm2": rng.random(n) * 9}


def test_objective_matrix_equals_reference():
    agg = _agg(None, 40, 17)
    a = np.random.default_rng(18).integers(0, 4, size=(40, 16))
    macs = np.arange(1, 17, dtype=np.float64) * 1e6
    for acc in (None, RA.AccuracySpec(floor_db=25.0)):
        want = RO.objective_matrix(agg, a, macs, RO.OBJECTIVES,
                                   accuracy=RA.resolve_accuracy(acc)
                                   if acc else None)
        tacc = TA.AccuracySpec(floor_db=25.0) if acc else None
        got = TO.objective_matrix(agg, a, macs, TO.OBJECTIVES,
                                  accuracy=TA.resolve_accuracy(tacc)
                                  if tacc else None)
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="multi-workload only"):
        TO.objective_matrix(agg, a, macs, ("total_energy_j",))
    with pytest.raises(ValueError, match="unknown objective"):
        TO.objective_matrix(agg, a, macs, ("speed",))
    # the serving objectives: the fleet simulator's metrics, clamped to
    # the floor penalty, as the reference's numpy route gives them
    objs = TO.SERVING_OBJECTIVES + ("accuracy_noise",)
    for traffic, n_slots in (("quick", 8), ("interactive", 1)):
        want = RO.objective_matrix(agg, a, macs, objs, traffic=traffic,
                                   n_slots=n_slots)
        got = TO.objective_matrix(agg, a, macs, objs, traffic=traffic,
                                  n_slots=n_slots, device="cpu")
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("weights", [None, (1.0, 2.0, 0.5)])
@pytest.mark.parametrize("floor", [None, 30.0, (20.0, 35.0, 28.0)])
def test_multi_objective_matrix_equals_reference(weights, floor):
    agg = _agg(3, 30, 19)
    rng = np.random.default_rng(20)
    assigns = [rng.integers(0, 4, size=(30, n)) for n in (16, 34, 57)]
    macs = [rng.integers(1, 10 ** 8, size=n) for n in (16, 34, 57)]
    racc = None if floor is None else RA.resolve_accuracy(
        RA.AccuracySpec(floor_db=floor))
    tacc = None if floor is None else TA.resolve_accuracy(
        TA.AccuracySpec(floor_db=floor))
    want = RO.multi_objective_matrix(agg, assigns, macs, RO.MULTI_OBJECTIVES,
                                     weights=weights, accuracy=racc)
    got = TO.multi_objective_matrix(agg, assigns, macs, TO.MULTI_OBJECTIVES,
                                    weights=weights, accuracy=tacc)
    assert np.array_equal(got, want)
    assert np.array_equal(
        TO.accuracy_floor_violation(assigns, macs, 30.0),
        RO.accuracy_floor_violation(assigns, macs, 30.0))


def test_objective_registry_equals_reference():
    assert list(TO.OBJECTIVE_REGISTRY) == list(RO.OBJECTIVE_REGISTRY)
    for name, spec in RO.OBJECTIVE_REGISTRY.items():
        assert TO.OBJECTIVE_REGISTRY[name].scope == spec.scope
    for k in ("OBJECTIVES", "SERVING_OBJECTIVES", "MULTI_OBJECTIVES",
              "DEFAULT_OBJECTIVES", "DEFAULT_MULTI_OBJECTIVES",
              "DEFAULT_SERVING_OBJECTIVES", "FLOOR_PENALTY"):
        assert getattr(TO, k) == getattr(RO, k), k


def test_mode_sqnr_db_equals_reference():
    assert TO.mode_sqnr_db() == RO.mode_sqnr_db()
    from repro_torch import explore
    assert explore.mode_sqnr_db is TO.mode_sqnr_db
    assert "mode_sqnr_db" in explore.__all__


def test_serving_metrics_equal_reference():
    agg = _agg(None, 64, 21)
    for traffic in ("steady", "bursty"):
        want = RO.serving_metrics(agg, traffic, n_slots=4)
        got = TO.serving_metrics(agg, traffic, n_slots=4, device="cpu")
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k


def test_objective_matrix_serving_floor_penalty():
    """Overloaded candidates land on the finite floor penalty, keeping
    hypervolume and nsga2's arithmetic finite (the reference's case)."""
    agg = {"latency_s": np.array([0.5]), "energy_j": np.array([1.0]),
           "perf_per_area": np.array([1.0]), "area_mm2": np.array([1.0])}
    from repro_torch.serving.traffic import resolve_traffic
    f = TO.objective_matrix(
        agg, None, None, objectives=("p99_latency_s", "energy_per_token_j"),
        traffic=resolve_traffic("interactive"), n_slots=1, device="cpu")
    assert np.isfinite(f).all()
    assert (f <= TO.FLOOR_PENALTY).all()
    assert f.tobytes() == RO.objective_matrix(
        agg, None, None, objectives=("p99_latency_s", "energy_per_token_j"),
        traffic="interactive", n_slots=1).tobytes()
    with pytest.raises(ValueError, match="traffic"):
        TO.objective_matrix(agg, None, None, objectives=("p99_latency_s",))


# ---------------------------------------------------------------------------
# search engines, fixed seeds, on the CPU exact path
# ---------------------------------------------------------------------------

def _assert_same_search(got, want):
    assert got.method == want.method and got.workload == want.workload
    assert got.objectives == want.objectives
    assert got.n_evals == want.n_evals
    assert np.array_equal(got.genomes, want.genomes)
    assert np.array_equal(got.front_objectives, want.front_objectives)
    assert np.array_equal(got.all_objectives, want.all_objectives)
    assert np.array_equal(got.ref_point, want.ref_point)
    assert got.history == want.history
    for f in ("population", "population_objectives"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    for k in ("requested_evals", "kernel_evals", "memo_hits",
              "n_workloads"):
        assert got.stats[k] == want.stats[k], k


ENGINES = [("random", dict(batch_size=40)),
           ("nsga2", dict(pop_size=16)),
           ("nsga2", dict(pop_size=12, archive_epsilon=0.05)),
           ("nsga2", dict(pop_size=8, mutation_rate=0.3, chunk_size=5)),
           ("successive_halving", dict(eta=3)),
           ("successive_halving", dict(eta=2, chunk_size=7))]


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("engine", range(len(ENGINES)))
def test_search_engines_equal_reference(engine, multi):
    method, kw = ENGINES[engine]
    if multi:
        rw, tw = R_TINY, T_TINY
        rs, ts = RSp.space_for_workloads(rw), TSp.space_for_workloads(tw)
    else:
        rw, tw = R_TINY[2], T_TINY[2]
        rs, ts = RSp.space_for_workload(rw), TSp.space_for_workload(tw)
    want = RS.SEARCH_METHODS[method](rs, rw, 96, seed=21, backend="numpy",
                                     **kw)
    got = TS.SEARCH_METHODS[method](ts, tw, 96, seed=21, device="cpu", **kw)
    _assert_same_search(got, want)
    assert got.stats["chunks"] >= 1 and got.stats["device"] == "cpu"
    assert [{k: v for k, v in p.items() if k != "config"}
            for p in got.front_points()] \
        == [{k: v for k, v in p.items() if k != "config"}
            for p in want.front_points()]
    assert [p["config"].name() for p in got.front_points()] \
        == [p["config"].name() for p in want.front_points()]


SERVING_ENGINES = [("random", dict(batch_size=40)),
                   ("nsga2", dict(pop_size=16)),
                   ("successive_halving", dict(eta=3))]


@pytest.mark.parametrize("traffic", ["quick", "bursty"])
@pytest.mark.parametrize("engine", range(len(SERVING_ENGINES)))
def test_serving_search_engines_equal_reference(engine, traffic):
    """Every engine under serving objectives (the fleet simulator's
    plain version on the CPU) reproduces the reference's numpy run."""
    method, kw = SERVING_ENGINES[engine]
    rw, tw = R_TINY[2], T_TINY[2]
    rs, ts = RSp.space_for_workload(rw), TSp.space_for_workload(tw)
    want = RS.SEARCH_METHODS[method](rs, rw, 96, seed=21, backend="numpy",
                                     traffic=traffic, n_slots=3, **kw)
    got = TS.SEARCH_METHODS[method](ts, tw, 96, seed=21, device="cpu",
                                    traffic=traffic, n_slots=3, **kw)
    _assert_same_search(got, want)
    assert got.objectives == TO.DEFAULT_SERVING_OBJECTIVES
    for k in ("traffic", "n_slots"):
        assert got.stats[k] == want.stats[k], k


@pytest.mark.parametrize("kw", [
    dict(preset="serving-quick"),
    dict(preset="quick", traffic="quick"),
    dict(preset="serving-default", budget=96, pop_size=16),
    dict(preset="serving-thorough", budget=96, pop_size=16),
    dict(preset="quick", budget=96, traffic="interactive", n_slots=2,
         objectives=("p50_latency_s", "neg_slo_attainment",
                     "neg_throughput_tps", "area_mm2"))])
def test_run_serving_equals_reference(kw):
    """The serving presets and an explicit trace over a non-serving
    preset, through run(), on the CPU: the reference's numpy result."""
    want = RD.run(RD.ExploreSpec.mixed("vgg16", seed=2, backend="numpy",
                                       **kw))
    got = TD.run(TD.ExploreSpec.mixed("vgg16", seed=2, **kw), device="cpu")
    _assert_same_search(got, want)
    assert (got.stats["traffic"], got.stats["n_slots"]) \
        == (want.stats["traffic"], want.stats["n_slots"])


def test_serving_objectives_via_facade():
    res = TD.run(TD.ExploreSpec.mixed("vgg16", preset="quick", seed=7,
                                      budget=64, traffic="quick"),
                 device="cpu")
    assert res.objectives == TO.DEFAULT_SERVING_OBJECTIVES
    assert res.stats["traffic"] == "quick"
    assert res.stats["n_slots"] == 8
    assert np.isfinite(res.front_objectives).all()


def test_serving_preset_equals_explicit_traffic():
    a = TD.run(TD.ExploreSpec.mixed("vgg16", preset="serving-quick", seed=2,
                                    budget=64), device="cpu")
    b = TD.run(TD.ExploreSpec.mixed("vgg16", preset="quick", seed=2,
                                    budget=64, traffic="quick"),
               device="cpu")
    assert a.objectives == b.objectives
    assert np.array_equal(a.front_objectives, b.front_objectives)


def test_serving_front_differs_from_edp_front():
    """The reference bench's claim in miniature: traffic-aware objectives
    select a different front than per-inference EDP."""
    base = TD.run(TD.ExploreSpec.mixed("vgg16", preset="quick", seed=7,
                                       budget=96), device="cpu")
    serv = TD.run(TD.ExploreSpec.mixed("vgg16", preset="quick", seed=7,
                                       budget=96, traffic="steady"),
                  device="cpu")
    assert {g.tobytes() for g in base.genomes} \
        != {g.tobytes() for g in serv.genomes}


def test_evaluator_serving_validation():
    space = TSp.space_for_workload(T_TINY[0])
    for kw, match in ((dict(objectives=("p99_latency_s",)), "need traffic="),
                      (dict(objectives=("edp",), traffic="quick"),
                       "no serving objective"),
                      (dict(traffic="quick", n_slots=0), "n_slots")):
        with pytest.raises(ValueError, match=match):
            TS.Evaluator(space, T_TINY[0], device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            RS.Evaluator(RSp.space_for_workload(R_TINY[0]), R_TINY[0],
                         backend="numpy", **kw)
    mspace = TSp.space_for_workloads(T_TINY[:2])
    with pytest.raises(ValueError, match="single-workload only"):
        TS.Evaluator(mspace, list(T_TINY[:2]), device="cpu",
                     objectives=("p99_latency_s",), traffic="quick")
    # one trace drives one fleet: a suite search refuses serving
    with pytest.raises(ValueError, match="single-workload only"):
        TD.run(TD.ExploreSpec.many(SUITE, precision="mixed",
                                   objectives=("p99_latency_s",)),
               device="cpu")
    with pytest.raises(ValueError, match="no serving objective"):
        TD.run(TD.ExploreSpec.many(SUITE, precision="mixed",
                                   traffic="quick"), device="cpu")
    ev = TS.Evaluator(space, T_TINY[0], device="cpu", traffic="bursty")
    assert ev.objectives == TO.DEFAULT_SERVING_OBJECTIVES
    assert ev.stats()["traffic"] == "bursty" and ev.stats()["n_slots"] == 8
    plain = TS.Evaluator(space, T_TINY[0], device="cpu").stats()
    assert plain["traffic"] is None and plain["n_slots"] is None


def test_evaluator_memo_chunks_and_subsets():
    space = TSp.space_for_workloads(T_TINY)
    ev = TS.Evaluator(space, list(T_TINY), device="cpu", chunk_size=10)
    g = space.random_population(25, np.random.default_rng(22))
    F = ev.evaluate(g)
    assert ev.stats()["chunks"] == 3 and ev.stats()["kernel_evals"] == 25
    F[:] = 0                              # the caller owns the result
    again = ev.evaluate(g)
    assert ev.stats()["memo_hits"] == 25 and ev.stats()["chunks"] == 3
    assert not (again == 0).all()
    ev.evaluate(g, subset=1)               # a prefix is another memo key
    assert ev.stats()["kernel_evals"] == 50
    ev.reset_stats()
    assert ev.stats()["requested_evals"] == 0
    with pytest.raises(ValueError, match="layer_counts"):
        TS.Evaluator(space, list(T_TINY[:2]), device="cpu")
    with pytest.raises(ValueError, match="CoExploreManySpace"):
        TS.Evaluator(TSp.space_for_workload(T_TINY[0]), [T_TINY[0]],
                     device="cpu")
    with pytest.raises(ValueError, match="layer genes"):
        TS.Evaluator(TSp.space_for_workload(T_TINY[0]), T_TINY[1],
                     device="cpu")


def test_run_mixed_quick_equals_reference():
    want = RD.run(RD.ExploreSpec.mixed("vgg16", preset="quick", seed=7,
                                       backend="numpy"))
    got = TD.run(TD.ExploreSpec.mixed("vgg16", preset="quick", seed=7),
                 device="cpu")
    _assert_same_search(got, want)


@pytest.mark.parametrize("kw", [
    dict(method="random", budget=120),
    dict(method="successive_halving", budget=150),
    dict(budget=96, objectives=("neg_worst_perf_per_area", "worst_edp",
                                "mean_accuracy_noise"),
         weights=(2.0, 1.0, 1.0), pop_size=12),
    dict(budget=64, accuracy="proxy", pop_size=8,
         space_overrides=dict(glb_kbs=(64, 512)))])
def test_run_many_mixed_equals_reference(kw):
    want = RD.run(RD.ExploreSpec.many(SUITE, precision="mixed",
                                      preset="many-quick", seed=4,
                                      backend="numpy", **kw))
    got = TD.run(TD.ExploreSpec.many(SUITE, precision="mixed",
                                     preset="many-quick", seed=4, **kw),
                 device="cpu")
    _assert_same_search(got, want)


def test_golden_many_workload_front_reproduced():
    golden = json.loads(GOLDEN.read_text())
    res = TD.run(TD.ExploreSpec.many(
        golden["workloads"], precision="mixed", preset=golden["preset"],
        budget=golden["budget"], seed=golden["seed"],
        pop_size=golden["pop_size"]), device="cpu")
    assert list(res.objectives) == golden["objectives"]
    want_g = res.space.unpack_genomes(
        np.array(golden["front_genomes_u16"], dtype=np.uint16))
    assert np.array_equal(res.genomes, want_g)
    np.testing.assert_allclose(res.front_objectives,
                               np.array(golden["front_objectives"]),
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# presets, specs and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    # the reference's own refusal of a shard count below 1
    (dict(mesh=0), "shard count"),
    # the deprecated spellings (ROADMAP C.12) are the reference's: each
    # refuses where the reference refuses, the mixed search's at run
    # time, after its DeprecationWarning
    (dict(sqnr_floor_db=20.0, accuracy="proxy"), r"not\s+both|only apply"),
    (dict(sqnr_floor_db=0.0), r"floor_db must be > 0|only apply"),
    (dict(objectives=("worst_quant_noise",)),
     r"multi-workload only|only apply")])
def test_spec_refuses_knobs_not_ported(kwargs, match):
    """``mesh=0`` refuses in every constructor; a deprecated spelling
    refuses as the reference's does (a mixed search only when it
    runs)."""
    if "mesh" in kwargs:
        with pytest.raises(ValueError, match=match):
            TD.ExploreSpec.mixed("vgg16", **kwargs)
    else:
        spec = TD.ExploreSpec.mixed("vgg16", **kwargs)
        with pytest.raises(ValueError, match=match):
            with pytest.warns(DeprecationWarning, match="deprecated"):
                TD.run(spec, device="cpu")
    with pytest.raises(ValueError, match=match):
        TD.ExploreSpec.many(SUITE, **kwargs)
    with pytest.raises(ValueError, match=match):
        TD.ExploreSpec.single("vgg16", **kwargs)


@pytest.mark.parametrize("spec", [
    lambda: TD.ExploreSpec.mixed("vgg16", preset="quick", budget=16,
                                 mesh=2),
    lambda: TD.ExploreSpec.many(("vgg16", "resnet34"), mesh=2),
    lambda: TD.ExploreSpec.single("vgg16", mesh=2)])
def test_int_mesh_refused_on_the_card(spec, monkeypatch):
    """An int shard count is the CPU route's simulation; on the card it
    raises and names ``make_sweep_mesh``, as the reference's jax backend
    refuses an int.  The device is a stand-in ``cuda`` device, so the
    refusal comes before anything reaches CUDA."""
    from repro_torch.core import dse_batch as TDB
    fake = lambda device="cuda": torch.device("cuda", 0)  # noqa: E731
    for mod in (TD, TDB, TS):
        monkeypatch.setattr(mod, "resolve_device", fake)
    with pytest.raises(ValueError, match="make_sweep_mesh"):
        TD.run(spec(), device="cuda")


@pytest.mark.parametrize("knob,value", [("backend", "numpy"),
                                        ("backend", "jax"),
                                        ("use_pallas", True),
                                        ("use_pallas", False)])
def test_spec_refuses_knobs_replaced_by_device(knob, value):
    """The reference's route knobs raise a ValueError that names
    ``device=`` in every constructor, never a TypeError from the
    dataclass or an engine."""
    for ctor in (lambda **k: TD.ExploreSpec.single("vgg16", **k),
                 lambda **k: TD.ExploreSpec.mixed("vgg16", **k),
                 lambda **k: TD.ExploreSpec.many(SUITE, **k),
                 lambda **k: TD.ExploreSpec.many(SUITE, precision="mixed",
                                                 **k)):
        with pytest.raises(ValueError, match=r"run\(\.\.\., device=\)"):
            ctor(**{knob: value})
    spec = TD.ExploreSpec.single("vgg16", engine="scalar")
    assert spec.engine == "scalar"


@pytest.mark.parametrize("knob", ["checkpoint_dir", "telemetry"])
def test_spec_runs_the_a3_knobs_as_reference(tmp_path, knob):
    """``checkpoint_dir`` and ``telemetry``, once refused, run a mixed and
    a many-workload search to the reference's numpy result."""
    for many in (False, True):
        kw = dict(budget=64, seed=2, pop_size=16)
        kw[knob] = (str(tmp_path / f"ck{int(many)}") if knob ==
                    "checkpoint_dir" else True)
        if many:
            ref = RD.run(RD.ExploreSpec.many(SUITE[:2], precision="mixed",
                                             backend="numpy", **kw))
            got = TD.run(TD.ExploreSpec.many(SUITE[:2], precision="mixed",
                                             **kw), device="cpu")
        else:
            ref = RD.run(RD.ExploreSpec.mixed("vgg16", backend="numpy",
                                              **kw))
            got = TD.run(TD.ExploreSpec.mixed("vgg16", **kw), device="cpu")
        assert np.array_equal(got.genomes, ref.genomes)
        assert got.front_objectives.tobytes() == \
            ref.front_objectives.tobytes()
        assert got.history == ref.history


@pytest.mark.parametrize("kw,match", [
    (dict(preset="quick"), "search knob"),
    (dict(precision="mixed", outputs="sweep"), "sweep knob"),
    (dict(precision="mixed", configs=()), "sweep knob"),
    (dict(precision="mixed", weights=(1.0,)), "across a workload suite"),
    (dict(precision="half"), "precision must be"),
    (dict(workloads=SUITE, chunk_size=8, configs=()), "single workload"),
    (dict(workloads=()), "at least one workload"),
    (dict(precision="mixed", accuracy="calibrated"), "bad accuracy spec"),
    (dict(sqnr_floor_db=20.0), "search knob"),
    (dict(precision="mixed", sqnr_floor_db=20.0),
     "across a workload suite")])
def test_spec_validation_as_reference(kw, match):
    kw = {"workloads": ("vgg16",), **kw}
    with pytest.raises(ValueError, match=match):
        RD.ExploreSpec(**kw)
    with pytest.raises(ValueError, match=match):
        TD.ExploreSpec(**kw)


def test_spec_constructors():
    with pytest.raises(ValueError, match="only apply"):
        TD.ExploreSpec.many(SUITE, pop_size=8)
    spec = TD.ExploreSpec.mixed("vgg16", accuracy="proxy", pop_size=8)
    assert spec.accuracy == TA.AccuracySpec() and spec.search_kwargs == {
        "pop_size": 8}


@pytest.mark.parametrize("knob", ["checkpoint_dir", "fail_at_generation"])
def test_nsga2_runs_the_a3_knobs_as_reference(tmp_path, knob):
    """nsga2's snapshots and fault injection, once refused, give the
    reference's search: an injected failure at generation 2 raises in
    both, and a rerun from the snapshots finishes as the uninterrupted
    reference run."""
    r_space = RSp.space_for_workload(R_TINY[0])
    t_space = TSp.space_for_workload(T_TINY[0])
    kw = dict(pop_size=8, seed=1)
    ref = RS.nsga2(r_space, R_TINY[0], 48, backend="numpy", **kw)
    if knob == "fail_at_generation":
        for fn, sp, wl, dev in ((RS.nsga2, r_space, R_TINY[0],
                                 dict(backend="numpy")),
                                (TS.nsga2, t_space, T_TINY[0],
                                 dict(device="cpu"))):
            with pytest.raises(RuntimeError, match="generation boundary 2"):
                fn(sp, wl, 48, fail_at_generation={2: 1}, **dev, **kw)
        return
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="generation boundary 3"):
        TS.nsga2(t_space, T_TINY[0], 48, device="cpu", checkpoint_dir=d,
                 checkpoint_every=1, fail_at_generation={3: 1}, **kw)
    got = TS.nsga2(t_space, T_TINY[0], 48, device="cpu", checkpoint_dir=d,
                   **kw)
    assert np.array_equal(got.genomes, ref.genomes)
    assert got.front_objectives.tobytes() == ref.front_objectives.tobytes()
    assert got.history == ref.history


def test_search_refusals(monkeypatch, tmp_path):
    """The tier-1/2 refusals (ROADMAP A.7) are gone: ``calibrated-quick``
    runs (its front is held to the reference's in
    ``test_torch_accuracy.py``); tier 2 over a suite refuses with the
    reference's words."""
    monkeypatch.setenv("REPRO_TORCH_CALIB_CACHE", str(tmp_path))
    res = TD.run(TD.ExploreSpec.mixed("vgg16", preset="calibrated-quick",
                                      budget=32, pop_size=8), device="cpu")
    assert res.front_size >= 1 and res.validation is None
    with pytest.raises(ValueError, match="single-workload only"):
        TD.run(TD.ExploreSpec.many(SUITE, precision="mixed",
                                   accuracy="measured:mamba2-130m"),
               device="cpu")
    with pytest.raises(ValueError, match="need traffic="):
        TD.run(TD.ExploreSpec.mixed("vgg16", objectives=("p99_latency_s",)),
               device="cpu")
    space = TSp.space_for_workload(T_TINY[0])
    with pytest.raises(ValueError, match="unknown co-exploration method"):
        TD.run(TD.ExploreSpec.mixed("vgg16", method="hill-climb"),
               device="cpu")
    with pytest.raises(ValueError, match="pop_size"):
        TS.nsga2(space, T_TINY[0], 16, device="cpu", pop_size=2)


def test_search_defaults_to_cuda_and_refuses_without_it():
    """run() and the Evaluator ask for the card by default; on a host
    without CUDA they raise, and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    space = TSp.space_for_workload(T_TINY[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.Evaluator(space, T_TINY[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.random_search(space, T_TINY[0], 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.run(TD.ExploreSpec.mixed("vgg16", preset="quick"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.run(TD.ExploreSpec.many(SUITE, precision="mixed"))
