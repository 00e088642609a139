"""Accuracy tiers 1 and 2 of the port (:mod:`repro_torch.explore.accuracy`)
against the reference's, both fed the reference's calibration tensors.

* Tier 1: ``CalibratedAccuracy`` on the reference's params has the
  reference's table bit for bit (``test_torch_calibrate.py``), so its
  ``layer_table``, scores and the ``calibrated-quick`` search front equal
  the reference's bit for bit.
* Tier 2: ``validate_elites`` picks the reference's elite indices (so the
  same plans) and measures each distinct plan's loss.  mamba2-130m's
  policy computes in bf16: the baseline and per-plan losses are held to
  the bf16 loss bar, 2.5e-4 relative (measured <= 1.1e-5; both near ln
  256, the bar is about 1.4e-3 absolute, larger than the loss deltas
  themselves, -8e-6 to 5.6e-5 here, whose signs differ between the two
  packages, so neither they nor the Pareto mask are compared).  Under an
  fp32 policy (the config's ``quant`` patched in both packages) the
  losses are held to 1e-5 (measured <= 8.9e-8) and the recomputed Pareto
  mask must be the reference's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs.base as RCB
import repro_torch.configs as TCFG
from repro.core import dse as RD
from repro.core.workloads import get_workload as r_get_workload
from repro.explore import accuracy as RA
from repro.explore import search as RS
from repro.explore.space import space_for_workload as r_space_for_workload
from repro.explore.space import space_for_workloads as r_space_for_workloads
from repro.quant import calibrate as RC
from repro_torch.core import dse as TD
from repro_torch.core.pe import PEType
from repro_torch.core.workloads import get_workload
from repro_torch.explore import accuracy as TA
from repro_torch.explore import search as TS
from repro_torch.explore.space import space_for_workload, space_for_workloads
from repro_torch.quant import calibrate as TC
from test_torch_calibrate import reference_calibration_params

MODEL = "mamba2-130m"
TYPES = tuple(PEType)
WL = "vgg16"
MACS = np.array([l.macs for l in get_workload(WL).layers], dtype=np.float64)


@pytest.fixture(scope="module")
def calib_dirs(tmp_path_factory):
    return (str(tmp_path_factory.mktemp("ref")),
            str(tmp_path_factory.mktemp("port")))


@pytest.fixture(scope="module")
def params():
    return reference_calibration_params(MODEL)


def _pair(calib_dirs, params, tier=1, **kw):
    ref = RA.CalibratedAccuracy(RA.AccuracySpec(
        tier=tier, model=MODEL, cache_dir=calib_dirs[0], **kw))
    port = TA.CalibratedAccuracy(TA.AccuracySpec(
        tier=tier, model=MODEL, cache_dir=calib_dirs[1], **kw),
        device="cpu", params=params)
    return ref, port


@pytest.fixture(scope="module")
def cal(calib_dirs, params):
    return _pair(calib_dirs, params)


def _assigns(n=16, seed=0):
    space = space_for_workload(WL)
    _, assign = space.decode(space.random_population(
        n, np.random.default_rng(seed)))
    return assign


# ------------------------------------------------------------------ tier 1

def test_calibrated_table_mapping_and_scores(cal):
    ref, port = cal
    assert np.array_equal(port.calibration.table, ref.calibration.table)
    for n in (1, 5, 16, 24, 40):
        assert np.array_equal(port.layer_table(n), ref.layer_table(n))
    assert port.layer_table(16) is port.layer_table(16)       # memoized
    assign = _assigns()
    got, want = port.score(assign, MACS), ref.score(assign, MACS)
    assert np.array_equal(got, want)
    fp32 = np.full((1, assign.shape[1]), TYPES.index(PEType.FP32))
    assert port.score(fp32, MACS)[0] == 0.0
    lp1 = TYPES.index(PEType.LIGHTPE1)
    assert np.ptp(port.calibration.table[:, lp1]) > 0


def test_state_restore_and_digest(cal, calib_dirs):
    ref, port = cal
    other = TA.CalibratedAccuracy(
        TA.AccuracySpec(tier=1, model=MODEL, cache_dir=calib_dirs[1]),
        device="cpu")                    # the port's own draw
    assert other.digest() != port.digest()
    other.restore_state({k: v.copy() for k, v in ref.state().items()})
    assert other.digest() == port.digest()
    assign = _assigns(seed=3)
    assert np.array_equal(other.score(assign, MACS),
                          ref.score(assign, MACS))
    s = {k: v.copy() for k, v in port.state().items()}
    s["table"] = s["table"] * 1.5
    other.restore_state(s)
    assert other.digest() != port.digest()


def test_resolve_accuracy_coercions(cal, calib_dirs):
    _, port = cal
    assert isinstance(TA.resolve_accuracy(None), TA.ProxyAccuracy)
    assert isinstance(TA.resolve_accuracy("proxy"), TA.ProxyAccuracy)
    assert TA.resolve_accuracy(port) is port
    assert isinstance(port, TA.AccuracyModel)
    spec = TA.AccuracySpec(tier=1, model=MODEL, cache_dir=calib_dirs[1])
    got = TA.resolve_accuracy(spec, device="cpu")
    assert isinstance(got, TA.CalibratedAccuracy) and got.tier == 1
    with pytest.raises(TypeError, match="accuracy must be"):
        TA.resolve_accuracy(42)
    with pytest.raises(ValueError, match="needs tier 1/2"):
        TA.CalibratedAccuracy(TA.AccuracySpec())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TA.resolve_accuracy(spec)


def test_calibrated_quick_front_equals_reference(cal):
    """The committed tier-1 preset, scored on the same table: the same
    front bit for bit, and not the tier-0 proxy's front."""
    ref, port = cal
    want = RD.run(RD.ExploreSpec.mixed(WL, preset="calibrated-quick",
                                       backend="numpy", accuracy=ref))
    got = TD.run(TD.ExploreSpec.mixed(WL, preset="calibrated-quick",
                                      accuracy=port), device="cpu")
    assert got.objectives == want.objectives
    assert np.array_equal(got.genomes, want.genomes)
    assert got.front_objectives.tobytes() == want.front_objectives.tobytes()
    assert got.history == want.history
    assert got.validation is None
    proxy = TD.run(TD.ExploreSpec.mixed(WL, preset="quick"), device="cpu")
    assert set(got.space.genome_keys(got.genomes)) != \
        set(proxy.space.genome_keys(proxy.genomes))


def test_calibrated_quick_runs_from_its_preset(monkeypatch, tmp_path):
    """``preset="calibrated-quick"`` alone calibrates (the port's own
    draw) into the port's cache, then hits it on the next run."""
    monkeypatch.setenv("REPRO_TORCH_CALIB_CACHE", str(tmp_path))
    TC.reset_calibration_cache_stats()
    a = TD.run(TD.ExploreSpec.mixed(WL, preset="calibrated-quick",
                                    budget=48, pop_size=8), device="cpu")
    b = TD.run(TD.ExploreSpec.mixed(WL, preset="calibrated-quick",
                                    budget=48, pop_size=8), device="cpu")
    assert TC.calibration_cache_stats() == {"hits": 1, "misses": 1}
    assert np.array_equal(a.genomes, b.genomes)
    assert len(list(tmp_path.glob("calib_*.npz"))) == 1


def test_resume_pins_the_calibration(cal, calib_dirs, tmp_path):
    _, port = cal
    space = space_for_workload(WL)
    base = TS.nsga2(space, WL, 48, pop_size=8, seed=5, device="cpu",
                    accuracy=port)
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="generation boundary 2"):
        TS.nsga2(space, WL, 48, pop_size=8, seed=5, device="cpu",
                 accuracy=port, checkpoint_dir=d, checkpoint_every=1,
                 fail_at_generation={2: 1})
    res = TS.nsga2(space, WL, 48, pop_size=8, seed=5, device="cpu",
                   accuracy=port, checkpoint_dir=d, checkpoint_every=1)
    assert np.array_equal(base.genomes, res.genomes)
    assert np.array_equal(base.front_objectives, res.front_objectives)
    other = TA.CalibratedAccuracy(
        TA.AccuracySpec(tier=1, model=MODEL, percentile=50.0,
                        cache_dir=calib_dirs[1]), device="cpu")
    with pytest.raises(ValueError, match="refusing to resume"):
        TS.nsga2(space, WL, 48, pop_size=8, seed=5, device="cpu",
                 accuracy=other, checkpoint_dir=d, checkpoint_every=1)


# ------------------------------------------------------------------ tier 2

def _tier2_search(ref):
    space = r_space_for_workload(r_get_workload(WL))
    return RS.nsga2(space, r_get_workload(WL), 48, pop_size=8, seed=7,
                    backend="numpy", accuracy=ref)


@pytest.mark.parametrize("fp32", [False, True])
def test_validate_elites_matches_reference(calib_dirs, params, monkeypatch,
                                           fp32):
    if fp32:
        for mod, name in ((RCB, "get_config"), (TCFG, "get_config")):
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda n, real=real: (
                dataclasses.replace(real(n), quant="fp32")))
    ref, port = _pair(calib_dirs, params, tier=2, max_elites=3)
    rres = _tier2_search(ref)
    tres = TS.nsga2(space_for_workload(WL), WL, 48, pop_size=8, seed=7,
                    device="cpu", accuracy=port)
    assert np.array_equal(tres.genomes, rres.genomes)
    want = RA.validate_elites(rres, ref)
    got = TA.validate_elites(tres, port, device="cpu", params=params)
    assert np.array_equal(got.elite_indices, want.elite_indices)
    assert 1 <= len(got.elite_indices) <= 3
    tol = 1e-5 if fp32 else 2.5e-4
    rel = np.abs(np.r_[got.baseline_loss, got.quant_loss]
                 - np.r_[want.baseline_loss, want.quant_loss]) \
        / np.abs(np.r_[want.baseline_loss, want.quant_loss])
    print("fp32" if fp32 else "bf16", rel.max(), got.loss_delta,
          want.loss_delta)
    assert rel.max() <= tol
    # plans equal: the same elites of the same genomes; a plan's repeat
    # reuses its loss, as in the reference
    _, assign = tres.space.decode(tres.genomes)
    lm = TC.calibration_config(MODEL).n_layers
    plans = assign[got.elite_indices][:, (np.arange(lm) * assign.shape[1])
                                      // lm]
    for i in range(len(plans)):
        for j in range(len(plans)):
            if np.array_equal(plans[i], plans[j]):
                assert got.quant_loss[i] == got.quant_loss[j]
    assert got.accuracy_column == want.accuracy_column == \
        list(tres.objectives).index("accuracy_noise")
    assert np.array_equal(got.measured_objectives[:, got.accuracy_column],
                          got.loss_delta)
    cols = [k for k in range(len(tres.objectives))
            if k != got.accuracy_column]
    assert np.array_equal(got.measured_objectives[:, cols],
                          want.measured_objectives[:, cols])
    if fp32:
        assert np.array_equal(got.pareto_mask, want.pareto_mask)
    assert got.summary()["n_elites"] == len(got.elite_indices)
    again = TA.validate_elites(tres, port, device="cpu", params=params)
    assert np.array_equal(again.quant_loss, got.quant_loss)


def test_validate_elites_appends_a_column_without_accuracy(calib_dirs,
                                                           params):
    _, port = _pair(calib_dirs, params, tier=2, max_elites=1)
    res = TS.nsga2(space_for_workload(WL), WL, 24, pop_size=8, seed=1,
                   device="cpu", objectives=("energy_j", "edp"),
                   accuracy=port)
    v = TA.validate_elites(res, port, device="cpu", params=params)
    assert v.accuracy_column is None
    assert v.measured_objectives.shape == (len(v.elite_indices), 3)
    assert np.array_equal(v.measured_objectives[:, 2], v.loss_delta)


def test_validate_elites_refusals(cal):
    ref, port = cal
    res = TS.nsga2(space_for_workload(WL), WL, 24, pop_size=8, seed=3,
                   device="cpu")
    with pytest.raises(ValueError, match="tier-0 proxy"):
        TA.validate_elites(res, "proxy", device="cpu")
    wls = ("vgg16", "resnet34")
    many = TS.nsga2(space_for_workloads(wls), wls, 24, pop_size=8, seed=3,
                    device="cpu")
    rmany = RS.nsga2(r_space_for_workloads(tuple(r_get_workload(w)
                                                 for w in wls)),
                     tuple(r_get_workload(w) for w in wls), 24, pop_size=8,
                     seed=3, backend="numpy")
    with pytest.raises(ValueError, match="single-workload only") as got:
        TA.validate_elites(many, port, device="cpu")
    with pytest.raises(ValueError, match="single-workload only") as want:
        RA.validate_elites(rmany, ref)
    assert str(got.value) == str(want.value)


def test_run_attaches_validation_at_tier_2_only(calib_dirs):
    spec = TA.AccuracySpec(tier=2, model=MODEL, cache_dir=calib_dirs[1],
                           max_elites=2)
    res = TD.run(TD.ExploreSpec.mixed(WL, preset="quick", budget=32,
                                      pop_size=8, seed=2, accuracy=spec),
                 device="cpu")
    assert isinstance(res.validation, TA.EliteValidation)
    assert res.validation.summary()["n_elites"] <= 2
    t1 = dataclasses.replace(spec, tier=1)
    res1 = TD.run(TD.ExploreSpec.mixed(WL, preset="quick", budget=32,
                                       pop_size=8, seed=2, accuracy=t1),
                  device="cpu")
    assert res1.validation is None
    assert np.array_equal(res1.genomes, res.genomes)


def test_many_refuses_tier_2_as_reference(calib_dirs):
    spec = TA.AccuracySpec(tier=2, model=MODEL, cache_dir=calib_dirs[1])
    rspec = RA.AccuracySpec(tier=2, model=MODEL, cache_dir=calib_dirs[0])
    with pytest.raises(ValueError, match="single-workload only") as got:
        TD.run(TD.ExploreSpec.many(("vgg16", "resnet34"), precision="mixed",
                                   preset="many-quick", budget=16,
                                   accuracy=spec), device="cpu")
    with pytest.raises(ValueError, match="single-workload only") as want:
        RD.run(RD.ExploreSpec.many(("vgg16", "resnet34"), precision="mixed",
                                   preset="many-quick", budget=16,
                                   backend="numpy", accuracy=rspec))
    assert str(got.value) == str(want.value)


def test_validation_refuses_the_card_without_one(cal):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, port = cal
    res = TS.nsga2(space_for_workload(WL), WL, 16, pop_size=8, seed=3,
                   device="cpu", accuracy=port)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.validate_elites(res, port)


def test_reference_measures_the_same_draw_it_validates():
    """The reference's tier-2 forward and its tier-1 table use one draw,
    ``m.init(jax.random.key(seed))`` at full depth and reduced width; the
    port's ``reference_calibration_params`` is that draw."""
    cfg = RCB.get_config(MODEL)
    from repro.models.model import Model as RModel
    rp = RModel(RCB.reduced(cfg, n_layers=cfg.n_layers)).init(
        jax.random.key(0))
    got = reference_calibration_params(MODEL)
    assert np.array_equal(got["embed"].numpy(), np.asarray(rp["embed"]))
    assert RC._measure(MODEL, 0, 99.9, True).n_layers == len(got["layers"])


# ------------------------------------- the deprecated spellings (C.12)

def _r_space():
    return r_space_for_workload(r_get_workload(WL))


@pytest.mark.parametrize("engine", ["random_search", "nsga2",
                                    "successive_halving"])
def test_engine_sqnr_floor_kwarg_folds_into_accuracy(engine):
    """``sqnr_floor_db=`` on every engine: a DeprecationWarning, then the
    search of ``accuracy=AccuracySpec(floor_db=...)``, which is the
    reference's."""
    kw = dict(seed=1, **({"pop_size": 8} if engine == "nsga2" else {}))
    space = space_for_workload(WL)
    with pytest.warns(DeprecationWarning, match="sqnr_floor_db"):
        a = getattr(TS, engine)(space, WL, 32, device="cpu",
                                sqnr_floor_db=20.0, **kw)
    b = getattr(TS, engine)(space, WL, 32, device="cpu",
                            accuracy=TA.AccuracySpec(floor_db=20.0), **kw)
    with pytest.warns(DeprecationWarning, match="sqnr_floor_db"):
        want = getattr(RS, engine)(_r_space(), r_get_workload(WL), 32,
                                   backend="numpy", sqnr_floor_db=20.0,
                                   **kw)
    for got in (a, b):
        assert np.array_equal(got.genomes, want.genomes)
        assert got.front_objectives.tobytes() == \
            want.front_objectives.tobytes()


def test_both_floor_spellings_rejected():
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="not\\s+both"):
            TS.Evaluator(space_for_workload(WL), WL, device="cpu",
                         sqnr_floor_db=20.0,
                         accuracy=TA.AccuracySpec(floor_db=20.0))


def test_random_search_batch_kwarg_is_batch_size():
    space = space_for_workload(WL)
    with pytest.warns(DeprecationWarning, match="batch_size"):
        a = TS.random_search(space, WL, 40, seed=2, device="cpu", batch=8)
    b = TS.random_search(space, WL, 40, seed=2, device="cpu", batch_size=8)
    with pytest.warns(DeprecationWarning, match="batch_size"):
        want = RS.random_search(_r_space(), r_get_workload(WL), 40, seed=2,
                                backend="numpy", batch=8)
    assert a.history == b.history == want.history
    assert len(a.history) == 5
    assert np.array_equal(a.genomes, want.genomes)


def test_preset_floor_folds_with_warning():
    from repro_torch.configs.coexplore_presets import CoExplorePreset
    with pytest.warns(DeprecationWarning, match="sqnr_floor_db"):
        p = CoExplorePreset(name="x", sqnr_floor_db=21.0)
    assert p.sqnr_floor_db is None
    assert p.accuracy == TA.AccuracySpec(floor_db=21.0)
    with pytest.warns(DeprecationWarning):
        q = CoExplorePreset(name="y", objectives=(
            "neg_perf_per_area", "energy_j", "quant_noise"))
    assert q.objectives == ("neg_perf_per_area", "energy_j",
                            "accuracy_noise")
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="not both"):
            CoExplorePreset(name="z", sqnr_floor_db=21.0,
                            accuracy=TA.AccuracySpec(floor_db=20.0))


def test_legacy_objective_names_warn_and_resolve():
    from repro.explore import objectives as RO
    from repro_torch.explore import objectives as TO
    assert TO.LEGACY_OBJECTIVE_ALIASES == RO.LEGACY_OBJECTIVE_ALIASES
    assert not set(TO.LEGACY_OBJECTIVE_ALIASES) & set(TO.OBJECTIVE_REGISTRY)
    for old, new in TO.LEGACY_OBJECTIVE_ALIASES.items():
        with pytest.warns(DeprecationWarning, match="deprecated"):
            assert TO.resolve_objectives((old,)) == (new,)
    with pytest.warns(DeprecationWarning, match="quant_noise"):
        got = TD.run(TD.ExploreSpec.mixed(WL, objectives=(
            "edp", "quant_noise"), budget=32, pop_size=8), device="cpu")
    with pytest.warns(DeprecationWarning, match="quant_noise"):
        want = RD.run(RD.ExploreSpec.mixed(WL, objectives=(
            "edp", "quant_noise"), budget=32, pop_size=8, backend="numpy"))
    assert got.objectives == want.objectives == ("edp", "accuracy_noise")
    assert np.array_equal(got.genomes, want.genomes)


def test_many_sqnr_floor_override_as_reference():
    """``.many(..., sqnr_floor_db=)`` replaces the preset's accuracy (in
    ``many-thorough`` a 20 dB floor) and folds in the engine."""
    kw = dict(precision="mixed", preset="many-thorough", budget=32,
              pop_size=8, sqnr_floor_db=30.0)
    with pytest.warns(DeprecationWarning, match="sqnr_floor_db"):
        got = TD.run(TD.ExploreSpec.many(("vgg16", "resnet34"), **kw),
                     device="cpu")
    with pytest.warns(DeprecationWarning, match="sqnr_floor_db"):
        want = RD.run(RD.ExploreSpec.many(("vgg16", "resnet34"),
                                          backend="numpy", **kw))
    assert np.array_equal(got.genomes, want.genomes)
    assert got.front_objectives.tobytes() == want.front_objectives.tobytes()
    plain = TD.run(TD.ExploreSpec.many(("vgg16", "resnet34"), **{
        k: v for k, v in kw.items() if k != "sqnr_floor_db"}), device="cpu")
    assert plain.front_objectives.tobytes() != \
        got.front_objectives.tobytes()
