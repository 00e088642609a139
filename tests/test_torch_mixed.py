"""The port's mixed-precision and many-workload sweeps against the
JAX package's numpy engine.

On the CPU the port runs the exact policy, so ``_sweep_mixed``,
``_sweep_mixed_many``, ``_explore_many`` and ``IncrementalSweep`` must
equal the reference's numpy backend bit for bit on the same genomes,
built from seeded numpy draws; both sweeps must refuse what the
reference refuses with the same errors.
"""

import numpy as np
import pytest
import torch

from repro.core import dse as RD
from repro.core import dse_batch as RB
from repro.core.workloads import get_workload as r_get_workload
from repro.explore.space import space_for_workload as r_space
from repro.explore.space import space_for_workloads as r_space_many
from repro_torch.core import dse as TD
from repro_torch.core import dse_batch as TB
from repro_torch.core.accelerator import design_space
from repro_torch.core.workloads import Workload, get_workload
from repro_torch.kernels import sweep_kernel as K

SUITE = ("vgg16", "resnet34", "resnet50")
RTOL = 1e-6


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def _genomes(space, n: int, seed: int):
    return space.decode(space.random_population(
        n, np.random.default_rng(seed)))


@pytest.mark.parametrize("outputs", ["aggregates", "full", "layer_totals"])
@pytest.mark.parametrize("workload", ["vgg16", "resnet34"])
def test_sweep_mixed_bit_identical(workload, outputs):
    soa, assign = _genomes(r_space(workload), 200, seed=0)
    want = RB._sweep_mixed(r_get_workload(workload), soa, assign,
                           backend="numpy", outputs=outputs)
    got = TB._sweep_mixed(get_workload(workload), soa, assign,
                          device="cpu", outputs=outputs)
    _assert_same(got, want)


@pytest.mark.parametrize("suite", [SUITE, ("resnet50",),
                                   ("resnet34", "vgg16")])
def test_sweep_mixed_many_bit_identical(suite):
    space = r_space_many(suite)
    soa, assign = _genomes(space, 100, seed=1)
    assigns = space.split_assign(assign)
    want = RB._sweep_mixed_many([r_get_workload(w) for w in suite], soa,
                                assigns, backend="numpy")
    got = TB._sweep_mixed_many([get_workload(w) for w in suite], soa,
                               assigns, device="cpu", use_cache=False)
    _assert_same(got, want)


def test_many_rows_equal_each_workload_alone():
    """Workload w's row of the fused pass is bit-identical to sweeping w
    alone (the reference's contract, held on the port)."""
    space = r_space_many(SUITE)
    soa, assign = _genomes(space, 64, seed=2)
    assigns = space.split_assign(assign)
    many = TB._sweep_mixed_many([get_workload(w) for w in SUITE], soa,
                                assigns, device="cpu")
    for w, (name, a) in enumerate(zip(SUITE, assigns)):
        one = TB._sweep_mixed(get_workload(name), soa, a, device="cpu")
        for k in TB.AGGREGATE_OUTPUTS:
            assert np.array_equal(many[k][w], one[k]), (name, k)


def test_mode_tables_and_assignment_columns():
    for a, b in zip(TB._mode_tables(), RB._mode_tables()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    soa, assign = _genomes(r_space("vgg16"), 32, seed=3)
    wb = TB._workload_batch(get_workload("vgg16"))
    cfg, _ = TB._make_cfg_lay(soa, TB._synthesize(soa, False), wb)
    _assert_same(TB.mixed_assign_cfg(cfg, assign),
                 RB.mixed_assign_cfg(cfg, assign))


def _bad_assignments(soa, assign):
    wrong_type = assign.copy()
    fp32_on_l1 = np.nonzero(soa["pe_type_idx"] == 2)[0][0]
    wrong_type[fp32_on_l1, 3] = 0          # an FP32 layer on LightPE-1
    return {"shape": assign[:, :-1][None], "rows": assign[:-1],
            "negative": assign - 1 - assign.max(),
            "too_large": assign + 4, "incompatible": wrong_type}


@pytest.mark.parametrize("case", ["shape", "rows", "negative", "too_large",
                                  "incompatible"])
def test_check_assignment_refuses_as_reference(case):
    soa, assign = _genomes(r_space("vgg16"), 40, seed=4)
    bad = _bad_assignments(soa, assign)[case]
    with pytest.raises(ValueError) as want:
        RB.check_assignment(soa, bad)
    with pytest.raises(ValueError) as got:
        TB.check_assignment(soa, bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["rows", "too_large", "incompatible"])
def test_sweeps_refuse_bad_assignments_as_reference(case):
    soa, assign = _genomes(r_space("vgg16"), 40, seed=5)
    bad = _bad_assignments(soa, assign)[case]
    with pytest.raises(ValueError) as want:
        RB._sweep_mixed(r_get_workload("vgg16"), soa, bad, backend="numpy")
    with pytest.raises(ValueError) as got:
        TB._sweep_mixed(get_workload("vgg16"), soa, bad, device="cpu")
    assert str(got.value) == str(want.value)
    suite = ("vgg16", "resnet34")
    rw = [r_get_workload(w) for w in suite]
    tw = [get_workload(w) for w in suite]
    other = r_space("resnet34").random_population(
        40, np.random.default_rng(6))[:, 5:]
    other[:, 0] = 0                 # keep the modes legal only where fp32
    for assigns in ([bad, other], [assign], [assign, other[:, :-1]]):
        with pytest.raises(ValueError) as want:
            RB._sweep_mixed_many(rw, soa, assigns, backend="numpy")
        with pytest.raises(ValueError) as got:
            TB._sweep_mixed_many(tw, soa, assigns, device="cpu")
        assert str(got.value) == str(want.value)


def test_many_sweep_needs_a_workload():
    soa, assign = _genomes(r_space("vgg16"), 4, seed=7)
    with pytest.raises(ValueError, match="at least one workload"):
        TB._sweep_mixed_many([], soa, [], device="cpu")


@pytest.mark.parametrize("outputs", ["points", "sweep", "aggregates"])
def test_explore_many_bit_identical(outputs):
    want = RD._explore_many(SUITE, backend="numpy", outputs=outputs)
    got = TD.run(TD.ExploreSpec.many(SUITE, outputs=outputs), device="cpu")
    assert list(got) == list(want)
    for name in SUITE:
        g, w = got[name], want[name]
        if outputs == "points":
            assert g.headline_ratios() == w.headline_ratios()
            assert g.normalized() == w.normalized()
            continue
        assert set(g.arrays) == set(w.arrays)
        for k in w.arrays:
            assert np.array_equal(g.arrays[k], w.arrays[k]), (name, k)
        assert np.array_equal(g.area_mm2, w.area_mm2)


def test_explore_many_on_a_config_list():
    configs = list(design_space())[::5]
    rconfigs = [RD.AcceleratorConfig(**c.__dict__) for c in configs]
    want = RD._explore_many(SUITE[:2], rconfigs, backend="numpy",
                            use_cache=False)
    got = TD._explore_many(SUITE[:2], configs, device="cpu",
                           use_cache=False)
    for name in SUITE[:2]:
        assert [(p.perf_per_area, p.energy_j) for p in got[name].points] \
            == [(p.perf_per_area, p.energy_j) for p in want[name].points]


def test_incremental_sweep_bit_identical():
    perm = np.random.default_rng(10).permutation(720)
    configs = [list(design_space())[i] for i in perm]
    rconfigs = [RD.AcceleratorConfig(**c.__dict__) for c in configs]
    want = RD.IncrementalSweep("resnet34", rconfigs[:300], backend="numpy")
    got = TD.IncrementalSweep("resnet34", configs[:300], device="cpu")
    assert len(got) == len(want) == 300
    # overlapping extension: only the new configs are evaluated
    n_w = want.extend(rconfigs[200:500] + rconfigs[450:460])
    n_g = got.extend(configs[200:500] + configs[450:460])
    assert n_g == n_w == 200
    assert got.extend([]) == 0
    rw, rg = want.result(), got.result()
    assert [p.config.name() for p in rg.points] \
        == [p.config.name() for p in rw.points]
    assert [(p.perf_per_area, p.energy_j) for p in rg.points] \
        == [(p.perf_per_area, p.energy_j) for p in rw.points]
    assert rg.headline_ratios() == rw.headline_ratios()


def test_sweeps_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    soa, assign = _genomes(r_space("vgg16"), 8, seed=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB._sweep_mixed(get_workload("vgg16"), soa, assign)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB._sweep_mixed_many([get_workload("vgg16")], soa, [assign])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.run(TD.ExploreSpec.many(SUITE))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.IncrementalSweep("vgg16")


def _exact_packed(cfg, lay, bounds):
    cpu = torch.device("cpu")
    ecfg, elay = TB._to_device_inputs(cfg, lay, cpu, exact=True)
    totals = TB._sweep_kernel(ecfg, elay, exact=True, outputs="layer_totals")
    seg = TB._segment_aggregates(totals, ecfg, elay, bounds, exact=True)
    return np.concatenate([seg[k].numpy().T for k in TB.AGGREGATE_OUTPUTS],
                          axis=1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


@pytest.mark.parametrize("suite,prefix", [
    (("vgg16",), None), (SUITE, None), (SUITE, 1), (SUITE, 2)])
def test_kernel_plain_version_at_the_search_shapes(suite, prefix):
    """The sweep kernel's wrapper on CPU tensors (its plain version) at
    the shapes the search gives it — 64 genomes, (N, L) mode columns, one
    or three segments, and the successive-halving prefixes that cut each
    segment to one or two layers — against the exact path, within 1e-6
    (on the 102,960-config grid the ResNet segments stray to ~1.8e-6,
    ROADMAP C.1; these genomes stay inside 1e-6)."""
    wls = [get_workload(w) for w in suite]
    if prefix is not None:
        wls = [Workload(name=w.name, layers=w.layers[:prefix])
               for w in wls]
    space = r_space_many(suite)
    soa, assign = _genomes(space, 64, seed=9)
    assigns = [a[:, :len(w.layers)]
               for a, w in zip(space.split_assign(assign), wls)]
    combined, bounds = TB._workload_batch_many(tuple(wls))
    cfg, lay = TB._make_cfg_lay(soa, TB._synthesize(soa, True), combined)
    cfg = TB.mixed_assign_cfg(cfg, np.concatenate(assigns, axis=1))
    cpu = torch.device("cpu")
    got = K.sweep_aggregates_packed(TB._cfg_to_device(cfg, cpu, False),
                                    TB._lay_to_device(lay, cpu, False),
                                    bounds=bounds).numpy()
    assert got.shape == (64, 6 * len(suite))
    assert np.isfinite(got).all()
    assert _rel(got, _exact_packed(cfg, lay, bounds)) <= RTOL
