"""The port's scalar dataflow oracle and point-result surface against the
JAX package's.

``repro_torch.core.dataflow`` is a jax-free copy of the reference's
per-config model: ``map_layer``, ``run_workload`` and
``run_workload_mixed`` must give the reference's results bit for bit over
a seeded sample of the design space and of per-layer modes.  The port's
exact batched path must equal that oracle, as the reference's batched
numpy kernel equals its own (``tests/test_dataflow.py``,
``tests/test_mixed_precision.py``), and ``run(ExploreSpec.single(...,
engine="scalar"), device="cpu")`` must equal the exact batched run.  The
scalar engine has no card path: on CUDA it raises.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import accelerator as RA
from repro.core import dataflow as RDF
from repro.core import dse as RD
from repro.core import pe as RPE
from repro.core import workloads as RW
from repro.core.synthesis import synthesize as r_synthesize
from repro_torch.core import accelerator as TA
from repro_torch.core import dataflow as TDF
from repro_torch.core import dse as TD
from repro_torch.core import dse_batch as TB
from repro_torch.core import pe as TPE
from repro_torch.core import workloads as TW
from repro_torch.core.synthesis import synthesize as t_synthesize

WORKLOADS = ("vgg16", "resnet34", "resnet50")
_CFG_FIELDS = ("pe_rows", "pe_cols", "ifmap_spad", "filter_spad",
               "psum_spad", "glb_kb", "dram_bw_gbps", "clock_ghz")


def _sample(n: int, seed: int):
    """``n`` configs of the paper's space (and off-grid GLBs and
    bandwidths), the same in both packages."""
    rng = np.random.default_rng(seed)
    space = list(TA.design_space())
    out = []
    for i in rng.choice(len(space), n, replace=False):
        c = space[i]
        if rng.random() < 0.3:
            c = dataclasses.replace(
                c, glb_kb=int(rng.choice([4, 24, 1000, 4096])),
                dram_bw_gbps=float(rng.uniform(1.0, 80.0)))
        out.append(c)
    return out


def _ref_cfg(c):
    fields = {k: getattr(c, k) for k in _CFG_FIELDS}
    return RA.AcceleratorConfig(pe_type=RPE.PEType(c.pe_type.value),
                                **fields)


def _same_layer(got, want, types: bool = True):
    """Equal fields; with ``types`` also equal Python types (the copies
    against the reference; a batched view holds Python floats where the
    scalar model holds numpy's)."""
    assert type(got).__name__ == type(want).__name__ == "LayerResult"
    g, w = dataclasses.astuple(got), dataclasses.astuple(want)
    assert g == w
    if types:
        assert [type(v) for v in g] == [type(v) for v in w]
    assert got.bound == want.bound


def _same_workload_result(got, want, types: bool = True):
    assert (got.workload, got.config_name) == (want.workload,
                                               want.config_name)
    assert (got.area_mm2, got.clock_ghz) == (want.area_mm2, want.clock_ghz)
    for g, w in zip(got.layers, want.layers, strict=True):
        _same_layer(g, w, types)
    for prop in ("total_macs", "total_cycles", "latency_s", "energy_j",
                 "throughput_gmacs", "perf_per_area", "edp"):
        assert getattr(got, prop) == getattr(want, prop), prop


# ---------------------------------------------------------------------------
# the host copies == the reference, bit for bit
# ---------------------------------------------------------------------------

def test_helpers_equal_reference():
    for t in TPE.PEType:
        ts, rs = TPE.pe_spec(t), RPE.pe_spec(t.value)
        for ent in ((12, 224, 24), (6, 112, 12), (0, 1, 3)):
            assert ts.scratchpad_bits(*ent) == rs.scratchpad_bits(*ent)
    assert TPE.dram_energy_pj_per_byte() == RPE.dram_energy_pj_per_byte()
    for name in WORKLOADS:
        assert TW.get_workload(name).total_macs \
            == RW.get_workload(name).total_macs
    assert TA.design_space_size() == RA.design_space_size() == 720
    kw = dict(glb_kbs=(64, 128), bws=(6.4, 12.8, 25.6, 51.2))
    assert TA.design_space_size(**kw) == RA.design_space_size(**kw) \
        == len(list(TA.design_space(**kw)))


@pytest.mark.parametrize("seed", range(4))
def test_map_layer_equals_reference(seed):
    """Every layer of the paper's workloads on a seeded sample of
    configs, at the hardware's own mode and at a random executable mode."""
    rng = np.random.default_rng(100 + seed)
    for c in _sample(12, seed):
        rc = _ref_cfg(c)
        rep = t_synthesize(c)
        assert dataclasses.astuple(rep) == dataclasses.astuple(
            r_synthesize(rc))
        leak = TDF.leakage_mw(c)
        assert leak == RDF.leakage_mw(rc)
        modes = TPE.supported_modes(c.pe_type)
        for name in WORKLOADS:
            for tl, rl in zip(TW.get_workload(name).layers,
                              RW.get_workload(name).layers, strict=True):
                _same_layer(TDF.map_layer(tl, c, rep.clock_ghz,
                                          rep.area_mm2, leak),
                            RDF.map_layer(rl, rc, rep.clock_ghz,
                                          rep.area_mm2, leak))
                m = modes[int(rng.integers(len(modes)))]
                _same_layer(TDF.map_layer(tl, c, rep.clock_ghz,
                                          rep.area_mm2, leak, mode=m),
                            RDF.map_layer(rl, rc, rep.clock_ghz,
                                          rep.area_mm2, leak,
                                          mode=RPE.PEType(m.value)))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_run_workload_and_mixed_equal_reference(workload):
    rng = np.random.default_rng(7)
    twl, rwl = TW.get_workload(workload), RW.get_workload(workload)
    for c in _sample(6, 11):
        rc = _ref_cfg(c)
        _same_workload_result(TDF.run_workload(twl, c),
                              RDF.run_workload(rwl, rc))
        modes = TPE.supported_modes(c.pe_type)
        assign = [modes[int(i)].value
                  for i in rng.integers(len(modes), size=len(twl.layers))]
        _same_workload_result(TDF.run_workload_mixed(twl, c, assign),
                              RDF.run_workload_mixed(rwl, rc, assign))


def test_run_workload_mixed_refuses_as_reference():
    c = TA.AcceleratorConfig(pe_type=TPE.PEType.INT16)
    rc = _ref_cfg(c)
    twl, rwl = TW.get_workload("vgg16"), RW.get_workload("vgg16")
    for assign, match in ((["int16"] * 3, "assignment length"),
                          (["fp32"] * 16, "not executable")):
        with pytest.raises(ValueError, match=match):
            RDF.run_workload_mixed(rwl, rc, assign)
        with pytest.raises(ValueError, match=match):
            TDF.run_workload_mixed(twl, c, assign)


# ---------------------------------------------------------------------------
# the oracle == the port's exact batched path
# ---------------------------------------------------------------------------

def test_batched_exact_path_equals_the_scalar_oracle():
    configs = _sample(40, 3)
    twl = TW.get_workload("resnet34")
    sweep = TB._sweep_workload(twl, configs, device="cpu")
    for i, c in enumerate(configs):
        view = sweep.result_view(i)
        _same_workload_result(view, TDF.run_workload(twl, c), types=False)


def test_mixed_sweep_equals_run_workload_mixed():
    configs = _sample(24, 5)
    twl = TW.get_workload("vgg16")
    soa = TA.configs_to_soa(configs)
    rng = np.random.default_rng(9)
    compat = TPE.mode_compat_matrix()
    types = tuple(TPE.PEType)
    assign = np.stack([
        rng.choice(np.nonzero(compat[soa["pe_type_idx"][i]])[0],
                   len(twl.layers)) for i in range(len(configs))])
    out = TB._sweep_mixed(twl, soa, assign, device="cpu", outputs="full")
    for i, c in enumerate(configs):
        want = TDF.run_workload_mixed(twl, c,
                                      [types[j] for j in assign[i]])
        for j, l in enumerate(want.layers):
            assert out["total_cycles"][i, j] == l.total_cycles
            assert out["energy_pj"][i, j] == l.energy_pj
            assert out["dram_bytes"][i, j] == l.dram_bytes
            assert out["utilization"][i, j] == l.utilization
        assert out["energy_j"][i] == want.energy_j
        assert out["latency_s"][i] == want.latency_s
        assert out["perf_per_area"][i] == want.perf_per_area


def test_scalar_engine_equals_the_batched_run():
    configs = list(TA.design_space())[::5]
    got = TD.run(TD.ExploreSpec.single("vgg16", configs, engine="scalar"),
                 device="cpu")
    want = TD.run(TD.ExploreSpec.single("vgg16", configs), device="cpu")
    ref = RD.run(RD.ExploreSpec.single("vgg16", [_ref_cfg(c)
                                                 for c in configs],
                                       engine="scalar"))
    assert len(got.points) == len(want.points) == len(ref.points)
    for g, w, r in zip(got.points, want.points, ref.points):
        assert isinstance(g.result, TDF.WorkloadResult)
        _same_workload_result(g.result, w.result, types=False)
        _same_workload_result(g.result, r.result)
    assert got.headline_ratios() == want.headline_ratios() \
        == ref.headline_ratios()
    assert [p.config.name() for p in TD.pareto_front_scalar(got.points)] \
        == [p.config.name() for p in TD.pareto_front(got.points)] \
        == [p.config.name() for p in RD.pareto_front_scalar(ref.points)]


def test_scalar_engine_runs_on_the_cpu_only():
    spec = TD.ExploreSpec.single("vgg16", engine="scalar")
    for dev in ("cuda", "cuda:0"):
        with pytest.raises(ValueError, match='device="cpu"'):
            TD.run(spec, device=dev)


@pytest.mark.parametrize("kw,match", [
    (dict(engine="vector"), "unknown DSE engine"),
    (dict(engine="scalar", outputs="sweep"), "only supports"),
    (dict(engine="scalar", chunk_size=8, configs=()), "only supports"),
    (dict(engine="scalar", precision="mixed"), "sweep knob"),
    (dict(traffic="quick"), "search knob"),
    (dict(n_slots=4), "search knob")])
def test_engine_and_serving_spec_checks_as_reference(kw, match):
    kw = {"workloads": ("vgg16",), **kw}
    with pytest.raises(ValueError, match=match):
        RD.ExploreSpec(**kw)
    with pytest.raises(ValueError, match=match):
        TD.ExploreSpec(**kw)


# ---------------------------------------------------------------------------
# the result views' duck-typed surface
# ---------------------------------------------------------------------------

def test_result_view_surface_equals_reference():
    configs = list(TA.design_space())[::37]
    got = TD.run(TD.ExploreSpec.single("resnet50", configs), device="cpu")
    want = RD.run(RD.ExploreSpec.single(
        "resnet50", [_ref_cfg(c) for c in configs], backend="numpy"))
    for g, w in zip(got.points, want.points, strict=True):
        for prop in ("workload", "config_name", "edp", "area_mm2",
                     "clock_ghz", "total_macs", "total_cycles",
                     "latency_s", "energy_j", "throughput_gmacs",
                     "perf_per_area"):
            assert getattr(g.result, prop) == getattr(w.result, prop), prop


def test_chunked_front_points_equal_reference():
    grid = dict(glb_kbs=(64, 256), bws=tuple(np.linspace(2.0, 64.0, 8)))
    got = TD.run(TD.ExploreSpec.single(
        "vgg16", TA.design_space_soa(**grid), chunk_size=256), device="cpu")
    want = RD.run(RD.ExploreSpec.single(
        "vgg16", RA.design_space_soa(**grid), chunk_size=256,
        backend="numpy"))
    gp, wp = got.front_points(), want.front_points()
    assert len(gp) == len(wp) == got.front_size > 0
    for g, w in zip(gp, wp):
        assert g["config"].name() == w["config"].name()
        assert {k: v for k, v in g.items() if k != "config"} \
            == {k: v for k, v in w.items() if k != "config"}
    assert [p["config"].name() for p in gp] \
        == [c.name() for c in got.front_configs()]
