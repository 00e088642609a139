"""The port's sweep entry point and streamed driver against the JAX package.

On the CPU the port runs the exact policy, so its results must equal the
reference's numpy engine exactly: the paper's headline ratios, and the
streamed Pareto front with its synthesis-cache accounting at every
prefetch depth.
"""

import numpy as np
import pytest
import torch

from repro.core import dse as RD
from repro.core import dse_batch as RB
from repro.core.accelerator import design_space_soa as r_design_space_soa
from repro.core.synthesis import PersistentSynthesisCache as RCache
from repro.core.workloads import get_workload as r_get_workload
from repro_torch.core import dse as TD
from repro_torch.core import dse_batch as TB
from repro_torch.core.accelerator import AcceleratorConfig, design_space
from repro_torch.core.accelerator import design_space_soa
from repro_torch.core.synthesis import PersistentSynthesisCache
from repro_torch.core.workloads import get_workload

# the quick chunked grid of benchmarks/dse_sweep_bench.py (_CHUNKED_QUICK)
QUICK = dict(glb_kbs=(64, 128, 256, 512),
             bws=tuple(np.linspace(2.0, 64.0, 64)))
CHUNK = 4096


def _ref_run(**kw):
    return RD.run(RD.ExploreSpec.single("vgg16", backend="numpy", **kw))


@pytest.mark.parametrize("workload", ["vgg16", "resnet34", "resnet50"])
def test_headline_ratios_equal_reference(workload):
    want = RD.run(RD.ExploreSpec.single(workload,
                                        backend="numpy")).headline_ratios()
    got = TD.run(TD.ExploreSpec.single(workload),
                 device="cpu").headline_ratios()
    assert got == want


def test_points_and_layers_equal_reference():
    configs = list(design_space())[::7]
    want = RD.run(RD.ExploreSpec.single(
        "vgg16", [RD.AcceleratorConfig(**c.__dict__) for c in configs],
        backend="numpy"))
    got = TD.run(TD.ExploreSpec.single("vgg16", configs), device="cpu")
    assert len(got.points) == len(want.points)
    for g, w in zip(got.points, want.points):
        assert g.config.name() == w.config.name()
        assert (g.perf_per_area, g.energy_j) == (w.perf_per_area, w.energy_j)
        assert g.result.total_cycles == w.result.total_cycles
        assert [l.__dict__ for l in g.result.layers] \
            == [l.__dict__ for l in w.result.layers]
    assert [p.config.name() for p in TD.pareto_front(got.points)] \
        == [p.config.name() for p in RD.pareto_front(want.points)]
    assert got.normalized() == want.normalized()


@pytest.mark.parametrize("outputs", ["sweep", "aggregates"])
def test_sweep_outputs_equal_reference(outputs):
    want = _ref_run(outputs=outputs)
    got = TD.run(TD.ExploreSpec.single("vgg16", outputs=outputs),
                 device="cpu")
    assert isinstance(got, TB.BatchedSweep)
    assert set(got.arrays) == set(want.arrays)
    for k in want.arrays:
        assert np.array_equal(got.arrays[k], want.arrays[k]), k
    assert np.array_equal(got.clock_ghz, want.clock_ghz)
    assert np.array_equal(got.area_mm2, want.area_mm2)


def _assert_same_stream(got, want):
    assert (got.n_configs, got.n_chunks) == (want.n_configs, want.n_chunks)
    assert got.front_size == want.front_size
    for k in want.front_soa:
        assert np.array_equal(got.front_soa[k], want.front_soa[k]), k
    for m in want.front_metrics:
        assert np.array_equal(got.front_metrics[m], want.front_metrics[m]), m
    assert [c.name() for c in got.front_configs()] \
        == [c.name() for c in want.front_configs()]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_chunked_front_and_cache_equal_reference(tmp_path, depth):
    """The quick grid streamed through both drivers with a persisted
    cache each: identical fronts, identical hit/miss counts — on a cold
    pass and on a warm re-sweep of the same space."""
    ref_cache = RCache(tmp_path / "ref.npz")
    cache = PersistentSynthesisCache(tmp_path / "port.npz")
    wl, rwl = get_workload("vgg16"), r_get_workload("vgg16")
    for _ in range(2):
        want = RB._sweep_chunked(
            rwl, r_design_space_soa(**QUICK), backend="numpy",
            chunk_size=CHUNK, cache=ref_cache, prefetch_depth=depth)
        got = TB._sweep_chunked(
            wl, design_space_soa(**QUICK), device="cpu", chunk_size=CHUNK,
            cache=cache, prefetch_depth=depth)
        _assert_same_stream(got, want)
        assert (cache.hits, cache.misses, len(cache)) \
            == (ref_cache.hits, ref_cache.misses, len(ref_cache))
        assert got.timings["prefetch_depth"] == depth
        for t in ("wall_s", "synth_s", "kernel_wait_s"):
            assert got.timings[t] >= 0.0
    assert cache.hits == 15360 and cache.misses == 15360
    assert (tmp_path / "port.npz").exists()


def test_chunked_through_run_and_config_feeds():
    """run() with chunk_size streams; SoA chunks, config lists and a
    flat generator give one front."""
    configs = list(design_space())
    spec = TD.ExploreSpec.single("vgg16", [configs], chunk_size=100,
                                 use_cache=False, overlap=False)
    a = TD.run(spec, device="cpu")
    b = TD.run(TD.ExploreSpec.single("vgg16", design_space_soa(),
                                     chunk_size=100), device="cpu")
    c = TD.run(TD.ExploreSpec.single("vgg16", iter(configs),
                                     chunk_size=100), device="cpu")
    assert a.timings["overlap"] is False and a.timings["prefetch_depth"] == 1
    for x in (b, c):
        _assert_same_stream(x, a)
    assert a.n_configs == 720 and a.n_chunks == 8


def test_empty_feed_returns_empty_front():
    res = TB._sweep_chunked(get_workload("vgg16"), [], device="cpu")
    assert res.n_configs == 0 and res.front_size == 0
    assert res.front_configs() == []


def test_explore_spec_validation():
    with pytest.raises(ValueError, match="outputs"):
        TD.ExploreSpec.single("vgg16", outputs="all")
    with pytest.raises(ValueError, match="chunk_size"):
        TD.ExploreSpec.single("vgg16", chunk_size=0)
    with pytest.raises(ValueError, match="prefetch_depth"):
        TD.ExploreSpec.single("vgg16", [], chunk_size=8, prefetch_depth=0)
    with pytest.raises(ValueError, match="chunk_size"):
        TD.ExploreSpec.single("vgg16", prefetch_depth=4)
    with pytest.raises(ValueError, match="config feed"):
        TD.ExploreSpec.single("vgg16", chunk_size=8)
    with pytest.raises(ValueError, match="ChunkedSweep"):
        TD.ExploreSpec.single("vgg16", [], chunk_size=8, outputs="sweep")
    with pytest.raises(ValueError, match="one workload"):
        TD.ExploreSpec(workloads=())
    with pytest.raises(ValueError, match="single workload"):
        TD.ExploreSpec(workloads=("vgg16", "resnet34"), configs=(),
                       chunk_size=8)
    spec = TD.ExploreSpec.single("vgg16", [AcceleratorConfig()])
    assert spec.configs == (AcceleratorConfig(),)
    with pytest.raises(TypeError, match="ExploreSpec"):
        TD.run(RD.ExploreSpec.single("vgg16"), device="cpu")


def test_run_defaults_to_cuda_and_refuses_without_it():
    """With no device, run() asks for the card; on a host without CUDA
    it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.run(TD.ExploreSpec.single("vgg16"))
    spec = TD.ExploreSpec.single("vgg16", design_space_soa(), chunk_size=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.run(spec)
