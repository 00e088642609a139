"""The port's sweep body and aggregate kernel against the JAX package.

Same numpy inputs through both packages:

* the exact (int64/float64) policy of ``repro_torch``'s ``_sweep_kernel``
  is bit-identical to ``repro``'s numpy exact kernel on every output;
* the x64-free (int32/float32) policy and the kernel's plain version
  ``sweep_aggregates_ref`` agree with the numpy exact kernel and with the
  Pallas kernel in interpret mode to <= 1e-6 relative — ragged tails,
  mixed-precision ``(N, L)`` columns and multi-segment bounds included;
* the CUDA kernel itself is held against the plain version by the tests
  marked ``cuda``, which run only where a card is present.
"""

import numpy as np
import pytest
import torch

from repro.core import dse_batch as R
from repro.core.accelerator import AcceleratorConfig, configs_to_soa
from repro.core.pe import PEType
from repro.core.synthesis import synthesize_soa
from repro.core.workloads import get_workload
from repro.kernels.sweep_kernel import sweep_aggregates_pallas
from repro_torch.core import dse_batch as T
from repro_torch.kernels import sweep_kernel as K

RTOL = 1e-6
CPU = torch.device("cpu")


def _configs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    types = tuple(PEType)
    return tuple(
        AcceleratorConfig(
            pe_type=types[int(rng.integers(len(types)))],
            pe_rows=int(rng.integers(4, 33)),
            pe_cols=int(rng.integers(4, 33)),
            glb_kb=int(rng.choice([4, 64, 128, 256, 512, 4096])),
            dram_bw_gbps=float(rng.choice([2.0, 6.4, 12.8, 25.6, 64.0])))
        for _ in range(n))


def _cfg_lay(n: int, seed: int, workloads=("vgg16",)):
    """Reference-built (cfg, lay, bounds) over the concatenated layers."""
    soa = configs_to_soa(_configs(n, seed))
    combined, bounds = R._workload_batch_many(
        tuple(get_workload(w) for w in workloads))
    cfg, lay = R._make_cfg_lay(soa, synthesize_soa(soa), combined)
    return cfg, lay, bounds


def _mixed(cfg: dict, n_layers: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, len(tuple(PEType)), size=(len(cfg["pe_rows"]),
                                                       n_layers))
    return R.mixed_assign_cfg(cfg, assign)


def _numpy_segments(cfg, lay, bounds) -> dict:
    """Exact reference per segment: ``{column: (W, N)}`` float64."""
    out = {k: [] for k in R.AGGREGATE_OUTPUTS}
    for s, e in bounds:
        sub_lay = {k: v[:, s:e] for k, v in lay.items()}
        sub_cfg = {k: (v[:, s:e] if v.shape[1] > 1 else v)
                   for k, v in cfg.items()}
        agg = R._sweep_kernel(np, sub_cfg, sub_lay, outputs="aggregates")
        for k in R.AGGREGATE_OUTPUTS:
            out[k].append(np.asarray(agg[k], dtype=np.float64))
    return {k: np.stack(v) for k, v in out.items()}


def _rel(got, want) -> float:
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    assert g.shape == w.shape
    return float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))


def _x64free(cfg, lay):
    return T._to_device_inputs(cfg, lay, CPU, exact=False)



# ---------------------------------------------------------------------------
# exact policy: bit-identical to the reference numpy kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
@pytest.mark.parametrize("n", [1, 40, 300])
def test_exact_full_bit_identical(n, mixed):
    cfg, lay, _ = _cfg_lay(n, seed=n)
    if mixed:
        cfg = _mixed(cfg, lay["r"].shape[1], seed=n)
    want = R._sweep_kernel(np, cfg, lay, exact=True, outputs="full")
    dcfg, dlay = T._to_device_inputs(cfg, lay, CPU, exact=True)
    got = T._sweep_kernel(dcfg, dlay, exact=True, outputs="full")
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("outputs", ["aggregates", "layer_totals"])
def test_exact_output_modes_bit_identical(outputs):
    cfg, lay, _ = _cfg_lay(50, seed=3)
    want = R._sweep_kernel(np, cfg, lay, exact=True, outputs=outputs)
    dcfg, dlay = T._to_device_inputs(cfg, lay, CPU, exact=True)
    got = T._sweep_kernel(dcfg, dlay, exact=True, outputs=outputs)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_exact_segment_aggregates_bit_identical():
    cfg, lay, bounds = _cfg_lay(30, seed=4,
                                workloads=("vgg16", "resnet34", "resnet50"))
    totals = R._sweep_kernel(np, cfg, lay, outputs="layer_totals")
    want = R._segment_aggregates(np, totals, cfg, lay, bounds, exact=True)
    dcfg, dlay = T._to_device_inputs(cfg, lay, CPU, exact=True)
    dtot = T._sweep_kernel(dcfg, dlay, exact=True, outputs="layer_totals")
    got = T._segment_aggregates(dtot, dcfg, dlay, bounds, exact=True)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k


def test_unknown_output_mode_raises():
    cfg, lay, _ = _cfg_lay(4, seed=5)
    dcfg, dlay = T._to_device_inputs(cfg, lay, CPU, exact=True)
    with pytest.raises(ValueError, match="outputs"):
        T._sweep_kernel(dcfg, dlay, outputs="everything")


# ---------------------------------------------------------------------------
# x64-free policy and the plain aggregates: <= 1e-6 of numpy exact
# ---------------------------------------------------------------------------

def test_x64free_dtypes():
    cfg, lay, _ = _cfg_lay(8, seed=6)
    dcfg, dlay = _x64free(cfg, lay)
    for k, v in dcfg.items():
        assert v.dtype == (torch.int32 if k in T._CFG_INT32
                           else torch.float32), k
    for k, v in dlay.items():
        assert v.dtype == (torch.float32 if k == "macs" else torch.int32), k


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_x64free_aggregates_match_exact(mixed):
    cfg, lay, _ = _cfg_lay(300, seed=7)
    if mixed:
        cfg = _mixed(cfg, lay["r"].shape[1], seed=7)
    want = R._sweep_kernel(np, cfg, lay, exact=True, outputs="aggregates")
    got = T._sweep_kernel(*_x64free(cfg, lay), exact=False,
                          outputs="aggregates")
    for k in R.AGGREGATE_OUTPUTS:
        assert got[k].dtype == torch.float32
        assert _rel(got[k].numpy(), want[k]) <= RTOL, k


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_x64free_full_matches_reference_policy(mixed):
    """The reference body run by numpy on the reference's own x64-free
    inputs: every count column (cycles, bytes, utilization, the
    throughput aggregates) is bit-identical; the energy columns, where
    numpy promotes int32 / float to float64, agree to <= 1e-6."""
    cfg, lay, _ = _cfg_lay(300, seed=8)
    if mixed:
        cfg = _mixed(cfg, lay["r"].shape[1], seed=8)
    want = R._sweep_kernel(np, *R._to_jax_inputs(cfg, lay, exact=False),
                           exact=False)
    got = T._sweep_kernel(*_x64free(cfg, lay), exact=False)
    assert set(got) == set(want)
    for k in want:
        if k in ("energy_pj", "energy_pj_sum", "energy_j"):
            assert _rel(got[k].numpy(), want[k]) <= RTOL, k
        else:
            assert np.array_equal(got[k].numpy(), want[k]), k


@pytest.mark.parametrize("case", ["single", "ragged", "mixed", "segments"])
def test_plain_aggregates_match_exact_and_pallas(case):
    """``sweep_aggregates_ref`` (and the wrapper on CPU tensors) against
    the numpy exact kernel and the Pallas kernel in interpret mode."""
    if case == "segments":
        cfg, lay, bounds = _cfg_lay(21, seed=3,
                                    workloads=("vgg16", "resnet34"))
    else:
        n = {"single": 83, "ragged": 53, "mixed": 40}[case]
        cfg, lay, _ = _cfg_lay(n, seed=n)
        bounds = None
    if case == "mixed":
        cfg = _mixed(cfg, lay["r"].shape[1], seed=2)
    l = lay["r"].shape[1]
    exact = _numpy_segments(cfg, lay, bounds or ((0, l),))
    blocks = {"ragged": dict(block_n=16, block_l=5),
              "mixed": dict(block_n=16, block_l=4),
              "segments": dict(block_n=8, block_l=8)}.get(case, {})
    pallas = sweep_aggregates_pallas(cfg, lay, bounds=bounds,
                                     interpret=True, **blocks)
    dcfg, dlay = _x64free(cfg, lay)
    ref = K.sweep_aggregates_ref(dcfg, dlay, bounds=bounds)
    wrapped = K.sweep_aggregates(dcfg, dlay, bounds=bounds)
    for k in R.AGGREGATE_OUTPUTS:
        want = exact[k][0] if bounds is None else exact[k]
        assert ref[k].shape == want.shape, k
        assert _rel(ref[k].numpy(), want) <= RTOL, k
        assert _rel(ref[k].numpy(), np.asarray(pallas[k])) <= RTOL, k
        assert torch.equal(wrapped[k], ref[k]), k


def test_packed_layout():
    cfg, lay, bounds = _cfg_lay(9, seed=9, workloads=("vgg16", "resnet34"))
    dcfg, dlay = _x64free(cfg, lay)
    packed = K.sweep_aggregates_packed(dcfg, dlay, bounds=bounds)
    ref = K.sweep_aggregates_ref(dcfg, dlay, bounds=bounds)
    w = len(bounds)
    assert packed.shape == (9, 6 * w)
    for i, k in enumerate(R.AGGREGATE_OUTPUTS):
        for seg in range(w):
            assert torch.equal(packed[:, i * w + seg], ref[k][seg])


def test_segment_macs_as_reference():
    _, lay, bounds = _cfg_lay(2, seed=1,
                              workloads=("vgg16", "resnet34", "resnet50"))
    macs = lay["macs"].astype(np.float32)
    want = [macs[0, s:e].sum(dtype=np.float32) for s, e in bounds]
    assert np.array_equal(K.segment_macs(macs, bounds),
                          np.array(want, dtype=np.float32))


def test_layer_table_layout():
    cfg, lay, bounds = _cfg_lay(2, seed=1, workloads=("vgg16", "resnet34"))
    _, dlay = _x64free(cfg, lay)
    table = K._layer_table(dlay, bounds)
    l, w = lay["r"].shape[1], len(bounds)
    assert table.dtype == np.int32 and table.shape == (10 * l + 4 * w,)
    assert np.array_equal(table[:l], lay["r"][0])
    assert np.array_equal(table[8 * l:9 * l], lay["batch"][0])
    assert np.array_equal(table[9 * l:10 * l].view(np.float32),
                          lay["macs"][0].astype(np.float32))
    assert np.array_equal(table[10 * l:10 * l + 2 * w],
                          np.asarray(bounds).reshape(-1))
    assert np.array_equal(table[10 * l + 2 * w:10 * l + 3 * w]
                          .view(np.float32),
                          K.segment_macs(lay["macs"], bounds))
    assert tuple(table[10 * l + 3 * w:]) == K.plan(1, bounds).tiles


# ---------------------------------------------------------------------------
# wrapper guards
# ---------------------------------------------------------------------------

def test_wrapper_validation():
    cfg, lay, _ = _cfg_lay(8, seed=10)
    dcfg, dlay = _x64free(cfg, lay)
    l = lay["r"].shape[1]
    bad = dict(dcfg)
    del bad["pe_rows"]
    with pytest.raises(ValueError, match="missing field"):
        K.sweep_aggregates(bad, dlay)
    with pytest.raises(ValueError, match="shape"):
        K.sweep_aggregates(dict(dcfg, pe_rows=dcfg["pe_rows"][:, 0]), dlay)
    with pytest.raises(ValueError, match="x64-free"):
        K.sweep_aggregates(dict(dcfg, pe_rows=dcfg["pe_rows"].long()), dlay)
    with pytest.raises(ValueError, match="x64-free"):
        K.sweep_aggregates(dcfg, dict(dlay, macs=dlay["macs"].double()))
    with pytest.raises(ValueError, match="contiguous"):
        wide = dcfg["act_bits"].expand(8, l)
        K.sweep_aggregates(dict(dcfg, act_bits=wide), dlay)
    with pytest.raises(ValueError, match="bounds"):
        K.sweep_aggregates(dcfg, dlay, bounds=((0, 0),))
    with pytest.raises(ValueError, match="bounds"):
        K.sweep_aggregates(dcfg, dlay, bounds=((0, l + 1),))


def test_wrapper_refuses_non_cpu_tensors_without_a_result():
    """Tensors that are not on the CPU never take the plain version: the
    wrapper launches the kernel or raises."""
    cfg, lay, _ = _cfg_lay(4, seed=11)
    dcfg, dlay = _x64free(cfg, lay)
    meta = {k: v.to("meta") for k, v in dcfg.items()}
    with pytest.raises(ValueError, match="neither CPU nor CUDA"):
        K.sweep_aggregates(meta, dlay)
    with pytest.raises(ValueError, match="host data"):
        K.sweep_aggregates(dcfg, {k: v.to("meta") for k, v in dlay.items()})
