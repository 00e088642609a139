"""The port's CUDA sweep kernel on the card.

Every test here is marked ``cuda`` and skips on a host without a card.
The file imports only the port (no jax, nothing of ``repro``), so it runs
where the JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the card and
against the port's exact float64 CPU path, whose bit-identity to the JAX
package's numpy kernel the CPU tests pin.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import dse as TD
from repro_torch.core import dse_batch as TB
from repro_torch.core.accelerator import design_space_soa
from repro_torch.core.pe import PEType, pe_spec
from repro_torch.core.synthesis import synthesize_soa
from repro_torch.core.workloads import get_workload
from repro_torch.kernels import sweep_kernel as K

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
