"""The port's CUDA kernels on the card: the sweep kernel and the two
quantized matmuls of the serving path.

Every test here is marked ``cuda`` and skips on a host without a card.
The file imports only the port (no jax, nothing of ``repro``), so it runs
where the JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The sweep kernel is held against its plain PyTorch version on the card
and against the port's exact float64 CPU path, whose bit-identity to the
JAX package's numpy kernel the CPU tests pin.  The matmul kernels sum
exactly in int32, so they must equal their plain versions bit for bit.
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


# ------------------------------------------------- quantized matmuls

QMM = {"w8a8": (OPS.w8a8_matmul, W8, 1), "w4a8": (OPS.w4a8_matmul, W4, 2)}


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
