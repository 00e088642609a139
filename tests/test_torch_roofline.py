"""The port's hardware-analysis tooling against the reference's.

``repro_torch.core.gpu_roofline`` against ``repro.core.tpu_roofline`` on
the same stats; ``repro_torch.core.op_analysis`` against hand counts, the
reference's HLO cost model and ``FlopCounterMode``; each kernel's
``cost()`` against hand counts and the bounds ``PERF.md`` reports; one
step counted alike on the plain route, under fake tensors and on the
kernel route (stubbed); ``repro_torch.launch.dryrun`` against the
reference's formulas and refusals; the C.15 pins of the reference.
Counts are integers held in float64, so they are compared exactly.
"""

import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.core import hlo_analysis as RH
from repro.core import tpu_roofline as RR
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig, reduced
from repro_torch.core import gpu_roofline as GR
from repro_torch.core import op_analysis as OA
from repro_torch.kernels import flash_attention as T_flash
from repro_torch.kernels import ops
from repro_torch.kernels import w4a8_matmul as T_w4a8
from repro_torch.kernels import w8a8_decode as T_dec
from repro_torch.kernels import w8a8_matmul as T_w8a8
from repro_torch.launch import dryrun
from repro_torch.models.model import Model

ROOT = pathlib.Path(__file__).resolve().parent.parent
# a chip with the reference's v5e figures, every FLOP in the bf16 class
V5E_AS_PORT = GR.ChipSpec(
    name=RR.V5E.name, peak_bf16_flops=RR.V5E.peak_bf16_flops,
    hbm_bw=RR.V5E.hbm_bw, nvlink_links=RR.V5E.ici_links,
    nvlink_link_bw=RR.V5E.ici_link_bw, hbm_gb=RR.V5E.hbm_gb)
# one phi4-mini layer's projections, (k, n): count (chip_smoke.LAYER_PROJ)
LAYER_PROJ = {(3072, 3072): 2, (3072, 1024): 2, (3072, 8192): 2,
              (8192, 3072): 1}
H100 = GR.H100


# ------------------------------------------------------------- roofline

STATS = [
    dict(flops=197e12, bytes_accessed=819e9, coll={"all-reduce": 200e9},
         count={"all-reduce": 4}, chips=256, model_flops=197e12 * 256),
    dict(flops=3.7e9, bytes_accessed=1.25e10, coll={}, count={}, chips=1,
         model_flops=7.6e9),
    dict(flops=8.1e15, bytes_accessed=2.2e12,
         coll={"all-gather": 3e10, "reduce-scatter": 1.5e10},
         count={"all-gather": 9, "reduce-scatter": 3}, chips=512,
         model_flops=2.9e18),
]


@pytest.mark.parametrize("case", STATS)
def test_roofline_matches_reference_on_the_same_stats(case):
    ref_stats = RH.CompiledStats(
        flops=case["flops"], bytes_accessed=case["bytes_accessed"],
        transcendentals=0,
        collectives=RH.CollectiveStats(case["coll"], case["count"]),
        xla_flops=0, xla_bytes=0, argument_bytes=0, output_bytes=0,
        temp_bytes=0, generated_code_bytes=0)
    port_stats = OA.StepStats(
        flops=case["flops"], flops_by_class={"bf16": case["flops"]},
        bytes_accessed=case["bytes_accessed"], transcendentals=0,
        collectives=OA.CollectiveStats(case["coll"], case["count"]),
        by_kernel={}, flop_counter_flops=0, argument_bytes=0,
        output_bytes=0, temp_bytes=0)
    kw = dict(arch="a", shape="s", mesh="m", chips=case["chips"],
              model_flops=case["model_flops"])
    want = RR.roofline_from_stats(ref_stats, **kw)
    got = GR.roofline_from_stats(port_stats, chip=V5E_AS_PORT, **kw)
    for term in ("compute_s", "memory_s", "collective_s", "step_time_s",
                 "useful_flops_ratio", "roofline_fraction", "bottleneck"):
        assert getattr(got, term) == getattr(want, term), term
    d_want, d_got = want.as_dict(), got.as_dict()
    assert set(d_got) == set(d_want) | {"chip", "flops_by_class"}
    assert {k: d_got[k] for k in d_want} == d_want


def test_model_flops_helpers_match_reference():
    for n, d in ((1e9, 1e6), (3.8e9, 4096), (1.29e8, 512 * 8)):
        assert GR.dense_model_flops(n, d) == RR.dense_model_flops(n, d)
        assert GR.serve_model_flops(n, d) == RR.serve_model_flops(n, d)


def test_h100_classes_and_peaks():
    assert GR.H100.name == "h100-sxm"
    assert GR.H100.peak("fp32_dot") == GR.H100.peak_tf32_flops / 3
    st = OA.StepStats(
        flops=0, flops_by_class={"int8": 1979e12, "bf16": 989e12,
                                 "fp32_dot": 494.7e12 / 3, "fp32": 67e12},
        bytes_accessed=3.35e12, transcendentals=0,
        collectives=OA.CollectiveStats({"all-reduce": 450e9}, {}),
        by_kernel={}, flop_counter_flops=0, argument_bytes=0,
        output_bytes=0, temp_bytes=0)
    r = GR.roofline_from_stats(st, arch="a", shape="s", mesh="1", chips=1,
                               model_flops=0)
    assert r.compute_s == pytest.approx(4.0, rel=1e-15)
    assert r.memory_s == 1.0 and r.collective_s == 1.0
    assert r.bottleneck == "compute"


# --------------------------------------------------------- the op counter

def test_matmul_counts_2mnk_and_equals_flop_counter_mode():
    m, k, n = 256, 512, 128
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    _, st = OA.analyze_step(torch.matmul, a, b)
    assert st.flops == 2 * m * n * k
    assert st.flops_by_class == {"int8": 0.0, "bf16": 0.0,
                                 "fp32_dot": 2.0 * m * n * k, "fp32": 0.0}
    with FlopCounterMode(display=False) as fc:
        torch.matmul(a, b)
    assert st.flop_counter_flops == fc.get_total_flops()
    assert st.bytes_accessed == 4 * (m * k + k * n + m * n)
    # the reference's HLO count of the same program, within its own 2 %
    co = jax.jit(lambda x, y: x @ y).lower(
        jax.ShapeDtypeStruct((m, k), jnp.float32),
        jax.ShapeDtypeStruct((k, n), jnp.float32)).compile()
    ref = RH.analyze_hlo_text(co.as_text()).flops
    assert abs(ref - st.flops) / st.flops < 0.02


def test_layer_loop_counts_every_layer():
    """The reference's scan test: 7 tanh layers and their gradient.  x
    requires grad too, as the reference's scan body computes the carry's
    gradient in every layer: 3 dots a layer."""
    L = 7
    rng = np.random.default_rng(1)
    W = torch.from_numpy(rng.normal(size=(L, 64, 64)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))

    def grad_program(W, x):
        W, x = W.requires_grad_(True), x.requires_grad_(True)
        c = x
        for l in range(L):
            c = torch.tanh(c @ W[l])
        c.sum().backward()
        return W.grad

    _, st = OA.analyze_step(grad_program, W.clone(), x.clone())
    expect = 2 * 8 * 64 * 64 * L * 3
    assert st.flops_by_class["fp32_dot"] == expect
    assert st.transcendentals == 8 * 64 * L

    def f(params, x):
        def body(c, w):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, params)
        return y.sum()
    co = jax.jit(jax.grad(f)).lower(
        jax.ShapeDtypeStruct((L, 64, 64), jnp.float32),
        jax.ShapeDtypeStruct((8, 64), jnp.float32)).compile()
    ref = RH.analyze_hlo_text(co.as_text()).flops
    # the reference's trip-corrected count (dots and elementwise) within
    # its own 10 % of the dot count
    assert abs(ref - expect) / expect < 0.10


def test_step_stats_fields_and_transcendentals():
    a = torch.from_numpy(np.random.default_rng(2).normal(
        size=(128, 128)).astype(np.float32))
    out, st = OA.analyze_step(lambda t: torch.tanh(t).sum(), a)
    assert st.flops > 0 and st.bytes_accessed > 0
    assert st.transcendentals >= 128 * 128
    assert st.collectives.total_bytes == 0
    assert st.collectives.total_count == 0
    assert st.argument_bytes == 128 * 128 * 4
    assert st.output_bytes == 4 and float(out) == float(torch.tanh(a).sum())
    assert st.temp_bytes >= 128 * 128 * 4
    d = st.as_dict()
    for key in ("collective_bytes_by_kind", "flops", "flops_by_class",
                "by_kernel", "flop_counter_flops", "temp_bytes"):
        assert key in d


def test_views_are_free_and_slice_writes_cost_twice_the_region():
    cache = torch.zeros(4, 64, 8)
    val = torch.ones(4, 1, 8)

    def write(c, v):
        c[:, 5:6] = v
        return c.transpose(0, 1)
    _, st = OA.analyze_step(write, cache, val)
    assert st.bytes_accessed == 2 * val.numel() * 4
    assert st.flops == 0 and st.temp_bytes == 0


def test_collectives_under_the_fake_process_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        t = torch.ones(8, 16)
        _, st = OA.analyze_step(dist.all_reduce, t)
    finally:
        dist.destroy_process_group()
    assert st.collectives.bytes_by_kind == {"all-reduce": 8 * 16 * 4}
    assert st.collectives.count_by_kind == {"all-reduce": 1}
    assert set(st.collectives.bytes_by_kind) <= set(RH._COLLECTIVES)


def test_kernel_scope_replaces_the_ops_inside():
    a = torch.ones(64, 64)
    with OA.OpCounter() as counter:
        with OA.kernel_scope("k", 100.0, 10.0, "int8"):
            with OA.kernel_scope("inner", 7.0, 7.0, "bf16"):
                a @ a
        a + a
    st = counter.stats()
    assert st.by_kernel == {"k": {"flops": 100.0, "bytes": 10.0,
                                  "calls": 1}}
    assert st.flops_by_class == {"int8": 100.0, "bf16": 0.0,
                                 "fp32_dot": 0.0, "fp32": 64 * 64}
    assert st.bytes_accessed == 10.0 + 3 * 64 * 64 * 4
    assert OA.active() is None


# ------------------------------------------------------------ kernel costs

def _layer(cost, m):
    return [sum(c * cost(m, k, n)[i] for (k, n), c in LAYER_PROJ.items())
            for i in (0, 1)]


def test_kernel_costs_reproduce_perf_bounds():
    """The bounds of PERF.md's kernel table, from the kernels' cost()."""
    # flash bf16 at (1, 24, 4096, 128) causal: 1.031e11 FLOP, 0.1043 ms
    flops, nbytes, cls = T_flash.cost(1, 24, 4096, 4096, 128, causal=True,
                                      window=None, dtype=torch.bfloat16)
    assert flops == 4 * 128 * 24 * 4096 * 4097 // 2 and cls == "bf16"
    assert f"{flops:.4g}" == "1.031e+11"
    assert round(flops / H100.peak_bf16_flops * 1e3, 4) == 0.1043
    assert nbytes == 4 * 24 * 4096 * 128 * 2
    # float32: the 3xTF32 route's class, 0.6253 ms
    flops32, _, cls32 = T_flash.cost(1, 24, 4096, 4096, 128, causal=True,
                                     window=None, dtype=torch.float32)
    assert cls32 == "fp32_dot" and flops32 == flops
    assert round(flops32 / H100.peak("fp32_dot") * 1e3, 4) == 0.6253
    # decode at b 4, kvh 8, rep 3, hd 128, S 4096, every key live:
    # 0.01035 ms of bytes
    ops_, nbytes, cls = T_dec.cost(4, 8, 3, 128, [4096] * 4)
    assert cls == "int8" and ops_ == 4 * 4 * 8 * 3 * 4096 * 128
    assert nbytes == (4 * 8 * 3 * (128 + 4) + 2 * 4 * 4096 * 8 * (128 + 4)
                      + 4 * 4 + 4 * 4 * 8 * 3 * 128)
    assert round(nbytes / H100.hbm_bw * 1e3, 5) == 0.01035
    # W8A8 over one phi4-mini layer: m 4096 ops-bound 0.4167 ms, m 4
    # bytes-bound 0.03025 ms
    ops_tc, _ = _layer(T_w8a8.cost, 4096)
    assert round(ops_tc / H100.peak_int8_ops * 1e3, 4) == 0.4167
    _, bytes_dp4a = _layer(T_w8a8.cost, 4)
    assert round(bytes_dp4a / H100.hbm_bw * 1e3, 5) == 0.03025
    # W4A8 at m 4: 0.01522 ms of bytes
    _, bytes_w4 = _layer(T_w4a8.cost, 4)
    assert round(bytes_w4 / H100.hbm_bw * 1e3, 5) == 0.01522


@pytest.mark.parametrize("m,k,n", [(1, 96, 40), (3, 130, 257),
                                   (64, 3072, 1024)])
def test_matmul_costs_by_hand(m, k, n):
    assert T_w8a8.cost(m, k, n) == (2.0 * m * k * n, float(
        m * k + k * n + 4 + 4 * n + 4 * m * n), "int8")
    assert T_w8a8.cost(m, k, n, torch.bfloat16)[1] == \
        m * k + k * n + 4 + 4 * n + 2 * m * n
    assert T_w4a8.cost(m, k, n) == (2.0 * m * k * n, float(
        m * k + k * n // 2 + 4 + 4 * n + 4 * m * n), "int8")


@pytest.mark.parametrize("sq,sk,causal,window", [
    (7, 7, True, None), (5, 9, True, None), (9, 9, True, 3),
    (1, 40, False, None), (6, 11, False, 4), (16, 16, True, 16),
    (3, 2, True, None)])
def test_flash_live_pairs_count_the_mask(sq, sk, causal, window):
    mask = T_flash._mask(sq, sk, causal, window, "cpu")
    assert T_flash.live_pairs(sq, sk, causal, window) == int(mask.sum())
    flops, nbytes, _ = T_flash.cost(2, 3, sq, sk, 16, causal=causal,
                                    window=window, dtype=torch.float32)
    assert flops == 4 * 16 * 2 * 3 * int(mask.sum())
    assert nbytes == 2 * (sq + sk) * 2 * 3 * 16 * 4


def test_decode_cost_counts_keys_up_to_each_position():
    live = ops.live_keys(torch.tensor([0, 5, 99, 3], dtype=torch.int32), 4,
                         64)
    assert live == [1, 6, 64, 4]
    assert ops.live_keys(7, 3, 64) == [8, 8, 8]
    ops_, nbytes, _ = T_dec.cost(4, 2, 3, 16, live, out_dtype=torch.bfloat16)
    keys = 1 + 6 + 64 + 4
    assert ops_ == 4 * 2 * 3 * 16 * keys
    assert nbytes == 4 * 2 * 3 * 20 + 2 * keys * 2 * 20 + 16 \
        + 2 * 4 * 2 * 3 * 16
    with FakeTensorMode():
        fake = torch.zeros(4, dtype=torch.int32)
    assert ops.live_keys(fake, 4, 64) == [64] * 4


# --------------------------------------------------------- route invariance

@pytest.fixture
def kernels_everywhere(monkeypatch):
    """``"auto"`` finds every tensor on a kernel device, and the kernel
    wrappers count their calls and return their plain versions."""
    calls = {"flash": 0, "w8a8": 0, "w4a8": 0, "decode": 0}

    def counting(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(ops, "on_card", lambda x: True)
    monkeypatch.setattr(T_flash, "flash_attention",
                        counting("flash", T_flash.flash_attention_ref))
    monkeypatch.setattr(T_w8a8, "w8a8_matmul",
                        counting("w8a8", T_w8a8.w8a8_matmul_ref))
    monkeypatch.setattr(T_w4a8, "w4a8_matmul",
                        counting("w4a8", T_w4a8.w4a8_matmul_ref))
    monkeypatch.setattr(T_dec, "w8a8_decode_attention_body",
                        counting("decode",
                                 T_dec.w8a8_decode_attention_body_ref))
    return calls


def _step_stats(arch, quant, kind, impl, *, fake=False, seq=24, batch=2):
    cfg = dataclasses.replace(reduced(get_config(arch)), quant=quant)
    ctx = FakeTensorMode() if fake else torch.no_grad()
    with ctx:
        model = Model(cfg, device="cpu", impl=impl)
        params = model.init(torch.Generator("cpu").manual_seed(3),
                            quantize=True)
        tokens = torch.randint(0, cfg.vocab, (batch, seq),
                               generator=torch.Generator().manual_seed(4))
        with torch.no_grad():
            if kind == "prefill":
                _, st = OA.analyze_step(
                    lambda p, t: model.forward(p, t, last_only=True)[0],
                    params, tokens)
            else:
                caches = model.init_cache(batch, seq,
                                          kv_quant=kind == "decode_int8")
                _, st = OA.analyze_step(model.decode_step, params, caches,
                                        tokens[:, :1], seq - 1)
    return st.as_dict()


@pytest.mark.parametrize("arch,quant,kind", [
    ("phi4-mini-3.8b", "w8a8", "decode_int8"),
    ("phi4-mini-3.8b", "w8a8", "decode"),
    ("phi4-mini-3.8b", "w4a8_pow2", "decode"),
    ("phi4-mini-3.8b", "w8a8", "prefill"),
    ("gemma3-4b", "w8a8", "prefill"),
    ("moonshot-v1-16b-a3b", "w8a8", "decode_int8")])
def test_step_count_is_the_same_on_every_route(arch, quant, kind, request):
    plain = _step_stats(arch, quant, kind, "ref")
    fake = _step_stats(arch, quant, kind, "auto", fake=True)
    calls = request.getfixturevalue("kernels_everywhere")
    kernel = _step_stats(arch, quant, kind, "auto")
    assert plain == fake
    assert plain == kernel
    matmul = "w4a8" if quant == "w4a8_pow2" else "w8a8"
    assert calls[matmul] > 0
    assert plain["by_kernel"][f"{matmul}_matmul"]["calls"] == calls[matmul]
    if kind == "decode_int8":
        assert calls["decode"] == plain["by_kernel"][
            "w8a8_decode_attention"]["calls"] > 0
    if kind == "prefill":
        assert calls["flash"] == plain["by_kernel"]["flash_attention"][
            "calls"] > 0


def test_under_grad_no_kernel_is_counted(kernels_everywhere):
    cfg = dataclasses.replace(reduced(get_config("phi4-mini-3.8b")),
                              quant="w8a8")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(3))
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int64),
             "labels": torch.ones((2, 8), dtype=torch.int64)}
    leaves = [p.requires_grad_(True) for p in params["layers"][0].values()]

    def step():
        loss = model.loss(params, batch)
        loss.backward()
        return loss
    _, st = OA.analyze_step(step)
    assert st.by_kernel == {} and sum(kernels_everywhere.values()) == 0
    assert st.flops_by_class["bf16"] > 0 and leaves[0].grad is not None


# ----------------------------------------------------------------- dry run

SMALL_SHAPES = {"train": ShapeConfig("t_small", 16, 2, "train"),
                "prefill": ShapeConfig("p_small", 16, 2, "prefill"),
                "decode": ShapeConfig("d_small", 16, 2, "decode")}


@pytest.fixture
def reduced_cells(monkeypatch):
    """The dry run on the reduced configs and small shapes."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: reduced(get_config(arch)))
    monkeypatch.setattr(dryrun, "ONE_CARD_SHAPES",
                        {s.name: s for s in SMALL_SHAPES.values()})


FAMILY_ARCHS = ("phi4-mini-3.8b", "moonshot-v1-16b-a3b",
                "mamba2-130m", "zamba2-1.2b", "llama-3.2-vision-90b",
                "whisper-medium")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_dry_run_of_each_family(arch, kind, reduced_cells, tmp_path):
    shape = SMALL_SHAPES[kind]
    rec = dryrun.run_cell(arch, shape.name, serve_quant=kind != "train",
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    ref_cfg = ref_reduced(ref_get_config(arch))
    n = ref_cfg.n_active_params()
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    want = (6.0 if kind == "train" else 2.0) * n * tokens
    assert rec["roofline"]["model_flops"] == want
    assert rec["mesh"] == "1" and rec["roofline"]["chips"] == 1
    assert json.loads((tmp_path / f"{arch}__{shape.name}__1__quant.json"
                       if kind != "train" else
                       tmp_path / f"{arch}__{shape.name}__1.json")
                      .read_text())["status"] == "ok"
    st = rec["stats"]
    assert st["flops"] > 0 and st["temp_bytes"] > 0
    if kind == "train":
        assert st["by_kernel"] == {}
    elif reduced(get_config(arch)).quant in ("w8a8", "w4a8_pow2"):
        assert st["by_kernel"]["w8a8_matmul"]["calls"] > 0


def test_dry_run_train_options(reduced_cells):
    base = dryrun.run_cell("phi4-mini-3.8b", "t_small", out_dir=None)
    mb = dryrun.run_cell("phi4-mini-3.8b", "t_small", microbatch=2,
                         out_dir=None)
    wo = dryrun.run_cell("phi4-mini-3.8b", "t_small", weight_only_qat=True,
                         out_dir=None)
    bf = dryrun.run_cell("phi4-mini-3.8b", "t_small", bf16_params=True,
                         out_dir=None)
    for rec in (base, mb, wo, bf):
        assert rec["status"] == "ok", rec.get("traceback")
    assert mb["variant"] == "__mb2" and wo["variant"] == "__woqat"
    # weight-only QAT drops the activations' fake quantization
    assert wo["stats"]["flops"] < base["stats"]["flops"]
    assert bf["stats"]["flops_by_class"]["bf16"] \
        == base["stats"]["flops_by_class"]["bf16"]


def test_full_width_decode_cell_fits_and_counts_every_layer():
    rec = dryrun.run_cell("phi4-mini-3.8b", "decode_4k", serve_quant=True,
                          kv_quant=True, out_dir=None)
    assert rec["status"] == "ok"
    k = rec["stats"]["by_kernel"]
    assert k["w8a8_matmul"]["calls"] == 32 * 7
    assert k["w8a8_decode_attention"]["calls"] == 32
    # every key of the 4096-position cache is read: pos = 4095
    assert k["w8a8_decode_attention"]["flops"] == 32 * T_dec.cost(
        4, 8, 3, 128, [4096] * 4)[0]
    assert rec["memory_analysis"]["fits_hbm"]
    assert rec["roofline"]["bottleneck"] == "memory"


def test_skip_reason_matches_reference():
    code = (
        "import json\n"
        "from repro.launch import dryrun\n"
        "from repro.configs import ALL_ARCHS, get_config\n"
        "from repro.configs.base import SHAPES\n"
        "print(json.dumps({f'{a}|{s}': dryrun.skip_reason(get_config(a), "
        "SHAPES[s]) for a in ALL_ARCHS for s in SHAPES}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT),
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = {f"{a}|{s}": dryrun.skip_reason(get_config(a), SHAPES[s])
           for a in ALL_ARCHS for s in SHAPES}
    assert got == want
    assert sum(v is not None for v in got.values()) > 0


@pytest.mark.parametrize("kwargs,mesh", [(dict(multi_pod=True), "2x16x16"),
                                         (dict(kv_seq_shard=True), "16x16")])
def test_pod_mesh_records(kwargs, mesh):
    """``multi_pod`` and ``kv_seq_shard`` place the cell on the
    reference's pod mesh: a record of each card's argument bytes, and no
    count, collective bytes or roofline (the port has no sharded step
    under the op counter: ROADMAP A.11)."""
    rec = dryrun.run_cell("phi4-mini-3.8b", "decode_4k", out_dir=None,
                          **kwargs)
    assert rec["status"] == "placed" and rec["mesh"] == mesh
    mem = rec["memory_analysis"]
    assert 0 < mem["argument_bytes"] <= mem["hbm_bytes"] and mem["fits_hbm"]
    assert rec["stats"] is None and rec["collective_bytes"] is None
    assert rec["roofline"] is None and "A.11" in rec["absent"]
    one_card = dryrun.run_cell("phi4-mini-3.8b", "decode_4k", out_dir=None)
    # params, caches and batch of the one-card cell, spread over the pod
    assert mem["argument_bytes"] \
        < one_card["memory_analysis"]["argument_bytes"]


def test_refusals():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.run_cell("phi4-mini-3.8b", "decode_4k", measure=True,
                        out_dir=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.run_cell("phi4-mini-3.8b", "decode_4k", device="cuda",
                        out_dir=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.build_cell("phi4-mini-3.8b", "decode_4k")


def test_skipped_record_and_roofline_bench_reads_the_records(
        reduced_cells, tmp_path, monkeypatch):
    skipped = dryrun.run_cell("phi4-mini-3.8b", "long_500k",
                              out_dir=str(tmp_path))
    assert skipped["status"] == "skipped"
    dryrun.main(["--arch", "mamba2-130m", "--shape", "d_small", "--quant",
                 "--out", str(tmp_path)])
    spec = importlib.util.spec_from_file_location(
        "roofline_bench", ROOT / "benchmarks" / "roofline_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    monkeypatch.setattr(bench, "DRYRUN_DIR", str(tmp_path))
    rows = bench.run()
    assert not any(note == "ERROR" for _, _, note in rows)
    assert rows[-1] == ("roofline/summary", 0.0,
                        "ok=1;skipped=1;failed=0")


# ------------------------------------------------- C.15: the reference's pins

def test_c15a_reference_fraction_divides_by_v5e_whatever_chip():
    st = RH.CompiledStats(
        flops=1e12, bytes_accessed=1e9, transcendentals=0,
        collectives=RH.CollectiveStats({}, {}), xla_flops=0, xla_bytes=0,
        argument_bytes=0, output_bytes=0, temp_bytes=0,
        generated_code_bytes=0)
    fast = RR.ChipSpec(name="twice",
                       peak_bf16_flops=2 * RR.V5E.peak_bf16_flops)
    kw = dict(arch="a", shape="s", mesh="m", chips=1, model_flops=1e12)
    ref = RR.roofline_from_stats(st, chip=fast, **kw)
    # compute_s reads the chip it was given, the fraction reads the v5e
    assert ref.compute_s == 1e12 / fast.peak_bf16_flops
    assert ref.roofline_fraction == 1e12 / ref.step_time_s \
        / RR.V5E.peak_bf16_flops
    port = GR.roofline_from_stats(
        OA.StepStats(flops=1e12, flops_by_class={"bf16": 1e12},
                     bytes_accessed=1e9, transcendentals=0,
                     collectives=OA.CollectiveStats({}, {}), by_kernel={},
                     flop_counter_flops=0, argument_bytes=0, output_bytes=0,
                     temp_bytes=0),
        chip=dataclasses.replace(V5E_AS_PORT,
                                 peak_bf16_flops=fast.peak_bf16_flops), **kw)
    assert port.roofline_fraction == 1e12 / port.step_time_s \
        / fast.peak_bf16_flops
    assert port.roofline_fraction == ref.roofline_fraction / 2


PALLAS_HLO = """HloModule pallas

ENTRY %main.3 (Arg_0.1: s8[4096,3072], Arg_1.2: s8[3072,3072]) -> f32[4096,3072] {
  %Arg_0.1 = s8[4096,3072]{1,0} parameter(0)
  %Arg_1.2 = s8[3072,3072]{1,0} parameter(1)
  ROOT %custom-call.3 = f32[4096,3072]{1,0} custom-call(s8[4096,3072]{1,0} %Arg_0.1, s8[3072,3072]{1,0} %Arg_1.2), custom_call_target="tpu_custom_call", backend_config={"custom_call_config": {"body": "..."}}
}
"""


def test_c15b_reference_counts_a_pallas_call_as_zero_flops():
    mc = RH.analyze_hlo_text(PALLAS_HLO)
    assert mc.flops == 0.0
    # its bytes are counted at the call site: operands and result
    assert mc.bytes_accessed == 4096 * 3072 + 3072 * 3072 \
        + 4 * 4096 * 3072
    # the port counts the same product at its kernel's declared cost
    assert T_w8a8.cost(4096, 3072, 3072)[0] == 2.0 * 4096 * 3072 * 3072
