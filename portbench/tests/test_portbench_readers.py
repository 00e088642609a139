"""Each per-layer metric's reader on a canned device trace, and the
trace's own reductions."""

import pytest

from conftest import ROOT
from portbench.harness import devtrace, main
from portbench.harness.spec import ModelShape
from portbench.roofline import flash_tc, w4a8_tc, w8a8_tc

SHAPE = ModelShape("canned", 2, 256, 2, 1, 128, 512, 1000, "swiglu",
                   "w4a8_pow2", 1e4, 1e-6)
W4 = "void (anonymous namespace)::w4a8_tc_kernel<true>(signed char const*)"
FL = "void (anonymous namespace)::flash_tc_kernel<128>(__nv_bfloat16 const*)"
EW = "void at::native::vectorized_elementwise_kernel<4, float>(int, float)"
PORT = frozenset({"w4a8_tc_kernel", "flash_tc_kernel", "w8a8_tc_kernel"})


def canned(lengths=(100, 300)):
    """Two requests: per layer 7 W4A8 launches of 10 us, one flash of 20
    us, 5 elementwise kernels of 2 us, 1 us apart; then a 5 us copy and
    a 100 us gap before the next request."""
    ops, spans, t = [], [], 1_000_000
    for _ in lengths:
        begin = t
        for _layer in range(SHAPE.n_layers):
            for name, dur in [(W4, 10_000)] * 7 + [(FL, 20_000)] \
                    + [(EW, 2_000)] * 5:
                ops.append(("kernel", name, t, t + dur))
                t += dur + 1_000
        spans.append(("forward_enqueue", begin, t - 1_000))
        ops.append(("gpu_memcpy", "Memcpy DtoH", t, t + 5_000))
        spans.append(("sync_readback", t - 1_000, t + 6_000))
        t += 105_000
    trace = devtrace.DeviceTrace(ops=ops, window=(1_000_000, t), spans=spans)
    return devtrace.TraceContext(model=SHAPE, lengths=list(lengths),
                                 request_s=[0.5, 0.5], trace=trace,
                                 port_kernels=PORT)


def read(name, ctx):
    return main.load_reader(name)(ctx)


def test_w4a8_roofline():
    ctx = canned()
    least = sum(w4a8_tc.least_s(s, k, n) for s in (100, 300)
                for _ in range(2) for _, k, n in SHAPE.projections)
    assert read("w4a8_tc_roofline", ctx) == pytest.approx(
        100 * least / (2 * 2 * 7 * 10e-6))
    assert read("w8a8_tc_roofline", ctx) is None       # not this mode


def test_roofline_silent_where_launches_do_not_match():
    ctx = canned()
    ctx.trace.ops = [o for o in ctx.trace.ops if o[1] != W4][:-3] + \
        [o for o in ctx.trace.ops if o[1] == W4][1:]
    assert read("w4a8_tc_roofline", ctx) is None
    ctx.trace.ops = [o for o in ctx.trace.ops if o[1] != FL]
    assert read("flash_roofline", ctx) is None


def test_w8a8_roofline():
    ctx = canned()
    ctx.model = ModelShape(**{**SHAPE.__dict__, "quant": "w8a8"})
    ctx.trace.ops = [(k, n.replace("w4a8", "w8a8"), a, b)
                     for k, n, a, b in ctx.trace.ops]
    least = sum(w8a8_tc.least_s(s, k, n) for s in (100, 300)
                for _ in range(2) for _, k, n in SHAPE.projections)
    assert read("w8a8_tc_roofline", ctx) == pytest.approx(
        100 * least / (2 * 2 * 7 * 10e-6))


def test_flash_roofline():
    least = 2 * sum(flash_tc.least_s(s, 2, 1, 128) for s in (100, 300))
    assert read("flash_roofline", canned()) == pytest.approx(
        100 * least / (4 * 20e-6))


def test_prefill_mfu():
    from portbench.roofline import qmatmul
    ctx = canned()
    least = 0.0
    for s in (100, 300):
        least += 2 * sum(qmatmul.ops(s, k, n)
                         for _, k, n in SHAPE.projections) / 1979e12
        least += (2 * flash_tc.flops(s, 2, 128) + 2 * 256 * 1000) / 989e12
    assert read("prefill_mfu", ctx) == pytest.approx(100 * least / 1.0)


def test_torch_op_share():
    # per layer 7 x 10 + 20 us the port's, 5 x 2 us PyTorch's
    assert read("torch_op_share", canned()) == pytest.approx(
        100 * 10 / 100)


def test_kernel_launches_per_ktok():
    assert read("kernel_launches_per_ktok", canned()) == pytest.approx(
        1000 * 2 * 2 * 13 / 400)


def test_device_idle_share():
    ctx = canned()
    busy = 2 * (2 * (7 * 10 + 20 + 5 * 2) + 5) * 1e-6
    window = (ctx.trace.window[1] - ctx.trace.window[0]) / 1e9
    assert ctx.trace.busy_s() == pytest.approx(busy)
    assert read("device_idle_share", ctx) == pytest.approx(
        100 * (1 - busy / window))


def test_readers_find_nothing_in_an_empty_trace():
    ctx = canned()
    ctx.trace.ops = []
    for name in ("w4a8_tc_roofline", "w8a8_tc_roofline", "flash_roofline",
                 "torch_op_share", "kernel_launches_per_ktok",
                 "device_idle_share"):
        assert read(name, ctx) is None, name


def test_idle_gaps_named_by_host_span():
    ctx = canned()
    idle = ctx.trace.idle_by_span()
    # inside each forward 2 x 13 - 1 one-us gaps, and before the copy 1 us
    assert idle["forward_enqueue"] == pytest.approx(2 * (2 * 13 - 1) * 1e-6)
    assert set(idle) == {"forward_enqueue", "sync_readback", "between_spans"}
    # and the copy's 1 us of the readback span after it
    assert idle["sync_readback"] == pytest.approx(2 * 2e-6)
    assert idle["between_spans"] == pytest.approx(2 * 99e-6)
    bd = devtrace.breakdown(ctx.trace)
    assert bd["device_ops"][0] == ["w4a8_tc_kernel", pytest.approx(280e-6)]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_kernel_ids():
    assert devtrace.kernel_id(W4) == "w4a8_tc_kernel"
    assert devtrace.kernel_id(EW) == "vectorized_elementwise_kernel"
    assert devtrace.kernel_id("ampere_bf16_s16816gemm_bf16_128x64") == \
        "ampere_bf16_s16816gemm_bf16_128x64"


def test_port_kernel_names_from_its_sources():
    names = devtrace.port_kernel_names(
        ROOT / "src" / "repro_torch" / "kernels" / "csrc")
    assert {"w4a8_tc_kernel", "w8a8_tc_kernel", "flash_tc_kernel",
            "w4a8_splitk_kernel", "w8a8_dp4a_kernel"} <= names
    assert "vectorized_elementwise_kernel" not in names
