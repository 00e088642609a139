"""``tools/spans.py``'s shares on a canned trace: the PyTorch kernels
each span launched, over the window's kernel time."""

import importlib.util
import sys

import pytest

from conftest import ROOT
from portbench.harness import devtrace, main
from repro_torch.obs.attribution import Kernel, WallSpan

W4 = "void (anonymous namespace)::w4a8_tc_kernel<true>(signed char const*)"
EW = "void at::native::vectorized_elementwise_kernel<4, float>(int, float)"
PORT = frozenset({"w4a8_tc_kernel"})


@pytest.fixture(scope="module")
def tool():
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "portbench_tool_spans", ROOT / "portbench" / "tools" / "spans.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def canned():
    """One forward (root 1) from 0 to 1000 and a span of another root:
    each named span launches one 10 ns PyTorch kernel, the serve_dot a
    100 ns W4A8 kernel too, and one 20 ns kernel is launched outside every
    span."""
    spans = [WallSpan("model.forward", 0, 1000, 1, 1),
             WallSpan("model.layer", 10, 900, 2, 1),
             WallSpan("attn.self", 20, 400, 3, 1),
             WallSpan("qlinear.serve_dot", 30, 100, 4, 1),
             WallSpan("qlinear.act_quant", 35, 50, 5, 1),
             WallSpan("qlinear.out_cast", 80, 90, 6, 1),
             WallSpan("common.rope", 150, 200, 7, 1),
             WallSpan("common.rms_norm", 500, 600, 8, 1),
             WallSpan("sweep.pull", 2000, 3000, 9, 9)]
    launches = [(EW, 10, 40), (W4, 100, 60), (EW, 10, 85), (EW, 10, 160),
                (EW, 10, 300), (EW, 10, 550), (EW, 10, 700), (EW, 10, 5),
                (EW, 20, 1500), (EW, 10, 2500)]
    runs, t = [], 10_000
    for name, dur, launch in launches:
        runs.append(Kernel(name, t, t + dur, launch))
        t += dur + 5
    return spans, runs


def test_shares_split_the_pytorch_kernels_by_span(tool):
    spans, runs = canned()
    total = sum(k.seconds for k in runs)     # 210 ns
    got = tool.shares(runs, spans, PORT)
    one = 100 * 10e-9 / total
    assert got == pytest.approx({
        "act_quant_share": one, "qlinear_cast_share": one,
        "rope_share": one, "attn_glue_share": one, "norm_share": one,
        # the layer's kernel and the forward's own: outside the others
        "block_rest_share": 2 * one})
    # torch_op_share also counts what no forward launched
    trace = devtrace.DeviceTrace(
        ops=[("kernel", k.name, k.start_ns, k.end_ns) for k in runs],
        window=(0, 20_000))
    ctx = devtrace.TraceContext(model=None, lengths=[1], request_s=[1.0],
                                trace=trace, port_kernels=PORT)
    theirs = main.load_reader("torch_op_share")(ctx)
    assert sum(got.values()) == pytest.approx(theirs - 100 * 30e-9 / total)


def test_shares_move_only_where_a_launch_crosses_a_span(tool):
    spans, runs = canned()
    base = tool.shares(runs, spans, PORT)
    assert tool.shares(runs, spans, PORT, shift_ns=4) == pytest.approx(base)
    moved = tool.shares(runs, spans, PORT, shift_ns=12)   # 40 -> 52
    assert moved["act_quant_share"] == 0.0


def test_share_of_needs_a_forward_root(tool):
    spans, _ = canned()
    roots = {1: "model.forward", 9: "sweep.pull"}
    assert tool.share_of(spans[4], roots) == "act_quant_share"
    assert tool.share_of(spans[3], roots) == "block_rest_share"
    assert tool.share_of(spans[8], roots) is None
    assert tool.share_of(None, roots) is None
