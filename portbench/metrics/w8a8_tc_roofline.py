"""``w8a8_tc_roofline`` (kernels/w8a8_matmul): the least time of the
window's W8A8 projections, worked out from their shapes, over the
device time of ``w8a8_tc_kernel``, in %.  Nothing where the model is not
W8A8, or where the kernel's launches are not one a projection."""

from portbench.roofline import forward, w8a8_tc


def read(ctx):
    if ctx.model.quant != w8a8_tc.MODE:
        return None
    calls = [c for s in ctx.lengths for c in forward.projections(ctx.model, s)]
    runs = ctx.trace.kernels(w8a8_tc.KERNEL)
    if not runs or len(runs) != len(calls):
        return None
    least = sum(w8a8_tc.least_s(*c) for c in calls)
    return 100.0 * least / (sum(b - a for _, a, b in runs) / 1e9)
