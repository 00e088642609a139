"""``flash_roofline`` (kernels/flash_attention): the least time of the
window's causal self-attentions (live pairs' FLOPs at the bf16 peak, or
q, k, v and o once at HBM's rate) over the device time of
``flash_tc_kernel``, in %.  Nothing where its launches are not one an
attention."""

from portbench.roofline import flash_tc, forward


def read(ctx):
    calls = [c for s in ctx.lengths for c in forward.attentions(ctx.model, s)]
    runs = ctx.trace.kernels(flash_tc.KERNEL)
    if not runs or len(runs) != len(calls):
        return None
    least = sum(flash_tc.least_s(*c) for c in calls)
    return 100.0 * least / (sum(b - a for _, a, b in runs) / 1e9)
