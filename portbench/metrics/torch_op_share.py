"""``torch_op_share`` (quant/qlinear and models/common glue): the share
of the window's kernel time spent in PyTorch's own kernels (elementwise
ops, casts, reductions, library GEMMs) rather than the program's
hand-written ones, in %."""

from portbench.harness.devtrace import kernel_id


def read(ctx):
    runs = ctx.trace.kernels()
    total = sum(b - a for _, a, b in runs)
    if not total:
        return None
    theirs = sum(b - a for n, a, b in runs
                 if kernel_id(n) not in ctx.port_kernels)
    return 100.0 * theirs / total
