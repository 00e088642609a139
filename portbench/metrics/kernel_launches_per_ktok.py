"""``kernel_launches_per_ktok`` (kernels/ops dispatch): kernels run on
the device a 1000 prompt tokens of the window."""


def read(ctx):
    tokens = sum(ctx.lengths)
    runs = ctx.trace.kernels()
    if not tokens or not runs:
        return None
    return 1000.0 * len(runs) / tokens
