"""``device_idle_share`` (device): the share of the traced window in
which no kernel, copy or fill runs on the card, in %."""


def read(ctx):
    if not ctx.trace.ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
