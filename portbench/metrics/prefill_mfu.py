"""``prefill_mfu`` (models/model): the whole forward's share of the
card's peak, in %: the projections' int8 operations at the int8 peak
plus the attentions' live-pair FLOPs and the last position's logits at
the bf16 peak, over the requests' send-to-logits seconds."""

from portbench.roofline import flash_tc, forward, peaks, qmatmul


def read(ctx):
    if not ctx.lengths:
        return None
    least = 0.0
    for s in ctx.lengths:
        least += sum(qmatmul.ops(*c) for c in
                     forward.projections(ctx.model, s)) / peaks.INT8_OPS
        least += (sum(flash_tc.flops(sa, h, hd) for sa, h, _, hd in
                      forward.attentions(ctx.model, s))
                  + forward.logits_flops(ctx.model)) / peaks.BF16_FLOPS
    return 100.0 * least / sum(ctx.request_s)
