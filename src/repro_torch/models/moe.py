"""Top-k mixture of experts with the reference's sort-based dispatch.

The port of ``repro.models.moe``: tokens are routed to their top-k
experts, sorted by expert, and scattered into an equal-capacity ``(E, C,
d)`` buffer (MegaBlocks-style, not GShard one-hot einsums); the three
expert products run as batched matrix products over that buffer, and
each token's contributions are gathered back, weighted by its gates and
summed.  Entries past an expert's capacity ``C`` are dropped.

The router runs in float32.  Top-k breaks ties to the lower expert index,
as ``jax.lax.top_k`` does.  The sort is stable, so capacity goes to the
lowest token index first: one row's output can depend on the other rows
of the batch, as in the reference (ROADMAP C.9).  The combine sums each
token's contributions one at a time in the order of the sorted entries
(ascending expert id), rounding to the compute dtype after each add, as
XLA's ``segment_sum`` scatters them: no atomics, so the result is the
same on every run and device route.

The reference's expert-parallel ``moe_ffn_ep`` (a ``shard_map`` over the
mesh's "model" axis) falls back to ``moe_ffn`` without a mesh; the port
runs on one card and has :func:`moe_ffn` alone.  The expert products are
plain PyTorch on both routes, as the reference's are XLA outside any
Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.quant.qlinear import qat_act, qat_weight


def topk_route(x: torch.Tensor, w_router: torch.Tensor, n_experts: int,
               top_k: int):
    """x: (T, d) -> (gates (T, k) float32, experts (T, k) int64, the
    Switch-style load-balance loss)."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    # a stable descending sort keeps equal probabilities in index order:
    # jax.lax.top_k's tie order, which torch.topk does not promise
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = top[:, :top_k], idx[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # E * sum(fraction of tokens whose first choice is e * mean prob of e)
    me = torch.mean(probs, dim=0)
    # the one-hot of the first choices as a comparison: F.one_hot runs
    # other ops on the CPU (a range check), the card and fake tensors
    first = experts[:, :1] == torch.arange(n_experts, device=x.device)
    ce = torch.mean(first.to(torch.float32), dim=0)
    aux = n_experts * torch.sum(me * ce)
    return gates, experts, aux


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """The reference's per-expert capacity ``C``."""
    return int(max(1, -(-n_tokens * top_k // n_experts) * capacity_factor))


def dispatch(experts: torch.Tensor, n_experts: int, cap: int):
    """The sort-based dispatch of the flat ``(T * k,)`` entries: the
    stable order by expert, each entry's row in the flat ``(E * C)``
    buffer (``E * C``, a spare row, for the dropped) and the kept mask,
    all in sorted order."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    # the reference's bincount / cumsum starts: the first index of each
    # expert in the sorted ids
    starts = torch.searchsorted(
        se, torch.arange(n_experts, device=se.device, dtype=se.dtype))
    pos = torch.arange(se.numel(), device=se.device) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, n_experts * cap)
    return order, slot, keep


def expert_ffn(buf: torch.Tensor, p: dict, policy, train: bool):
    """The experts' SwiGLU over the (E, C, d) buffer in the compute
    dtype: ``"ecd,edf->ecf"`` for gate and in, ``"ecf,efd->ecd"`` out.
    Under QAT (``train`` and a quantized policy) the gate and in products
    fake-quantize the buffer per tensor and each expert's weight per
    output channel (``axis=1`` of (E, d, ff)); the out product does not,
    as in the reference's ``edot``."""
    cd = policy.compute_dtype

    def edot(a, w):
        if train and policy.quantized:
            a = qat_act(a, policy)
            w = qat_weight(w, policy, axis=1)
        return torch.bmm(a.to(cd), w.to(cd))
    g = edot(buf, p["w_experts_gate"])
    u = edot(buf, p["w_experts_in"])
    h = F.silu(g) * u
    return torch.bmm(h.to(cd), p["w_experts_out"].to(cd))


def combine(out_buf: torch.Tensor, order: torch.Tensor, slot: torch.Tensor,
            keep: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Each token's k contributions, gathered from the flat buffer,
    masked and weighted by their gates in the buffer's dtype, then summed
    from zero in the order of the sorted entries, one rounded add at a
    time (XLA's bf16 ``segment_sum``)."""
    n_tok, k = gates.shape
    rows = out_buf.reshape(-1, out_buf.shape[-1])
    gathered = rows[torch.where(keep, slot, 0)].masked_fill(
        ~keep[:, None], 0)
    weighted = gathered * gates.reshape(-1)[order][:, None] \
        .to(gathered.dtype)
    # where each token's entries sit among the sorted ones, in that order
    at = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    at = torch.sort(at.view(n_tok, k), dim=1).values
    out = torch.zeros((n_tok, rows.shape[-1]), dtype=weighted.dtype,
                      device=weighted.device)
    for j in range(k):
        out = out + weighted[at[:, j]]
    return out


def moe_ffn(x: torch.Tensor, p: dict, cfg, *, policy, train: bool,
            capacity_factor: float = 1.25):
    """x: (b, s, d) -> ((b, s, d), aux).  p: ``router`` (d, E),
    ``w_experts_gate`` / ``w_experts_in`` (E, d, ff), ``w_experts_out``
    (E, ff, d)."""
    b, s, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xf = x.reshape(b * s, d)
    gates, experts, aux = topk_route(xf, p["router"], E, K)
    cap = capacity(b * s, E, K, capacity_factor)
    order, slot, keep = dispatch(experts, E, cap)
    # scatter the kept entries into the (E, C, d) buffer; the dropped
    # ones all land on the spare row E * C, cut off after
    buf = torch.zeros((E * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, slot, xf[order // K])
    out_buf = expert_ffn(buf[:E * cap].view(E, cap, d), p, policy, train)
    out = combine(out_buf, order, slot, keep, gates)
    return out.reshape(b, s, d).to(x.dtype), aux
