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

:func:`moe_ffn_ep` is the reference's expert parallelism on
``torch.distributed`` ranks: inside :func:`~repro_torch.parallel
.sharding.activation_sharding` on a mesh with a "model" axis each rank
routes its data slice of the tokens to its own ``E / n_model`` experts
and one float32 all-reduce over "model" sums the contributions; without
a mesh, or when the experts do not divide, it is :func:`moe_ffn`, as in
the reference.  The expert products are plain PyTorch on every route, as
the reference's are XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel.sharding import shard
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
    buf = shard(buf[:E * cap].view(E, cap, d), "moe_buffer")
    out_buf = shard(expert_ffn(buf, p, policy, train), "moe_buffer")
    out = combine(out_buf, order, slot, keep, gates)
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_ffn_ep(x, p: dict, cfg, *, policy, train: bool,
               capacity_factor: float = 1.25):
    """Expert-parallel MoE over the activation context's mesh (the
    reference's ``shard_map`` body, one rank per device).

    Each rank takes its data slice of the tokens (``x`` and ``p`` whole
    on every rank), routes them over all ``E`` experts, and
    dispatches the entries of its local experts ``[e0, e0 + E / n_model)``
    into a ``(E / n_model, C, d)`` buffer, ``C`` the capacity of its
    ``T`` tokens, in a stable order with the other ranks' entries last.
    It runs the local expert products, gathers, weights and sums each
    token's entries, and one float32 all-reduce over the "model" group
    sums the ranks' contributions; ``aux`` is averaged over the data
    axes, and the output gathered whole over them on every rank.

    Without a mesh, without a "model" axis, or when ``E`` does not divide
    over it, this is :func:`moe_ffn`.
    """
    from repro_torch.launch.mesh import (all_gather_group, all_reduce_sum,
                                         mesh_sizes)
    from repro_torch.parallel.sharding import _mesh, data_axes
    mesh = _mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return moe_ffn(x, p, cfg, policy=policy, train=train,
                       capacity_factor=capacity_factor)
    E, K = cfg.n_experts, cfg.top_k
    sizes = mesh_sizes(mesh)
    n_model = sizes["model"]
    if E % n_model != 0:
        return moe_ffn(x, p, cfg, policy=policy, train=train,
                       capacity_factor=capacity_factor)
    db = data_axes(mesh)
    if ops.sharded(x):
        return _moe_ffn_ep_dtensor(x, p, cfg, db, policy, train,
                                   capacity_factor)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    n_data, data_idx = 1, 0
    for a in db:                         # major to minor
        n_data *= sizes[a]
        data_idx = data_idx * sizes[a] + coord[a]
    if x.shape[0] % n_data:
        raise ValueError(f"moe_ffn_ep: batch {x.shape[0]} does not divide "
                         f"over the data axes {db} ({n_data})")
    b_l = x.shape[0] // n_data
    x_l = x.narrow(0, data_idx * b_l, b_l)
    e_l = E // n_model
    e0 = coord["model"] * e_l
    local_p = {k: p[k].narrow(0, e0, e_l)
               for k in ("w_experts_gate", "w_experts_in", "w_experts_out")}

    out, aux = _ep_local(x_l, p["router"], local_p, e0, e_l, cfg, policy,
                         train, capacity_factor)
    out = all_reduce_sum(out, mesh.get_group("model"))
    for a in db:
        aux = all_reduce_sum(aux, mesh.get_group(a))
    aux = aux / n_data
    out = out.reshape(x_l.shape).to(x_l.dtype)
    for a in reversed(db):               # minor first: major-to-minor order
        out = all_gather_group(out, mesh.get_group(a))
    return out, aux


def _ep_local(x_l, router, local_p, e0: int, e_l: int, cfg, policy, train,
              capacity_factor):
    """One rank's part of :func:`moe_ffn_ep`: its tokens ``x_l`` routed
    over all experts, the entries of experts ``[e0, e0 + e_l)`` dispatched,
    run and combined; returns (the float32 contributions, the tokens'
    aux)."""
    E, K = cfg.n_experts, cfg.top_k
    b_l, s, d = x_l.shape
    T = b_l * s
    xf = x_l.reshape(T, d)
    gates, experts, aux = topk_route(xf, router, E, K)
    flat = experts.reshape(-1)
    local = (flat >= e0) & (flat < e0 + e_l)
    le = torch.where(local, flat - e0, torch.full_like(flat, e_l))
    order = torch.argsort(le, stable=True)           # non-local last
    se = le[order]
    starts = torch.searchsorted(
        se, torch.arange(e_l, device=se.device, dtype=se.dtype))
    kept_local = se < e_l
    pos = torch.arange(se.numel(), device=se.device) \
        - torch.where(kept_local, starts[se.clamp(max=e_l - 1)], 0)
    cap = capacity(T, E, K, capacity_factor)
    keep = kept_local & (pos < cap)
    slot = torch.where(keep, se * cap + pos, e_l * cap)
    buf = torch.zeros((e_l * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, slot, xf[order // K])
    out_buf = expert_ffn(buf[:e_l * cap].view(e_l, cap, d), local_p, policy,
                         train)
    out = combine(out_buf, order, slot, keep, gates)
    return out.to(torch.float32), aux


def _moe_ffn_ep_dtensor(x, p, cfg, db, policy, train, capacity_factor):
    """:func:`moe_ffn_ep` on ``DTensor`` operands, through ``local_map``:
    the tokens split over the data axes and whole over "model", the
    router whole, the stacked experts split over "model" (gathered over
    the others).  Each rank runs :func:`_ep_local`; its contributions
    leave as a ``Partial`` sum over "model", reduced in float32 before
    the cast (the one all-reduce), and its aux as a ``Partial`` mean over
    the data axes and "model" (the "model" ranks hold equal values).

    Under autograd each rank's gradients are its part of the whole:
    ``Partial`` sums over "model" for the tokens and the router (a rank
    differentiates its own experts' entries and its share of the aux),
    over the data axes for the router and the experts (a rank sees its
    own tokens), the experts' own rows split over "model"."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    E = cfg.n_experts
    n_data = 1
    for a in db:
        n_data *= mesh.size(names.index(a))
    if x.shape[0] % n_data:
        raise ValueError(f"moe_ffn_ep: batch {x.shape[0]} does not divide "
                         f"over the data axes {db} ({n_data})")
    n_model = mesh.size(names.index("model"))
    e_l = E // n_model

    def by_axis(on_data, on_model, other):
        return tuple(on_data if a in db else on_model if a == "model"
                     else other for a in names)
    rep = by_axis(Replicate(), Replicate(), Replicate())
    experts = by_axis(Replicate(), Shard(0), Replicate())

    def body(x_l, router, wg, wi, wo):
        e0 = mesh.get_local_rank("model") * e_l
        local_p = {"w_experts_gate": wg, "w_experts_in": wi,
                   "w_experts_out": wo}
        out, aux = _ep_local(x_l, router, local_p, e0, e_l, cfg, policy,
                             train, capacity_factor)
        return out.reshape(x_l.shape), aux / n_data / n_model

    expert_grads = by_axis(Partial(), Shard(0), Replicate())
    out, aux = local_map(
        body,
        out_placements=(by_axis(Shard(0), Partial(), Replicate()),
                        by_axis(Partial(), Partial(), Replicate())),
        in_placements=(by_axis(Shard(0), Replicate(), Replicate()), rep,
                       experts, experts, experts),
        in_grad_placements=(by_axis(Shard(0), Partial(), Replicate()),
                            by_axis(Partial(), Partial(), Replicate()),
                            expert_grads, expert_grads, expert_grads),
        redistribute_inputs=True)(
            x, p["router"], p["w_experts_gate"], p["w_experts_in"],
            p["w_experts_out"])
    out = out.redistribute(out.device_mesh,
                           by_axis(Shard(0), Replicate(), Replicate()))
    aux = aux.redistribute(aux.device_mesh, rep)
    return out.to(x.dtype), aux
