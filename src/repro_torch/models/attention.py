"""GQA self-attention (the full-sequence forward and decode with a KV
cache) and cross-attention over a precomputed context: the reference's
``repro.models.attention``.

* :func:`self_attention` (forward / prefill): projections, RoPE, then
  :func:`attend`, with an optional sliding ``window`` (gemma3's local
  layers).  On the card ``attend`` routes every length through the
  flash-attention kernel (``kernels/ops.flash_attention``), the
  reference's TPU path; the plain route is the reference's own CPU path:
  :func:`dense_attention` up to ``DENSE_SEQ_LIMIT`` tokens and
  :func:`chunked_attention` (online softmax over key blocks) above.
  Under grad the plain route runs on the card too: the kernel has no
  backward.
* :func:`decode_self_attention`: one token against a bf16 (or float)
  cache or an int8 cache with per-(position, head) scales, at one position
  for the whole batch (an int) or one per slot (a ``(b,)`` tensor, for
  continuous batching).  Grouped-query attention without materializing
  the kv -> q-head broadcast: q is reshaped to (b, kvh, rep, hd) and both
  contractions carry the group dim.  With a float cache, as in the
  reference (``preferred_element_type=f32``), both contractions run in
  float32 on operands in the cache's dtype.  With the int8 cache, q is
  quantized in the reference's model branch's dtype (bf16 under the bf16
  and quantized policies) and the int8 decode-attention kernel's body
  computes the rest with the whole cache (or window) as one block, so its
  probability scale spans the whole row, as the model branch's does.
  gemma3's local layers decode on a ring buffer of ``W`` positions
  (``static_window == S``) or on a ``W``-wide slice of a longer cache
  (``static_window < S``); ``window`` masks keys older than
  ``pos - window + 1``.
* :func:`context_kv` projects a context (image patches, encoder frames)
  to keys and values once; :func:`cross_attention` attends to them
  through :func:`attend` without a mask or RoPE, at every length (one
  token at decode), so on the card through the flash kernel too.  It
  hands ``attend`` the context's ``kvh`` heads: at decode (few q rows)
  the kernel's decode regime reads the caches where they lie, with no
  repeat of the kv heads and no copy; the plain route and the tile
  regime repeat them first, as the reference does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention, ops, w8a8_decode
from repro_torch.models.common import rope
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.sharding import einsum, reshape, shard
from repro_torch.quant.quantizers import const_like
from repro_torch.quant.qlinear import qdot

NEG_INF = -1e30
#: the plain route's longest dense attention; above, chunked
DENSE_SEQ_LIMIT = 2048
#: q blocks per group of chunked attention's causal skip
_SKIP_GROUP = 4


def _broadcast_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, kvh, hd) -> (b, s, H, hd) by repeating each kv head."""
    rep = n_heads // k.shape[2]
    return k if rep == 1 else torch.repeat_interleave(k, rep, dim=2)


def _mask(qi, ki, causal, window):
    """Which keys ``ki`` each query ``qi`` attends to (broadcast)."""
    mask = torch.ones(torch.broadcast_shapes(qi.shape, ki.shape),
                      dtype=torch.bool, device=qi.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return mask


def dense_attention(q, k, v, *, causal=True, window=None):
    """q: (b, sq, H, hd); k, v: (b, sk, H, hd).  The plain route: a dense
    float32 softmax, masked logits filled with -1e30."""
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    logits = einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                    k.to(torch.float32)) * hd ** -0.5
    qi = (torch.arange(sq, device=q.device) + (sk - sq))[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    p = torch.softmax(torch.where(_mask(qi, ki, causal, window), logits,
                                  NEG_INF), dim=-1)
    out = einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def _block_size(n: int, target: int) -> int:
    """Largest divisor of n that is <= target; if only degenerate divisors
    exist (e.g. prime n), one block of n."""
    if n <= target:
        return n
    for b in range(target, max(15, target // 8), -1):
        if n % b == 0:
            return b
    return n


def chunked_attention(q, k, v, *, causal=True, window=None,
                      bq: int = 512, bk: int = 512):
    """The reference's memory-efficient attention: q blocks, each an
    online softmax over kv blocks, O(bq * bk) live logits.  q: (b, sq, H,
    hd); k, v: (b, sk, H, hd).

    Causal: q blocks go in groups of ``_SKIP_GROUP``, and a group's kv
    walk stops at its static causal bound, so strictly-future kv blocks
    are never computed (the reference's ``causal_skip``).  Otherwise every
    q block walks every kv block (the reference's ``lax.map``)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    bq = _block_size(sq, bq)
    bk = _block_size(sk, bk)
    scale = hd ** -0.5
    nq, nk = sq // bq, sk // bk
    qb = q.reshape(b, nq, bq, h, hd).to(torch.float32)
    kb = k.reshape(b, nk, bk, h, hd).to(torch.float32)
    vb = v.reshape(b, nk, bk, h, hd).to(torch.float32)
    dev = q.device

    def q_block(i, qtile, n_kv):      # qtile: (b, tile_q, h, hd)
        tile_q = qtile.shape[1]
        qi = (i * bq + (sk - sq) + torch.arange(tile_q, device=dev))[:, None]
        acc = torch.zeros((b, h, tile_q, hd), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, h, tile_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, tile_q), dtype=torch.float32, device=dev)
        for j in range(n_kv):
            s = einsum("bqhd,bkhd->bhqk", qtile, kb[:, j]) * scale
            ki = (j * bk + torch.arange(bk, device=dev))[None, :]
            s = torch.where(_mask(qi, ki, causal, window), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] \
                + einsum("bhqk,bkhd->bhqd", p, vb[:, j])
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        return out.transpose(1, 2)    # (b, tile_q, h, hd)

    if causal and nq > 1:
        outs = []
        for g0 in range(0, nq, _SKIP_GROUP):
            g1 = min(nq, g0 + _SKIP_GROUP)
            # the group's static causal bound (its last row's)
            hi = min(nk, ((g1 - 1) * bq + (sk - sq) + bq - 1) // bk + 1)
            tile = qb[:, g0:g1].reshape(b, (g1 - g0) * bq, h, hd)
            outs.append(q_block(g0, tile, max(1, hi)))
        return torch.cat(outs, dim=1).to(q.dtype)
    out = torch.cat([q_block(i, qb[:, i], nk) for i in range(nq)], dim=1)
    return out.to(q.dtype)


def attend(q, k, v, *, causal=True, window=None, impl: str = "auto",
           regime: str | None = None):
    """q: (b, sq, H, hd); k, v: (b, sk, kvh, hd) with ``kvh`` dividing H
    -> (b, sq, H, hd): the flash-attention kernel where ``impl`` routes to
    kernels, handed (b, heads, s, hd) views of q, k and v at their heads
    (the wrapper picks its regime, or takes ``regime``: the decode regime
    reads them in place, the tile regime repeats and copies them itself),
    else the reference's route on the kv heads repeated to H:
    :func:`dense_attention` up to :data:`DENSE_SEQ_LIMIT` tokens,
    :func:`chunked_attention` above.
    Under grad (grad enabled and q, k or v requiring it) ``"auto"`` takes
    the reference's route on every device, the one its training step
    differentiates: the kernel has no backward (``kernels/ops.py``).
    Operands of mixed dtypes (a bf16 q against the float32 context k, v
    of the vlm forward) meet in float32, as the plain route computes
    them: the float32 kernel, out cast to q's dtype.  An op counter counts
    either route as one flash call (``ops.counted``), k and v at their
    ``kvh`` heads.  On ``DTensor`` operands the kv heads are repeated to H
    first and each card attends over its own batch rows and heads
    (``ops.on_local_shards``); a split sequence is gathered first."""
    flash_attention.regime_for(q.shape[1], regime)
    if ops.sharded(q, k, v):
        h = q.shape[2]
        return ops.on_local_shards(
            lambda *t: attend(*t, causal=causal, window=window, impl=impl,
                              regime=regime),
            (q, _broadcast_kv(k, h), _broadcast_kv(v, h)),
            (("b", "s", "h", "d"),) * 3, ("b", "s", "h", "d"),
            split=("b", "h"))
    dt = q.dtype if q.dtype == k.dtype == v.dtype else torch.float32
    b, sq, h, hd = q.shape
    return ops.counted("flash_attention", lambda: flash_attention.cost(
        b, h, sq, k.shape[1], hd, causal=causal, window=window, dtype=dt,
        kvh=k.shape[2]),
        lambda: _attend(q, k, v, causal, window, impl, dt, regime),
        grad=(q, k, v))


def _attend(q, k, v, causal, window, impl, dt, regime):
    """:func:`attend`'s routes: the plain one on the kv heads repeated to
    H; the kernel on (b, heads, s, hd) views of q, k, v (no copy where the
    dtypes agree)."""
    if not ops.use_kernel(q, impl, grad=(q, k, v)):
        h = q.shape[2]
        k, v = _broadcast_kv(k, h), _broadcast_kv(v, h)
        # a fake q outside grad is inside the flash scope, where only the
        # output's shape counts: the dense route gives it for nothing
        if max(q.shape[1], k.shape[1]) <= DENSE_SEQ_LIMIT or (
                ops.is_fake(q) and not ops.needs_grad(q, k, v)):
            return dense_attention(q, k, v, causal=causal, window=window)
        return chunked_attention(q, k, v, causal=causal, window=window)
    out = ops.flash_attention(
        *(t.transpose(1, 2).to(dt) for t in (q, k, v)), causal=causal,
        window=window, impl="kernel", regime=regime)
    return out.transpose(1, 2).to(q.dtype)


def self_attention(x, p, cfg, *, policy, train=False, window=None,
                   impl: str = "auto"):
    """Full-sequence self-attention.  x: (b, s, d); ``window``: the local
    layers' sliding window (None: full causal).  Returns
    ``(out, (k, v))``.  Span ``attn.self``."""
    with obs_trace.span("attn.self"):
        b, s, _ = x.shape
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = reshape(qdot(x, p["wq"], policy, train=train, impl=impl),
                    b, s, h, hd)
        k = reshape(qdot(x, p["wk"], policy, train=train, impl=impl),
                    b, s, kvh, hd)
        v = reshape(qdot(x, p["wv"], policy, train=train, impl=impl),
                    b, s, kvh, hd)
        q = shard(q, "attn_qkv")
        positions = torch.arange(s, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = attend(q, _broadcast_kv(k, h), _broadcast_kv(v, h),
                     window=window, impl=impl)
        out = reshape(out, b, s, h * hd)
        return qdot(out, p["wo"], policy, train=train, impl=impl), (k, v)


def _quantize_kv(t: torch.Tensor):
    """The reference's int8 KV write: ``t_s = max|t| / 127`` in t's dtype,
    then float32; codes ``round(t / max(t_s, 1e-8))`` in float32."""
    t_s = (t.abs().amax(dim=-1) / const_like(127.0, t)).to(torch.float32)
    t_q = torch.round(t / t_s.clamp_min(1e-8)[..., None]) \
        .clamp(-128, 127).to(torch.int8)
    return t_q, t_s


def _write_on_shards(cache, val, w: int) -> None:
    """``cache[:, w] = val`` in place on a ``DTensor`` cache: each rank
    writes its own shard, and a rank whose part of a split sequence does
    not hold slot ``w`` writes nothing (a slice of a split dim would be
    written into a gathered copy, and lost)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = cache.device_mesh
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i, p in enumerate(cache.placements):
        if type(p) is Shard and p.dim == 1:
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    start = idx * (cache.shape[1] // n)

    def body(c, v):
        if start <= w < start + c.shape[1]:
            c[:, w - start:w - start + 1] = v.to(c.dtype)
        return c
    val_pl = tuple(Replicate() if type(p) is Shard and p.dim == 1 else p
                   for p in cache.placements)
    local_map(body, out_placements=[*cache.placements],
              in_placements=(tuple(cache.placements), val_pl),
              redistribute_inputs=True)(cache, val)


def decode_self_attention(x, p, cfg, cache_k, cache_v, pos, *,
                          policy, train=False, window=None,
                          static_window: int | None = None,
                          kv_scales=None, impl: str = "auto"):
    """One-token decode.  x: (b, 1, d); cache_k/v: (b, S, kvh, hd), int8
    when ``kv_scales = (k_scale, v_scale)``, each (b, S, kvh) float32;
    pos: the current position (an int; past = [0, pos]) or a ``(b,)``
    tensor of per-slot positions.  Writes this token's k and v (and
    scales) into the caches in place (the reference returns updated
    copies) and returns ``(out, cache_k, cache_v[, (k_scale, v_scale)])``.

    ``static_window = W``: with ``W == S`` the cache is a ring buffer (the
    token goes to slot ``pos mod W``); with ``W < S`` only the ``W``
    positions from ``clip(pos - W + 1, 0, S - W)`` are read.  ``window``
    also masks keys at or before ``pos - window``; the int8 kernel has no
    such mask (ROADMAP A.6), so on the int8 kernel route it raises."""
    if window is not None and kv_scales is not None \
            and ops.use_kernel(x, impl, grad=(x,)):
        raise NotImplementedError(
            "a dynamic decode window on the int8 KV cache runs on the plain "
            "route only: the int8 decode-attention kernel masks s <= pos "
            "alone (ROADMAP A.6)")
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = h // kvh
    S = cache_k.shape[1]
    ring = static_window is not None and static_window == S
    sliced = static_window is not None and static_window < S
    per_slot = isinstance(pos, torch.Tensor) and pos.dim() == 1
    dev = x.device
    q = reshape(qdot(x, p["wq"], policy, train=train, impl=impl),
                b, 1, h, hd)
    k = reshape(qdot(x, p["wk"], policy, train=train, impl=impl),
                b, 1, kvh, hd)
    v = reshape(qdot(x, p["wv"], policy, train=train, impl=impl),
                b, 1, kvh, hd)
    if per_slot:
        pos_b = pos.to(device=dev, dtype=torch.int64)
        posv = pos_b[:, None]
        rows = torch.arange(b, device=dev)
    else:
        pos = int(pos)
        posv = torch.full((1,), pos, dtype=torch.float32, device=dev)
    q = rope(q, posv, cfg.rope_theta)[:, 0]           # (b, h, hd)
    k = rope(k, posv, cfg.rope_theta)

    def write(cache, val):
        if per_slot:   # per-slot scatter write (iteration-level batching)
            cache[rows, pos_b % S if ring else pos_b] = val[:, 0].to(
                cache.dtype)
        elif ops.sharded(cache):
            _write_on_shards(cache, val, pos % S if ring else pos)
        else:
            w = pos % S if ring else pos
            cache[:, w:w + 1] = val.to(cache.dtype)

    # the absolute position ki of each key read, (b, W), where something
    # reads it: the slice, a window's mask or the float cache's mask (the
    # int8 body masks s <= pos itself)
    if sliced or window is not None or kv_scales is None:
        if not per_slot:
            pos_b = torch.full((b,), pos, dtype=torch.int64, device=dev)
        col = torch.arange(static_window if sliced else S, device=dev)
        if ring:
            # slot r holds position pos - ((pos - r) mod S); stale slots
            # have ki < 0
            ki = pos_b[:, None] - torch.remainder(pos_b[:, None] - col, S)
        elif sliced:
            W = static_window
            if per_slot:
                start_b = (pos_b - W + 1).clamp(0, S - W)
            else:
                start = min(max(pos - W + 1, 0), S - W)
                start_b = torch.full((b,), start, dtype=torch.int64,
                                     device=dev)
            ki = start_b[:, None] + col
        else:
            ki = col.expand(b, S)

    def read(cache):
        """The keys' rows of ``cache``: all S, or the W of the slice."""
        if not sliced:
            return cache
        if not per_slot:
            return cache[:, start:start + W]
        idx = ki.view(b, W, *(1,) * (cache.dim() - 2)) \
            .expand(b, W, *cache.shape[2:])
        return torch.gather(cache, 1, idx)

    keep = None if window is None else ki > pos_b[:, None] - window
    qg = reshape(q, b, kvh, rep, hd)
    if kv_scales is not None:   # int8 KV cache
        k_scale, v_scale = kv_scales
        k_q, k_s = _quantize_kv(k)
        v_q, v_s = _quantize_kv(v)
        for cache, val in ((cache_k, k_q), (cache_v, v_q), (k_scale, k_s),
                           (v_scale, v_s)):
            write(cache, val)
        # the model branch's q quantization, in q's dtype
        q_s = qg.abs().amax(dim=-1, keepdim=True) / const_like(127.0, qg)
        q_q = torch.round(qg / q_s.clamp_min(1e-8)).clamp(-128, 127) \
            .to(torch.int8)
        factor = (q_s * hd ** -0.5)[..., 0].to(torch.float32)
        out_dtype = x.dtype if x.dtype in (torch.float32, torch.bfloat16) \
            else torch.float32
        # The body masks key s to s <= its row's position.  On the ring
        # that is the reference's mask at the absolute position: ki =
        # pos - ((pos - r) mod S) <= pos always, and ki >= 0 exactly when
        # r <= pos.  Both sum the slots in slot order r.  On the slice the
        # position is relative to its start.
        body_pos = pos if not sliced else pos_b - start_b if per_slot \
            else pos - start
        kk, vv, ks, vs = (read(t).contiguous() for t in (
            cache_k, cache_v, k_scale, v_scale))
        if keep is None:
            out = ops.w8a8_decode_attention_body(
                q_q, factor, kk, vv, ks, vs, body_pos, bs=kk.shape[1],
                out_dtype=out_dtype, impl=impl)
        else:   # the plain route (the kernel route refused it above)
            out = w8a8_decode.w8a8_decode_attention_body_ref(
                q_q, factor, kk, vv, ks, vs,
                w8a8_decode.positions(body_pos, b, dev), bs=kk.shape[1],
                out_dtype=out_dtype, keep=keep)
    else:
        write(cache_k, k)
        write(cache_v, v)
        kk, vv = read(cache_k), read(cache_v)
        logits = einsum("bgrd,bsgd->bgrs", qg.to(torch.float32),
                        kk.to(torch.float32)) * hd ** -0.5
        valid = (ki <= pos_b[:, None]) & (ki >= 0)
        if keep is not None:
            valid &= keep
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
        pr = torch.softmax(logits, dim=-1)            # (b, g, r, s) f32
        out = einsum("bgrs,bsgd->bgrd",
                     pr.to(vv.dtype).to(torch.float32),
                     vv.to(torch.float32))
    out = reshape(out, b, 1, h * hd).to(x.dtype)
    out = qdot(out, p["wo"], policy, train=train, impl=impl)
    if kv_scales is not None:
        return out, cache_k, cache_v, kv_scales
    return out, cache_k, cache_v


def cross_attention(x, ctx_k, ctx_v, p, cfg, *, policy, train=False,
                    impl: str = "auto"):
    """Attention of x (b, s, d) over a context's keys and values ctx_k,
    ctx_v (b, sc, kvh, hd), precomputed by :func:`context_kv` (the
    whisper decoder's and llama-3.2-vision's image layers): no RoPE, the
    kv heads broadcast to ``n_heads`` (by :func:`attend`), no mask."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = reshape(qdot(x, p["wq_x"], policy, train=train, impl=impl),
                b, s, h, hd)
    out = attend(q, ctx_k, ctx_v, causal=False, impl=impl)
    return qdot(reshape(out, b, s, h * hd), p["wo_x"], policy, train=train,
                impl=impl)


def context_kv(ctx, p, cfg, *, policy, train=False, impl: str = "auto"):
    """The context embeddings ctx (b, sc, d) projected once to (k, v),
    each (b, sc, kvh, hd), in ctx's dtype under a quantized policy (one
    per-tensor activation scale over the whole context, as ``serve_dot``
    takes it) and in the compute dtype otherwise."""
    b, sc, _ = ctx.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    k = reshape(qdot(ctx, p["wk_img"], policy, train=train, impl=impl),
                b, sc, kvh, hd)
    v = reshape(qdot(ctx, p["wv_img"], policy, train=train, impl=impl),
                b, sc, kvh, hd)
    return k, v
