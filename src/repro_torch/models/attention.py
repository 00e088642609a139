"""GQA self-attention: the full-sequence forward and decode with a KV
cache, the reference's ``repro.models.attention`` for the dense family.

* :func:`self_attention` (forward / prefill): projections, RoPE, then
  :func:`attend`.  On the card ``attend`` routes every length through the
  flash-attention kernel (``kernels/ops.flash_attention``), the
  reference's TPU path; the plain route is :func:`dense_attention`, the
  reference's own CPU path (its ``chunked_attention`` for long sequences
  is not ported).
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
  computes the rest with the whole cache as one block, so its probability
  scale spans the whole row, as the model branch's does.

Decode's sliding windows and ring-buffer caches (gemma3) raise here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops, w8a8_decode
from repro_torch.models.common import rope
from repro_torch.quant.quantizers import const_like
from repro_torch.quant.qlinear import qdot

NEG_INF = -1e30


def _broadcast_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, kvh, hd) -> (b, s, H, hd) by repeating each kv head."""
    rep = n_heads // k.shape[2]
    return k if rep == 1 else torch.repeat_interleave(k, rep, dim=2)


def dense_attention(q, k, v, *, causal=True, window=None):
    """q: (b, sq, H, hd); k, v: (b, sk, H, hd).  The plain route: a dense
    float32 softmax, masked logits filled with -1e30."""
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    qi = (torch.arange(sq, device=q.device) + (sk - sq))[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def attend(q, k, v, *, causal=True, window=None, impl: str = "auto"):
    """q: (b, sq, H, hd); k, v: (b, sk, H, hd) -> (b, sq, H, hd): the
    flash-attention kernel where ``impl`` routes to kernels, else
    :func:`dense_attention`."""
    if not ops.use_kernel(q, impl):
        return dense_attention(q, k, v, causal=causal, window=window)
    out = ops.flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal, window=window,
        impl="kernel")
    return out.transpose(1, 2)


def self_attention(x, p, cfg, *, policy, train=False, impl: str = "auto"):
    """Full-sequence self-attention.  x: (b, s, d).  Returns
    ``(out, (k, v))``."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = qdot(x, p["wq"], policy, train=train, impl=impl).reshape(b, s, h, hd)
    k = qdot(x, p["wk"], policy, train=train, impl=impl) \
        .reshape(b, s, kvh, hd)
    v = qdot(x, p["wv"], policy, train=train, impl=impl) \
        .reshape(b, s, kvh, hd)
    positions = torch.arange(s, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = attend(q, _broadcast_kv(k, h), _broadcast_kv(v, h), impl=impl)
    out = out.reshape(b, s, h * hd)
    return qdot(out, p["wo"], policy, train=train, impl=impl), (k, v)


def _quantize_kv(t: torch.Tensor):
    """The reference's int8 KV write: ``t_s = max|t| / 127`` in t's dtype,
    then float32; codes ``round(t / max(t_s, 1e-8))`` in float32."""
    t_s = (t.abs().amax(dim=-1) / const_like(127.0, t)).to(torch.float32)
    t_q = torch.round(t / t_s.clamp_min(1e-8)[..., None]) \
        .clamp(-128, 127).to(torch.int8)
    return t_q, t_s


def decode_self_attention(x, p, cfg, cache_k, cache_v, pos, *,
                          policy, train=False, window=None,
                          static_window: int | None = None,
                          kv_scales=None, impl: str = "auto"):
    """One-token decode.  x: (b, 1, d); cache_k/v: (b, S, kvh, hd), int8
    when ``kv_scales = (k_scale, v_scale)``, each (b, S, kvh) float32;
    pos: the current position (an int; past = [0, pos]) or a ``(b,)``
    tensor of per-slot positions.  Writes this token's k and v (and
    scales) into the caches in place (the reference returns updated
    copies) and returns ``(out, cache_k, cache_v[, (k_scale, v_scale)])``."""
    if window is not None or static_window is not None:
        raise NotImplementedError(
            "sliding-window attention (window, static_window) is not "
            "ported yet")
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = h // kvh
    S = cache_k.shape[1]
    per_slot = isinstance(pos, torch.Tensor) and pos.dim() == 1
    q = qdot(x, p["wq"], policy, train=train, impl=impl).reshape(b, 1, h, hd)
    k = qdot(x, p["wk"], policy, train=train, impl=impl) \
        .reshape(b, 1, kvh, hd)
    v = qdot(x, p["wv"], policy, train=train, impl=impl) \
        .reshape(b, 1, kvh, hd)
    if per_slot:
        pos_b = pos.to(device=x.device, dtype=torch.int64)
        posv = pos_b[:, None]
        rows = torch.arange(b, device=x.device)
    else:
        pos = int(pos)
        posv = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)[:, 0]           # (b, h, hd)
    k = rope(k, posv, cfg.rope_theta)

    def write(cache, val):
        if per_slot:   # per-slot scatter write (iteration-level batching)
            cache[rows, pos_b] = val[:, 0].to(cache.dtype)
        else:
            cache[:, pos:pos + 1] = val.to(cache.dtype)

    qg = q.reshape(b, kvh, rep, hd)
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
        out = ops.w8a8_decode_attention_body(
            q_q, factor, cache_k, cache_v, k_scale, v_scale,
            w8a8_decode.positions(pos, b, x.device), bs=S,
            out_dtype=out_dtype, impl=impl)
    else:
        write(cache_k, k)
        write(cache_v, v)
        logits = torch.einsum("bgrd,bsgd->bgrs", qg.to(torch.float32),
                              cache_k.to(torch.float32)) * hd ** -0.5
        ki = torch.arange(S, device=x.device)
        valid = ki[None, :] <= (pos_b[:, None] if per_slot else pos)
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
        pr = torch.softmax(logits, dim=-1)            # (b, g, r, s) f32
        out = torch.einsum("bgrs,bsgd->bgrd",
                           pr.to(cache_v.dtype).to(torch.float32),
                           cache_v.to(torch.float32))
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    out = qdot(out, p["wo"], policy, train=train, impl=impl)
    if kv_scales is not None:
        return out, cache_k, cache_v, kv_scales
    return out, cache_k, cache_v
