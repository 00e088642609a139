"""Decode self-attention with a KV cache: the reference's
``decode_self_attention`` for one scalar position and a bf16 (or float)
cache.

Grouped-query attention without materializing the kv -> q-head
broadcast: q is reshaped to (b, kvh, rep, hd) and both contractions carry
the group dim.  As in the reference (``preferred_element_type=f32``),
both contractions run in float32 on operands in the cache's dtype: q, K,
the probabilities (rounded to the cache's dtype first) and V are upcast
before each einsum.

The reference's other decode paths (sliding-window masks, a ring-buffer
or windowed cache read, per-slot positions for continuous batching, the
int8 KV cache) arrive with the models that use them; they raise here.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import rope
from repro_torch.quant.qlinear import qdot

NEG_INF = -1e30


def decode_self_attention(x, p, cfg, cache_k, cache_v, pos: int, *,
                          policy, train=False, window=None,
                          static_window: int | None = None,
                          kv_scales=None, impl: str = "auto"):
    """One-token decode.  x: (b, 1, d); cache_k/v: (b, S, kvh, hd); pos:
    the current position (an int; past = [0, pos]).  Writes this token's
    k and v into the caches in place (the reference returns updated
    copies) and returns ``(out, cache_k, cache_v)``."""
    if window is not None or static_window is not None:
        raise NotImplementedError(
            "sliding-window attention (window, static_window) is not "
            "ported yet")
    if kv_scales is not None:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    if not isinstance(pos, int):
        raise NotImplementedError(
            "per-slot positions (continuous batching) are not ported yet; "
            "pos must be an int")
    b, _, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = h // kvh
    S = cache_k.shape[1]
    q = qdot(x, p["wq"], policy, train=train, impl=impl).reshape(b, 1, h, hd)
    k = qdot(x, p["wk"], policy, train=train, impl=impl) \
        .reshape(b, 1, kvh, hd)
    v = qdot(x, p["wv"], policy, train=train, impl=impl) \
        .reshape(b, 1, kvh, hd)
    posv = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)[:, 0]           # (b, h, hd)
    k = rope(k, posv, cfg.rope_theta)
    cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)

    qg = q.reshape(b, kvh, rep, hd)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg.to(torch.float32),
                          cache_k.to(torch.float32)) * hd ** -0.5
    valid = torch.arange(S, device=x.device) <= pos
    logits = torch.where(valid, logits, NEG_INF)
    pr = torch.softmax(logits, dim=-1)                # (b, g, r, s) f32
    out = torch.einsum("bgrs,bsgd->bgrd",
                       pr.to(cache_v.dtype).to(torch.float32),
                       cache_v.to(torch.float32))
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    out = qdot(out, p["wo"], policy, train=train, impl=impl)
    return out, cache_k, cache_v
