"""Mamba-2 (SSD, state-space duality) block — arXiv:2405.21060: the
reference's ``repro.models.ssm`` in PyTorch.

Chunked SSD forward (a quadratic intra-chunk term, then the linear
inter-chunk state recurrence, a Python loop over the chunks where the
reference runs ``lax.scan``) and the single-token decode recurrence.  The
state and the SSD stay float32 (a precision-sensitive recurrence);
quantization applies to the in/out projections only, through ``qdot``
and so through the quantized matmul kernels on the card.  The reference
computes the SSD in XLA, outside any Pallas kernel, so here it is plain
PyTorch on both devices.

Layout conventions:
  d_inner = expand * d_model (expand=2), head dim P, heads H = d_inner/P,
  groups G (B/C shared across H/G heads), state N = cfg.ssm_state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import on_local_shards, sharded
from repro_torch.parallel.sharding import einsum, gather_dim, reshape
from repro_torch.quant.qlinear import qdot

P_HEADDIM = 64
D_CONV = 4


def dims(cfg):
    d_inner = 2 * cfg.d_model
    n_heads = d_inner // P_HEADDIM
    n_groups = 1
    return d_inner, n_heads, n_groups, cfg.ssm_state


def conv_dim(cfg):
    d_inner, _, g, n = dims(cfg)
    return d_inner + 2 * g * n


def in_proj_dim(cfg):
    d_inner, h, g, n = dims(cfg)
    return 2 * d_inner + 2 * g * n + h     # z, xBC(conv), dt


def _split(zxbcdt, cfg):
    d_inner, h, g, n = dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim(cfg)]
    dt = zxbcdt[..., -h:]
    return z, xbc, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x itself
    # above its threshold of 20, which the reference does not
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv_step(cache, x, w):
    """The streaming step of :func:`causal_conv1d`."""
    window = torch.cat([cache, x], dim=1)                 # (b, D_CONV, c)
    y = torch.einsum("bkc,kc->bc", window.to(torch.float32),
                     w.to(torch.float32))[:, None]
    return F.silu(y).to(x.dtype), window[:, 1:]


def causal_conv1d(x, w, cache=None):
    """Depthwise causal conv.  x: (b, s, c); w: (D_CONV, c).
    If cache (b, D_CONV-1, c) is given, performs a streaming step on s=1
    and returns (y, new_cache)."""
    if cache is not None:
        if sharded(cache, x, w):
            # on each card's batch rows and channels
            return on_local_shards(
                _conv_step, (cache, x, w),
                (("b", "t", "c"), ("b", "s", "c"), ("k", "c")),
                (("b", "s", "c"), ("b", "t", "c")), split=("b", "c"))
        return _conv_step(cache, x, w)
    if sharded(x, w):
        # on each card's batch rows and channels, the sequence gathered
        # whole: each position reads the D_CONV - 1 before it
        return on_local_shards(lambda a, b: causal_conv1d(a, b)[0], (x, w),
                               (("b", "s", "c"), ("k", "c")),
                               ("b", "s", "c"), split=("b", "c")), None
    s = x.shape[1]
    xp = F.pad(x, (0, 0, D_CONV - 1, 0))
    # sum_k w[k] * x[t - (D_CONV-1) + k], in float32 in the order k = 0..3
    y = sum(xp[:, k:k + s].to(torch.float32)
            * w[k].to(torch.float32) for k in range(D_CONV))
    return F.silu(y).to(x.dtype), None


def _cumsum(x, dim: int):
    """``torch.cumsum(x, dim)``; on a ``DTensor`` on each card's shards
    with ``dim`` whole (its backward, a flipped cumsum, has no DTensor
    sharding strategy in some torch versions)."""
    if not sharded(x):
        return torch.cumsum(x, dim=dim)
    dim %= x.dim()
    names = tuple(f"d{i}" for i in range(x.dim()))
    return on_local_shards(lambda t: torch.cumsum(t, dim=dim), (x,),
                           (names,), names,
                           split=names[:dim] + names[dim + 1:])


def _segsum(log_a):
    """(..., q) -> (..., q, q) lower-triangular cumulative-sum matrix:
    the difference of two cumulative sums, -inf above the diagonal."""
    q = log_a.shape[-1]
    cs = _cumsum(log_a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(q, device=log_a.device)
    mask = ii[:, None] >= ii[None, :]
    return diff.masked_fill_(~mask, -math.inf)


def ssd_chunked(xh, dt, a_log, B, C, *, chunk: int = 256,
                init_state=None):
    """SSD forward.  xh: (b, s, h, p); dt: (b, s, h) (softplus applied);
    a_log: (h,) with A = -exp(a_log); B, C: (b, s, g, n).
    Returns (y (b,s,h,p), final_state (b,h,p,n)), float32.

    The (b, nc, h, q, q) float32 intermediates of the intra-chunk term
    are freed as soon as they have been used (0.54 GB each at zamba2's 64
    heads, 1 x 4096 tokens, q = 512)."""
    f32 = torch.float32
    b, s, h, p = xh.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    rep = h // g
    A = -torch.exp(a_log.to(f32))                              # (h,)
    dA = dt.to(f32) * A                                        # (b, s, h)
    Bh = torch.repeat_interleave(B, rep, dim=2).to(f32)        # (b, s, h, n)
    Ch = torch.repeat_interleave(C, rep, dim=2).to(f32)
    xf = xh.to(f32) * dt.to(f32)[..., None]

    # chunked views: (b, nc, q, ...)
    q = chunk
    dAc = reshape(dA, b, nc, q, h)
    Bc = reshape(Bh, b, nc, q, h, n)
    Cc = reshape(Ch, b, nc, q, h, n)
    xc = reshape(xf, b, nc, q, h, p)

    # intra-chunk (quadratic) term
    L = _segsum(dAc.permute(0, 1, 3, 2)).exp_()               # (b,nc,h,q,q)
    scores = einsum("bcqhn,bckhn->bchqk", Cc, Bc)              # (b,nc,h,q,q)
    scores.mul_(L)
    del L
    y_intra = einsum("bchqk,bckhp->bcqhp", scores, xc)
    del scores

    # per-chunk input -> end-of-chunk state contribution
    cumA = _cumsum(dAc, 2)                                     # (b,nc,q,h)
    decay_to_end = torch.exp(cumA[:, :, -1:, :] - cumA)        # (b,nc,q,h)
    chunk_states = einsum("bcqhn,bcqh,bcqhp->bchpn",
                          Bc, decay_to_end, xc)                # (b,nc,h,p,n)
    chunk_decay = torch.exp(cumA[:, :, -1, :])                 # (b,nc,h)

    # inter-chunk recurrence over the nc chunks (each step emits the state
    # before its chunk)
    state = init_state if init_state is not None else \
        torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # (b,nc,h,p,n)

    # inter-chunk output: y += C_t · (decay from chunk start) · prev_state
    state_decay = torch.exp(cumA)                              # (b,nc,q,h)
    y_inter = einsum("bcqhn,bcqh,bchpn->bcqhp",
                     Cc, state_decay, prev_states)
    y = reshape(y_intra + y_inter, b, s, h, p)
    return y, state


def mamba2_block(x, p, cfg, *, policy, train=False, impl: str = "auto"):
    """Full Mamba-2 mixer.  x: (b, s, d) -> (b, s, d)."""
    b, s, d = x.shape
    d_inner, h, g, n = dims(cfg)
    zxbcdt = qdot(x, p["in_proj"], policy, train=train, impl=impl)
    z, xbc, dt = _split(zxbcdt, cfg)
    xbc, _ = causal_conv1d(xbc, p["conv_w"])
    xs = reshape(xbc[..., :d_inner], b, s, h, P_HEADDIM)
    B = reshape(xbc[..., d_inner:d_inner + g * n], b, s, g, n)
    C = reshape(xbc[..., d_inner + g * n:], b, s, g, n)
    dt_ = _softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    c0 = cfg.ssm_chunk
    chunk = min(c0, s) if s % c0 != 0 else c0
    if s % chunk != 0:          # tiny smoke shapes
        chunk = s
    y, _ = ssd_chunked(xs, dt_, p["a_log"], B, C, chunk=chunk)
    y = y + xs.to(torch.float32) \
        * p["d_skip"].to(torch.float32)[None, None, :, None]
    y = reshape(y, b, s, d_inner).to(x.dtype)
    y = y * F.silu(z)                                          # gated
    return qdot(y, p["out_proj"], policy, train=train, impl=impl)


def _ssm_step(state, xs, Bh, Ch, dt, dt_bias, a_log, d_skip):
    """One token's recurrence on ``state`` (b, h, p, n); returns the
    output (b, h, p) with the skip term, and the new state, float32."""
    f32 = torch.float32
    dt_ = _softplus(dt.to(f32) + dt_bias.to(f32))              # (b, h)
    A = -torch.exp(a_log.to(f32))                              # (h,)
    dA = torch.exp(dt_ * A)                                    # (b, h)
    xf = xs.to(f32) * dt_[..., None]                           # (b, h, p)
    state = state * dA[..., None, None] \
        + torch.einsum("bhp,bhn->bhpn", xf, Bh)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y + xs.to(f32) * d_skip.to(f32)[None, :, None], state


def mamba2_decode(x, p, cfg, state, conv_cache, *, policy, train=False,
                  impl: str = "auto"):
    """One-token recurrence.  x: (b, 1, d); state: (b, h, p, n) f32;
    conv_cache: (b, D_CONV-1, conv_dim).  Returns (y, state, conv_cache),
    new tensors (the caller stores them)."""
    b = x.shape[0]
    d_inner, h, g, n = dims(cfg)
    f32 = torch.float32
    # on a mesh the channels whole: z, x, B, C and dt are slices of them
    zxbcdt = gather_dim(qdot(x, p["in_proj"], policy, train=train,
                             impl=impl), -1)
    z, xbc, dt = _split(zxbcdt, cfg)
    xbc, conv_cache = causal_conv1d(xbc, p["conv_w"], cache=conv_cache)
    xs = reshape(xbc[..., :d_inner], b, h, P_HEADDIM)
    B = reshape(xbc[..., d_inner:d_inner + g * n], b, g, n)
    C = reshape(xbc[..., d_inner + g * n:], b, g, n)
    rep = h // g
    Bh = torch.repeat_interleave(B, rep, dim=1).to(f32)        # (b, h, n)
    Ch = torch.repeat_interleave(C, rep, dim=1).to(f32)
    args = (state, xs, Bh, Ch, dt[:, 0], p["dt_bias"], p["a_log"],
            p["d_skip"])
    if sharded(*args):
        # on each card's batch rows and heads, as the state is placed
        y, state = on_local_shards(
            _ssm_step, args,
            (("b", "h", "p", "n"), ("b", "h", "p"), ("b", "h", "n"),
             ("b", "h", "n"), ("b", "h"), ("h",), ("h",), ("h",)),
            (("b", "h", "p"), ("b", "h", "p", "n")), split=("b", "h"))
    else:
        y, state = _ssm_step(*args)
    y = reshape(y, b, 1, d_inner).to(x.dtype)
    y = y * F.silu(z)
    return qdot(y, p["out_proj"], policy, train=train, impl=impl), state, \
        conv_cache
