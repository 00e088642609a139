"""Shared model components: norms, RoPE, the loss, MLPs, init."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.sharding import shard
from repro_torch.quant.qlinear import qdot


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On ``DTensor``s the vocab-parallel lookup:
    each card holds the rows of its "model" slice of the vocab (the
    table gathered over its other axes), looks up the tokens of its own
    batch slice that fall in it, zeros the rest, and the cards' rows meet
    as a ``Partial`` sum over "model" (exact: one nonzero a position).
    Without a "model" split of the vocab the table is gathered whole and
    looked up as it is.  Under autograd the table's gradient is a
    ``Partial`` sum over the axes that split the tokens."""
    from repro_torch.kernels.ops import sharded
    if not sharded(table, tokens):
        return table[tokens]
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    names = tuple(mesh.mesh_dim_names)
    n_model = mesh.size(names.index("model")) if "model" in names else 1
    split = n_model > 1 and table.shape[0] % n_model == 0
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    tab_pl = tuple(Shard(0) if split and a == "model" else Replicate()
                   for a in names)
    tok_pl = tuple(Replicate() if split and a == "model" else p
                   for a, p in zip(names, tokens.placements))
    out_pl = [Partial() if split and a == "model" else p
              for a, p in zip(names, tok_pl)]
    # each card's rows of the table take the gradient of its own tokens:
    # a Partial sum over the axes that split the tokens
    tab_grad = tuple(Partial() if p.is_shard() else t
                     for t, p in zip(tab_pl, tok_pl))
    rows = table.shape[0] // n_model

    def lookup(t, tok):
        if not split:
            return t[tok]
        idx = tok.to(torch.int64) - mesh.get_local_rank("model") * rows
        keep = (idx >= 0) & (idx < rows)
        return t[idx.clamp(0, rows - 1)] * keep[..., None].to(t.dtype)
    return local_map(lookup, out_placements=out_pl,
                     in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(tab_grad, tok_pl),
                     redistribute_inputs=True)(table, tokens)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 (precision-sensitive in every quantization
    mode), returned in ``x``'s dtype.  Span ``common.rms_norm``."""
    with obs_trace.span("common.rms_norm"):
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)
        return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding in float32.  x: (..., s, h, hd); positions:
    broadcastable (s,) or (b, s).  Span ``common.rope``."""
    with obs_trace.span("common.rope"):
        hd = x.shape[-1]
        half = hd // 2
        freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                        device=x.device) / half)
        ang = positions.to(torch.float32)[..., None] * freqs  # (..., s, half)
        cos = torch.cos(ang)[..., None, :]                  # (..., s, 1, half)
        sin = torch.sin(ang)[..., None, :]
        xf1 = x[..., :half].to(torch.float32)
        xf2 = x[..., half:].to(torch.float32)
        out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                        dim=-1)
        return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy in float32 with the z-loss regularizer
    ``z_loss * mean(lse**2)``.  logits: (b, s, V) any float dtype;
    labels: (b, s) integer."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse ** 2)
    return loss


def gelu_mlp(x, w_in, w_out, policy, train, *, impl: str = "auto"):
    """The GELU MLP; span ``common.mlp``."""
    with obs_trace.span("common.mlp"):
        # jax.nn.gelu, the reference's activation, is the tanh
        # approximation
        h = F.gelu(qdot(x, w_in, policy, train=train, impl=impl),
                   approximate="tanh")
        return qdot(h, w_out, policy, train=train, impl=impl)


def swiglu_mlp(x, w_gate, w_up, w_down, policy, train, *,
               impl: str = "auto"):
    """The SwiGLU MLP; span ``common.mlp``."""
    with obs_trace.span("common.mlp"):
        g = qdot(x, w_gate, policy, train=train, impl=impl)
        u = qdot(x, w_up, policy, train=train, impl=impl)
        h = shard(F.silu(g) * u, "ffn_hidden")
        return qdot(h, w_down, policy, train=train, impl=impl)


def normal_init(generator: torch.Generator, shape,
                scale: float = 0.02) -> torch.Tensor:
    """``N(0, scale^2)`` float32 draws on the generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32) * scale
