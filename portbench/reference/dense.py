"""Plain reference of the cells' dense decoders: the last position's
logits of a prompt, in float32, with the quantization the configuration
states worked out again from the float weights.

It follows the model the configuration file describes, as the port runs
it (the departures from the published model are the file's ``assumed``):

* the embedding row of each token, then per layer
  ``x += wo(attn(rope(wq(n1)), rope(wk(n1)), wv(n1)))`` and
  ``x += mlp(n2)``, ``n1``, ``n2`` the RMS norms of ``x`` (weight ones);
* RoPE on the rotate-half layout, ``theta^(-2i / hd)``, angles in
  float32 as the published implementations compute them;
* causal softmax attention with the q heads grouped on their kv head;
* SwiGLU (``silu(gate) * up``) or the tanh GELU;
* the last position's RMS norm against the embedding (tied).

Every projection is the configuration's quantized product: the
activation quantized per tensor to ``act_bits`` (symmetric, scale
``max|x| / qmax``, round half to even), the weight per output column as
the mode states (``w8a8``: symmetric ``weight_bits`` integers;
``w4a8_pow2``: sign and a power of two ``2^-7 .. 2^0`` of the column's
``max|w|``), the product in float32 on the dequantized values.  The
rest (norms, RoPE, attention, the residual stream) stays float32, with
TF32 off.

``act_bits = weight_bits = 4`` is the control: every int8 operand at
int4, the step below the configuration's precision.

It imports nothing of the program: weights come from the benchmark's own
``harness.weights`` and prompts from its token pool.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.harness import weights
from portbench.harness.spec import ModelShape

#: q rows of one attention block (bounds its float32 scores)
Q_BLOCK = 1024
POW2_BIAS = 7


def quantize_act(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` quantized per tensor to ``bits`` and dequantized."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = x.abs().amax().clamp_min(1e-8) / qmax
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def dequant_weight(w: torch.Tensor, mode: str, bits: int) -> torch.Tensor:
    """A (d_in, d_out) float weight as the mode stores it, dequantized:
    one scale per output column."""
    amax = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-8)
    if mode == "w8a8":
        qmax = float(2 ** (bits - 1) - 1)
        scale = amax / qmax
        return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale
    if mode == "w4a8_pow2":
        mag = (w.abs() / amax).clamp_min(2.0 ** -POW2_BIAS)
        e = torch.clamp(torch.round(torch.log2(mag)), -POW2_BIAS, 0)
        return torch.where(w < 0, -1.0, 1.0) * torch.exp2(e) * amax
    raise ValueError(f"no quantized mode {mode!r}")


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (s, heads, hd) rotated by its positions 0 .. s - 1."""
    s, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device,
                                        dtype=torch.float32) / hd))
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q (s, h, hd), k and v (s, kvh, hd) -> (s, h, hd); q head j reads
    kv head ``j // (h / kvh)``.  In blocks of ``Q_BLOCK`` query rows,
    each over the keys up to its last row."""
    s, h, hd = q.shape
    kvh = k.shape[1]
    rep = h // kvh
    kt = k.permute(1, 2, 0)                          # (kvh, hd, s)
    vt = v.permute(1, 0, 2)                          # (kvh, s, hd)
    out = torch.empty_like(q)
    for i0 in range(0, s, Q_BLOCK):
        i1 = min(s, i0 + Q_BLOCK)
        qb = q[i0:i1].reshape(i1 - i0, kvh, rep, hd).permute(1, 2, 0, 3)
        scores = torch.matmul(qb.reshape(kvh, rep * (i1 - i0), hd),
                              kt[:, :, :i1]) / math.sqrt(hd)
        scores = scores.view(kvh, rep, i1 - i0, i1)
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        ki = torch.arange(i1, device=q.device)[None, :]
        scores.masked_fill_(ki > qi, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        ob = torch.matmul(p.view(kvh, rep * (i1 - i0), i1), vt[:, :i1])
        out[i0:i1] = ob.view(kvh, rep, i1 - i0, hd).permute(2, 0, 1, 3) \
            .reshape(i1 - i0, h, hd)
        del scores, p, ob
    return out


class Reference:
    """The reference model of one configuration at a precision."""

    def __init__(self, shape: ModelShape, *, act_bits: int = 8,
                 weight_bits: int = 8):
        self.shape = shape
        self.act_bits = act_bits
        self.weight_bits = weight_bits

    def proj(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return quantize_act(x, self.act_bits) @ w

    def block(self, x: torch.Tensor, w: dict) -> torch.Tensor:
        sh = self.shape
        s = x.shape[0]
        n1 = rms_norm(x, sh.norm_eps)
        q = rope(self.proj(n1, w["wq"]).view(s, sh.n_heads, sh.head_dim),
                 sh.rope_theta)
        k = rope(self.proj(n1, w["wk"]).view(s, sh.n_kv_heads,
                                             sh.head_dim), sh.rope_theta)
        v = self.proj(n1, w["wv"]).view(s, sh.n_kv_heads, sh.head_dim)
        a = causal_attention(q, k, v).reshape(s, sh.n_heads * sh.head_dim)
        x = x + self.proj(a, w["wo"])
        n2 = rms_norm(x, sh.norm_eps)
        if sh.mlp == "swiglu":
            hid = F.silu(self.proj(n2, w["w_gate"])) * self.proj(n2,
                                                                 w["w_up"])
        else:
            hid = F.gelu(self.proj(n2, w["w_up"]), approximate="tanh")
        return x + self.proj(hid, w["w_down"])

    def last_logits(self, seed: int, prompts: list, device) -> list:
        """The last position's float32 logits (vocab,) of each prompt (a
        1-D tensor of token ids), layer by layer over all prompts."""
        sh = self.shape
        emb = weights.embedding(sh, seed, device)
        hs = [emb[p.to(device)] for p in prompts]
        for index in range(sh.n_layers):
            lp = weights.layer(sh, seed, index, device)
            w = {name: dequant_weight(lp[name], sh.quant, self.weight_bits)
                 for name, _, _ in sh.projections}
            del lp
            hs = [self.block(h, w) for h in hs]
            del w
        return [(rms_norm(h[-1], sh.norm_eps) @ emb.T) for h in hs]


def per_request(served: list, ref: list) -> list:
    """``{top_gap, logit_err, logit_cos_dist}`` of each request:

    * ``top_gap``: how far below the reference's best logit the served
      token's (the served logits' argmax) lies, in units of the
      reference logits' standard deviation;
    * ``logit_err``: ``|served - ref| / |ref|`` (L2 over the vocabulary);
    * ``logit_cos_dist``: ``1 - cos(served, ref)`` over the vocabulary.

    Each infinite where the served logits are not finite."""
    out = []
    for p, r in zip(served, ref):
        p, r = p.to(torch.float32), r.to(torch.float32).to(p.device)
        if not bool(torch.isfinite(p).all()):
            out.append(dict.fromkeys(NUMBERS, math.inf))
            continue
        out.append({
            "top_gap": float((r.max() - r[p.argmax()]) / r.std()),
            "logit_err": float(torch.linalg.vector_norm(p - r)
                               / torch.linalg.vector_norm(r)),
            "logit_cos_dist": float(1.0 - F.cosine_similarity(p, r, dim=0))})
    return out


NUMBERS = ("top_gap", "logit_err", "logit_cos_dist")


def numbers(served: list, ref: list) -> dict:
    """The worst request's value of each of :data:`NUMBERS`
    (:func:`per_request`)."""
    rows = per_request(served, ref)
    return {name: max(r[name] for r in rows) for name in NUMBERS}
