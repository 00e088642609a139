"""Quantization-aware linear algebra of the model layers.

One entry point, :func:`qdot`:

* **serve**: weights are stored quantized (:class:`QuantizedTensor`: int8,
  or nibble-packed pow2-int4), activations are quantized per tensor to
  int8 on the fly, and the contraction runs on a CUDA kernel with a fused
  dequantizing epilogue (:mod:`repro_torch.kernels.ops`; the plain
  version on the CPU);
* **train (QAT)**: under a quantized policy with ``train=True``, the
  weight (per output channel) and the activation (per tensor) are
  fake-quantized with a straight-through gradient and contract in the
  compute dtype with ``torch.matmul``, as the reference computes them in
  XLA outside any Pallas kernel;
* **eval**: a float weight contracts in the policy's compute dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.quant import quantizers as qz
from repro_torch.quant.policy import ExecMode, QuantPolicy


@dataclasses.dataclass
class QuantizedTensor:
    """Serving-time quantized weight: data + per-output-channel scales.

    ``data`` layout:
      * w8a8: int8, logical shape (d_in, d_out)
      * w4a8_pow2: int8 nibble-packed pow2 codes, shape (d_in//2, d_out),
        packed along d_in (two input-channel codes per byte)
    """

    data: torch.Tensor
    scale: torch.Tensor       # (1, d_out) float32
    mode: str                 # ExecMode value
    orig_shape: tuple         # logical (d_in, d_out)


def quantize_weight(w: torch.Tensor, policy: QuantPolicy) -> QuantizedTensor:
    """Quantize a (d_in, d_out) weight for serving."""
    if w.dim() != 2:
        raise ValueError(
            f"quantize_weight expects (d_in, d_out), got {tuple(w.shape)}")
    if policy.mode == ExecMode.W8A8:
        scale = qz.int_scale(w, 8, axis=0)              # (1, d_out)
        q = qz.quantize_int(w, scale, 8)
        return QuantizedTensor(q, scale, policy.mode.value, tuple(w.shape))
    if policy.mode == ExecMode.W4A8_POW2:
        scale = qz.pow2_scale(w, axis=0)                # (1, d_out)
        codes = qz.pow2_encode(w, scale)                # (d_in, d_out)
        packed = qz.pack_int4(codes.T).T.contiguous()   # pack along d_in
        return QuantizedTensor(packed, scale, policy.mode.value,
                               tuple(w.shape))
    raise ValueError(f"mode {policy.mode} is not a quantized mode")


def dequantize_weight(qw: QuantizedTensor,
                      dtype=torch.float32) -> torch.Tensor:
    if qw.mode == ExecMode.W8A8.value:
        return qz.dequantize_int(qw.data, qw.scale, dtype)
    if qw.mode == ExecMode.W4A8_POW2.value:
        codes = qz.unpack_int4(qw.data.T).T
        return qz.pow2_decode(codes, qw.scale, dtype)
    raise ValueError(qw.mode)


def weight_quant_spec(policy: QuantPolicy, axis=0) -> qz.FakeQuantSpec:
    """FakeQuantSpec for a (d_in, d_out) weight under ``policy``."""
    if policy.mode == ExecMode.W8A8:
        return qz.FakeQuantSpec("int", 8, axis)
    if policy.mode == ExecMode.W4A8_POW2:
        return qz.FakeQuantSpec("pow2", axis=axis)
    return qz.FakeQuantSpec("none")


def act_quant_spec(policy: QuantPolicy) -> qz.FakeQuantSpec:
    """FakeQuantSpec for activations (dynamic per-tensor int8, or none)."""
    if policy.quantized and policy.qat_acts:
        return qz.FakeQuantSpec("int", 8)
    return qz.FakeQuantSpec("none")


def qat_weight(w: torch.Tensor, policy: QuantPolicy,
               axis=0) -> torch.Tensor:
    """Fake-quantized weight view for training; STE gradients."""
    return qz.fake_quant(w, weight_quant_spec(policy, axis=axis))


def qat_act(x: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """Fake-quantized activation (dynamic per-tensor int8)."""
    return qz.fake_quant(x, act_quant_spec(policy))


def int8_dot(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
             w_scale: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """(m, k) int8 x (k, n) int8 -> exact int32 -> dequant, the plain
    integer contraction on any device."""
    return ops.w8a8_matmul(x_q, w_q, x_scale, w_scale, out_dtype=out_dtype,
                           impl="ref")


def serve_dot(x: torch.Tensor, qw: QuantizedTensor, out_dtype=None, *,
              impl: str = "auto") -> torch.Tensor:
    """Quantized serving matmul on the last dim of ``x``; ``impl`` as in
    :mod:`repro_torch.kernels.ops`."""
    out_dtype = out_dtype or x.dtype
    d_in, d_out = qw.orig_shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d_in).to(torch.float32)
    x_scale = qz.int_scale(x2, 8, axis=None)
    x_q = qz.quantize_int(x2, x_scale, 8)
    w_scale = qw.scale.reshape(-1)
    if qw.mode == ExecMode.W8A8.value:
        out = ops.w8a8_matmul(x_q, qw.data, x_scale, w_scale, impl=impl)
    elif qw.mode == ExecMode.W4A8_POW2.value:
        out = ops.w4a8_matmul(x_q, qw.data, x_scale, w_scale, impl=impl)
    else:
        raise ValueError(qw.mode)
    return out.reshape(*lead, d_out).to(out_dtype)


def _one_split_lead(x):
    """``x`` with its leading dims (all but the last) split over ranks on
    one dim at most: a ``DTensor`` split on two (the batch on "data", the
    sequence on "model") has the later one gathered, the all-gather of
    sequence parallelism before a projection: the product then splits
    the weight's columns over "model" instead of gathering the weight,
    and the quantized one can flatten the leading dims, which a
    ``DTensor`` views only from one split dim."""
    if not ops.sharded(x):
        return x
    from torch.distributed.tensor import Replicate
    first, placements = None, list(x.placements)
    for i, p in enumerate(placements):
        d = getattr(p, "dim", None)
        if d is None or d == x.dim() - 1:
            continue
        if first is None:
            first = d
        elif d != first:
            placements[i] = Replicate()
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _matmul(a, b):
    """``a @ b``; on ``DTensor`` operands on each card's shards by the
    quantized products' rule (``ops.on_local_shards``: rows and output
    columns split, a split contraction a ``Partial`` output), so a
    product's placements and collectives do not depend on its route or
    on DTensor's own ``mm`` strategy."""
    if not ops.sharded(a, b):
        return torch.matmul(a, b)
    lead = tuple(f"m{i}" for i in range(a.dim() - 1))
    return ops.on_local_shards(torch.matmul, (a, b),
                               (lead + ("k",), ("k", "n")), lead + ("n",),
                               split=lead + ("n",), sums=("k",))


def qdot(x: torch.Tensor, w, policy: QuantPolicy, *, train: bool,
         impl: str = "auto") -> torch.Tensor:
    """Quantization-aware (..., d_in) x (d_in, d_out) contraction."""
    x = _one_split_lead(x)
    if isinstance(w, QuantizedTensor):
        return serve_dot(x, w, impl=impl)
    if train and policy.quantized:
        cd = policy.compute_dtype
        return _matmul(qat_act(x, policy).to(cd),
                       qat_weight(w, policy, axis=0).to(cd))
    return _matmul(x.to(policy.compute_dtype), w.to(policy.compute_dtype))
