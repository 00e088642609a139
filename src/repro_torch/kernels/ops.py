"""Routing of the port's kernels between kernel and plain version: the
quantized matmuls, the int8-KV decode attention and flash attention.

``impl``:

* ``"auto"``: the CUDA kernel for CUDA tensors, the plain version for CPU
  tensors;
* ``"kernel"``: the CUDA kernel; raises for CPU tensors;
* ``"ref"``: the plain version on the tensors' device.

The kernels have no backward: they write their outputs through ctypes,
outside autograd (the reference's Pallas kernels have no ``custom_vjp``
either, and it trains through its plain XLA route).  So one rule comes
before the device: where autograd would record the operation (grad is
enabled and an operand that carries a gradient requires it,
:func:`needs_grad`), ``"auto"`` takes the plain version, which autograd
differentiates, and ``"kernel"`` raises.  Under ``torch.no_grad()`` the
card routes as above.

A failed build or launch raises; nothing falls back.  The reference's
padding to block multiples (and its assertion of divisible lengths for
flash attention) has no counterpart: the kernels mask ragged edges
themselves.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import w4a8_matmul as _w4a8
from repro_torch.kernels import w8a8_decode as _dec
from repro_torch.kernels import w8a8_matmul as _w8a8

IMPLS = ("auto", "kernel", "ref")


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an operation on ``tensors``: grad is
    enabled and one of them requires it."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def on_card(x: torch.Tensor) -> bool:
    """Whether ``"auto"`` finds ``x`` on a device that runs the kernels."""
    return x.device.type != "cpu"


def use_kernel(x_q: torch.Tensor, impl: str, *, grad=()) -> bool:
    """Whether ``impl`` sends an operation on ``x_q``'s device to its
    kernel.  ``grad``: the operands a gradient would flow through; when
    :func:`needs_grad` holds for them the plain version runs (``"auto"``)
    or the call raises (``"kernel"``), since no kernel has a backward."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if needs_grad(*grad):
        if impl == "kernel":
            raise RuntimeError(
                "the CUDA kernels have no backward: an operand requires "
                "grad under torch.is_grad_enabled(); use impl='auto' (the "
                "plain version under grad) or torch.no_grad()")
        return False
    return impl == "kernel" or (impl == "auto" and on_card(x_q))


def w8a8_matmul(x_q, w_q, x_scale, w_scale, *, out_dtype=torch.float32,
                impl: str = "auto") -> torch.Tensor:
    """x_q (m, k) int8 x w_q (k, n) int8, dequantized by the scalar
    ``x_scale`` and per-column ``w_scale``."""
    if use_kernel(x_q, impl, grad=(x_scale, w_scale)):
        return _w8a8.w8a8_matmul(x_q, w_q, x_scale, w_scale,
                                 out_dtype=out_dtype)
    return _w8a8.w8a8_matmul_ref(x_q, w_q, x_scale, w_scale, out_dtype)


def w4a8_matmul(x_q, w_packed, x_scale, w_scale, *,
                out_dtype=torch.float32, impl: str = "auto") -> torch.Tensor:
    """x_q (m, k) int8 x w_packed (k/2, n) packed pow2 codes, dequantized
    by the scalar ``x_scale`` and per-column ``w_scale``."""
    if use_kernel(x_q, impl, grad=(x_scale, w_scale)):
        return _w4a8.w4a8_matmul(x_q, w_packed, x_scale, w_scale,
                                 out_dtype=out_dtype)
    return _w4a8.w4a8_matmul_ref(x_q, w_packed, x_scale, w_scale, out_dtype)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None, impl: str = "auto") -> torch.Tensor:
    """Attention forward over q, k, v ``(b, h, s, d)`` with the kv heads
    broadcast (see ``flash_attention.flash_attention_ref``)."""
    if use_kernel(q, impl, grad=(q, k, v)):
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale)
    return _flash.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      scale=scale)


def w8a8_decode_attention(q, k_q, v_q, k_scale, v_scale, pos, *,
                          bs: int = 512, impl: str = "auto") -> torch.Tensor:
    """int8-KV grouped decode attention, q quantized in float32 (the TPU
    entry point; see ``w8a8_decode.w8a8_decode_attention_ref``)."""
    if use_kernel(q, impl, grad=(q, k_scale, v_scale)):
        return _dec.w8a8_decode_attention(q, k_q, v_q, k_scale, v_scale, pos,
                                          bs=bs)
    return _dec.w8a8_decode_attention_ref(q, k_q, v_q, k_scale, v_scale, pos,
                                          bs=bs)


def w8a8_decode_attention_body(q_q, factor, k_q, v_q, k_scale, v_scale, pos,
                               *, bs: int, out_dtype=torch.float32,
                               impl: str = "auto") -> torch.Tensor:
    """The body of :func:`w8a8_decode_attention` on q codes and per-row
    logit factors that the caller computed (the model's bf16 form)."""
    fn = _dec.w8a8_decode_attention_body \
        if use_kernel(q_q, impl, grad=(factor, k_scale, v_scale)) \
        else _dec.w8a8_decode_attention_body_ref
    return fn(q_q, factor, k_q, v_q, k_scale, v_scale, pos, bs=bs,
              out_dtype=out_dtype)
