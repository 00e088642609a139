"""Routing of the quantized matmuls between kernel and plain version.

``impl``:

* ``"auto"``: the CUDA kernel for CUDA tensors, the plain version for CPU
  tensors;
* ``"kernel"``: the CUDA kernel; raises for CPU tensors;
* ``"ref"``: the plain version on the tensors' device.

A failed build or launch raises; nothing falls back.  The reference's
padding to block multiples has no counterpart: the kernels mask ragged
edges themselves.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import w4a8_matmul as _w4a8
from repro_torch.kernels import w8a8_matmul as _w8a8

IMPLS = ("auto", "kernel", "ref")


def _use_kernel(x_q: torch.Tensor, impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "kernel" or (impl == "auto" and x_q.device.type != "cpu")


def w8a8_matmul(x_q, w_q, x_scale, w_scale, *, out_dtype=torch.float32,
                impl: str = "auto") -> torch.Tensor:
    """x_q (m, k) int8 x w_q (k, n) int8, dequantized by the scalar
    ``x_scale`` and per-column ``w_scale``."""
    if _use_kernel(x_q, impl):
        return _w8a8.w8a8_matmul(x_q, w_q, x_scale, w_scale,
                                 out_dtype=out_dtype)
    return _w8a8.w8a8_matmul_ref(x_q, w_q, x_scale, w_scale, out_dtype)


def w4a8_matmul(x_q, w_packed, x_scale, w_scale, *,
                out_dtype=torch.float32, impl: str = "auto") -> torch.Tensor:
    """x_q (m, k) int8 x w_packed (k/2, n) packed pow2 codes, dequantized
    by the scalar ``x_scale`` and per-column ``w_scale``."""
    if _use_kernel(x_q, impl):
        return _w4a8.w4a8_matmul(x_q, w_packed, x_scale, w_scale,
                                 out_dtype=out_dtype)
    return _w4a8.w4a8_matmul_ref(x_q, w_packed, x_scale, w_scale, out_dtype)
