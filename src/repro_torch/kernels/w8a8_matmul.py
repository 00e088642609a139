"""W8A8 matmul: (m, k) int8 x (k, n) int8 -> int32 -> dequantized f32.

Replaces the Pallas TPU kernel ``repro/kernels/w8a8_matmul.py``
(``_w8a8_kernel``, built around its ``pl.pallas_call`` in
``w8a8_matmul``) with a CUDA kernel written for Hopper,
``csrc/w8a8_matmul.cu``; its header says what bounds it and how it is
laid out.  It computes ``out = (float(x_q @ w_q) * x_scale) * w_scale``
with an exact int32 sum, the epilogue's products rounded once each in
that order.

The plain version :func:`w8a8_matmul_ref` takes the same route on any
device: PyTorch has no integer matmul on CUDA, so the product runs in
float64, which is exact for these sums (below 2^53), and is then cast to
int32.  So kernel and plain version agree bit for bit.
:func:`w8a8_matmul` launches the kernel on CUDA tensors and raises for
any other; ``repro_torch.kernels.ops`` routes CPU tensors to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

# the int32 sum of k products of at most 128 * 128 stays below 2^31
MAX_K = 2 ** 17 - 1

#: kernel launches since the counter was last set to 0
launches = 0


def w8a8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                    x_scale: torch.Tensor, w_scale: torch.Tensor,
                    out_dtype=torch.float32) -> torch.Tensor:
    """The plain version: exact int32 product, then
    ``(acc * x_scale) * w_scale`` in float32."""
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)
    return (acc.to(torch.float32) * x_scale * w_scale).to(out_dtype)


def check_operands(name: str, x_q: torch.Tensor, w: torch.Tensor,
                   x_scale: torch.Tensor, w_scale: torch.Tensor, *,
                   packed: bool) -> tuple[int, int, int]:
    """Validate a quantized matmul's operands; returns ``(m, k, n)``."""
    if x_q.dim() != 2 or w.dim() != 2:
        raise ValueError(
            f"{name}: x_q and w must be 2-D, got {tuple(x_q.shape)} and "
            f"{tuple(w.shape)}")
    m, k = x_q.shape
    kw, n = w.shape
    if (2 * kw if packed else kw) != k:
        raise ValueError(
            f"{name}: x_q {tuple(x_q.shape)} does not contract with w "
            f"{tuple(w.shape)}"
            + (" (two 4-bit codes per byte along k)" if packed else ""))
    if min(m, k, n) < 1 or k > MAX_K:
        raise ValueError(
            f"{name}: need 1 <= m, n and 1 <= k <= {MAX_K} (the int32 "
            f"sum's range), got m={m}, k={k}, n={n}")
    if x_q.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(
            f"{name}: x_q and w must be int8, got {x_q.dtype} and "
            f"{w.dtype}")
    if x_scale.numel() != 1 or w_scale.numel() != n:
        raise ValueError(
            f"{name}: need one x_scale and {n} w_scale values, got "
            f"{x_scale.numel()} and {w_scale.numel()}")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise ValueError(
            f"{name}: scales must be float32, got {x_scale.dtype} and "
            f"{w_scale.dtype}")
    for t in (x_q, w, x_scale, w_scale):
        if t.device != x_q.device:
            raise ValueError(
                f"{name}: operands on {t.device} and {x_q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return m, k, n


def launch_qmatmul(lib_name: str, fn_name: str, x_q: torch.Tensor,
                   w: torch.Tensor, x_scale: torch.Tensor,
                   w_scale: torch.Tensor, m: int, k: int,
                   n: int) -> torch.Tensor:
    """Launch one of the quantized matmul kernels on the current stream;
    the scales stay on the device (no host sync).  Raises on a CPU
    tensor, a failed build or a failed launch."""
    device = x_q.device
    if device.type != "cuda":
        raise ValueError(
            f"{fn_name}: the kernel takes CUDA tensors, got {device}; the "
            f"plain version runs on the CPU (ops impl='auto' or 'ref')")
    from repro_torch.kernels import _build
    lib = _build.library(lib_name)
    with torch.cuda.device(device):
        out = torch.empty((m, n), dtype=torch.float32, device=device)
        err = getattr(lib, fn_name)(
            ctypes.c_void_p(x_q.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(x_scale.data_ptr()),
            ctypes.c_void_p(w_scale.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), m, k, n,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(
            f"{fn_name} kernel launch failed: CUDA error {err} "
            f"({lib.qappa_error_string(err).decode()})")
    return out


def w8a8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *,
                out_dtype=torch.float32) -> torch.Tensor:
    """The CUDA kernel: x_q (m, k) int8, w_q (k, n) int8, x_scale one
    float32, w_scale n float32 (any shape), all on one CUDA device."""
    global launches
    m, k, n = check_operands("w8a8_matmul", x_q, w_q, x_scale, w_scale,
                             packed=False)
    out = launch_qmatmul("w8a8_matmul", "qappa_w8a8_matmul", x_q, w_q,
                         x_scale, w_scale, m, k, n)
    launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)
