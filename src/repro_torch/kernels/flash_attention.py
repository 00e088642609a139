"""Flash attention forward: tiled online-softmax attention.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel``, built around its ``pl.pallas_call`` in
``flash_attention``) with two CUDA kernels written for Hopper, one per
operand dtype; each source's header says what bounds it and how it is
laid out:

* bfloat16: ``csrc/flash_attention_tc.cu``, both products on the bf16
  tensor cores (``wgmma``), for every d in :data:`HEAD_DIMS` (d below 64
  is zero-padded to 64 in shared memory).  The tensor cores take P in
  bf16, which the TPU kernel keeps in float32: the kernel splits P into
  two bf16 parts (~16 bits) for two PV products, within the bf16 bound
  of 2e-2.
* float32: ``csrc/flash_attention.cu``, both products on the TF32 tensor
  cores (``wgmma``) in three products on split operands (3xTF32): each
  operand is a TF32 hi part plus a TF32 lo part (the float32 rest), and
  ``a . b = a_lo . b_hi + a_hi . b_lo + a_hi . b_hi`` in float32, ~2^-21
  relative a product where one TF32 product alone (~1e-3) would break the
  float32 bound of 1e-5.  The softmax stays float32 on the CUDA cores.

Same function as the TPU kernel: q, k, v ``(b, h, s, d)`` with
the kv heads broadcast, float32 or bfloat16, computed in float32; causal
mask, optional sliding window (``ki > qi - window``), or neither; the last
q row aligned to the last key (``qi = i + sk - sq``); masked logits
filled with -1e30 and ``l`` floored at 1e-30; out in q's dtype.  Unlike
the TPU entry point, any ``sq`` and ``sk`` are taken: the kernel masks
the ragged tail of its tiles itself, so nothing is padded.

The plain version :func:`flash_attention_ref` follows
``ref.flash_attention_ref``: a dense float32 softmax over all keys, with
``-inf`` in the masked places (it agrees with the kernel's -1e30 wherever
a row has a live key) and the scale ``d^-0.5`` as a float, the TPU
kernel's (the reference's oracle rounds the scale to q's dtype first).
"""

from __future__ import annotations

import ctypes

import torch

#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 128, 256)
_INT_MAX = 2 ** 31 - 1

#: kernel launches since the counters were last set to 0: all of them,
#: the bf16 route's, the float32 (3xTF32) route's, and those with a
#: sliding window (either route)
launches = 0
launches_tc = 0
launches_f32 = 0
launches_windowed = 0


def _scale(d: int, scale) -> float:
    return float(scale) if scale is not None else float(d) ** -0.5


def _mask(sq: int, sk: int, causal: bool, window, device) -> torch.Tensor:
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """The plain version: q, k, v ``(b, h, s, d)``; out ``(b, h, sq, d)``
    in q's dtype."""
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * _scale(d, scale)
    logits = logits.masked_fill(
        ~_mask(sq, sk, causal, window, q.device), float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return out.to(q.dtype)


def check_operands(q, k, v, window) -> tuple[int, int, int, int, int]:
    """Validate the operands; returns ``(b, h, sq, sk, d)``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention: q, k, v must be (b, h, s, d), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"flash_attention: k and v must be ({b}, {h}, sk, {d}) alike, "
            f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if min(b, h, sq, sk) < 1:
        raise ValueError("flash_attention: empty operands")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q, k, v float32 or bfloat16 alike, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(
                f"flash_attention: operands on {t.device} and {q.device}")
    return b, h, sq, sk, d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """The CUDA kernel: contiguous q, k, v ``(b, h, s, d)`` on one CUDA
    device with 16-byte aligned bases, ``d`` in :data:`HEAD_DIMS`.
    bfloat16 goes to the bf16 tensor-core kernel
    (``csrc/flash_attention_tc.cu``), float32 to the 3xTF32 kernel
    (``csrc/flash_attention.cu``); the dispatch is on dtype alone.  Raises
    on a CPU tensor, a failed build or a failed launch."""
    global launches, launches_tc, launches_f32, launches_windowed
    b, h, sq, sk, d = check_operands(q, k, v, window)
    device = q.device
    if device.type != "cuda":
        raise ValueError(
            f"flash_attention: the kernel takes CUDA tensors, got {device}; "
            f"the plain version runs on the CPU (ops impl='auto' or 'ref')")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: the kernel is built for head dims "
            f"{HEAD_DIMS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: operands must be contiguous")
    tc = q.dtype == torch.bfloat16
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must start on 16-byte "
                         "boundaries")
    from repro_torch.kernels import _build
    window_arg = 0 if window is None else min(int(window), _INT_MAX)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v)]
    with torch.cuda.device(device):
        out = torch.empty_like(q)
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        if tc:
            lib = _build.library("flash_attention_tc")
            err = lib.qappa_flash_attention_tc(
                *ptrs, ctypes.c_void_p(out.data_ptr()), b * h, sq, sk, d,
                int(causal), window_arg, ctypes.c_float(_scale(d, scale)),
                stream)
        else:
            lib = _build.library("flash_attention")
            err = lib.qappa_flash_attention(
                *ptrs, ctypes.c_void_p(out.data_ptr()), b * h, sq, sk, d,
                int(causal), window_arg, ctypes.c_float(_scale(d, scale)),
                stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"({lib.qappa_error_string(err).decode()})")
    launches += 1
    launches_windowed += window is not None
    if tc:
        launches_tc += 1
    else:
        launches_f32 += 1
    return out
