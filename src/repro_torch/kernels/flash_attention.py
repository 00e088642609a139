"""Flash attention forward: tiled online-softmax attention.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel``, built around its ``pl.pallas_call`` in
``flash_attention``) with a CUDA kernel written for Hopper,
``csrc/flash_attention.cu``; its header says what bounds it and how it is
laid out.  Same function as the TPU kernel: q, k, v ``(b, h, s, d)`` with
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

#: kernel launches since the counter was last set to 0
launches = 0


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
    device, ``d`` in :data:`HEAD_DIMS`.  Raises on a CPU tensor, a failed
    build or a failed launch."""
    global launches
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
    from repro_torch.kernels import _build
    lib = _build.library("flash_attention")
    with torch.cuda.device(device):
        out = torch.empty_like(q)
        err = lib.qappa_flash_attention(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            int(q.dtype == torch.bfloat16), b * h, sq, sk, d, int(causal),
            0 if window is None else min(int(window), _INT_MAX),
            ctypes.c_float(_scale(d, scale)),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"({lib.qappa_error_string(err).decode()})")
    launches += 1
    return out
