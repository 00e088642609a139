"""W4A8-pow2 matmul: (m, k) int8 activations x (k/2, n) int8 weights of
nibble-packed power-of-two codes -> dequantized f32.

Replaces the Pallas TPU kernel ``repro/kernels/w4a8_matmul.py``
(``_w4a8_kernel`` and ``_decode_pow2_block``, built around its
``pl.pallas_call`` in ``w4a8_matmul``) with a CUDA kernel written for
Hopper, ``csrc/w4a8_matmul.cu``; its header says what bounds it and how
it is laid out.  Packed row ``p`` holds ``k = 2p`` in the low nibble and
``k = 2p + 1`` in the high one; a code is ``sign << 3 | e`` with value
``+-2^(e - 7)``.

The C entry runs one split-k kernel for every m, on the grid that
:func:`plan` gives (W8A8's, ``w8a8_matmul.split_k``): the codes decoded in
registers into magnitude bytes, ``dp4a`` on the CUDA cores, and k split
so the card gets at least ``SPLIT_TARGET_BLOCKS`` blocks where k allows;
the splits add their int32 sums into the persistent zeroed workspace of
the stream (``kernels/_workspace.py``) and the last block of each output
tile runs the epilogue and leaves the workspace zeroed.  One launch a
call; the entry reports its grid, which the wrapper keeps as
:data:`last_grid`.

It sums the integers ``+-(x_q << e)`` exactly in int32 and computes
``out = ((float(acc) * 2^-7) * x_scale) * w_scale``.  The plain version
:func:`w4a8_matmul_ref` computes the same exact sum in float64 and the
same epilogue, so kernel and plain version agree bit for bit; both differ
from the reference's float32 sum (``repro.kernels.ref.w4a8_matmul_ref``)
only by that sum's rounding.  :func:`w4a8_matmul` launches the kernel on
CUDA tensors and raises for any other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.w8a8_matmul import (Plan, check_operands,
                                             launch_planned, split_k)
from repro_torch.kernels.w8a8_matmul import cost as w8a8_cost
from repro_torch.quant.quantizers import POW2_EXP_BIAS, unpack_int4

#: kernel launches since the counter was last set to 0
launches = 0
#: the grid of the last launch as the C entry reported it: (columns /
#: 128, row tiles, splits)
last_grid = None
_Info = ctypes.c_int * 3


@functools.lru_cache(maxsize=1024)
def plan(m: int, k: int, n: int) -> Plan:
    """The row tile and split count for an ``(m, k) x (k, n)`` product
    (``k / 2`` packed rows), on the grid of
    :func:`~repro_torch.kernels.w8a8_matmul.split_k` (cached: a decode
    step asks for the same few shapes every layer)."""
    return Plan("splitk", *split_k(m, k, n))


def cost(m: int, k: int, n: int, out_dtype=torch.float32
         ) -> tuple[float, float, str]:
    """``(operations, bytes, class)`` of one call: W8A8's
    (:func:`~repro_torch.kernels.w8a8_matmul.cost`) with the weights at
    half a byte each."""
    ops, nbytes, cls = w8a8_cost(m, k, n, out_dtype)
    return ops, nbytes - k * n + k * n // 2, cls


def pow2_integers(w_packed: torch.Tensor) -> torch.Tensor:
    """``(k/2, n)`` packed codes -> ``(k, n)`` float64 integers ``+-2^e``
    (the weights without their ``2^-7`` bias)."""
    codes = unpack_int4(w_packed.T).T                 # (k, n)
    mag = torch.exp2((codes & 7).to(torch.float64))
    return torch.where((codes & 8) != 0, -mag, mag)


def w4a8_matmul_ref(x_q: torch.Tensor, w_packed: torch.Tensor,
                    x_scale: torch.Tensor, w_scale: torch.Tensor,
                    out_dtype=torch.float32) -> torch.Tensor:
    """The plain version: exact int32 sum of ``x_q * +-2^e``, then
    ``((acc * 2^-7) * x_scale) * w_scale`` in float32."""
    acc = (x_q.to(torch.float64) @ pow2_integers(w_packed)).to(torch.int32)
    out = acc.to(torch.float32) * 2.0 ** -POW2_EXP_BIAS
    return (out * x_scale * w_scale).to(out_dtype)


def w4a8_matmul(x_q: torch.Tensor, w_packed: torch.Tensor,
                x_scale: torch.Tensor, w_scale: torch.Tensor, *,
                out_dtype=torch.float32) -> torch.Tensor:
    """The CUDA kernel: x_q (m, k) int8 with k even, w_packed (k/2, n)
    int8, x_scale one float32, w_scale n float32, on one CUDA device; the
    regime and split-k workspace as :func:`plan` says."""
    global launches, last_grid
    m, k, n = check_operands("w4a8_matmul", x_q, w_packed, x_scale,
                             w_scale, packed=True)
    info = _Info()
    out = launch_planned("w4a8_matmul", "qappa_w4a8_matmul", None,
                         plan(m, k, n), x_q, w_packed, x_scale, w_scale,
                         m, k, n, info)
    last_grid = tuple(info)
    launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)
