"""W4A8-pow2 matmul: (m, k) int8 activations x (k/2, n) int8 weights of
nibble-packed power-of-two codes -> dequantized f32.

Replaces the Pallas TPU kernel ``repro/kernels/w4a8_matmul.py``
(``_w4a8_kernel`` and ``_decode_pow2_block``, built around its
``pl.pallas_call`` in ``w4a8_matmul``) with a CUDA kernel written for
Hopper, ``csrc/w4a8_matmul.cu``; its header says what bounds it and how
it is laid out.  Packed row ``p`` holds ``k = 2p`` in the low nibble and
``k = 2p + 1`` in the high one; a code is ``sign << 3 | e`` with value
``+-2^(e - 7)``.

The one C entry runs one of two regimes, which :func:`plan` picks from
the shape (one launch a call either way; the entry reports its grid,
which the wrapper keeps as :data:`last_grid`):

* ``"splitk"`` for ``m < TC_MIN_M`` (decode): on W8A8's split grid
  (``w8a8_matmul.split_k``), the codes decoded in registers into
  magnitude bytes, ``dp4a`` on the CUDA cores, and k split so the card
  gets at least ``SPLIT_TARGET_BLOCKS`` blocks where k allows; the splits
  add their int32 sums into the persistent zeroed workspace of the
  stream (``kernels/_workspace.py``) and the last block of each output
  tile runs the epilogue and leaves the workspace zeroed;
* ``"tc"`` for ``m >= TC_MIN_M`` (prefill): the int8 tensor cores
  (``wgmma`` s32.s8.u8, two products a k step), 128 x 128 output tiles,
  each packed tile decoded in shared memory into the magnitude tiles the
  products read.

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

from repro_torch.kernels.w8a8_matmul import (TC_TILE, Plan, check_operands,
                                             launch_planned, split_k)
from repro_torch.kernels.w8a8_matmul import cost as w8a8_cost
from repro_torch.quant.quantizers import POW2_EXP_BIAS, unpack_int4

#: m from which the tensor-core regime runs; below it split-k.  Measured
#: on a phi4-mini and a llama-3.2-vision-90b layer on an H100, weights
#: read cold (chip_smoke.py phase qmatmul_regimes): below 129 rows the tc
#: grid has only n / 128 blocks, so split-k stays faster on phi4 up to
#: m = 48 and tc is faster from 64; on llama tc is faster from m = 24
TC_MIN_M = 64
REGIMES = ("splitk", "tc")

#: kernel launches since the counters were last set to 0: all of them,
#: and each regime's
launches = 0
launches_splitk = 0
launches_tc = 0
#: the grid of the last launch as the C entry reported it: (columns /
#: 128, row tiles, splits)
last_grid = None
_Info = ctypes.c_int * 3


def plan(m: int, k: int, n: int, regime: str | None = None) -> Plan:
    """The regime, row tile and split count for an ``(m, k) x (k, n)``
    product (``k / 2`` packed rows).

    ``m >= TC_MIN_M``: the tensor cores, one block a 128 x 128 tile.
    Else split-k on the grid of
    :func:`~repro_torch.kernels.w8a8_matmul.split_k`.  ``regime``
    ("splitk" or "tc") forces one whatever m is.
    """
    if regime is None:
        regime = "tc" if m >= TC_MIN_M else "splitk"
    elif regime not in REGIMES:
        raise ValueError(f"w4a8_matmul: regime {regime!r} not in {REGIMES}")
    return _plan(regime, m, k, n)


@functools.lru_cache(maxsize=1024)
def _plan(regime: str, m: int, k: int, n: int) -> Plan:
    # cached: a decode step asks for the same few shapes every layer
    if regime == "tc":
        return Plan("tc", 1, TC_TILE, 0)
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
                out_dtype=torch.float32,
                regime: str | None = None) -> torch.Tensor:
    """The CUDA kernel: x_q (m, k) int8 with k even, w_packed (k/2, n)
    int8, x_scale one float32, w_scale n float32, on one CUDA device; the
    regime and split-k workspace as :func:`plan` says (``regime`` forces
    one, for timing and tests)."""
    global launches, launches_splitk, launches_tc, last_grid
    m, k, n = check_operands("w4a8_matmul", x_q, w_packed, x_scale,
                             w_scale, packed=True)
    p = plan(m, k, n, regime)
    info = _Info()
    out = launch_planned("w4a8_matmul", "qappa_w4a8_matmul", p, x_q,
                         w_packed, x_scale, w_scale, m, k, n, info)
    last_grid = tuple(info)
    launches += 1
    if p.regime == "tc":
        launches_tc += 1
    else:
        launches_splitk += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)
