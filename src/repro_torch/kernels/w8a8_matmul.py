"""W8A8 matmul: (m, k) int8 x (k, n) int8 -> int32 -> dequantized f32.

Replaces the Pallas TPU kernel ``repro/kernels/w8a8_matmul.py``
(``_w8a8_kernel``, built around its ``pl.pallas_call`` in
``w8a8_matmul``) with a CUDA kernel written for Hopper,
``csrc/w8a8_matmul.cu``; its header says what bounds it and how it is
laid out.  It computes ``out = (float(x_q @ w_q) * x_scale) * w_scale``
with an exact int32 sum, the epilogue's products rounded once each in
that order.

The one C entry runs one of two regimes, which :func:`plan` picks from
the shape (one launch per call either way):

* ``"dp4a"`` for ``m < TC_MIN_M`` (decode): ``__dp4a`` on the CUDA cores,
  the grid split over k so that the card gets at least
  :data:`SPLIT_TARGET_BLOCKS` blocks; the splits add their int32 sums
  into an ``(m, n)`` buffer and the last block of each output tile, told
  by a per-tile counter, runs the epilogue on them.  Sums and counters
  live in the persistent zeroed workspace of the stream
  (``kernels/_workspace.py``), which the kernel leaves zeroed;
* ``"tc"`` for ``m >= TC_MIN_M`` (prefill): the int8 tensor cores
  (``wgmma``), 128 x 128 output tiles.

The plain version :func:`w8a8_matmul_ref` takes the same route on any
device: PyTorch has no integer matmul on CUDA, so the product runs in
float64, which is exact for these sums (below 2^53), and is then cast to
int32.  So kernel and plain version agree bit for bit.
:func:`w8a8_matmul` launches the kernel on CUDA tensors and raises for
any other; ``repro_torch.kernels.ops`` routes CPU tensors to the plain
version.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._workspace import current_stream, workspace

# the int32 sum of k products of at most 128 * 128 stays below 2^31
MAX_K = 2 ** 17 - 1

#: m from which the tensor-core regime runs; below it the split-k dp4a
#: regime.  Measured on a phi4 layer on an H100 (chip_smoke.py phase
#: qmatmul_regimes): dp4a faster at m = 16, the tensor cores from m = 24
TC_MIN_M = 17
#: blocks the dp4a regime aims for: two per SM of an H100 (132 SMs)
SPLIT_TARGET_BLOCKS = 264
#: least k a split walks (4 k to a quad)
SPLIT_MIN_QUADS = 16
TC_TILE = 128             # output rows and columns of a tensor-core block
DP4A_COLS = 128           # output columns of a dp4a block

#: kernel launches since the counters were last set to 0: all of them,
#: and each regime's
launches = 0
launches_dp4a = 0
launches_tc = 0


class Plan(NamedTuple):
    """How one call runs: ``regime`` "dp4a" or "tc"; ``splits`` of k
    (1 for "tc"); ``row_tile`` output rows a block; ``workspace`` int32
    of the split-k workspace, ``m * n`` sums then one counter an output
    tile (0 when ``splits == 1``).  The C entry takes the row tile and
    refuses a workspace smaller than the one its grid needs."""
    regime: str
    splits: int
    row_tile: int
    workspace: int


def split_k(m: int, k: int, n: int) -> tuple[int, int, int]:
    """``(splits, row_tile, workspace)`` of a split-k grid for an
    ``(m, k) x (k, n)`` product: the grid of W8A8's ``dp4a`` regime and of
    the W4A8 kernel (``kernels/w4a8_matmul.plan``).

    ``row_tile`` 4, 8 or 16 rows x ``DP4A_COLS`` columns a block, and k
    split so the grid has at least ``SPLIT_TARGET_BLOCKS`` blocks where k
    allows (``SPLIT_MIN_QUADS`` quads of 4 k a split at least); the
    kernels give the splits ``ceil(k / 4 / splits)`` quads each, the last
    the rest, none empty.  ``workspace``: int32 of ``m * n`` sums then one
    counter an output tile, 0 when ``splits == 1``.
    """
    row_tile = 4 if m <= 4 else 8 if m <= 8 else 16
    tiles = -(-m // row_tile) * -(-n // DP4A_COLS)
    nq = -(-k // 4)                       # k in quads of 4
    want = -(-SPLIT_TARGET_BLOCKS // tiles)
    per = max(SPLIT_MIN_QUADS, nq // want)
    splits = -(-nq // per)                # then ceil(nq / splits) each
    return splits, row_tile, m * n + tiles if splits > 1 else 0


@functools.lru_cache(maxsize=1024)
def plan(m: int, k: int, n: int) -> Plan:
    """The regime and split count for an ``(m, k) x (k, n)`` product
    (cached: a decode step asks for the same few shapes every layer).

    ``m >= TC_MIN_M``: the tensor cores, one block a 128 x 128 tile.
    Else dp4a on the grid of :func:`split_k`.
    """
    if m >= TC_MIN_M:
        return Plan("tc", 1, TC_TILE, 0)
    return Plan("dp4a", *split_k(m, k, n))


def cost(m: int, k: int, n: int, out_dtype=torch.float32
         ) -> tuple[float, float, str]:
    """``(operations, bytes, class)`` of one ``(m, k) x (k, n)`` call, from
    the function it computes: 2 m k n int8 operations; x and w codes, the
    x scale and n w scales read once, the output written once."""
    return (2.0 * m * k * n,
            float(m * k + k * n + 4 + 4 * n + out_dtype.itemsize * m * n),
            "int8")


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
                   w_scale: torch.Tensor, m: int, k: int, n: int,
                   extra: tuple = (), stream: int | None = None
                   ) -> torch.Tensor:
    """Launch one of the quantized matmul kernels on ``stream`` (a CUDA
    stream handle; default the current stream); the scales stay on the
    device (no host sync).  ``extra``: C arguments after ``n`` (a tensor
    passes its address, None a null pointer).  Raises on a CPU tensor, a
    failed build or a failed launch."""
    device = x_q.device
    if device.type != "cuda":
        raise ValueError(
            f"{fn_name}: the kernel takes CUDA tensors, got {device}; the "
            f"plain version runs on the CPU (ops impl='auto' or 'ref')")
    from repro_torch.kernels import _build
    lib = _build.library(lib_name)
    if stream is None:
        stream = current_stream(device)
    extra = [a.data_ptr() if torch.is_tensor(a) else a for a in extra]
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    # the launch goes to the tensors' device (a context only when that is
    # not the current one: entering it costs a few µs a call)
    with (contextlib.nullcontext()
          if device.index == torch.cuda.current_device()
          else torch.cuda.device(device)):
        err = getattr(lib, fn_name)(
            x_q.data_ptr(), w.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), m, k, n, *extra, stream)
    if err != 0:
        raise RuntimeError(
            f"{fn_name} kernel launch failed: CUDA error {err} "
            f"({lib.qappa_error_string(err).decode()})")
    return out


def launch_planned(lib_name: str, fn_name: str, regime: int | None,
                   p: Plan, x_q: torch.Tensor, w: torch.Tensor,
                   x_scale: torch.Tensor, w_scale: torch.Tensor, m: int,
                   k: int, n: int, info=None) -> torch.Tensor:
    """:func:`launch_qmatmul` with a plan's C arguments: the stream's
    split-k workspace (when ``p.splits > 1``) and its length, the regime's
    number in the C entry (None: the entry takes none), the row tile and
    the split count, then ``info`` (a ctypes int array the entry reports
    its launch in) where given."""
    stream = buf = None
    if x_q.is_cuda:
        stream = current_stream(x_q.device)
        if p.splits > 1:
            buf = workspace(x_q.device, p.workspace, stream)
    extra = ((buf, 0 if buf is None else buf.numel())
             + (() if regime is None else (regime,))
             + (p.row_tile, p.splits) + (() if info is None else (info,)))
    return launch_qmatmul(lib_name, fn_name, x_q, w, x_scale, w_scale, m, k,
                          n, extra, stream)


def w8a8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *,
                out_dtype=torch.float32) -> torch.Tensor:
    """The CUDA kernel: x_q (m, k) int8, w_q (k, n) int8, x_scale one
    float32, w_scale n float32 (any shape), all on one CUDA device; the
    regime and split-k workspace as :func:`plan` says."""
    global launches, launches_dp4a, launches_tc
    m, k, n = check_operands("w8a8_matmul", x_q, w_q, x_scale, w_scale,
                             packed=False)
    p = plan(m, k, n)
    out = launch_planned("w8a8_matmul", "qappa_w8a8_matmul",
                         int(p.regime == "tc"), p, x_q, w_q, x_scale,
                         w_scale, m, k, n)
    launches += 1
    if p.regime == "tc":
        launches_tc += 1
    else:
        launches_dp4a += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)
