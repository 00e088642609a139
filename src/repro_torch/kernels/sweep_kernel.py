"""The sweep's aggregate kernel: mapping + energy model + segment sums.

Replaces the Pallas TPU kernel ``repro/kernels/sweep_kernel.py``
(``_sweep_block_body``, built by ``_build_sweep_call`` around its
``pl.pallas_call``, entry point ``sweep_aggregates_pallas``) with a CUDA
kernel written for Hopper, ``csrc/sweep_kernel.cu``.

What it computes: for each config row and each workload segment
``[s, e)``, the x64-free row-stationary mapping + energy model of
:func:`repro_torch.core.dse_batch._sweep_kernel` per layer, a sequential
Kahan sum of total cycles and energy over the segment's layers in layer
order, and the six :data:`AGGREGATE_OUTPUTS` columns -> ``(N, 6 * W)``
float32.

What bounds it on an H100: neither memory nor arithmetic.  It reads ~60
bytes and writes 24 bytes per config for ~50 float32 operations per
(config, layer) — at N = 32768, L = 16 that is under a microsecond of
either — but each (config, layer) cell issues a few hundred instructions,
most of them for ten integer divisions by values that vary from cell to
cell.  There is no matrix product, so tensor cores, TMA and ``wgmma`` do
not apply.  The design (the header of ``csrc/sweep_kernel.cu`` has the
detail):

* one (config, layer) cell per thread and step: a block takes a tile of
  configs x the layers of one segment (:func:`plan` sizes the tiles and
  the one-axis grid over every segment's tiles), stages each cell's cycles
  and energy in shared memory, then one thread per config runs the Kahan
  updates in layer order and the epilogue — the TPU kernel's
  ``(block_n, block_l)`` tile followed by its sequential sum;
* exact integer division through the float reciprocal wherever a cell's
  operands lie in the domain where that is exact, C++ ``/`` elsewhere;
* the packed layer table lives on the device, cached per (layer arrays,
  bounds, device) by :func:`device_table`, so a stream of chunks copies
  it once.

Layers run fastest within a block, so ``(N, L)`` precision columns are
read along contiguous rows; the ragged N edge is masked in the kernel, so
nothing is padded.  Results hold to ≤1e-6 relative of the exact float64
path only because the build keeps IEEE float32 semantics: no fast-math and
no FMA contraction (see ``kernels/_build.py``).

The plain version is :func:`sweep_aggregates_ref`.  The wrapper
:func:`sweep_aggregates` takes it only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.dse_batch import (_CFG_INT32, AGGREGATE_OUTPUTS,
                                        _segment_aggregates, _sweep_kernel)
from repro_torch.kernels._workspace import current_stream

CFG_FIELDS = ("pe_rows", "pe_cols", "num_pes", "act_bits", "weight_bits",
              "glb_kb", "glb_bits", "filter_spad", "psum_spad",
              "spad_bits", "dram_bw_gbps", "mac_energy_pj", "clock_ghz",
              "area_mm2", "leak_mw")
LAY_FIELDS = ("r", "s", "e", "f", "c", "k", "h", "w", "batch", "macs")
# the per-layer precision columns that may be (N, L) instead of (N, 1)
MIXED_CFG_FIELDS = ("act_bits", "weight_bits", "mac_energy_pj")
# config columns the CUDA kernel reads, in the C function's argument order
KERNEL_CFG_FIELDS = ("pe_rows", "pe_cols", "act_bits", "weight_bits",
                     "glb_kb", "glb_bits", "filter_spad", "psum_spad",
                     "spad_bits", "dram_bw_gbps", "mac_energy_pj",
                     "clock_ghz", "area_mm2", "leak_mw")
# the layer-table rows staged in shared memory (int32), then macs (f32)
_TABLE_INT_FIELDS = ("r", "s", "e", "f", "c", "k", "h", "w", "batch")
#: the longest segment a block stages in shared memory
MAX_SEGMENT_LAYERS = 1024
#: threads a block (the kernel's kThreads)
THREADS = 256
#: cells (configs x layers of one segment) a block aims for, and the most
#: configs it takes (one Kahan thread each)
TILE_CELLS = 1024
MAX_TILE_CONFIGS = THREADS
# shared-memory words per layer and per config of a tile, and bytes per
# staged (cycles, energy) pair (the kernel's kLayerWords, kConfigWords)
_LAYER_WORDS = 20
_CONFIG_WORDS = 20
_PAIR_BYTES = 8
# packed device tables kept by device_table
_MAX_TABLES = 16

#: kernel launches since the counter was last set to 0
launches = 0
#: the grid of the last launch as the C entry reported it: (blocks,
#: threads a block, shared-memory bytes a block)
last_grid = None
_Info = ctypes.c_int * 3
_TABLES: dict = {}     # (layer bytes, bounds, device) -> packed table


class Plan(NamedTuple):
    """A launch's geometry: configs per block of each segment, blocks in
    all (every segment's ``ceil(N / tile)``, in segment order) and the
    dynamic shared memory of a block, in bytes."""
    tiles: tuple[int, ...]
    blocks: int
    smem: int


def _tiles(bounds) -> tuple[int, ...]:
    return tuple(min(MAX_TILE_CONFIGS, max(1, TILE_CELLS // (e - s)))
                 for s, e in bounds)


@functools.lru_cache(maxsize=256)
def plan(n: int, bounds: tuple[tuple[int, int], ...]) -> Plan:
    """The grid for ``n`` configs over the segments ``bounds``: each
    segment of ``len`` layers takes tiles of ``min(MAX_TILE_CONFIGS,
    TILE_CELLS // len)`` configs (at least one), so every block computes
    about ``TILE_CELLS`` cells whatever its segment; shared memory holds
    the tile's staged pairs (rows padded to an odd length), its configs'
    values and the segment's layer rows."""
    tiles = _tiles(bounds)
    blocks = sum(-(-n // t) for t in tiles)
    smem = max(_PAIR_BYTES * t * ((e - s) | 1)
               + 4 * (_CONFIG_WORDS * t + _LAYER_WORDS * (e - s))
               for (s, e), t in zip(bounds, tiles))
    return Plan(tiles, blocks, smem)


def _check_inputs(cfg: dict, lay: dict, bounds) -> tuple:
    """Validate fields, shapes, dtypes and bounds; returns
    ``(n, l, bounds)`` with ``bounds`` normalized."""
    missing = [k for k in CFG_FIELDS if k not in cfg]
    if missing:
        raise ValueError(
            f"sweep_aggregates: cfg is missing field(s) {missing}; build "
            f"it with repro_torch.core.dse_batch._to_device_inputs")
    missing = [k for k in LAY_FIELDS if k not in lay]
    if missing:
        raise ValueError(
            f"sweep_aggregates: lay is missing field(s) {missing}; build "
            f"it with repro_torch.core.dse_batch._to_device_inputs")
    n = int(cfg["pe_rows"].shape[0])
    l = int(lay["r"].shape[1]) if lay["r"].dim() == 2 else 0
    if n < 1 or l < 1:
        raise ValueError(
            f"sweep_aggregates: need at least one config and one layer, "
            f"got N={n}, L={l}")
    device = cfg["pe_rows"].device
    for name in CFG_FIELDS:
        t = cfg[name]
        want_widths = (1, l) if name in MIXED_CFG_FIELDS else (1,)
        if t.dim() != 2 or t.shape[0] != n or t.shape[1] not in want_widths:
            raise ValueError(
                f"sweep_aggregates: cfg[{name!r}] has shape "
                f"{tuple(t.shape)}; expected ({n}, w) with w in "
                f"{want_widths}")
        want = torch.int32 if name in _CFG_INT32 else torch.float32
        if t.dtype != want:
            raise ValueError(
                f"sweep_aggregates: cfg[{name!r}] is {t.dtype}, expected "
                f"{want} (the x64-free policy)")
        if t.device != device:
            raise ValueError(
                f"sweep_aggregates: cfg[{name!r}] is on {t.device}, "
                f"cfg['pe_rows'] on {device}")
        if not t.is_contiguous():
            raise ValueError(
                f"sweep_aggregates: cfg[{name!r}] is not contiguous")
    for name in LAY_FIELDS:
        t = lay[name]
        if tuple(t.shape) != (1, l):
            raise ValueError(
                f"sweep_aggregates: lay[{name!r}] has shape "
                f"{tuple(t.shape)}; expected (1, {l})")
        want = torch.float32 if name == "macs" else torch.int32
        if t.dtype != want:
            raise ValueError(
                f"sweep_aggregates: lay[{name!r}] is {t.dtype}, expected "
                f"{want} (the x64-free policy)")
        if t.device.type != "cpu":
            raise ValueError(
                f"sweep_aggregates: lay[{name!r}] is on {t.device}; the "
                f"layer table is host data (the wrapper packs it with the "
                f"segment sums and caches it on the device: device_table)")
    if bounds is None:
        bounds = ((0, l),)
    bounds = tuple((int(s), int(e)) for s, e in bounds)
    if not bounds:
        raise ValueError("sweep_aggregates: bounds must name a segment")
    for s, e in bounds:
        if not (0 <= s < e <= l):
            raise ValueError(
                f"sweep_aggregates: segment bounds ({s}, {e}) are not a "
                f"non-empty slice of the {l}-layer axis")
        if e - s > MAX_SEGMENT_LAYERS:
            raise ValueError(
                f"sweep_aggregates: a segment of {e - s} layers exceeds "
                f"the kernel's {MAX_SEGMENT_LAYERS}")
    return n, l, bounds


def segment_macs(macs: np.ndarray, bounds) -> np.ndarray:
    """Per-segment MAC totals as the reference computes them: a numpy
    float32 sum of the float32 ``macs`` row of each segment."""
    macs = np.asarray(macs, dtype=np.float32).reshape(-1)
    return np.array([macs[s:e].sum(dtype=np.float32) for s, e in bounds],
                    dtype=np.float32)


def sweep_aggregates_ref(cfg: dict, lay: dict, *,
                         bounds: tuple[tuple[int, int], ...] | None = None
                         ) -> dict:
    """The plain PyTorch version on any device: the x64-free mapping per
    layer, per-segment Kahan sums and the epilogue formulas.  ``cfg`` and
    ``lay`` lie on one device.  Returns ``{column: (N,)}`` for
    ``bounds=None``, else ``{column: (W, N)}``."""
    squeeze = bounds is None
    l = int(lay["r"].shape[1])
    if bounds is None:
        bounds = ((0, l),)
    totals = _sweep_kernel(cfg, lay, exact=False, outputs="layer_totals")
    out = _segment_aggregates(totals, cfg, lay, tuple(bounds), exact=False)
    return {k: v[0] for k, v in out.items()} if squeeze else out


def _layer_table(lay: dict, bounds) -> np.ndarray:
    """One int32 buffer: the 9 integer layer rows, the float32 macs row
    (as bits), the ``(W, 2)`` segment bounds, the float32 segment MAC
    totals (as bits) and each segment's configs per block."""
    ints = np.stack([lay[k].numpy()[0] for k in _TABLE_INT_FIELDS])
    macs = lay["macs"].numpy()[0]
    return np.concatenate([
        ints.reshape(-1).astype(np.int32),
        macs.astype(np.float32).view(np.int32),
        np.asarray(bounds, dtype=np.int32).reshape(-1),
        segment_macs(macs, bounds).view(np.int32),
        np.asarray(_tiles(bounds), dtype=np.int32)])


def device_table(lay: dict, bounds, device: torch.device) -> torch.Tensor:
    """The packed layer table (:func:`_layer_table`) on ``device``, built
    and copied once per (layer arrays, bounds, device): the last
    ``_MAX_TABLES`` stay cached, so a stream of chunks over one workload
    copies its table once."""
    key = (b"".join(lay[k].numpy().tobytes() for k in LAY_FIELDS),
           bounds, device)
    table = _TABLES.get(key)
    if table is None:
        if len(_TABLES) >= _MAX_TABLES:
            del _TABLES[next(iter(_TABLES))]
        table = torch.from_numpy(_layer_table(lay, bounds)).to(device)
        _TABLES[key] = table
    return table


def _launch(cfg: dict, lay: dict, bounds, n: int, l: int) -> torch.Tensor:
    global launches, last_grid
    from repro_torch.kernels import _build
    lib = _build.library("sweep_kernel")
    device = cfg["pe_rows"].device
    p = plan(n, bounds)
    table = device_table(lay, bounds, device)
    out = torch.empty((n, 6 * len(bounds)), dtype=torch.float32,
                      device=device)
    wide = [int(cfg[k].shape[1] != 1) for k in MIXED_CFG_FIELDS]
    info = _Info()
    # the launch goes to the tensors' device (a context only when that is
    # not the current one: entering it costs a few µs a call)
    with (contextlib.nullcontext()
          if device.index == torch.cuda.current_device()
          else torch.cuda.device(device)):
        err = lib.qappa_sweep_aggregates(
            *[cfg[k].data_ptr() for k in KERNEL_CFG_FIELDS],
            table.data_ptr(), out.data_ptr(), n, l, len(bounds), p.blocks,
            p.smem, *wide, info, current_stream(device))
    if err != 0:
        raise RuntimeError(
            f"sweep_aggregates kernel launch failed: CUDA error {err} "
            f"({lib.qappa_error_string(err).decode()})")
    last_grid = tuple(info)
    launches += 1
    return out


def sweep_aggregates_packed(cfg: dict, lay: dict, *,
                            bounds: tuple[tuple[int, int], ...] | None = None
                            ) -> torch.Tensor:
    """Aggregate sweep columns as one ``(N, 6 * W)`` float32 tensor on
    ``cfg``'s device (column ``i * W + w`` is column ``i`` of
    :data:`AGGREGATE_OUTPUTS` for segment ``w``).

    ``cfg`` holds ``(N, 1)`` (or ``(N, L)`` for the mixed-precision
    fields) int32/float32 tensors on the CPU or a CUDA device; ``lay``
    holds ``(1, L)`` int32/float32 tensors on the host.  CPU ``cfg`` ->
    the plain version; CUDA ``cfg`` -> the kernel, or an error.
    """
    n, l, bounds = _check_inputs(cfg, lay, bounds)
    device = cfg["pe_rows"].device
    if device.type == "cpu":
        ref = sweep_aggregates_ref(cfg, lay, bounds=bounds)
        return torch.cat([ref[k].T for k in AGGREGATE_OUTPUTS], dim=1)
    if device.type != "cuda":
        raise ValueError(
            f"sweep_aggregates: tensors on {device} are neither CPU nor "
            f"CUDA")
    return _launch(cfg, lay, bounds, n, l)


def sweep_aggregates(cfg: dict, lay: dict, *,
                     bounds: tuple[tuple[int, int], ...] | None = None
                     ) -> dict:
    """Aggregate sweep columns via the CUDA kernel (the plain version for
    CPU tensors).  ``bounds=None`` treats the whole layer axis as one
    workload and returns ``{column: (N,)}``; explicit ``bounds`` returns
    ``{column: (W, N)}``.  Inputs as for :func:`sweep_aggregates_packed`.
    """
    packed = sweep_aggregates_packed(cfg, lay, bounds=bounds)
    w = packed.shape[1] // 6
    if bounds is None:
        return {k: packed[:, i] for i, k in enumerate(AGGREGATE_OUTPUTS)}
    return {k: packed[:, i * w:(i + 1) * w].T
            for i, k in enumerate(AGGREGATE_OUTPUTS)}
