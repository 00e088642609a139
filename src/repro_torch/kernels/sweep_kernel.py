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
either — so a launch costs its fixed overhead plus the latency of the
serial layer loop, in which about ten integer divisions per layer
dominate the issued instructions.  There is no matrix product, so tensor
cores, TMA and ``wgmma`` do not apply.  The design is one thread per
(config, segment) on a ``(ceil(N / 256), W)`` grid: each thread walks its
segment's layers in order with the Kahan state in registers — the TPU
kernel's sequential grid axis over layer tiles becomes that loop — and
the block stages the segment's layer fields in shared memory, where every
thread of the block reads the same word (a broadcast).  Per-config
columns are read coalesced; the ragged N edge is masked in the kernel, so
nothing is padded.  Results hold to ≤1e-6 relative of the exact float64
path only because the build keeps IEEE float32 semantics: no fast-math and
no FMA contraction (see ``kernels/_build.py``).

The plain version is :func:`sweep_aggregates_ref`.  The wrapper
:func:`sweep_aggregates` takes it only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.dse_batch import (_CFG_INT32, AGGREGATE_OUTPUTS,
                                        _segment_aggregates, _sweep_kernel)

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
# shared memory holds 10 words per layer of the longest segment
MAX_SEGMENT_LAYERS = 1024

#: kernel launches since the counter was last set to 0
launches = 0


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
                f"segment sums and copies it with the launch)")
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
    (as bits), the ``(W, 2)`` segment bounds and the float32 segment MAC
    totals (as bits)."""
    ints = np.stack([lay[k].numpy()[0] for k in _TABLE_INT_FIELDS])
    macs = lay["macs"].numpy()[0]
    return np.concatenate([
        ints.reshape(-1).astype(np.int32),
        macs.astype(np.float32).view(np.int32),
        np.asarray(bounds, dtype=np.int32).reshape(-1),
        segment_macs(macs, bounds).view(np.int32)])


def _launch(cfg: dict, lay: dict, bounds, n: int, l: int) -> torch.Tensor:
    global launches
    from repro_torch.kernels import _build
    lib = _build.library("sweep_kernel")
    device = cfg["pe_rows"].device
    w = len(bounds)
    with torch.cuda.device(device):
        table = torch.from_numpy(_layer_table(lay, bounds)).pin_memory() \
            .to(device, non_blocking=True)
        out = torch.empty((n, 6 * w), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        wide = [int(cfg[k].shape[1] != 1) for k in MIXED_CFG_FIELDS]
        err = lib.qappa_sweep_aggregates(
            *[ctypes.c_void_p(cfg[k].data_ptr()) for k in KERNEL_CFG_FIELDS],
            ctypes.c_void_p(table.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            n, l, w, max(e - s for s, e in bounds), *wide,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"sweep_aggregates kernel launch failed: CUDA error {err} "
            f"({lib.qappa_error_string(err).decode()})")
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
