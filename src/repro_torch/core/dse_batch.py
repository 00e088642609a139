"""Batched DSE sweep engine on torch tensors.

Port of :mod:`repro.core.dse_batch`: the design space becomes
struct-of-arrays columns on the host, the row-stationary mapping + energy
model runs over an ``(N configs, L layers)`` grid of broadcast tensor
expressions, and each workload segment reduces to the
:data:`AGGREGATE_OUTPUTS` columns.

The dtype policy follows the device, as the reference's ``auto`` does:

* CPU — the exact policy (int64/float64), op for op the reference's numpy
  path, so every output is bit-identical to
  ``repro.core.dse_batch._sweep_kernel(np, exact=True)`` (tested);
* CUDA — the x64-free policy of the reference's device path: mapping
  integers stay int32, counts and energies are float32 with explicit
  ``floor``, and per-config sums are Kahan-compensated.  The aggregate
  columns come from the hand-written CUDA kernel
  (:mod:`repro_torch.kernels.sweep_kernel`); the per-layer ``"full"`` and
  ``"layer_totals"`` outputs run the plain tensor expressions on the card.

Mixed precision (one execution mode per config and layer) and many
workloads (W layer axes concatenated, reduced per segment) go through the
same kernel: :func:`_sweep_mixed` and :func:`_sweep_mixed_many`, which the
co-exploration search calls per genome batch.

Enumeration, synthesis, hashing and the Pareto reduction stay host numpy
code; the device boundary is the sweep kernel's inputs.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import time
import warnings
from collections import deque
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.accelerator import (AcceleratorConfig, configs_to_soa,
                                          soa_to_configs)
from repro_torch.core.dataflow import LayerResult, leakage_mw_soa
from repro_torch.core.device import resolve_device
from repro_torch.core.pe import (PEType, mode_compat_matrix, pe_spec,
                                 rf_access_energy_pj, sram_access_energy_pj)
from repro_torch.core.synthesis import (PersistentSynthesisCache,
                                        sweep_synthesis_cache,
                                        synthesize_soa)
from repro_torch.core.workloads import Workload
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

_CPU = torch.device("cpu")


def _ceil_div(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class WorkloadBatch:
    """SoA view of a workload: one int64 array per layer field, ``(L,)``."""

    name: str
    layer_names: tuple[str, ...]
    arrays: dict[str, np.ndarray]

    @classmethod
    def from_workload(cls, wl: Workload) -> "WorkloadBatch":
        i8 = np.int64
        ls = wl.layers
        arrays = {k: np.array([getattr(l, k) for l in ls], dtype=i8)
                  for k in ("r", "s", "e", "f", "c", "k", "h", "w",
                            "batch", "macs")}
        return cls(name=wl.name, layer_names=tuple(l.name for l in ls),
                   arrays=arrays)

    def __len__(self) -> int:
        return len(self.layer_names)


@functools.lru_cache(maxsize=64)
def _workload_batch(wl: Workload) -> WorkloadBatch:
    return WorkloadBatch.from_workload(wl)


def _kahan_sum_rows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Sequential compensated row sum over the layer axis."""
    total = torch.zeros(x.shape[0], dtype=dtype, device=x.device)
    comp = torch.zeros_like(total)
    for j in range(x.shape[1]):
        y = x[:, j] - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total


def _sequential_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Plain left-to-right row sum (bit-matches the scalar ``sum()``)."""
    total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        total = total + x[:, j]
    return total


AGGREGATE_OUTPUTS = ("total_cycles_sum", "energy_pj_sum", "latency_s",
                     "energy_j", "throughput_gmacs", "perf_per_area")
LAYER_TOTAL_OUTPUTS = ("total_cycles", "energy_pj")
OUTPUT_MODES = ("full", "aggregates", "layer_totals")


def _sweep_kernel(cfg: dict, lay: dict, *, exact: bool = True,
                  outputs: str = "full") -> dict:
    """All-configs x all-layers row-stationary mapping + energy model.

    ``cfg`` holds ``(N, 1)`` tensors (``act_bits`` / ``weight_bits`` /
    ``mac_energy_pj`` may be ``(N, L)``: one precision per layer), ``lay``
    holds ``(1, L)`` tensors; every expression broadcasts to ``(N, L)``.
    ``exact=True`` expects int64/float64 inputs, ``exact=False`` the
    int32/float32 inputs of :func:`_to_device_inputs`.
    """
    if outputs not in OUTPUT_MODES:
        raise ValueError(
            f"unknown sweep outputs: {outputs!r} (choose from "
            f"{OUTPUT_MODES})")
    f = torch.float64 if exact else torch.float32
    r, e, f_, ss = lay["r"], lay["e"], lay["f"], lay["s"]
    c, k, n = lay["c"], lay["k"], lay["batch"]
    macs = lay["macs"]          # int64 when exact, float32 otherwise

    def fl(x):
        return x.to(f)

    # ---- spatial mapping (small integers) ----------------------------------
    sets_fit = (cfg["pe_rows"] // r).clamp(min=1)
    c_simult = torch.minimum(c, sets_fit)
    k_simult = (sets_fit // c_simult).clamp(min=1)
    fit_horz = torch.minimum(e, cfg["pe_cols"])
    n_e_groups = _ceil_div(e, fit_horz)
    n_c_groups = _ceil_div(c, c_simult)
    n_k_groups = _ceil_div(k, k_simult)

    if exact:
        passes = n * n_e_groups * n_c_groups * n_k_groups
        compute_cycles = passes * (ss * f_)
        # torch divides int64 by int64 in float32: cast first
        utilization = fl(macs) / fl(
            (compute_cycles * cfg["num_pes"]).clamp(min=1))
    else:
        compute_cycles = (fl(n) * fl(n_e_groups) * fl(n_c_groups)
                          * fl(n_k_groups) * fl(ss) * fl(f_))
        utilization = macs / (compute_cycles
                              * fl(cfg["num_pes"])).clamp(min=1.0)

    # ---- element / byte counts (quantization-aware) -------------------------
    ab, wb = cfg["act_bits"], cfg["weight_bits"]
    ifmap_elems = n * c * lay["h"] * lay["w"]
    weight_elems = k * c * r * ss
    ofmap_elems = n * k * e * f_
    if exact:
        ifmap_bytes = ifmap_elems * ab // 8
        weight_bytes = weight_elems * wb // 8
        ofmap_bytes = ofmap_elems * ab // 8
    else:
        ifmap_bytes = torch.floor(fl(ifmap_elems) * fl(ab) / 8.0)
        weight_bytes = torch.floor(fl(weight_elems) * fl(wb) / 8.0)
        ofmap_bytes = torch.floor(fl(ofmap_elems) * fl(ab) / 8.0)

    glb_half = cfg["glb_kb"] * 1024 // 2
    filt_bytes_one = (c * r * ss * wb // 8).clamp(min=1)
    k_fit_glb = (glb_half // filt_bytes_one).clamp(min=1)
    n_k_glb = _ceil_div(k, k_fit_glb)
    if exact:
        ifmap_restream = torch.where(ifmap_bytes <= glb_half, 1, n_k_glb)
        dram_bytes = ifmap_bytes * ifmap_restream + weight_bytes \
            + ofmap_bytes
        dram_elems = ifmap_elems * ifmap_restream + weight_elems \
            + ofmap_elems
    else:
        ifmap_restream = torch.where(ifmap_bytes <= fl(glb_half), 1.0,
                                     fl(n_k_glb))
        dram_bytes = ifmap_bytes * ifmap_restream + weight_bytes \
            + ofmap_bytes
        dram_elems = fl(ifmap_elems) * ifmap_restream + fl(weight_elems) \
            + fl(ofmap_elems)

    filt_res = (cfg["filter_spad"] // ss.clamp(min=1)).clamp(min=1)
    k_res = filt_res
    w_res = torch.minimum(n_e_groups, filt_res)
    spill = torch.where(cfg["psum_spad"] >= f_, 0, n_c_groups - 1)
    if exact:
        glb_ifmap = ifmap_elems * _ceil_div(n_k_groups, k_res)
        glb_weight = weight_elems * (n_e_groups // w_res).clamp(min=1)
        glb_psum = 2 * ofmap_elems * spill.clamp(min=0)
        glb_elems = 2 * dram_elems + glb_ifmap + glb_weight + glb_psum
        glb_bytes = glb_elems * ab // 8
    else:
        glb_ifmap = fl(ifmap_elems) * fl(_ceil_div(n_k_groups, k_res))
        glb_weight = fl(weight_elems) * fl((n_e_groups // w_res).clamp(min=1))
        glb_psum = 2.0 * fl(ofmap_elems) * fl(spill.clamp(min=0))
        glb_elems = 2.0 * dram_elems + glb_ifmap + glb_weight + glb_psum
        glb_bytes = torch.floor(glb_elems * fl(ab) / 8.0)

    # ---- stalls -------------------------------------------------------------
    clock_ghz = cfg["clock_ghz"]
    bw_bytes_per_cycle = cfg["dram_bw_gbps"] / clock_ghz
    if exact:
        mem_cycles = (dram_bytes / bw_bytes_per_cycle.clamp(min=1e-9)
                      ).to(torch.int64)
    else:
        mem_cycles = torch.floor(dram_bytes
                                 / bw_bytes_per_cycle.clamp(min=1e-9))
    total_cycles = torch.maximum(compute_cycles, mem_cycles)

    # ---- energy -------------------------------------------------------------
    e_spad_pj = rf_access_energy_pj(cfg["spad_bits"], f)
    spad_accesses = 3 * macs
    e_spad = spad_accesses * e_spad_pj
    e_mac = macs * cfg["mac_energy_pj"]
    e_glb = glb_elems * sram_access_energy_pj(cfg["glb_bits"], f)
    e_leak = cfg["leak_mw"] * 1e-3 \
        * (total_cycles / (clock_ghz * 1e9)) * 1e12
    energy_pj = e_mac + e_spad + e_glb + e_leak

    if outputs == "layer_totals":
        return {"total_cycles": total_cycles, "energy_pj": energy_pj}

    # ---- per-config aggregates ---------------------------------------------
    if exact:
        energy_sum = _sequential_sum_rows(energy_pj)
        total_cycles_sum = total_cycles.sum(dim=1)
    else:
        energy_sum = _kahan_sum_rows(energy_pj, f)
        total_cycles_sum = _kahan_sum_rows(total_cycles, f)
    total_macs = macs.sum()

    clk = clock_ghz[:, 0]
    latency_s = total_cycles_sum / (clk * 1e9)
    energy_j = energy_sum / 1e12
    throughput_gmacs = total_macs / latency_s / 1e9
    perf_per_area = throughput_gmacs / cfg["area_mm2"][:, 0]

    out = {
        "compute_cycles": compute_cycles, "mem_cycles": mem_cycles,
        "total_cycles": total_cycles, "utilization": utilization,
        "spad_accesses": spad_accesses, "glb_bytes": glb_bytes,
        "dram_bytes": dram_bytes, "energy_pj": energy_pj,
        "total_cycles_sum": total_cycles_sum, "energy_pj_sum": energy_sum,
        "latency_s": latency_s, "energy_j": energy_j,
        "throughput_gmacs": throughput_gmacs, "perf_per_area": perf_per_area,
    }
    if outputs == "aggregates":
        return {k2: out[k2] for k2 in AGGREGATE_OUTPUTS}
    return out


def _segment_aggregates(totals: dict, cfg: dict, lay: dict,
                        bounds: tuple[tuple[int, int], ...],
                        exact: bool) -> dict:
    """Per-workload aggregate columns ``{column: (W, N)}`` from the
    combined layer axis, one ``[start, end)`` segment per workload."""
    f = torch.float64 if exact else torch.float32
    tc, ep = totals["total_cycles"], totals["energy_pj"]
    clk = cfg["clock_ghz"][:, 0]
    area = cfg["area_mm2"][:, 0]
    rows: dict[str, list] = {k: [] for k in AGGREGATE_OUTPUTS}
    for s, e in bounds:
        epw, tcw = ep[:, s:e], tc[:, s:e]
        if exact:
            energy_sum = _sequential_sum_rows(epw)
            cycles_sum = tcw.sum(dim=1)
        else:
            energy_sum = _kahan_sum_rows(epw, f)
            cycles_sum = _kahan_sum_rows(tcw, f)
        total_macs = lay["macs"][:, s:e].sum()
        latency_s = cycles_sum / (clk * 1e9)
        energy_j = energy_sum / 1e12
        throughput_gmacs = total_macs / latency_s / 1e9
        perf_per_area = throughput_gmacs / area
        for k, v in zip(AGGREGATE_OUTPUTS,
                        (cycles_sum, energy_sum, latency_s, energy_j,
                         throughput_gmacs, perf_per_area)):
            rows[k].append(v)
    return {k: torch.stack(v, dim=0) for k, v in rows.items()}


# ---------------------------------------------------------------------------
# Host -> device inputs under the two dtype policies
# ---------------------------------------------------------------------------

# int32-safe cfg/lay fields under the x64-free policy; everything else
# (counts that can pass 2**31, float quantities) converts to float32
_CFG_INT32 = ("pe_rows", "pe_cols", "ifmap_spad", "filter_spad",
              "psum_spad", "glb_kb", "glb_bits", "num_pes", "act_bits",
              "weight_bits", "spad_bits")
_LAY_INT32 = ("r", "s", "e", "f", "c", "k", "h", "w", "batch")


def _column(a: np.ndarray, int_field: bool, exact: bool,
            device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if exact:
        dtype = np.int64 if a.dtype.kind in "iu" else np.float64
    else:
        dtype = np.int32 if int_field else np.float32
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
    if device.type == "cuda":
        # pinned staging makes the copy asynchronous to the host
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _cfg_to_device(cfg: dict, device: torch.device, exact: bool) -> dict:
    return {k: _column(v, k in _CFG_INT32, exact, device)
            for k, v in cfg.items()}


def _lay_to_device(lay: dict, device: torch.device, exact: bool) -> dict:
    return {k: _column(v, k in _LAY_INT32, exact, device)
            for k, v in lay.items()}


def _to_device_inputs(cfg: dict, lay: dict, device: torch.device, *,
                      exact: bool) -> tuple[dict, dict]:
    """The numpy ``(cfg, lay)`` of :func:`_make_cfg_lay` (or of the
    reference's) as tensors on ``device``: int64/float64 under the exact
    policy, int32/float32 per :data:`_CFG_INT32` / :data:`_LAY_INT32`
    under the x64-free one."""
    return (_cfg_to_device(cfg, device, exact),
            _lay_to_device(lay, device, exact))


def _make_cfg_lay(soa: dict, cols: dict, wb: WorkloadBatch
                  ) -> tuple[dict, dict]:
    """Kernel inputs from a SoA batch, its synthesis columns and a
    workload: ``(N, 1)`` config columns and ``(1, L)`` layer columns."""
    leak_mw = leakage_mw_soa(soa)
    cfg = {k: soa[k][:, None] for k in
           ("pe_rows", "pe_cols", "ifmap_spad", "filter_spad", "psum_spad",
            "glb_kb", "glb_bits", "num_pes", "act_bits", "weight_bits",
            "spad_bits", "dram_bw_gbps", "mac_energy_pj")}
    cfg["clock_ghz"] = np.asarray(cols["clock_ghz"],
                                  dtype=np.float64)[:, None]
    cfg["area_mm2"] = np.asarray(cols["area_mm2"], dtype=np.float64)[:, None]
    cfg["leak_mw"] = leak_mw[:, None]
    lay = {k: v[None, :] for k, v in wb.arrays.items()}
    return cfg, lay


# ---------------------------------------------------------------------------
# The config axis across shards: ``mesh=None``, an int (shards simulated
# on the CPU) or a DeviceMesh (ranks)
# ---------------------------------------------------------------------------

def _mesh_shards(mesh) -> int:
    """Config-axis shards a ``mesh=`` argument implies: ``None`` -> 1, an
    int -> itself (the CPU route's simulated shard count), a mesh -> its
    size."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        if mesh < 1:
            raise ValueError(f"mesh shard count must be >= 1, got {mesh}")
        return mesh
    return int(mesh.size())


def _check_mesh(mesh, device: torch.device) -> None:
    """Refuse a ``mesh=`` the sweep cannot place on ``device``: an int on
    the card (as the reference's jax backend refuses one), a mesh of
    another device type, a mesh of more than one dim, or one this rank
    is not in."""
    if mesh is None:
        return
    if isinstance(mesh, int):
        _mesh_shards(mesh)
        if device.type != "cpu":
            raise ValueError(
                "device='cuda' needs a torch DeviceMesh for mesh=, not an "
                "int shard count (see repro_torch.launch.mesh"
                ".make_sweep_mesh)")
        return
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh= takes None, an int shard count (device='cpu') or a "
            f"DeviceMesh (repro_torch.launch.mesh.make_sweep_mesh), got "
            f"{type(mesh).__name__}")
    if mesh.ndim != 1:
        raise ValueError(
            f"a sweep shards its config axis over a 1-D mesh, got axes "
            f"{mesh.mesh_dim_names}")
    if mesh.device_type != device.type:
        raise ValueError(
            f"a {mesh.device_type!r} mesh cannot place a sweep on "
            f"{device}: build the mesh for the sweep's device")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the sweep's mesh")


def _pad_rows(arrays: dict, pad: int) -> dict:
    """Repeat each array's last row ``pad`` times (row-local kernels make
    the padded rows valid throwaway work; callers slice them back off)."""
    if pad <= 0:
        return arrays
    return {k: np.concatenate([v, v[-1:].repeat(pad, axis=0)])
            for k, v in arrays.items()}


def _eval_rows(fn, cfg: dict, lo: int, hi: int, axis: int):
    """``fn`` on config rows ``[lo, hi)``: ``(outputs, config-major
    names)``, those outputs cut to the slice.  A one-row slice runs with
    its row twice, so that every config-major output is told from the
    layer-only ones (``(1, L)``) by its length."""
    part = {k: v[lo:hi] for k, v in cfg.items()}
    if hi - lo == 1:
        part = _pad_rows(part, 1)
    rows = len(part["pe_rows"])
    out = fn(part)
    major = {k for k, v in out.items()
             if v.dim() > axis and v.shape[axis] == rows}
    return ({k: v.narrow(axis, 0, hi - lo) if k in major else v
             for k, v in out.items()}, major)


def _on_shards(fn, cfg: dict, mesh, axis: int = 0) -> dict:
    """``fn(cfg rows) -> {name: tensor}`` over the config axis as ``mesh``
    places it; its config-major outputs (config axis ``axis``) come back
    whole, in config order.  Every row is evaluated alone, so each split
    gives the unsharded bits:

    * ``None`` — one call;
    * an int — ``min(shards, max(1, n))`` contiguous ``np.array_split``
      slices, each its own call, concatenated (the reference's simulated
      shards);
    * a ``DeviceMesh`` — the config axis padded by repeating its last row
      ``-n % shards`` times, this rank's contiguous slice evaluated, every
      rank's gathered (:func:`repro_torch.launch.mesh.all_gather_group`)
      and the padding sliced off.
    """
    n = len(cfg["pe_rows"])
    if mesh is None:
        return fn(cfg)
    if isinstance(mesh, int):
        shards = min(_mesh_shards(mesh), max(1, n))
        if shards == 1:
            return fn(cfg)
        parts = [_eval_rows(fn, cfg, int(idx[0]), int(idx[-1]) + 1, axis)
                 for idx in np.array_split(np.arange(n), shards)]
        major = parts[0][1]
        return {k: torch.cat([p[k] for p, _ in parts], dim=axis)
                if k in major else v for k, v in parts[0][0].items()}
    from repro_torch.launch.mesh import all_gather_group
    shards = mesh.size()
    cfg = _pad_rows(cfg, -n % shards)
    per = len(cfg["pe_rows"]) // shards
    r = mesh.get_local_rank(0)
    local, major = _eval_rows(fn, cfg, r * per, (r + 1) * per, axis)
    return {k: all_gather_group(v, mesh.get_group(), dim=axis)
            .narrow(axis, 0, n) if k in major else v
            for k, v in local.items()}


def _run_kernel(cfg: dict, lay: dict, device: torch.device,
                outputs: str = "full", mesh=None) -> dict[str, np.ndarray]:
    """Evaluate numpy ``(cfg, lay)`` on ``device``, the config axis placed
    by ``mesh`` (:func:`_on_shards`); numpy results."""
    if outputs not in OUTPUT_MODES:
        raise ValueError(
            f"unknown sweep outputs: {outputs!r} (choose from "
            f"{OUTPUT_MODES})")
    device = resolve_device(device)
    _check_mesh(mesh, device)

    def evaluate(c: dict) -> dict:
        if device.type == "cpu":
            dcfg, dlay = _to_device_inputs(c, lay, device, exact=True)
            return _sweep_kernel(dcfg, dlay, exact=True, outputs=outputs)
        if outputs == "aggregates":
            from repro_torch.kernels.sweep_kernel import sweep_aggregates
            return sweep_aggregates(_cfg_to_device(c, device, exact=False),
                                    _lay_to_device(lay, _CPU, exact=False))
        dcfg, dlay = _to_device_inputs(c, lay, device, exact=False)
        return _sweep_kernel(dcfg, dlay, exact=False, outputs=outputs)
    out = _on_shards(evaluate, cfg, mesh)
    return {k: v.cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# One-batch sweep
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchedSweep:
    """One evaluated sweep: N configs x L layers, results as arrays."""

    workload: str
    configs: tuple[AcceleratorConfig, ...]
    layer_names: tuple[str, ...]
    macs: np.ndarray               # (L,)
    clock_ghz: np.ndarray          # (N,)
    area_mm2: np.ndarray           # (N,)
    arrays: dict[str, np.ndarray]  # kernel outputs

    def __len__(self) -> int:
        return len(self.configs)

    def result_view(self, i: int) -> "BatchedWorkloadResult":
        return BatchedWorkloadResult(self, i)


class BatchedWorkloadResult:
    """Duck-typed :class:`repro_torch.core.dataflow.WorkloadResult` view
    over one row of a :class:`BatchedSweep` — O(1) until ``.layers`` is
    asked for (``"full"`` outputs only)."""

    __slots__ = ("_sweep", "_i", "_layers")

    def __init__(self, sweep: BatchedSweep, i: int):
        self._sweep = sweep
        self._i = i
        self._layers: tuple[LayerResult, ...] | None = None

    @property
    def workload(self) -> str:
        return self._sweep.workload

    @property
    def config_name(self) -> str:
        return self._sweep.configs[self._i].name()

    @property
    def area_mm2(self) -> float:
        return float(self._sweep.area_mm2[self._i])

    @property
    def clock_ghz(self) -> float:
        return float(self._sweep.clock_ghz[self._i])

    @property
    def layers(self) -> tuple[LayerResult, ...]:
        if self._layers is None:
            a, i = self._sweep.arrays, self._i
            self._layers = tuple(
                LayerResult(
                    name=nm, macs=int(self._sweep.macs[j]),
                    compute_cycles=int(a["compute_cycles"][i, j]),
                    mem_cycles=int(a["mem_cycles"][i, j]),
                    total_cycles=int(a["total_cycles"][i, j]),
                    utilization=float(a["utilization"][i, j]),
                    spad_accesses=int(a["spad_accesses"][0, j]),
                    glb_bytes=int(a["glb_bytes"][i, j]),
                    dram_bytes=int(a["dram_bytes"][i, j]),
                    energy_pj=float(a["energy_pj"][i, j]))
                for j, nm in enumerate(self._sweep.layer_names))
        return self._layers

    @property
    def total_macs(self) -> int:
        return int(self._sweep.macs.sum())

    @property
    def total_cycles(self) -> int:
        return int(self._sweep.arrays["total_cycles_sum"][self._i])

    @property
    def latency_s(self) -> float:
        return float(self._sweep.arrays["latency_s"][self._i])

    @property
    def energy_j(self) -> float:
        return float(self._sweep.arrays["energy_j"][self._i])

    @property
    def throughput_gmacs(self) -> float:
        return float(self._sweep.arrays["throughput_gmacs"][self._i])

    @property
    def perf_per_area(self) -> float:
        return float(self._sweep.arrays["perf_per_area"][self._i])

    @property
    def edp(self) -> float:
        return self.energy_j * self.latency_s


def _synthesize(soa: dict, use_cache: bool) -> dict[str, np.ndarray]:
    return (sweep_synthesis_cache().synthesize(soa) if use_cache
            else synthesize_soa(soa))


def _sweep_workload(workload: Workload,
                    configs: Sequence[AcceleratorConfig],
                    cols: dict[str, np.ndarray] | None = None,
                    *,
                    device: str | torch.device = "cuda",
                    use_cache: bool = True,
                    soa: dict[str, np.ndarray] | None = None,
                    outputs: str = "full", mesh=None) -> BatchedSweep:
    """Evaluate ``workload`` on every config in one batched pass.
    ``cols`` / ``soa`` let a many-workload sweep synthesize and convert
    the batch once and reuse it for every workload; ``mesh`` shards the
    config axis (:func:`_on_shards`)."""
    device = resolve_device(device)
    _check_mesh(mesh, device)
    configs = tuple(configs)
    if soa is None:
        soa = configs_to_soa(configs)
    if cols is None:
        cols = _synthesize(soa, use_cache)
    wb = _workload_batch(workload)
    cfg, lay = _make_cfg_lay(soa, cols, wb)
    out = _run_kernel(cfg, lay, device, outputs=outputs, mesh=mesh)
    return BatchedSweep(workload=workload.name, configs=configs,
                        layer_names=wb.layer_names, macs=wb.arrays["macs"],
                        clock_ghz=cfg["clock_ghz"][:, 0],
                        area_mm2=cfg["area_mm2"][:, 0], arrays=out)


# ---------------------------------------------------------------------------
# Mixed-precision sweeps: one execution mode per (config, layer), over one
# workload or W workloads whose layer axes are concatenated
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _mode_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-PE-type (act_bits, weight_bits, mac_energy_pj) lookup tables in
    ``tuple(PEType)`` order."""
    specs = [pe_spec(t) for t in PEType]
    return (np.array([s.act_bits for s in specs], dtype=np.int64),
            np.array([s.weight_bits for s in specs], dtype=np.int64),
            np.array([s.mac_energy_pj for s in specs], dtype=np.float64))


def mixed_assign_cfg(cfg: dict, assign: np.ndarray) -> dict:
    """Replace the per-config precision columns with per-layer ones.

    ``assign`` is an ``(N, L)`` int array of PE-type indices.  Only
    ``act_bits`` / ``weight_bits`` / ``mac_energy_pj`` become ``(N, L)``;
    everything physical keeps its hardware value, so synthesis and its
    digest-keyed caches see only the hardware config.
    """
    ab_t, wb_t, me_t = _mode_tables()
    a = np.asarray(assign, dtype=np.int64)
    if a.size and (a.min() < 0 or a.max() >= len(ab_t)):
        raise ValueError(
            f"assignment contains PE-type indices outside "
            f"[0, {len(ab_t)})")
    out = dict(cfg)
    out["act_bits"] = ab_t[a]
    out["weight_bits"] = wb_t[a]
    out["mac_energy_pj"] = me_t[a]
    return out


def check_assignment(soa: dict, assign: np.ndarray) -> None:
    """Raise ``ValueError`` unless every (config, layer) mode is executable
    on that config's hardware (operand widths fit the datapath)."""
    a = np.asarray(assign)
    n_types = len(tuple(PEType))
    if a.ndim != 2 or a.shape[0] != len(soa["pe_rows"]):
        raise ValueError(
            f"assignment shape {a.shape} does not match "
            f"{len(soa['pe_rows'])} configs")
    if a.min(initial=0) < 0 or a.max(initial=0) >= n_types:
        raise ValueError(
            f"assignment contains PE-type indices outside [0, {n_types})")
    ok = mode_compat_matrix()[soa["pe_type_idx"][:, None], a]
    if not ok.all():
        n_bad = int((~ok).sum())
        raise ValueError(
            f"{n_bad} (config, layer) mode assignment(s) are not "
            f"executable on their hardware PE type")


def _sweep_mixed(workload: Workload,
                 soa: dict[str, np.ndarray],
                 assign: np.ndarray,
                 cols: dict[str, np.ndarray] | None = None,
                 *,
                 use_cache: bool = True,
                 device: str | torch.device = "cuda",
                 outputs: str = "aggregates",
                 mesh=None) -> dict[str, np.ndarray]:
    """Evaluate a batch of mixed-precision genomes in one pass.

    ``soa`` is the hardware half of the batch, ``assign`` the ``(N, L)``
    per-layer mode half.  Synthesis runs on the hardware alone, through
    the digest-keyed sweep cache by default.  Returns the sweep's output
    columns plus ``clock_ghz`` / ``area_mm2``: on the CPU bit-identical to
    the reference's numpy path, on CUDA the ``"aggregates"`` come from the
    sweep kernel and per-layer outputs from the plain expressions.
    ``mesh`` shards the config axis (:func:`_on_shards`).
    """
    device = resolve_device(device)
    _check_mesh(mesh, device)
    wb = _workload_batch(workload)
    assign = np.asarray(assign, dtype=np.int64)
    if assign.shape != (len(soa["pe_rows"]), len(wb)):
        raise ValueError(
            f"assignment shape {assign.shape} != "
            f"({len(soa['pe_rows'])} configs, {len(wb)} layers)")
    check_assignment(soa, assign)
    if cols is None:
        cols = _synthesize(soa, use_cache)
    cfg, lay = _make_cfg_lay(soa, cols, wb)
    cfg = mixed_assign_cfg(cfg, assign)
    out = dict(_run_kernel(cfg, lay, device, outputs=outputs, mesh=mesh))
    out["clock_ghz"] = cfg["clock_ghz"][:, 0]
    out["area_mm2"] = cfg["area_mm2"][:, 0]
    return out


@functools.lru_cache(maxsize=32)
def _workload_batch_many(wls: tuple[Workload, ...]
                         ) -> tuple[WorkloadBatch,
                                    tuple[tuple[int, int], ...]]:
    """Concatenate W workloads into one layer-axis batch plus the
    ``(start, end)`` column bounds of each workload's segment."""
    wbs = [_workload_batch(w) for w in wls]
    bounds: list[tuple[int, int]] = []
    start = 0
    for wb in wbs:
        bounds.append((start, start + len(wb)))
        start += len(wb)
    arrays = {k: np.concatenate([wb.arrays[k] for wb in wbs])
              for k in wbs[0].arrays}
    names = tuple(f"{wb.name}/{nm}" for wb in wbs for nm in wb.layer_names)
    combined = WorkloadBatch(name="+".join(wb.name for wb in wbs),
                             layer_names=names, arrays=arrays)
    return combined, tuple(bounds)


def _sweep_mixed_many(workloads: Sequence[Workload],
                      soa: dict[str, np.ndarray],
                      assigns: Sequence[np.ndarray],
                      cols: dict[str, np.ndarray] | None = None,
                      *,
                      use_cache: bool = True,
                      device: str | torch.device = "cuda",
                      mesh=None) -> dict[str, np.ndarray]:
    """Evaluate one genome batch against W workloads in one pass.

    ``soa`` is the shared hardware half (N configs); ``assigns`` holds one
    ``(N, L_w)`` mode matrix per workload.  The W layer axes are
    concatenated into one ``(N, sum L_w)`` evaluation and reduced per
    workload segment, so the call costs one synthesis pass and, on CUDA,
    one sweep-kernel launch whatever W.

    Returns ``{column: (W, N)}`` over :data:`AGGREGATE_OUTPUTS` plus
    ``clock_ghz`` / ``area_mm2`` as ``(N,)``.  On the CPU workload ``w``'s
    row is bit-identical to the reference's numpy path.

    ``mesh`` shards the genome (config) axis (:func:`_on_shards`): an int
    splits the batch into that many contiguous shards on the CPU, a
    ``DeviceMesh`` (:func:`repro_torch.launch.mesh.make_sweep_mesh`)
    gives each rank its slice, on the card one kernel launch, and
    gathers the columns; either is bit for bit the unsharded result.
    """
    device = resolve_device(device)
    _check_mesh(mesh, device)
    wls = tuple(workloads)
    if not wls:
        raise ValueError("sweep_mixed_many needs at least one workload")
    combined, bounds = _workload_batch_many(wls)
    n = len(soa["pe_rows"])
    assigns = [np.asarray(a, dtype=np.int64) for a in assigns]
    if len(assigns) != len(wls):
        raise ValueError(
            f"{len(assigns)} assignment matrices for {len(wls)} workloads")
    for (s, e), a, wl in zip(bounds, assigns, wls):
        if a.shape != (n, e - s):
            raise ValueError(
                f"assignment shape {a.shape} != ({n} configs, "
                f"{e - s} layers) for workload {wl.name!r}")
    assign_all = np.concatenate(assigns, axis=1)
    check_assignment(soa, assign_all)
    if cols is None:
        cols = _synthesize(soa, use_cache)
    cfg, lay = _make_cfg_lay(soa, cols, combined)
    cfg = mixed_assign_cfg(cfg, assign_all)

    def evaluate(c: dict) -> dict:
        if device.type == "cpu":
            dcfg, dlay = _to_device_inputs(c, lay, device, exact=True)
            totals = _sweep_kernel(dcfg, dlay, exact=True,
                                   outputs="layer_totals")
            return _segment_aggregates(totals, dcfg, dlay, bounds,
                                       exact=True)
        from repro_torch.kernels.sweep_kernel import sweep_aggregates
        return sweep_aggregates(_cfg_to_device(c, device, exact=False),
                                _lay_to_device(lay, _CPU, exact=False),
                                bounds=bounds)
    agg = _on_shards(evaluate, cfg, mesh, axis=1)
    out = {k: v.cpu().numpy() for k, v in agg.items()}
    out["clock_ghz"] = cfg["clock_ghz"][:, 0]
    out["area_mm2"] = cfg["area_mm2"][:, 0]
    return out


# ---------------------------------------------------------------------------
# Streamed chunked sweep with running Pareto-front reduction
# ---------------------------------------------------------------------------

_FRONT_METRICS = ("perf_per_area", "energy_j", "latency_s",
                  "throughput_gmacs")
_SOA_ID_FIELDS = ("pe_type_idx", "pe_rows", "pe_cols", "ifmap_spad",
                  "filter_spad", "psum_spad", "glb_kb", "dram_bw_gbps",
                  "clock_cap")


@dataclasses.dataclass
class ChunkedSweep:
    """Result of a streamed sweep: running totals + the Pareto frontier
    (maximize perf/area, minimize energy), not the full point set."""

    workload: str
    device: str
    n_configs: int
    n_chunks: int
    front_soa: dict[str, np.ndarray]      # identity fields of survivors
    front_metrics: dict[str, np.ndarray]  # _FRONT_METRICS columns
    synthesis_cache: PersistentSynthesisCache | None = None
    # wall_s (whole stream), synth_s (host synthesis + feed pull),
    # kernel_wait_s (host time blocked on kernel results), kernel_busy_s
    # (dispatch -> results, summed over chunks), the watchdog's counters,
    # and restarts (resume_sweep)
    timings: dict | None = None

    @property
    def front_size(self) -> int:
        return len(self.front_metrics["energy_j"])

    def front_configs(self) -> list[AcceleratorConfig]:
        """The frontier as configs, sorted by energy."""
        order = np.argsort(self.front_metrics["energy_j"], kind="stable")
        return soa_to_configs(self.front_soa, order)

    def front_points(self) -> list[dict]:
        """The frontier as ``{metric: value, config: cfg}`` rows, sorted
        by energy."""
        order = np.argsort(self.front_metrics["energy_j"], kind="stable")
        cfgs = soa_to_configs(self.front_soa, order)
        return [
            dict({m: float(self.front_metrics[m][i])
                  for m in _FRONT_METRICS}, config=cfg)
            for i, cfg in zip(order, cfgs)]


def _as_soa_chunks(chunks, chunk_size: int) -> Iterator[dict]:
    """Normalize a config feed — SoA dicts, config sequences, or a flat
    config generator — into SoA chunks of at most ``chunk_size``."""
    pending: list[AcceleratorConfig] = []
    if isinstance(chunks, dict):        # single SoA
        chunks = (chunks,)
    for item in chunks:
        if isinstance(item, dict):
            if pending:
                yield configs_to_soa(tuple(pending))
                pending.clear()
            n = len(item["pe_rows"])
            for s in range(0, n, chunk_size):
                yield {k: v[s:s + chunk_size] for k, v in item.items()}
        elif isinstance(item, AcceleratorConfig):
            pending.append(item)
            if len(pending) >= chunk_size:
                yield configs_to_soa(tuple(pending))
                pending.clear()
        else:                           # a sequence of configs
            for cfg in item:
                pending.append(cfg)
                if len(pending) >= chunk_size:
                    yield configs_to_soa(tuple(pending))
                    pending.clear()
    if pending:
        yield configs_to_soa(tuple(pending))


class ChunkDeadlineExceeded(TimeoutError):
    """A dispatched chunk's results did not arrive within the streamed
    sweep's watchdog deadline (``chunk_deadline_s``)."""


def _dispatch_chunk(cfg: dict, klay: dict, device: torch.device,
                    mesh=None):
    """Start the aggregates kernel on one chunk; returns
    ``finalize(timeout=None)`` giving the host ``(n,)`` aggregate columns.
    ``mesh`` shards the chunk's config axis (:func:`_on_shards`): on a
    ``DeviceMesh`` each rank launches on its slice and the ``(n, 6)``
    columns are gathered on the card.

    On CUDA the kernel launches on the current stream, its ``(n, 6)``
    result is copied without blocking into pinned host memory, and an
    event marks the copy's end.  ``finalize`` waits on that event, or,
    given ``timeout`` seconds, polls it and raises
    :class:`ChunkDeadlineExceeded` once the deadline passes (the
    watchdog's hook; the launched work is abandoned, not cancelled).  On
    the CPU the exact path runs at once, so a deadline cannot fire.
    """
    if device.type == "cpu":
        out = _on_shards(
            lambda c: _sweep_kernel(_cfg_to_device(c, device, exact=True),
                                    klay, exact=True, outputs="aggregates"),
            cfg, mesh)
        res = {k: v.numpy() for k, v in out.items()}
        return lambda timeout=None: res
    from repro_torch.kernels.sweep_kernel import sweep_aggregates_packed
    packed = _on_shards(
        lambda c: {"packed": sweep_aggregates_packed(
            _cfg_to_device(c, device, False), klay)}, cfg, mesh)["packed"]
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def finalize(timeout: float | None = None):
        if timeout is None:
            done.synchronize()
        else:
            deadline = time.perf_counter() + timeout
            while not done.query():
                if time.perf_counter() >= deadline:
                    raise ChunkDeadlineExceeded(
                        f"chunk results not ready within {timeout}s")
                time.sleep(50e-6)
        a = host.numpy()
        return {k: a[:, i] for i, k in enumerate(AGGREGATE_OUTPUTS)}

    return finalize


def _sweep_chunked(workload: Workload,
                   configs: Iterable,
                   *,
                   device: str | torch.device = "cuda",
                   chunk_size: int = 32768,
                   use_cache: bool = False,
                   cache: PersistentSynthesisCache | str | None = None,
                   save_cache: bool = True,
                   overlap: bool = True,
                   prefetch_depth: int = 2,
                   checkpoint=None,
                   fail_at: dict[int, int] | None = None,
                   chunk_deadline_s: float | None = None,
                   mesh=None) -> ChunkedSweep:
    """Stream an arbitrary-size config feed through the sweep in bounded
    memory, keeping only running totals + the Pareto front.

    ``configs`` may be SoA dicts (e.g. from
    :func:`repro_torch.core.accelerator.design_space_soa`), sequences of
    :class:`AcceleratorConfig`, or a flat config generator.  ``cache`` (a
    :class:`PersistentSynthesisCache` or an npz path) persists synthesis
    across runs; ``use_cache`` routes through the process-wide cache.

    ``overlap=True`` keeps up to ``prefetch_depth`` chunks in flight on
    the device while the host synthesizes the next one; the Pareto
    reduction drains them in FIFO stream order, so fronts and cache
    hit/miss counts are identical at every depth.  ``overlap=False`` is
    depth 1.  On the CPU each chunk is evaluated when it is dispatched.

    Fault tolerance, as the reference's:

    * ``checkpoint`` — a snapshotter such as
      :class:`repro_torch.runtime.dse_checkpoint.SweepCheckpointer`
      (``restore()``, ``should_save(cursor)``, ``save(...)``).  On entry
      the newest valid snapshot restores the stream cursor, the running
      front and the cache's rows and accounting; chunks reduced before it
      are pulled from the feed but not synthesized.  A snapshot's cache
      state is captured at the synthesis boundary of its cursor, so the
      chunks prefetched behind it never leak in; the last snapshot is
      written when the stream ends.
    * ``fail_at`` — ``{chunk_index: n_times}`` raises
      :class:`~repro_torch.runtime.fault_tolerance.InjectedFailure` at
      those chunk boundaries (decremented in place, so a dict shared
      across restarts fails each boundary ``n_times`` in all).
    * ``chunk_deadline_s`` — watchdog: a chunk whose results are not back
      within the deadline is abandoned and dispatched again, synchronously,
      on the same device through the same kernel (counted in
      ``timings["watchdog_redispatches"]`` and
      ``["abandoned_finalizers"]``); if that launch fails, the stream
      raises.  Nothing falls back to another device.  The re-dispatch is
      one rank's decision, so on a mesh of several ranks (whose chunks
      end in a collective) the watchdog is refused.

    ``mesh`` shards every chunk's config axis (:func:`_on_shards`): an
    int on the CPU, a ``DeviceMesh`` on either device; the front is the
    unsharded one bit for bit.  Each rank of a mesh runs the whole
    stream's host work, so with ``checkpoint`` each keeps its own
    snapshot directory.

    The stages record ``sweep.*`` spans when :mod:`repro_torch.obs`
    tracing is on, and the totals always land in its metrics registry.
    """
    device = resolve_device(device)
    _check_mesh(mesh, device)
    if chunk_deadline_s is not None and not isinstance(mesh, int) \
            and _mesh_shards(mesh) > 1:
        raise ValueError(
            "chunk_deadline_s: the watchdog's re-dispatch is one rank's "
            "decision and would leave the other ranks' gathers unmatched; "
            "drop it, or sweep on a one-rank mesh")
    if int(prefetch_depth) < 1:
        raise ValueError(
            f"prefetch_depth must be >= 1, got {prefetch_depth}")
    depth = int(prefetch_depth) if overlap else 1
    if isinstance(cache, (str, bytes)) or hasattr(cache, "__fspath__"):
        cache = PersistentSynthesisCache(cache)
    wb = _workload_batch(workload)
    exact = device.type == "cpu"
    fail_at = fail_at if fail_at is not None else {}
    # the layer table is host data: the kernel wrapper packs it per launch
    klay = _lay_to_device({k: v[None, :] for k, v in wb.arrays.items()},
                          _CPU, exact)

    front_soa: dict[str, np.ndarray] | None = None
    front_metrics: dict[str, np.ndarray] | None = None
    n_total = 0
    n_chunks = 0
    resume_cursor = 0
    if checkpoint is not None:
        snap = checkpoint.restore()
        if snap is not None:
            resume_cursor = int(snap["cursor"])
            if resume_cursor > 0:
                n_total = int(snap["n_total"])
                n_chunks = resume_cursor
                front_soa = snap["front_soa"]
                front_metrics = snap["front_metrics"]
                if cache is not None \
                        and snap.get("cache_state") is not None:
                    cache.import_state(snap["cache_state"])
    t_wall = time.perf_counter()
    # executor_replacements / cancelled_recomputes are the reference's
    # worker-executor counters; the port has no executor, so they stay 0
    timings = {"overlap": bool(overlap), "prefetch_depth": depth,
               "wall_s": 0.0, "synth_s": 0.0, "kernel_wait_s": 0.0,
               "kernel_busy_s": 0.0, "watchdog_redispatches": 0,
               "executor_replacements": 0, "cancelled_recomputes": 0,
               "abandoned_finalizers": 0}
    reg = obs_metrics.get_registry()
    root_span = obs_trace.span_start(
        "sweep_chunked", workload=workload.name, device=str(device),
        chunk_size=int(chunk_size), overlap=bool(overlap),
        prefetch_depth=depth, resume_cursor=resume_cursor)
    n_total0, n_chunks0 = n_total, n_chunks   # restored-from-snapshot base
    flushed = False

    def flush_telemetry(status: str) -> None:
        # once per attempt, also from a failed one: only the work done in
        # this attempt is counted, not the totals restored from a snapshot
        nonlocal flushed
        if flushed:
            return
        flushed = True
        timings["wall_s"] = time.perf_counter() - t_wall
        reg.inc("sweep.chunks", n_chunks - n_chunks0)
        reg.inc("sweep.configs", n_total - n_total0)
        reg.inc("sweep.wall_s", timings["wall_s"])
        reg.inc("sweep.synth_s", timings["synth_s"])
        reg.inc("sweep.kernel_wait_s", timings["kernel_wait_s"])
        reg.inc("sweep.kernel_busy_s", timings["kernel_busy_s"])
        reg.set("sweep.prefetch_depth", depth)
        if status != "ok":
            reg.inc("sweep.failures")
        if timings["wall_s"] > 0:
            reg.set("sweep.configs_per_s",
                    (n_total - n_total0) / timings["wall_s"])
        obs_trace.span_end(root_span, status=status, configs=n_total,
                           chunks=n_chunks, wall_s=timings["wall_s"])

    def reduce_chunk(soa: dict, n: int, out: dict) -> None:
        nonlocal front_soa, front_metrics
        perf = np.asarray(out["perf_per_area"], dtype=np.float64)[:n]
        energy = np.asarray(out["energy_j"], dtype=np.float64)[:n]
        # only the chunk's own frontier can join the global one
        idx = np.nonzero(pareto_mask(perf, energy))[0]
        cand_soa = {k: soa[k][idx] for k in _SOA_ID_FIELDS}
        cand_metrics = {m: np.asarray(out[m], dtype=np.float64)[:n][idx]
                        for m in _FRONT_METRICS}
        if front_soa is None:
            front_soa, front_metrics = cand_soa, cand_metrics
        else:
            front_soa = {k: np.concatenate([front_soa[k], cand_soa[k]])
                         for k in _SOA_ID_FIELDS}
            front_metrics = {
                m: np.concatenate([front_metrics[m], cand_metrics[m]])
                for m in _FRONT_METRICS}
        keep = pareto_mask(front_metrics["perf_per_area"],
                           front_metrics["energy_j"])
        front_soa = {k: v[keep] for k, v in front_soa.items()}
        front_metrics = {m: v[keep] for m, v in front_metrics.items()}

    def dispatch(cfg: dict):
        # the mesh only where there is one, so that a stand-in dispatch
        # of the unsharded signature still takes the stream
        if mesh is None:
            return _dispatch_chunk(cfg, klay, device)
        return _dispatch_chunk(cfg, klay, device, mesh)

    # in flight, in stream order: (soa, n, cfg, finalize, save_info,
    # cache_state, chunk_index, kernel_span, t_dispatch)
    pending: deque = deque()

    def drain_one() -> None:
        (psoa, pn, pcfg, pfin, psave, pcache, pci, kspan,
         tdisp) = pending.popleft()
        t0 = time.perf_counter()
        kstatus = "ok"
        try:
            out = pfin(timeout=chunk_deadline_s)
        except ChunkDeadlineExceeded:
            warnings.warn(
                f"chunk kernel exceeded the {chunk_deadline_s:.3g}s "
                f"watchdog deadline; abandoned and re-dispatched on "
                f"{device}", RuntimeWarning, stacklevel=3)
            timings["watchdog_redispatches"] += 1
            timings["abandoned_finalizers"] += 1
            reg.inc("sweep.watchdog_redispatches")
            kstatus = "watchdog"
            with obs_trace.span("sweep.watchdog_redispatch", chunk=pci):
                out = dispatch(pcfg)()
        except Exception:
            obs_trace.span_end(kspan, status="error")
            raise
        now = time.perf_counter()
        timings["kernel_wait_s"] += now - t0
        # dispatch -> results: the kernel stage's busy time (chunks in
        # flight together each count their own)
        timings["kernel_busy_s"] += now - tdisp
        obs_trace.span_end(kspan, status=kstatus)
        with obs_trace.span("sweep.reduce", chunk=pci, n=pn):
            reduce_chunk(psoa, pn, out)
        if psave is not None:
            with obs_trace.span("sweep.checkpoint", cursor=psave[0]):
                checkpoint.save(cursor=psave[0], n_total=psave[1],
                                front_soa=front_soa,
                                front_metrics=front_metrics,
                                cache_state=pcache)

    try:
        feed = _as_soa_chunks(configs, chunk_size)
        ci = -1                 # absolute index of the chunk being pulled
        while True:
            t0 = time.perf_counter()
            with obs_trace.span("sweep.pull"):
                soa = next(feed, None)
            if soa is None:
                break
            n = len(soa["pe_rows"])
            if n == 0:
                continue
            ci += 1
            if ci < resume_cursor:
                # reduced before the restart: the snapshot carries its
                # front contribution and cache accounting
                continue
            if fail_at.get(ci, 0) > 0:
                fail_at[ci] -= 1
                from repro_torch.runtime.fault_tolerance import \
                    InjectedFailure
                raise InjectedFailure(
                    f"injected failure at chunk boundary {ci}")
            n_total += n
            n_chunks += 1
            # host synthesis in stream order, so cache lookups and inserts
            # match the serial loop row for row
            with obs_trace.span("sweep.synthesize", chunk=ci, n=n):
                if cache is not None:
                    cols = cache.synthesize(soa)
                elif use_cache:
                    cols = sweep_synthesis_cache().synthesize(soa)
                else:
                    cols = synthesize_soa(soa)
                cfg, _ = _make_cfg_lay(soa, cols, wb)
            timings["synth_s"] += time.perf_counter() - t0
            save_info = cache_state = None
            if checkpoint is not None and checkpoint.should_save(ci + 1):
                # capture the cache now, while it covers exactly chunks
                # 0..ci: chunk ci+1 is synthesized before chunk ci's
                # snapshot is written, and its rows must not turn into
                # hits after a resume
                save_info = (ci + 1, n_total)
                if cache is not None:
                    cache_state = cache.export_state()
            kspan = obs_trace.span_start("sweep.kernel", chunk=ci, n=n,
                                         device=str(device))
            try:
                with obs_trace.span("sweep.dispatch", chunk=ci):
                    finalize = dispatch(cfg)
            except Exception:
                obs_trace.span_end(kspan, status="error")
                raise
            pending.append((soa, n, cfg, finalize, save_info, cache_state,
                            ci, kspan, time.perf_counter()))
            reg.observe("sweep.inflight", len(pending))
            # bounded prefetch: at most depth-1 chunks stay in flight
            # behind the next synthesis
            while len(pending) >= depth:
                drain_one()
        while pending:
            drain_one()
    finally:
        if sys.exc_info()[0] is not None:
            flush_telemetry("error")

    if front_soa is None:
        front_soa = {k: np.empty(0, dtype=np.int64)
                     for k in _SOA_ID_FIELDS}
        front_metrics = {m: np.empty(0, dtype=np.float64)
                         for m in _FRONT_METRICS}
    if checkpoint is not None:
        # terminal snapshot: resuming a finished run restores the whole
        # front and skips the feed
        with obs_trace.span("sweep.checkpoint", cursor=n_chunks,
                            terminal=True):
            checkpoint.save(
                cursor=n_chunks, n_total=n_total, front_soa=front_soa,
                front_metrics=front_metrics,
                cache_state=cache.export_state() if cache is not None
                else None)
    if cache is not None and save_cache and cache.path is not None:
        cache.save()
    flush_telemetry("ok")
    return ChunkedSweep(workload=workload.name, device=str(device),
                        n_configs=n_total, n_chunks=n_chunks,
                        front_soa=front_soa, front_metrics=front_metrics,
                        synthesis_cache=cache, timings=timings)


def _pareto_mask_bcast(perf: np.ndarray, energy: np.ndarray,
                       chunk: int) -> np.ndarray:
    """O(n^2) chunked-broadcast dominance test (small batches)."""
    n = perf.shape[0]
    keep = np.ones(n, dtype=bool)
    for s in range(0, n, chunk):
        p = perf[s:s + chunk, None]
        e = energy[s:s + chunk, None]
        dominated = ((perf[None, :] >= p) & (energy[None, :] <= e)
                     & ((perf[None, :] > p) | (energy[None, :] < e))).any(1)
        keep[s:s + chunk] = ~dominated
    return keep


def _pareto_mask_sorted(perf: np.ndarray,
                        energy: np.ndarray) -> np.ndarray:
    """O(n log n) dominance test: sort by (energy asc, perf desc); a point
    survives iff it has its energy group's max perf and strictly beats the
    running perf max of all lower-energy groups (duplicates survive)."""
    n = perf.shape[0]
    order = np.lexsort((-perf, energy))
    ps, es = perf[order], energy[order]
    new_group = np.empty(n, dtype=bool)
    new_group[0] = True
    new_group[1:] = es[1:] != es[:-1]
    group_id = np.cumsum(new_group) - 1
    group_max = ps[new_group]
    cummax = np.maximum.accumulate(group_max)
    prev_best = np.full(len(group_max), -np.inf)
    prev_best[1:] = cummax[:-1]
    survive_sorted = (ps == group_max[group_id]) \
        & (ps > prev_best[group_id])
    keep = np.empty(n, dtype=bool)
    keep[order] = survive_sorted
    return keep


def pareto_mask(perf: np.ndarray, energy: np.ndarray,
                chunk: int = 1024) -> np.ndarray:
    """Boolean mask of non-dominated points for (maximize perf, minimize
    energy); the broadcast test for small batches, the sort for large."""
    perf = np.asarray(perf, dtype=np.float64)
    energy = np.asarray(energy, dtype=np.float64)
    if perf.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    if perf.shape[0] <= 2048:
        return _pareto_mask_bcast(perf, energy, chunk)
    return _pareto_mask_sorted(perf, energy)
