"""Row-stationary dataflow model (Eyeriss-style) for the QAPPA template.

Copy of :mod:`repro.core.dataflow`: the reference's per-config scalar
model, which maps one conv/FC layer onto the 2-D PE array the way Eyeriss
does —

* a *PE set* of ``R x E_tile`` computes one (channel, filter) plane;
* PE sets stack vertically (``sets_fit = pe_rows // R``) over channels
  first, then filters;
* output columns fold over the array width (``fit_horz``)

— and derives compute cycles, utilization and the quantization-aware
access counts of every storage level.  It is the host oracle of the
batched sweep (:func:`repro_torch.core.dse_batch._sweep_kernel`, which
computes the same mapping over ``(N configs, L layers)``), run by
``ExploreSpec.single(..., engine="scalar")`` on ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.accelerator import AcceleratorConfig
from repro_torch.core.pe import (PEType, pe_spec, rf_access_energy_pj,
                                 sram_access_energy_pj, supports_mode)
from repro_torch.core.workloads import ConvLayer, Workload


@dataclasses.dataclass(frozen=True)
class LayerResult:
    name: str
    macs: int
    compute_cycles: int
    mem_cycles: int
    total_cycles: int
    utilization: float
    spad_accesses: int            # word accesses (MAC-local)
    glb_bytes: int
    dram_bytes: int
    energy_pj: float

    @property
    def bound(self) -> str:
        return "memory" if self.mem_cycles > self.compute_cycles else "compute"


@dataclasses.dataclass(frozen=True)
class WorkloadResult:
    workload: str
    config_name: str
    layers: tuple[LayerResult, ...]
    area_mm2: float
    clock_ghz: float

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def total_cycles(self) -> int:
        return sum(l.total_cycles for l in self.layers)

    @property
    def latency_s(self) -> float:
        return self.total_cycles / (self.clock_ghz * 1e9)

    @property
    def energy_j(self) -> float:
        return sum(l.energy_pj for l in self.layers) / 1e12

    @property
    def throughput_gmacs(self) -> float:
        return self.total_macs / self.latency_s / 1e9

    @property
    def perf_per_area(self) -> float:
        """GMAC/s per mm^2 — the paper's performance-per-area metric."""
        return self.throughput_gmacs / self.area_mm2

    @property
    def edp(self) -> float:
        return self.energy_j * self.latency_s


def map_layer(layer: ConvLayer, cfg: AcceleratorConfig,
              clock_ghz: float, area_mm2: float,
              leakage_mw: float, mode: PEType | None = None) -> LayerResult:
    """Map one layer onto ``cfg``.  ``mode`` (default: the config's own PE
    type) is the layer's execution precision on a precision-scalable
    datapath: operand bytes and MAC energy follow the mode, array dims,
    scratchpads, clock, area and leakage stay the hardware's."""
    s = cfg.spec
    ms = s if mode is None else pe_spec(mode)
    r, e, f_, ss = layer.r, layer.e, layer.f, layer.s
    c, k, n = layer.c, layer.k, layer.batch

    # ---- spatial mapping ---------------------------------------------------
    sets_fit = max(1, cfg.pe_rows // r)            # PE sets stacked vertically
    c_simult = min(c, sets_fit)                    # channels accumulated in-array
    k_simult = max(1, sets_fit // c_simult)        # filters in parallel
    fit_horz = min(e, cfg.pe_cols)                 # output rows across width
    n_e_groups = math.ceil(e / fit_horz)
    n_c_groups = math.ceil(c / c_simult)
    n_k_groups = math.ceil(k / k_simult)

    passes = n * n_e_groups * n_c_groups * n_k_groups
    compute_cycles = passes * ss * f_
    macs = layer.macs
    utilization = macs / max(1, compute_cycles * cfg.num_pes)

    # ---- element / byte counts (quantization-aware) -------------------------
    ab, wb = ms.act_bits, ms.weight_bits
    ifmap_elems = n * c * layer.h * layer.w
    weight_elems = k * c * r * ss
    ofmap_elems = n * k * e * f_
    ifmap_bytes = ifmap_elems * ab // 8
    weight_bytes = weight_elems * wb // 8
    ofmap_bytes = ofmap_elems * ab // 8

    # DRAM traffic: weights stream once; the ifmap is re-streamed per
    # filter group that does not fit the GLB (half of it each for ifmap
    # and weights)
    glb_half = cfg.glb_kb * 1024 // 2
    filt_bytes_one = max(1, c * r * ss * wb // 8)
    k_fit_glb = max(1, glb_half // filt_bytes_one)
    n_k_glb = math.ceil(k / k_fit_glb)
    ifmap_resident = ifmap_bytes <= glb_half
    ifmap_dram = ifmap_bytes * (1 if ifmap_resident else n_k_glb)
    dram_bytes = ifmap_dram + weight_bytes + ofmap_bytes

    # GLB traffic in elements (fixed-width port): fills/drains mirror the
    # DRAM stream, the ifmap is multicast-read once per filter residency
    # group, weights re-read when the filter spad cannot hold its working
    # set, psums spill between channel groups when the psum spad cannot
    # hold an output strip
    dram_elems = ifmap_elems * (1 if ifmap_resident else n_k_glb) \
        + weight_elems + ofmap_elems
    k_res = max(1, cfg.filter_spad // max(1, ss))
    glb_ifmap = ifmap_elems * math.ceil(n_k_groups / k_res)
    w_res = min(n_e_groups, max(1, cfg.filter_spad // max(1, ss)))
    glb_weight = weight_elems * max(1, n_e_groups // w_res)
    psum_strip = f_  # psum entries a PE must hold per pass
    spill = 0 if cfg.psum_spad >= psum_strip else (n_c_groups - 1)
    glb_psum = 2 * ofmap_elems * max(0, spill)
    glb_elems = 2 * dram_elems + glb_ifmap + glb_weight + glb_psum
    glb_bytes = glb_elems * ab // 8  # reported for reference

    # ---- stalls -------------------------------------------------------------
    bw_bytes_per_cycle = cfg.dram_bw_gbps / clock_ghz
    mem_cycles = int(dram_bytes / max(1e-9, bw_bytes_per_cycle))
    total_cycles = max(compute_cycles, mem_cycles)   # double-buffered overlap

    # ---- energy: post-synthesis accelerator energy; the DRAM is not in
    # the netlist, so DRAM energy is excluded
    spad_bits = s.scratchpad_bits(cfg.ifmap_spad, cfg.filter_spad,
                                  cfg.psum_spad)
    # ifmap read + weight read + ~1 psum spad access per MAC
    spad_accesses = 3 * macs
    e_spad = spad_accesses * rf_access_energy_pj(spad_bits)
    e_mac = macs * ms.mac_energy_pj
    e_glb = glb_elems * sram_access_energy_pj(cfg.glb_bits)
    e_leak = leakage_mw * 1e-3 * (total_cycles / (clock_ghz * 1e9)) * 1e12
    energy_pj = e_mac + e_spad + e_glb + e_leak

    return LayerResult(
        name=layer.name, macs=macs,
        compute_cycles=compute_cycles, mem_cycles=mem_cycles,
        total_cycles=total_cycles, utilization=utilization,
        spad_accesses=spad_accesses, glb_bytes=glb_bytes,
        dram_bytes=dram_bytes, energy_pj=energy_pj,
    )


def leakage_mw(cfg: AcceleratorConfig) -> float:
    """Static power of one design point: PE leakage plus ~2 uW per GLB
    kB."""
    from repro_torch.core.pe import _P_PE_LEAK_UW
    return cfg.num_pes * _P_PE_LEAK_UW[cfg.pe_type] * 1e-3 \
        + 0.002 * cfg.glb_kb


def leakage_mw_soa(soa: dict) -> np.ndarray:
    """:func:`leakage_mw` of each design point of a SoA batch."""
    return soa["num_pes"] * soa["leak_uw"] * 1e-3 + 0.002 * soa["glb_kb"]


def run_workload(workload: Workload, cfg: AcceleratorConfig,
                 report=None) -> WorkloadResult:
    """Evaluate a workload on a design point (synthesis report
    optional)."""
    if report is None:
        from repro_torch.core.synthesis import synthesize
        report = synthesize(cfg)
    leak = leakage_mw(cfg)
    layers = tuple(
        map_layer(l, cfg, report.clock_ghz, report.area_mm2, leak)
        for l in workload.layers)
    return WorkloadResult(
        workload=workload.name, config_name=cfg.name(), layers=layers,
        area_mm2=report.area_mm2, clock_ghz=report.clock_ghz,
    )


def run_workload_mixed(workload: Workload, cfg: AcceleratorConfig,
                       assignment, report=None) -> WorkloadResult:
    """Evaluate a workload with one execution mode per layer (PEType
    values or their strings): the scalar oracle of the mixed-precision
    sweep (:func:`repro_torch.core.dse_batch._sweep_mixed`)."""
    modes = tuple(PEType(m) for m in assignment)
    if len(modes) != len(workload.layers):
        raise ValueError(
            f"assignment length {len(modes)} != {len(workload.layers)} "
            f"layers of workload {workload.name!r}")
    bad = [m.value for m in modes if not supports_mode(cfg.pe_type, m)]
    if bad:
        raise ValueError(
            f"mode(s) {sorted(set(bad))} not executable on "
            f"{cfg.pe_type.value} hardware (operand widths exceed the "
            f"datapath)")
    if report is None:
        from repro_torch.core.synthesis import synthesize
        report = synthesize(cfg)
    leak = leakage_mw(cfg)
    layers = tuple(
        map_layer(l, cfg, report.clock_ghz, report.area_mm2, leak, mode=m)
        for l, m in zip(workload.layers, modes))
    return WorkloadResult(
        workload=workload.name, config_name=cfg.name(), layers=layers,
        area_mm2=report.area_mm2, clock_ghz=report.clock_ghz,
    )
