"""Parameterized spatial-array accelerator template (QAPPA Fig. 1).

Copy of :mod:`repro.core.accelerator`: the design point (with the
derived quantities and the features the PPA models read), its
struct-of-arrays (SoA) form and the paper's full-factorial design space.
Host numpy code; the sweep moves SoA columns to the device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.pe import _P_PE_LEAK_UW, _SPECS, PESpec, PEType, pe_spec


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """One hardware design point in the QAPPA design space."""

    pe_type: PEType = PEType.INT16
    pe_rows: int = 12
    pe_cols: int = 14
    # per-PE scratchpad capacities in *entries* (words of the native width)
    ifmap_spad: int = 12
    filter_spad: int = 224
    psum_spad: int = 24
    glb_kb: int = 128              # shared global buffer capacity (kB)
    dram_bw_gbps: float = 12.8     # device bandwidth, GB/s
    clock_ghz: float | None = None  # None -> PE critical path sets the clock

    def __post_init__(self):
        object.__setattr__(self, "pe_type", PEType(self.pe_type))

    @property
    def num_pes(self) -> int:
        return self.pe_rows * self.pe_cols

    @property
    def spec(self) -> PESpec:
        return pe_spec(self.pe_type)

    @property
    def effective_clock_ghz(self) -> float:
        max_clk = self.spec.max_clock_ghz
        if self.clock_ghz is None:
            return max_clk
        return min(self.clock_ghz, max_clk)

    @property
    def peak_macs_per_s(self) -> float:
        return self.num_pes * self.effective_clock_ghz * 1e9

    @property
    def glb_bits(self) -> int:
        return self.glb_kb * 1024 * 8

    def name(self) -> str:
        return (f"{self.pe_type.value}_{self.pe_rows}x{self.pe_cols}"
                f"_glb{self.glb_kb}k_sp{self.ifmap_spad}-{self.filter_spad}-"
                f"{self.psum_spad}_bw{self.dram_bw_gbps:g}")

    def features(self) -> dict[str, float]:
        """Numeric features of the polynomial PPA models."""
        s = self.spec
        return {
            "num_pes": float(self.num_pes),
            "pe_rows": float(self.pe_rows),
            "pe_cols": float(self.pe_cols),
            "ifmap_spad": float(self.ifmap_spad),
            "filter_spad": float(self.filter_spad),
            "psum_spad": float(self.psum_spad),
            "glb_kb": float(self.glb_kb),
            "dram_bw_gbps": float(self.dram_bw_gbps),
            "act_bits": float(s.act_bits),
            "weight_bits": float(s.weight_bits),
        }


def soa_from_fields(pe_type_idx: np.ndarray,
                    pe_rows: np.ndarray, pe_cols: np.ndarray,
                    ifmap_spad: np.ndarray, filter_spad: np.ndarray,
                    psum_spad: np.ndarray, glb_kb: np.ndarray,
                    dram_bw_gbps: np.ndarray,
                    clock_cap: np.ndarray) -> dict[str, np.ndarray]:
    """Assemble the full SoA form from raw field arrays; per-PE-type
    constants are gathered from small tables by type index."""
    i8, f8 = np.int64, np.float64
    ti = np.asarray(pe_type_idx, dtype=i8)
    specs = [_SPECS[t] for t in PEType]
    soa = {
        "pe_type_idx": ti,
        "pe_rows": np.asarray(pe_rows, dtype=i8),
        "pe_cols": np.asarray(pe_cols, dtype=i8),
        "ifmap_spad": np.asarray(ifmap_spad, dtype=i8),
        "filter_spad": np.asarray(filter_spad, dtype=i8),
        "psum_spad": np.asarray(psum_spad, dtype=i8),
        "glb_kb": np.asarray(glb_kb, dtype=i8),
        "dram_bw_gbps": np.asarray(dram_bw_gbps, dtype=f8),
        "clock_cap": np.asarray(clock_cap, dtype=f8),
        "act_bits": np.array([s.act_bits for s in specs], dtype=i8)[ti],
        "weight_bits": np.array([s.weight_bits for s in specs],
                                dtype=i8)[ti],
        "psum_bits": np.array([s.psum_bits for s in specs], dtype=i8)[ti],
        "mac_energy_pj": np.array([s.mac_energy_pj for s in specs],
                                  dtype=f8)[ti],
        "mac_area_um2": np.array([s.mac_area_um2 for s in specs],
                                 dtype=f8)[ti],
        "max_clock_ghz": np.array([s.max_clock_ghz for s in specs],
                                  dtype=f8)[ti],
        "leak_uw": np.array([_P_PE_LEAK_UW[t] for t in PEType], dtype=f8)[ti],
    }
    soa["glb_bits"] = soa["glb_kb"] * (1024 * 8)
    soa["num_pes"] = soa["pe_rows"] * soa["pe_cols"]
    soa["spad_bits"] = (soa["ifmap_spad"] * soa["act_bits"]
                        + soa["filter_spad"] * soa["weight_bits"]
                        + soa["psum_spad"] * soa["psum_bits"])
    return soa


def configs_to_soa(
        configs: Sequence[AcceleratorConfig]) -> dict[str, np.ndarray]:
    """SoA view of a config batch: one array per field across N points."""
    i8 = np.int64
    type_idx = {t: i for i, t in enumerate(PEType)}
    rows = np.array(
        [(c.pe_rows, c.pe_cols, c.ifmap_spad, c.filter_spad, c.psum_spad,
          c.glb_kb, type_idx[c.pe_type]) for c in configs], dtype=i8)
    rows = rows.reshape(-1, 7)       # keep 2-D for the empty batch
    return soa_from_fields(
        pe_type_idx=rows[:, 6], pe_rows=rows[:, 0], pe_cols=rows[:, 1],
        ifmap_spad=rows[:, 2], filter_spad=rows[:, 3], psum_spad=rows[:, 4],
        glb_kb=rows[:, 5],
        dram_bw_gbps=np.array([c.dram_bw_gbps for c in configs],
                              dtype=np.float64),
        clock_cap=np.array([np.inf if c.clock_ghz is None else c.clock_ghz
                            for c in configs], dtype=np.float64))


def soa_to_configs(soa: dict[str, np.ndarray],
                   indices: Sequence[int] | np.ndarray | None = None
                   ) -> list[AcceleratorConfig]:
    """Materialize configs back out of SoA form (optionally ``indices``)."""
    types = tuple(PEType)
    idx = range(len(soa["pe_rows"])) if indices is None else indices
    return [
        AcceleratorConfig(
            pe_type=types[int(soa["pe_type_idx"][i])],
            pe_rows=int(soa["pe_rows"][i]), pe_cols=int(soa["pe_cols"][i]),
            ifmap_spad=int(soa["ifmap_spad"][i]),
            filter_spad=int(soa["filter_spad"][i]),
            psum_spad=int(soa["psum_spad"][i]),
            glb_kb=int(soa["glb_kb"][i]),
            dram_bw_gbps=float(soa["dram_bw_gbps"][i]),
            clock_ghz=(None if np.isinf(soa["clock_cap"][i])
                       else float(soa["clock_cap"][i])))
        for i in idx]


# the paper's Sec. 3.3 factor grid
DEFAULT_ARRAY_DIMS = ((8, 8), (12, 14), (16, 16), (24, 24), (32, 32))
DEFAULT_SPAD_SCALES = (0.5, 1.0, 2.0)
DEFAULT_GLB_KBS = (64, 128, 256, 512)
DEFAULT_BWS = (6.4, 12.8, 25.6)


def spad_capacities(scale: float) -> tuple[int, int, int]:
    """(ifmap, filter, psum) scratchpad entries for one spad-scale factor."""
    return (max(4, int(12 * scale)), max(16, int(224 * scale)),
            max(8, int(24 * scale)))


def design_space(
    pe_types: tuple[PEType, ...] = tuple(PEType),
    array_dims: tuple[tuple[int, int], ...] = DEFAULT_ARRAY_DIMS,
    spad_scales: tuple[float, ...] = DEFAULT_SPAD_SCALES,
    glb_kbs: tuple[int, ...] = DEFAULT_GLB_KBS,
    bws: tuple[float, ...] = DEFAULT_BWS,
) -> Iterator[AcceleratorConfig]:
    """Full-factorial QAPPA design space (paper Sec. 3.3)."""
    for pe_type, (r, c), ss, glb, bw in itertools.product(
            pe_types, array_dims, spad_scales, glb_kbs, bws):
        ifs, fls, pss = spad_capacities(ss)
        yield AcceleratorConfig(
            pe_type=pe_type, pe_rows=r, pe_cols=c,
            ifmap_spad=ifs, filter_spad=fls, psum_spad=pss,
            glb_kb=glb, dram_bw_gbps=bw)


def design_space_size(
    pe_types: tuple[PEType, ...] = tuple(PEType),
    array_dims: tuple[tuple[int, int], ...] = DEFAULT_ARRAY_DIMS,
    spad_scales: tuple[float, ...] = DEFAULT_SPAD_SCALES,
    glb_kbs: tuple[int, ...] = DEFAULT_GLB_KBS,
    bws: tuple[float, ...] = DEFAULT_BWS,
) -> int:
    return (len(pe_types) * len(array_dims) * len(spad_scales)
            * len(glb_kbs) * len(bws))


def design_space_soa(
    pe_types: tuple[PEType, ...] = tuple(PEType),
    array_dims: tuple[tuple[int, int], ...] = DEFAULT_ARRAY_DIMS,
    spad_scales: tuple[float, ...] = DEFAULT_SPAD_SCALES,
    glb_kbs: tuple[int, ...] = DEFAULT_GLB_KBS,
    bws: tuple[float, ...] = DEFAULT_BWS,
    chunk_size: int | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """The full-factorial space as SoA chunks of at most ``chunk_size``
    points, in :func:`design_space` order, with no per-config objects."""
    type_idx = {t: i for i, t in enumerate(PEType)}
    f_types = np.array([type_idx[PEType(t)] for t in pe_types],
                       dtype=np.int64)
    f_rows = np.array([d[0] for d in array_dims], dtype=np.int64)
    f_cols = np.array([d[1] for d in array_dims], dtype=np.int64)
    spads = [spad_capacities(s) for s in spad_scales]
    f_if = np.array([s[0] for s in spads], dtype=np.int64)
    f_fl = np.array([s[1] for s in spads], dtype=np.int64)
    f_ps = np.array([s[2] for s in spads], dtype=np.int64)
    f_glb = np.array(glb_kbs, dtype=np.int64)
    f_bw = np.array(bws, dtype=np.float64)

    sizes = (len(f_types), len(f_rows), len(f_if), len(f_glb), len(f_bw))
    total = int(np.prod(sizes))
    if total == 0:
        return
    chunk = total if chunk_size is None else max(1, int(chunk_size))
    # mixed-radix decomposition of the flat enumeration index
    strides = np.cumprod((1,) + sizes[:0:-1])[::-1]
    for start in range(0, total, chunk):
        flat = np.arange(start, min(start + chunk, total), dtype=np.int64)
        it, id_, is_, ig, ib = (flat // strides[j] % sizes[j]
                                for j in range(5))
        yield soa_from_fields(
            pe_type_idx=f_types[it], pe_rows=f_rows[id_], pe_cols=f_cols[id_],
            ifmap_spad=f_if[is_], filter_spad=f_fl[is_], psum_spad=f_ps[is_],
            glb_kb=f_glb[ig], dram_bw_gbps=f_bw[ib],
            clock_cap=np.full(flat.shape, np.inf))
