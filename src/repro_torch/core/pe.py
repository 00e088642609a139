"""Processing-element models for the QAPPA accelerator template.

Copy of :mod:`repro.core.pe` (the constants, the PE types the sweep
reads, and the execution modes a datapath can run).  The SRAM /
register-file energy helpers take numpy arrays (host synthesis) or torch
tensors (the sweep body on any device); on tensors the integer size is
cast to ``dtype`` first, because torch divides an int64 tensor by a
float scalar in float32 where numpy divides in float64.
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import numpy as np
import torch


class PEType(str, enum.Enum):
    FP32 = "fp32"
    INT16 = "int16"
    LIGHTPE1 = "lightpe1"
    LIGHTPE2 = "lightpe2"

    @property
    def pretty(self) -> str:
        return {
            PEType.FP32: "FP32",
            PEType.INT16: "INT16",
            PEType.LIGHTPE1: "LightPE-1",
            PEType.LIGHTPE2: "LightPE-2",
        }[self]


# 45nm per-op constants, calibrated against the paper's synthesis ratios
# (see repro.core.pe for the derivation)
_E_FP32_MAC = 1.38
_E_INT16_MAC = 1.00
_E_L1_MAC = 0.105
_E_L2_MAC = 0.135

_A_FP32_MAC = 12050.0
_A_INT16_MAC = 8850.0
_A_L1_MAC = 1430.0
_A_L2_MAC = 1450.0

_D_FP32_MAC = 1.39
_D_INT16_MAC = 1.25
_D_SHIFT_ADD = 0.80
_D_SHIFT2_ADD = 0.893

_P_PE_LEAK_UW = {       # static power per PE (uW) -- scales with area
    PEType.FP32: 14.0,
    PEType.INT16: 3.0,
    PEType.LIGHTPE1: 0.9,
    PEType.LIGHTPE2: 1.3,
}


@dataclasses.dataclass(frozen=True)
class PESpec:
    """Resolved datapath characteristics of one PE type."""

    pe_type: PEType
    act_bits: int
    weight_bits: int
    psum_bits: int
    mac_energy_pj: float
    mac_area_um2: float
    mac_delay_ns: float
    multiplier_free: bool

    @property
    def max_clock_ghz(self) -> float:
        return 1.0 / self.mac_delay_ns

    def scratchpad_bits(self, ifmap_entries: int, filter_entries: int,
                        psum_entries: int) -> int:
        """Total per-PE scratchpad storage in bits (quantization-aware)."""
        return (ifmap_entries * self.act_bits
                + filter_entries * self.weight_bits
                + psum_entries * self.psum_bits)


_SPECS = {
    PEType.FP32: PESpec(
        pe_type=PEType.FP32, act_bits=32, weight_bits=32, psum_bits=32,
        mac_energy_pj=_E_FP32_MAC, mac_area_um2=_A_FP32_MAC,
        mac_delay_ns=_D_FP32_MAC, multiplier_free=False),
    PEType.INT16: PESpec(
        pe_type=PEType.INT16, act_bits=16, weight_bits=16, psum_bits=32,
        mac_energy_pj=_E_INT16_MAC, mac_area_um2=_A_INT16_MAC,
        mac_delay_ns=_D_INT16_MAC, multiplier_free=False),
    PEType.LIGHTPE1: PESpec(
        pe_type=PEType.LIGHTPE1, act_bits=8, weight_bits=4, psum_bits=24,
        mac_energy_pj=_E_L1_MAC, mac_area_um2=_A_L1_MAC,
        mac_delay_ns=_D_SHIFT_ADD, multiplier_free=True),
    PEType.LIGHTPE2: PESpec(
        pe_type=PEType.LIGHTPE2, act_bits=8, weight_bits=8, psum_bits=24,
        mac_energy_pj=_E_L2_MAC, mac_area_um2=_A_L2_MAC,
        mac_delay_ns=_D_SHIFT2_ADD, multiplier_free=True),
}


def pe_spec(pe_type: PEType | str) -> PESpec:
    return _SPECS[PEType(pe_type)]


# A datapath built for PE type ``hw`` runs a layer in the *mode* of a
# narrower PE type: operands move at the mode's widths and unused slices
# gate off, so byte counts and MAC energy follow the mode while area,
# clock and leakage stay the hardware's.

def supports_mode(hw: PEType | str, mode: PEType | str) -> bool:
    """True iff ``mode``'s activation and weight widths both fit ``hw``'s
    native widths."""
    h, m = pe_spec(hw), pe_spec(mode)
    return m.act_bits <= h.act_bits and m.weight_bits <= h.weight_bits


def supported_modes(hw: PEType | str) -> tuple[PEType, ...]:
    """All modes executable on ``hw`` hardware, in enum order."""
    return tuple(t for t in PEType if supports_mode(hw, t))


@functools.lru_cache(maxsize=1)
def mode_compat_matrix() -> np.ndarray:
    """``(T, T)`` bool matrix, ``[hw_idx, mode_idx]`` = mode runs on hw, in
    ``tuple(PEType)`` order.  Cached; treat it as read-only."""
    types = tuple(PEType)
    return np.array([[supports_mode(h, m) for m in types] for h in types],
                    dtype=bool)


def _size_kb(size_bits, dtype):
    if isinstance(size_bits, torch.Tensor):
        return (size_bits.to(dtype) / 8192.0).clamp(min=0.03125)
    return np.maximum(size_bits / 8192.0, 0.03125)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else np.sqrt(x)


def rf_access_energy_pj(size_bits, dtype: torch.dtype = torch.float64):
    """Per-access energy of a PE-local register-file scratchpad (pJ).
    ``dtype`` is the float type a tensor input is computed in."""
    return 0.035 * _sqrt(_size_kb(size_bits, dtype)) + 0.015


def sram_access_energy_pj(size_bits, dtype: torch.dtype = torch.float64):
    """Per-element access energy of the global buffer (pJ)."""
    return 0.09 * _sqrt(_size_kb(size_bits, dtype)) + 0.04


def sram_area_um2(size_bits):
    """Area of an SRAM macro (host numpy only)."""
    return np.where(np.asarray(size_bits) > 0, 0.55 * size_bits + 300.0, 0.0)


def dram_energy_pj_per_byte() -> float:
    """LPDDR at 45 nm, ~80 pJ a byte: system-level context only.  The
    paper's energy is post-synthesis accelerator energy and the DRAM is
    not in the netlist, so :mod:`repro_torch.core.dataflow` excludes
    it."""
    return 80.0
