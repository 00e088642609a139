"""Row-stationary dataflow model: the pieces the batched sweep needs.

Copy of the leakage model and the per-layer result record of
:mod:`repro.core.dataflow`.  The mapping itself lives, batched over
``(N configs, L layers)``, in :func:`repro_torch.core.dse_batch._sweep_kernel`.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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


def leakage_mw_soa(soa: dict) -> np.ndarray:
    """Static power (mW) of each design point of a SoA batch: PE leakage
    plus ~2 uW per GLB kB."""
    return soa["num_pes"] * soa["leak_uw"] * 1e-3 + 0.002 * soa["glb_kb"]
