"""Design-space exploration: the port's entry point.

Port of the uniform single-workload sweep of :mod:`repro.core.dse`: an
:class:`ExploreSpec` built with :meth:`ExploreSpec.single` describes the
sweep and :func:`run` executes it on a device — the card unless the caller
passes ``device="cpu"``.  Results normalize performance-per-area and
energy against the best INT16 configuration, as the paper's Figs. 3-5 do.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.accelerator import AcceleratorConfig, design_space
from repro_torch.core.device import resolve_device
from repro_torch.core.dse_batch import (BatchedWorkloadResult, _sweep_chunked,
                                        _sweep_workload, pareto_mask)
from repro_torch.core.pe import PEType
from repro_torch.core.workloads import Workload, get_workload


@dataclasses.dataclass(frozen=True)
class DSEPoint:
    config: AcceleratorConfig
    result: BatchedWorkloadResult

    @property
    def perf_per_area(self) -> float:
        return self.result.perf_per_area

    @property
    def energy_j(self) -> float:
        return self.result.energy_j


@dataclasses.dataclass
class DSEResult:
    workload: str
    points: list[DSEPoint]

    def by_type(self, pe_type: PEType) -> list[DSEPoint]:
        return [p for p in self.points if p.config.pe_type == pe_type]

    def best_perf_per_area(self, pe_type: PEType) -> DSEPoint:
        return max(self.by_type(pe_type), key=lambda p: p.perf_per_area)

    def best_energy(self, pe_type: PEType) -> DSEPoint:
        return min(self.by_type(pe_type), key=lambda p: p.energy_j)

    def normalized(self) -> list[dict]:
        """Per paper Figs. 3-5: normalize against best-perf/area INT16."""
        anchor = self.best_perf_per_area(PEType.INT16)
        return [{
            "config": p.config.name(),
            "pe_type": p.config.pe_type.value,
            "norm_perf_per_area": p.perf_per_area / anchor.perf_per_area,
            "norm_energy": p.energy_j / anchor.energy_j,
        } for p in self.points]

    def headline_ratios(self) -> dict[str, float]:
        """The paper's headline numbers (Sec. 4): the best configuration
        of each PE type against the best INT16 (and INT16 against FP32)."""
        b = {t: self.best_perf_per_area(t) for t in PEType}
        e = {t: self.best_energy(t) for t in PEType}
        return {
            "lightpe1_perf_per_area_vs_int16":
                b[PEType.LIGHTPE1].perf_per_area / b[PEType.INT16].perf_per_area,
            "lightpe1_energy_vs_int16":
                e[PEType.INT16].energy_j / e[PEType.LIGHTPE1].energy_j,
            "lightpe2_perf_per_area_vs_int16":
                b[PEType.LIGHTPE2].perf_per_area / b[PEType.INT16].perf_per_area,
            "lightpe2_energy_vs_int16":
                e[PEType.INT16].energy_j / e[PEType.LIGHTPE2].energy_j,
            "int16_perf_per_area_vs_fp32":
                b[PEType.INT16].perf_per_area / b[PEType.FP32].perf_per_area,
            "int16_energy_vs_fp32":
                e[PEType.FP32].energy_j / e[PEType.INT16].energy_j,
        }


def pareto_front(points: Sequence[DSEPoint]) -> list[DSEPoint]:
    """Non-dominated set for (maximize perf/area, minimize energy),
    sorted by energy."""
    if not points:
        return []
    perf = np.array([p.perf_per_area for p in points], dtype=np.float64)
    energy = np.array([p.energy_j for p in points], dtype=np.float64)
    keep = pareto_mask(perf, energy)
    front = [p for p, k in zip(points, keep) if k]
    return sorted(front, key=lambda p: p.energy_j)


def _resolve(workload: Workload | str) -> Workload:
    return get_workload(workload) if isinstance(workload, str) else workload


_OUTPUT_MODES = ("points", "sweep", "aggregates")


@dataclasses.dataclass(frozen=True)
class ExploreSpec:
    """One uniform-precision sweep of one workload.  Build it with
    :meth:`single`; ``__post_init__`` rejects contradictory fields before
    any work."""

    workloads: tuple = ()
    configs: tuple | None = None
    outputs: str = "points"             # "points" | "sweep" | "aggregates"
    cache: object = None                # persisted synthesis cache (chunked)
    save_cache: bool = True
    overlap: bool = True
    # in-flight chunk bound of the streamed pipeline (chunked sweeps)
    prefetch_depth: int = 2
    use_cache: bool = True
    chunk_size: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "workloads", tuple(self.workloads))
        if len(self.workloads) != 1:
            raise ValueError(
                f"ExploreSpec sweeps exactly one workload, got "
                f"{len(self.workloads)}")
        if self.outputs not in _OUTPUT_MODES:
            raise ValueError(
                f"unknown outputs mode {self.outputs!r} "
                f"(choose from {_OUTPUT_MODES})")
        if self.configs is not None and self.chunk_size is None:
            # chunk-streamed feeds stay lazy; a one-batch sweep
            # materializes its configs once
            object.__setattr__(self, "configs", tuple(self.configs))
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError(
                f"chunk_size must be >= 1, got {self.chunk_size}")
        if int(self.prefetch_depth) < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.prefetch_depth != 2 and self.chunk_size is None:
            raise ValueError(
                "prefetch_depth tunes the streamed chunk pipeline; it "
                "needs chunk_size=")
        if self.chunk_size is not None:
            if self.configs is None:
                raise ValueError(
                    "chunked streaming needs an explicit config feed "
                    "(configs=); the default design space fits in one "
                    "batch")
            if self.outputs != "points":
                raise ValueError(
                    "chunked streaming returns a ChunkedSweep (aggregates "
                    'only); leave outputs="points"')

    @classmethod
    def single(cls, workload, configs=None, *, outputs: str = "points",
               chunk_size: int | None = None, use_cache: bool = True,
               cache=None, save_cache: bool = True, overlap: bool = True,
               prefetch_depth: int = 2) -> "ExploreSpec":
        """Uniform-precision sweep of one workload over a config batch
        (the paper's design space when ``configs`` is None).  A
        ``chunk_size`` streams an arbitrary-size feed with bounded memory
        and returns a :class:`~repro_torch.core.dse_batch.ChunkedSweep`."""
        return cls(workloads=(workload,), configs=configs, outputs=outputs,
                   chunk_size=chunk_size, use_cache=use_cache, cache=cache,
                   save_cache=save_cache, overlap=overlap,
                   prefetch_depth=prefetch_depth)


def run(spec: ExploreSpec, *, device: str | torch.device = "cuda"):
    """Execute an :class:`ExploreSpec` on ``device``.

    Returns a :class:`DSEResult` (``outputs="points"``), a
    :class:`~repro_torch.core.dse_batch.BatchedSweep` (``"sweep"`` /
    ``"aggregates"``), or a :class:`~repro_torch.core.dse_batch.ChunkedSweep`
    when ``chunk_size`` streams the feed.  ``device="cuda"`` raises
    ``RuntimeError`` on a host without CUDA.
    """
    if not isinstance(spec, ExploreSpec):
        raise TypeError(
            f"run() takes an ExploreSpec, got {type(spec).__name__}; "
            f"build one with ExploreSpec.single")
    device = resolve_device(device)
    wl = _resolve(spec.workloads[0])
    if spec.chunk_size is not None:
        return _sweep_chunked(
            wl, spec.configs, device=device, chunk_size=spec.chunk_size,
            use_cache=spec.use_cache, cache=spec.cache,
            save_cache=spec.save_cache, overlap=spec.overlap,
            prefetch_depth=spec.prefetch_depth)
    cfgs = tuple(design_space() if spec.configs is None else spec.configs)
    sweep = _sweep_workload(
        wl, cfgs, device=device, use_cache=spec.use_cache,
        outputs="aggregates" if spec.outputs == "aggregates" else "full")
    if spec.outputs != "points":
        return sweep
    return DSEResult(workload=wl.name,
                     points=[DSEPoint(config=c, result=sweep.result_view(i))
                             for i, c in enumerate(cfgs)])
