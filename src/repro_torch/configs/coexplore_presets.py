"""Search presets of the co-exploration engines, copied from
:mod:`repro.configs.coexplore_presets`.

A preset bundles the knobs of one search campaign — engine, evaluation
budget, population sizing, objective set — so runs are named and
reproducible.  ``quick`` is the CI smoke setting, ``default`` the
benchmark's, ``thorough`` the 5-objective set; the ``many-*`` presets
target a workload suite with the multi-workload objectives; the
``serving-*`` presets score every genome on a serving fleet: ``traffic``
names a :data:`repro_torch.serving.traffic.TRAFFIC_PRESETS` trace that
the fleet simulator replays per candidate over ``n_slots`` slots.

Every preset of the reference is registered; ``calibrated-quick`` scores
on the tier-1 table of mamba2-130m, measured on the search's device and
npz-cached.  The deprecated preset fields fold as in the reference:
``sqnr_floor_db`` into ``accuracy=AccuracySpec(floor_db=...)``, legacy
objective names into their canonical ones, each with a
``DeprecationWarning``.
"""

from __future__ import annotations

import dataclasses
import warnings

from repro_torch.explore.accuracy import AccuracySpec
from repro_torch.explore.objectives import (DEFAULT_MULTI_OBJECTIVES,
                                            DEFAULT_OBJECTIVES,
                                            DEFAULT_SERVING_OBJECTIVES,
                                            MULTI_OBJECTIVES, OBJECTIVES,
                                            SERVING_OBJECTIVES,
                                            resolve_objectives)


@dataclasses.dataclass(frozen=True)
class CoExplorePreset:
    name: str
    method: str = "nsga2"            # random | nsga2 | successive_halving
    budget: int = 2048               # requested genome evaluations
    pop_size: int = 64               # nsga2 population
    mutation_rate: float = 0.08
    objectives: tuple[str, ...] = DEFAULT_OBJECTIVES
    seed: int = 0
    chunk_size: int = 4096
    eta: int = 3                     # successive-halving reduction factor
    accuracy: AccuracySpec | str | None = None
    weights: tuple[float, ...] | None = None   # None = energy-weighted
    traffic: str | None = None       # TRAFFIC_PRESETS name (serving mode)
    n_slots: int = 8                 # fleet slots (serving mode)
    # nsga2 external-archive bound: relative epsilon-dominance grid
    # resolution (fraction of each objective's span), None = unbounded
    archive_epsilon: float | None = None
    sqnr_floor_db: float | tuple[float, ...] | None = None   # deprecated

    def __post_init__(self):
        # the DeprecationWarning of a legacy name lands on whoever built
        # the preset, 4 frames up through the generated __init__
        object.__setattr__(self, "objectives", resolve_objectives(
            self.objectives, stacklevel=4))
        if isinstance(self.accuracy, str):
            object.__setattr__(self, "accuracy",
                               AccuracySpec.parse(self.accuracy))
        if self.sqnr_floor_db is not None:
            warnings.warn(
                f"preset {self.name!r}: sqnr_floor_db= is deprecated; "
                f"use accuracy=AccuracySpec(floor_db=...)",
                DeprecationWarning, stacklevel=4)
            if self.accuracy is not None:
                raise ValueError(
                    f"preset {self.name!r}: pass either accuracy= or the "
                    f"deprecated sqnr_floor_db=, not both")
            object.__setattr__(self, "accuracy", AccuracySpec(
                floor_db=self.sqnr_floor_db))
            object.__setattr__(self, "sqnr_floor_db", None)
        serving = set(self.objectives) & set(SERVING_OBJECTIVES)
        if serving and self.traffic is None:
            raise ValueError(
                f"preset {self.name!r}: serving objective(s) "
                f"{sorted(serving)} need traffic= (one of "
                f"repro_torch.serving.traffic.TRAFFIC_PRESETS)")
        if self.traffic is not None:
            if not serving:
                raise ValueError(
                    f"preset {self.name!r}: traffic={self.traffic!r} but "
                    f"no serving objective in {self.objectives}")
            if set(self.objectives) & set(MULTI_OBJECTIVES):
                raise ValueError(
                    f"preset {self.name!r}: serving objectives are "
                    f"single-workload only; drop the multi-workload "
                    f"objectives or the traffic")
            from repro_torch.serving.traffic import get_traffic
            get_traffic(self.traffic)          # raises on unknown name
        if self.n_slots < 1:
            raise ValueError(
                f"preset {self.name!r}: n_slots must be >= 1, "
                f"got {self.n_slots}")
        if self.archive_epsilon is not None:
            if self.method != "nsga2":
                raise ValueError(
                    f"preset {self.name!r}: archive_epsilon bounds the "
                    f"nsga2 external archive; method is {self.method!r}")
            if not (0.0 < self.archive_epsilon < 1.0):
                raise ValueError(
                    f"preset {self.name!r}: archive_epsilon must be a "
                    f"relative resolution in (0, 1), "
                    f"got {self.archive_epsilon}")


PRESETS: dict[str, CoExplorePreset] = {p.name: p for p in (
    CoExplorePreset(name="quick", budget=384, pop_size=24),
    CoExplorePreset(name="default"),
    CoExplorePreset(name="thorough", budget=8192, pop_size=96,
                    objectives=OBJECTIVES),
    # long-horizon setting: the epsilon-bounded archive holds memory
    # constant
    CoExplorePreset(name="marathon", budget=16384, pop_size=96,
                    objectives=OBJECTIVES, archive_epsilon=0.01),
    CoExplorePreset(name="random-baseline", method="random"),
    CoExplorePreset(name="halving", method="successive_halving",
                    budget=4096),
    # tier-1 campaign: quick's budget, scored on a table calibrated from
    # mamba2-130m tensors
    CoExplorePreset(name="calibrated-quick", budget=384, pop_size=24,
                    accuracy="calibrated:mamba2-130m"),
    # multi-workload campaigns (shared hardware, per-workload precision)
    CoExplorePreset(name="many-quick", budget=384, pop_size=24,
                    objectives=DEFAULT_MULTI_OBJECTIVES),
    CoExplorePreset(name="many-default",
                    objectives=DEFAULT_MULTI_OBJECTIVES),
    CoExplorePreset(name="many-thorough", budget=8192, pop_size=96,
                    objectives=("neg_worst_perf_per_area",
                                "total_energy_j", "worst_edp",
                                "worst_accuracy_noise"),
                    accuracy=AccuracySpec(floor_db=20.0)),
    # serving-fleet campaigns (traffic-aware objectives)
    CoExplorePreset(name="serving-quick", budget=384, pop_size=24,
                    objectives=DEFAULT_SERVING_OBJECTIVES,
                    traffic="quick"),
    CoExplorePreset(name="serving-default",
                    objectives=DEFAULT_SERVING_OBJECTIVES,
                    traffic="steady"),
    CoExplorePreset(name="serving-thorough", budget=8192, pop_size=96,
                    objectives=("p99_latency_s", "neg_slo_attainment",
                                "neg_throughput_tps",
                                "energy_per_token_j", "accuracy_noise"),
                    traffic="bursty"),
)}


def get_preset(name: str) -> CoExplorePreset:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown co-exploration preset {name!r} "
            f"(known: {sorted(PRESETS)})") from None
