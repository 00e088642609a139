"""Objective functions for co-exploration (all minimized).

Port of :mod:`repro.explore.objectives`.  Hardware objectives come from
the sweep's aggregate columns (perf/area negated, energy, EDP, area); the
accuracy objective (``accuracy_noise``) is the tier-0 quantization-noise
proxy: each layer contributes its MAC share times the relative noise
power of its execution mode, one number per PE type measured on the
port's own quantizers (:func:`mode_noise_table`).

The noise table is measured once per process on the CPU in float32 torch,
from the reference's seeded draws and in its operation order, so a search
on the card and one on the CPU score genomes with one table — as the
reference's numpy and jax backends share theirs.  It equals the
reference's table bit for bit (tested).

Serving-fleet objectives (:data:`SERVING_OBJECTIVES`) replay a traffic
trace on every candidate's continuous batcher with the fleet simulator
(:func:`repro_torch.serving.fleet_sim.simulate_fleet`): on the card its
CUDA kernel, on the CPU its plain version; the stamps are integers and
bit-identical either way.  The reference scores serving on host numpy
even under jax; the port simulates on the Evaluator's own device, so a
search on the card has no host loop.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from repro_torch.core.pe import PEType


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """One registered objective: canonical name, which evaluation scope
    provides it, and a one-line description for reports."""

    name: str
    scope: str          # "single" | "serving" | "multi"
    description: str

    def __post_init__(self):
        if self.scope not in ("single", "serving", "multi"):
            raise ValueError(f"bad scope {self.scope!r}")


_REGISTRY_SPECS = (
    ObjectiveSpec("neg_perf_per_area", "single",
                  "negated TOPS/mm^2 of the synthesized design"),
    ObjectiveSpec("energy_j", "single", "energy per inference"),
    ObjectiveSpec("edp", "single", "energy-delay product"),
    ObjectiveSpec("area_mm2", "single", "die area"),
    ObjectiveSpec("accuracy_noise", "single",
                  "MAC-weighted relative quantization-noise power "
                  "(tier-0 proxy)"),
    # serving-fleet objectives (single-workload only), scored by the
    # trace-driven fleet simulator
    ObjectiveSpec("p50_latency_s", "serving", "median request latency"),
    ObjectiveSpec("p99_latency_s", "serving", "tail request latency"),
    ObjectiveSpec("neg_slo_attainment", "serving",
                  "negated fraction of requests inside the SLO"),
    ObjectiveSpec("neg_throughput_tps", "serving",
                  "negated sustained tokens/s"),
    ObjectiveSpec("energy_per_token_j", "serving",
                  "energy per served token (occupancy-sensitive)"),
    # multi-workload objectives (shared hardware, per-workload
    # assignments): worst_* is the max over the suite, mean_* the
    # weighted mean (default weights: each workload's share of the
    # genome's total energy)
    ObjectiveSpec("neg_worst_perf_per_area", "multi",
                  "negated worst-case perf/area over the suite"),
    ObjectiveSpec("worst_latency_s", "multi", "worst-case latency"),
    ObjectiveSpec("mean_latency_s", "multi", "weighted-mean latency"),
    ObjectiveSpec("worst_edp", "multi", "worst-case EDP"),
    ObjectiveSpec("mean_edp", "multi", "weighted-mean EDP"),
    ObjectiveSpec("total_energy_j", "multi", "suite energy"),
    ObjectiveSpec("worst_accuracy_noise", "multi",
                  "worst-case accuracy noise over the suite"),
    ObjectiveSpec("mean_accuracy_noise", "multi",
                  "weighted-mean accuracy noise"),
)

OBJECTIVE_REGISTRY: dict[str, ObjectiveSpec] = {
    s.name: s for s in _REGISTRY_SPECS}

# historical objective names -> canonical (accepted with a warning)
LEGACY_OBJECTIVE_ALIASES = {
    "quant_noise": "accuracy_noise",
    "worst_quant_noise": "worst_accuracy_noise",
    "mean_quant_noise": "mean_accuracy_noise",
}


def _scope(scope: str) -> tuple[str, ...]:
    return tuple(s.name for s in _REGISTRY_SPECS if s.scope == scope)


OBJECTIVES = _scope("single")
SERVING_OBJECTIVES = _scope("serving")
MULTI_OBJECTIVES = _scope("multi")
DEFAULT_OBJECTIVES = ("neg_perf_per_area", "energy_j", "accuracy_noise")
DEFAULT_SERVING_OBJECTIVES = ("p99_latency_s", "energy_per_token_j",
                              "accuracy_noise")
DEFAULT_MULTI_OBJECTIVES = ("neg_worst_perf_per_area", "total_energy_j",
                            "worst_accuracy_noise")


def resolve_objectives(objectives, *, stacklevel: int = 2,
                       scope: str | None = None) -> tuple[str, ...]:
    """Canonicalize an objective-name sequence against the registry.
    Legacy names (:data:`LEGACY_OBJECTIVE_ALIASES`) resolve to their
    canonical ones with a ``DeprecationWarning`` attributed
    ``stacklevel`` frames up; unknown names raise.  ``scope`` restricts
    the registry ("single" also admits serving objectives, which are
    single-workload by construction)."""
    out = []
    for name in objectives:
        if name in LEGACY_OBJECTIVE_ALIASES:
            new = LEGACY_OBJECTIVE_ALIASES[name]
            warnings.warn(
                f"objective name {name!r} is deprecated; use {new!r}",
                DeprecationWarning, stacklevel=stacklevel)
            name = new
        spec = OBJECTIVE_REGISTRY.get(name)
        if spec is None:
            raise ValueError(
                f"unknown objective {name!r} (choose from "
                f"{tuple(OBJECTIVE_REGISTRY)})")
        if scope == "single" and spec.scope == "multi":
            raise ValueError(
                f"objective {name!r} is multi-workload only")
        if scope == "multi" and spec.scope != "multi":
            if spec.scope == "serving":
                raise ValueError(
                    f"serving objective {name!r} is single-workload only "
                    f"(one traffic trace drives one fleet)")
            raise ValueError(
                f"objective {name!r} is not a multi-workload objective "
                f"(choose from {MULTI_OBJECTIVES})")
        out.append(name)
    return tuple(out)


# static-penalty scale for accuracy-floor violations: a genome breaking a
# floor lands far outside the feasible ranges in every objective
FLOOR_PENALTY = 1e9

_TYPES = tuple(PEType)

_NOISE_TABLE: list[np.ndarray] = []     # the measured table, once


def reset_sqnr_table() -> None:
    """Drop the memoized tier-0 table (tests)."""
    _NOISE_TABLE.clear()


def _measure_noise_table() -> np.ndarray:
    """Per-PE-type relative quantization-noise power, from the port's
    quantizers over the reference's fixed synthetic Gaussian tensors:
    E[(w - qdq(w))^2]/E[w^2] + E[(x - qdq_act(x))^2]/E[x^2] with the
    pairs of :data:`repro_torch.quant.calibrate.PE_QUANT_SPECS`, in
    float32 on the CPU."""
    import torch

    from repro_torch.quant.calibrate import PE_QUANT_SPECS
    from repro_torch.quant.quantizers import quantize_dequantize

    rng = np.random.default_rng(20220516)          # paper's arXiv date
    w = torch.from_numpy(rng.normal(size=8192).astype(np.float32))
    x = torch.from_numpy(np.abs(rng.normal(size=8192)).astype(np.float32))

    def rel_noise(v, q):
        v64 = v.numpy().astype(np.float64)
        q64 = q.numpy().astype(np.float64)
        return float(np.mean((v64 - q64) ** 2) / np.mean(v64 ** 2))

    table = np.zeros(len(_TYPES), dtype=np.float64)
    for t, (wspec, aspec) in PE_QUANT_SPECS.items():
        n = 0.0
        if wspec is not None:
            n += rel_noise(w, quantize_dequantize(w, wspec))
        if aspec is not None:
            n += rel_noise(x, quantize_dequantize(x, aspec))
        table[_TYPES.index(t)] = n
    return table


def mode_noise_table() -> np.ndarray:
    """``(T,)`` relative noise power per PE type (canonical order)."""
    if not _NOISE_TABLE:
        _NOISE_TABLE.append(_measure_noise_table())
    return _NOISE_TABLE[0]


def quant_noise(assign: np.ndarray, layer_macs: np.ndarray) -> np.ndarray:
    """MAC-weighted quantization-noise score per genome: ``assign`` is the
    ``(N, L)`` mode-index matrix, ``layer_macs`` the ``(L,)`` MAC counts;
    0 is fp32 everywhere."""
    table = mode_noise_table()
    macs = np.asarray(layer_macs, dtype=np.float64)
    wts = macs / macs.sum()
    # row-local axis-1 reduction, NOT `@` (BLAS gemv): gemv blocking
    # depends on N, so a genome scored in two batch compositions would
    # drift by ~1 ulp
    return (table[np.asarray(assign, dtype=np.int64)] * wts).sum(axis=1)


def mode_sqnr_db() -> dict[str, float]:
    """Human-readable SQNR (dB) per PE type, for reports."""
    table = mode_noise_table()
    out = {}
    for t, n in zip(_TYPES, table):
        out[t.value] = float("inf") if n <= 0 else float(-10 * np.log10(n))
    return out


def serving_metrics(agg: dict[str, np.ndarray], traffic, *,
                    n_slots: int = 8,
                    device="cuda") -> dict[str, np.ndarray]:
    """Fleet-simulator metrics of every candidate of a sweep aggregate:
    each candidate's ``latency_s`` is one batcher iteration and its
    ``energy_j`` one token-slot of energy; the shared ``traffic`` trace
    is replayed on an ``n_slots`` fleet per candidate, on ``device``."""
    from repro_torch.serving.fleet_sim import simulate_fleet
    res = simulate_fleet(np.asarray(agg["latency_s"], dtype=np.float64),
                         np.asarray(agg["energy_j"], dtype=np.float64),
                         traffic, n_slots=n_slots, device=device)
    return res.metrics()


def objective_matrix(agg: dict[str, np.ndarray],
                     assign: np.ndarray,
                     layer_macs: np.ndarray,
                     objectives=DEFAULT_OBJECTIVES, *,
                     traffic=None, n_slots: int = 8, device="cuda",
                     accuracy=None) -> np.ndarray:
    """The ``(N, K)`` minimization matrix from sweep aggregates.

    ``agg`` is the mixed-precision sweep output (the aggregate columns
    plus ``area_mm2``).  Serving objectives need ``traffic`` (a trace,
    preset or preset name) and run the fleet simulator on ``device``; an
    overloaded candidate's infinite tail latency or energy per token is
    clamped to :data:`FLOOR_PENALTY`, so it stays comparable yet always
    dominated.  ``accuracy`` is an accuracy model scoring the
    ``accuracy_noise`` column (``None`` = the tier-0 proxy); one carrying
    a ``floor_db`` adds a static penalty to every objective of a genome
    that breaks the floor.
    """
    objectives = resolve_objectives(objectives, stacklevel=3,
                                    scope="single")
    score = quant_noise if accuracy is None else accuracy.score
    need_serving = [n for n in objectives if n in SERVING_OBJECTIVES]
    fleet = None
    if need_serving:
        if traffic is None:
            raise ValueError(
                f"objectives {need_serving} need traffic= (a TrafficTrace,"
                f" TrafficPreset, or preset name)")
        fleet = serving_metrics(agg, traffic, n_slots=n_slots,
                                device=device)

    def clamp(col):
        return np.minimum(np.asarray(col, dtype=np.float64), FLOOR_PENALTY)

    cols = []
    for name in objectives:
        if name == "neg_perf_per_area":
            cols.append(-np.asarray(agg["perf_per_area"], dtype=np.float64))
        elif name == "energy_j":
            cols.append(np.asarray(agg["energy_j"], dtype=np.float64))
        elif name == "edp":
            cols.append(np.asarray(agg["energy_j"], dtype=np.float64)
                        * np.asarray(agg["latency_s"], dtype=np.float64))
        elif name == "area_mm2":
            cols.append(np.asarray(agg["area_mm2"], dtype=np.float64))
        elif name == "accuracy_noise":
            cols.append(score(assign, layer_macs))
        elif name in ("p50_latency_s", "p99_latency_s"):
            cols.append(clamp(fleet[name]))
        elif name == "neg_slo_attainment":
            cols.append(-np.asarray(fleet["slo_attainment"],
                                    dtype=np.float64))
        elif name == "neg_throughput_tps":
            cols.append(-np.asarray(fleet["throughput_tps"],
                                    dtype=np.float64))
        elif name == "energy_per_token_j":
            cols.append(clamp(fleet["energy_per_token_j"]))
        else:                     # registry-validated: unreachable
            raise AssertionError(name)
    F = np.stack(cols, axis=-1)
    floor_db = getattr(accuracy, "floor_db", None)
    if floor_db is not None:
        v = accuracy_floor_violation([assign], [layer_macs], floor_db,
                                     accuracy=accuracy)
        F = F + (FLOOR_PENALTY * v)[:, None]
    return F


def accuracy_floor_violation(assigns, layer_macs_list, floor_db,
                             accuracy=None) -> np.ndarray:
    """Per-genome violation of per-workload SQNR floors (``floor_db``
    scalar or one per workload): the summed relative excess of each
    workload's noise score over its ceiling ``10**(-floor_db/10)``, zero
    for feasible genomes."""
    score = quant_noise if accuracy is None else accuracy.score
    floors = np.broadcast_to(np.asarray(floor_db, dtype=np.float64),
                             (len(assigns),))
    ceil = 10.0 ** (-floors / 10.0)
    v = np.zeros(len(np.asarray(assigns[0])), dtype=np.float64)
    for a, macs, c in zip(assigns, layer_macs_list, ceil):
        noise = score(a, macs)
        v += np.maximum(0.0, noise - c) / c
    return v


def multi_objective_matrix(agg: dict[str, np.ndarray],
                           assigns,
                           layer_macs_list,
                           objectives=DEFAULT_MULTI_OBJECTIVES,
                           weights=None,
                           accuracy=None) -> np.ndarray:
    """The ``(N, K)`` minimization matrix for a workload suite.

    ``agg`` holds the ``(W, N)`` aggregate columns of
    :func:`repro_torch.core.dse_batch._sweep_mixed_many`, ``assigns`` the
    per-workload ``(N, L_w)`` mode matrices, ``layer_macs_list`` the
    per-workload MAC counts.  ``worst_*`` objectives take the max over
    the suite; ``mean_*`` are means weighted by ``weights`` (a ``(W,)``
    importance vector) or, when ``None``, by each workload's share of the
    genome's own energy.  A ``floor_db`` on ``accuracy`` adds the static
    penalty of :func:`accuracy_floor_violation`.
    """
    objectives = resolve_objectives(objectives, stacklevel=3,
                                    scope="multi")
    score = quant_noise if accuracy is None else accuracy.score
    floor_db = getattr(accuracy, "floor_db", None)
    lat = np.asarray(agg["latency_s"], dtype=np.float64)
    energy = np.asarray(agg["energy_j"], dtype=np.float64)
    if lat.ndim != 2:
        raise ValueError(
            f"multi-workload aggregates must be (W, N), got {lat.shape}")
    w_count = lat.shape[0]
    if len(assigns) != w_count or len(layer_macs_list) != w_count:
        raise ValueError(
            f"{len(assigns)} assignment matrices / "
            f"{len(layer_macs_list)} MAC vectors for {w_count} workloads")
    if weights is None:
        wts = energy / energy.sum(axis=0, keepdims=True)      # (W, N)
    else:
        wts = np.asarray(weights, dtype=np.float64)
        if wts.shape != (w_count,) or (wts < 0).any() or wts.sum() <= 0:
            raise ValueError(
                f"weights must be (W,) non-negative with positive sum, "
                f"got {weights!r}")
        wts = (wts / wts.sum())[:, None]                      # (W, 1)

    edp = energy * lat
    noise = None

    def _noise():
        nonlocal noise
        if noise is None:
            noise = np.stack([score(a, m) for a, m in
                              zip(assigns, layer_macs_list)])  # (W, N)
        return noise

    cols = []
    for name in objectives:
        if name == "neg_worst_perf_per_area":
            ppa = np.asarray(agg["perf_per_area"], dtype=np.float64)
            cols.append(-ppa.min(axis=0))
        elif name == "worst_latency_s":
            cols.append(lat.max(axis=0))
        elif name == "mean_latency_s":
            cols.append((wts * lat).sum(axis=0))
        elif name == "worst_edp":
            cols.append(edp.max(axis=0))
        elif name == "mean_edp":
            cols.append((wts * edp).sum(axis=0))
        elif name == "total_energy_j":
            cols.append(energy.sum(axis=0))
        elif name == "worst_accuracy_noise":
            cols.append(_noise().max(axis=0))
        elif name == "mean_accuracy_noise":
            cols.append((wts * _noise()).sum(axis=0))
        else:                     # registry-validated: unreachable
            raise AssertionError(name)
    F = np.stack(cols, axis=-1)
    if floor_db is not None:
        v = accuracy_floor_violation(assigns, layer_macs_list, floor_db,
                                     accuracy=accuracy)
        F = F + (FLOOR_PENALTY * v)[:, None]
    return F
