"""Design-space exploration: the port's entry point.

Port of :mod:`repro.core.dse`: an :class:`ExploreSpec` describes one
campaign and :func:`run` executes it on a device — the card unless the
caller passes ``device="cpu"``.  Specs are built with

* :meth:`ExploreSpec.single` — a uniform-precision sweep of one workload
  (optionally chunk-streamed);
* :meth:`ExploreSpec.mixed` — guided mixed-precision co-exploration of one
  workload (:mod:`repro_torch.explore`), optionally under a serving
  ``traffic`` trace scored by the fleet simulator;
* :meth:`ExploreSpec.many` — a workload suite: uniform precision sweeps
  the batch per workload, ``precision="mixed"`` searches one shared
  hardware config with a per-workload precision assignment.

Sweep results normalize performance-per-area and energy against the best
INT16 configuration, as the paper's Figs. 3-5 do.
``ExploreSpec.single(..., engine="scalar")`` runs the reference's
per-config scalar model (:mod:`repro_torch.core.dataflow`), the host
oracle of the batched engine, on ``device="cpu"`` only.
:class:`IncrementalSweep` extends a sweep without re-evaluating known
configs.  ``checkpoint_dir`` makes a chunked sweep or an nsga2 search
preemption-safe (:mod:`repro_torch.runtime.dse_checkpoint`), and
``telemetry`` scopes :mod:`repro_torch.obs` span tracing to one
:func:`run`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.accelerator import (AcceleratorConfig, configs_to_soa,
                                          design_space)
from repro_torch.core.confighash import config_digests, digest_keys
from repro_torch.core.dataflow import WorkloadResult, run_workload
from repro_torch.core.device import resolve_device
from repro_torch.core.dse_batch import (BatchedWorkloadResult, _mesh_shards,
                                        _synthesize, _sweep_chunked,
                                        _sweep_workload, pareto_mask)
from repro_torch.core.pe import PEType
from repro_torch.core.workloads import Workload, get_workload


@dataclasses.dataclass(frozen=True)
class DSEPoint:
    config: AcceleratorConfig
    result: BatchedWorkloadResult | WorkloadResult

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


def pareto_front_scalar(points: Sequence[DSEPoint]) -> list[DSEPoint]:
    """O(n^2) reference: non-dominated set for (max perf/area, min
    energy), sorted by energy."""
    front: list[DSEPoint] = []
    for p in points:
        dominated = any(
            (q.perf_per_area >= p.perf_per_area and q.energy_j <= p.energy_j
             and (q.perf_per_area > p.perf_per_area
                  or q.energy_j < p.energy_j))
            for q in points)
        if not dominated:
            front.append(p)
    return sorted(front, key=lambda p: p.energy_j)


def pareto_front(points: Sequence[DSEPoint]) -> list[DSEPoint]:
    """Non-dominated set for (maximize perf/area, minimize energy),
    sorted by energy; the same as :func:`pareto_front_scalar`."""
    if not points:
        return []
    perf = np.array([p.perf_per_area for p in points], dtype=np.float64)
    energy = np.array([p.energy_j for p in points], dtype=np.float64)
    keep = pareto_mask(perf, energy)
    front = [p for p, k in zip(points, keep) if k]
    return sorted(front, key=lambda p: p.energy_j)


_OUTPUT_MODES = ("points", "sweep", "aggregates")


def _resolve(workload: Workload | str) -> Workload:
    return get_workload(workload) if isinstance(workload, str) else workload


def _explore_scalar(workload: Workload | str,
                    configs: Iterable[AcceleratorConfig] | None = None,
                    *, use_cache: bool = False) -> DSEResult:
    """The reference's serial sweep on the host: one
    :func:`~repro_torch.core.dataflow.run_workload` per config — the
    oracle of the batched engine, which equals it bit for bit on the
    CPU's exact path."""
    from repro_torch.core.synthesis import synthesize_cached
    workload = _resolve(workload)
    if configs is None:
        configs = design_space()
    points = []
    for cfg in configs:
        rep = synthesize_cached(cfg) if use_cache else None
        points.append(DSEPoint(config=cfg,
                               result=run_workload(workload, cfg, rep)))
    return DSEResult(workload=workload.name, points=points)


def _explore_many(workloads: Sequence[Workload | str],
                  configs: Iterable[AcceleratorConfig] | None = None,
                  *,
                  use_cache: bool = True,
                  device: str | torch.device = "cuda",
                  outputs: str = "points", mesh=None) -> dict:
    """Uniform-precision sweep of a workload suite: synthesis and the SoA
    conversion run once for the config batch and are shared by every
    workload; ``mesh`` shards the config axis.  Returns ``{workload name:
    result}`` with each result as ``outputs`` asks (see :func:`run`)."""
    if outputs not in _OUTPUT_MODES:
        raise ValueError(
            f"unknown outputs mode {outputs!r} "
            f"(choose from {_OUTPUT_MODES})")
    device = resolve_device(device)
    cfgs = tuple(design_space() if configs is None else configs)
    soa = configs_to_soa(cfgs)
    cols = _synthesize(soa, use_cache)
    out: dict = {}
    for wl in workloads:
        wl = _resolve(wl)
        sweep = _sweep_workload(
            wl, cfgs, cols, soa=soa, device=device, mesh=mesh,
            outputs="aggregates" if outputs == "aggregates" else "full")
        if outputs != "points":
            out[wl.name] = sweep
        else:
            out[wl.name] = DSEResult(
                workload=wl.name,
                points=[DSEPoint(config=c, result=sweep.result_view(i))
                        for i, c in enumerate(cfgs)])
    return out


class IncrementalSweep:
    """Resumable, extensible sweep of one workload: each :meth:`extend`
    evaluates, in one batched pass, only the configs not seen before
    (keyed by config digest); :meth:`result` returns the accumulated
    :class:`DSEResult`."""

    def __init__(self, workload: Workload | str,
                 configs: Iterable[AcceleratorConfig] | None = None,
                 *, device: str | torch.device = "cuda"):
        self.workload = _resolve(workload)
        self.device = resolve_device(device)
        self._points: dict[bytes, DSEPoint] = {}
        if configs is not None:
            self.extend(configs)

    def __len__(self) -> int:
        return len(self._points)

    def extend(self, configs: Iterable[AcceleratorConfig]) -> int:
        """Evaluate any new configs; returns how many were new."""
        batch = list(configs)
        fresh: list[AcceleratorConfig] = []
        keys: list[bytes] = []
        seen_now = set()
        # one digest pass over the batch
        batch_keys = (digest_keys(config_digests(configs_to_soa(batch)))
                      if batch else [])
        for cfg, key in zip(batch, batch_keys):
            if key in self._points or key in seen_now:
                continue
            seen_now.add(key)
            fresh.append(cfg)
            keys.append(key)
        if fresh:
            sweep = _sweep_workload(self.workload, fresh, device=self.device)
            for i, (cfg, key) in enumerate(zip(fresh, keys)):
                self._points[key] = DSEPoint(config=cfg,
                                             result=sweep.result_view(i))
        return len(fresh)

    def result(self) -> DSEResult:
        return DSEResult(workload=self.workload.name,
                         points=list(self._points.values()))


def _apply_checkpointing(kwargs: dict, method: str,
                         checkpoint_dir: str | None,
                         checkpoint_every: int | None) -> None:
    """Thread the search's checkpointing knobs through to the engine —
    only nsga2 carries resumable generation state."""
    if checkpoint_dir is None:
        if checkpoint_every is not None:
            raise ValueError("checkpoint_every needs checkpoint_dir")
        return
    if method != "nsga2":
        raise ValueError(
            f"checkpoint_dir requires method='nsga2' (generation "
            f"snapshots); got method={method!r}")
    kwargs["checkpoint_dir"] = checkpoint_dir
    if checkpoint_every is not None:
        kwargs["checkpoint_every"] = checkpoint_every


def _search_kwargs(p, method: str, **kwargs) -> dict:
    """The engine's knobs from a preset ``p`` and explicit overrides."""
    if method == "nsga2":
        kwargs.update(pop_size=p.pop_size, mutation_rate=p.mutation_rate)
        if p.archive_epsilon is not None:
            kwargs["archive_epsilon"] = p.archive_epsilon
    elif method == "successive_halving":
        kwargs.update(eta=p.eta)
    return kwargs


def _method(p, method: str | None):
    from repro_torch.explore.search import SEARCH_METHODS
    method = p.method if method is None else method
    fn = SEARCH_METHODS.get(method)
    if fn is None:
        raise ValueError(
            f"unknown co-exploration method {method!r} "
            f"(choose from {sorted(SEARCH_METHODS)})")
    return method, fn


def _coexplore(workload: Workload | str,
               *,
               preset: str = "default",
               method: str | None = None,
               budget: int | None = None,
               seed: int | None = None,
               device: str | torch.device = "cuda",
               objectives=None,
               ref_point=None,
               space_overrides: dict | None = None,
               accuracy=None,
               chunk_size: int | None = None,
               traffic=None,
               n_slots: int | None = None,
               checkpoint_dir: str | None = None,
               checkpoint_every: int | None = None,
               mesh=None,
               **method_kwargs):
    """Guided co-exploration of one workload's joint (config x per-layer
    precision) space: resolves a named preset
    (:mod:`repro_torch.configs.coexplore_presets`), applies explicit
    overrides, sizes the genome space to the workload and runs the chosen
    engine of :mod:`repro_torch.explore.search`.  Returns a
    :class:`~repro_torch.explore.search.SearchResult`.

    A ``traffic`` trace (name, preset or trace; else the preset's)
    switches the search to serving-fleet objectives: each genome's
    latency and energy feed the fleet simulator over ``n_slots`` slots,
    and the objective set becomes
    :data:`~repro_torch.explore.objectives.DEFAULT_SERVING_OBJECTIVES`
    unless the preset or ``objectives=`` already names serving ones.

    A tier-2 accuracy (``"measured:<model>"``) scores the search with its
    tier-1 table and then re-scores the Pareto elites with quantized
    forward passes on ``device``: ``result.validation``
    (:func:`~repro_torch.explore.accuracy.validate_elites`)."""
    from repro_torch.configs.coexplore_presets import get_preset
    from repro_torch.explore.accuracy import (resolve_accuracy,
                                              validate_elites)
    from repro_torch.explore.objectives import (DEFAULT_SERVING_OBJECTIVES,
                                                SERVING_OBJECTIVES)
    from repro_torch.explore.space import space_for_workload

    p = get_preset(preset)
    acc = accuracy if accuracy is not None else p.accuracy
    acc_model = None if acc is None else resolve_accuracy(acc, device=device)
    wl = _resolve(workload)
    space = space_for_workload(wl, **(space_overrides or {}))
    method, fn = _method(p, method)
    if objectives is not None:
        objs = tuple(objectives)
    elif (traffic is not None
          and not set(p.objectives) & set(SERVING_OBJECTIVES)):
        # explicit traffic over a non-serving preset: the serving
        # objectives, else the Evaluator refuses the unused trace
        objs = DEFAULT_SERVING_OBJECTIVES
    else:
        objs = p.objectives
    kwargs = _search_kwargs(
        p, method, objectives=objs,
        seed=p.seed if seed is None else seed, device=device,
        chunk_size=p.chunk_size if chunk_size is None else chunk_size,
        ref_point=ref_point, accuracy=acc_model,
        traffic=traffic if traffic is not None else p.traffic,
        n_slots=p.n_slots if n_slots is None else n_slots, mesh=mesh)
    _apply_checkpointing(kwargs, method, checkpoint_dir, checkpoint_every)
    kwargs.update(method_kwargs)
    res = fn(space, wl, p.budget if budget is None else budget, **kwargs)
    if acc_model is not None and acc_model.tier == 2:
        res.validation = validate_elites(res, acc_model, device=device)
    return res


def _coexplore_many(workloads: Sequence[Workload | str],
                    *,
                    preset: str = "many-default",
                    method: str | None = None,
                    budget: int | None = None,
                    seed: int | None = None,
                    device: str | torch.device = "cuda",
                    objectives=None,
                    ref_point=None,
                    weights=None,
                    sqnr_floor_db=None,
                    accuracy=None,
                    space_overrides: dict | None = None,
                    chunk_size: int | None = None,
                    checkpoint_dir: str | None = None,
                    checkpoint_every: int | None = None,
                    mesh=None,
                    **method_kwargs):
    """Multi-workload co-exploration (the QUIDAM setting): one shared
    hardware config, one per-layer precision assignment per workload.
    Each evaluation chunk runs all W workloads in one pass (on the card,
    one sweep-kernel launch), and the objectives aggregate across the
    suite (worst case, or weighted means).  ``sqnr_floor_db`` is the
    deprecated spelling of an accuracy ``floor_db``: it replaces the
    preset's accuracy and the engine folds it in with a warning.  Tier 2
    is refused: a multi-workload genome has no single precision plan.
    Returns a :class:`~repro_torch.explore.search.SearchResult` whose
    ``front_points()`` decode to (config, ``{workload: modes}``)."""
    from repro_torch.configs.coexplore_presets import get_preset
    from repro_torch.explore.accuracy import resolve_accuracy
    from repro_torch.explore.space import space_for_workloads

    p = get_preset(preset)
    if sqnr_floor_db is not None and accuracy is None:
        # the deprecated floor override drops the preset's accuracy (in
        # the committed presets only a floor); the engine folds and warns
        acc = None
    else:
        acc = accuracy if accuracy is not None else p.accuracy
    acc_model = None if acc is None else resolve_accuracy(acc, device=device)
    if acc_model is not None and acc_model.tier == 2:
        raise ValueError(
            "tier-2 (measured) accuracy is single-workload only: a "
            "multi-workload genome has no single precision plan to run "
            "the calibration model under; use 'calibrated:<model>'")
    wls = tuple(_resolve(w) for w in workloads)
    if not wls:
        raise ValueError("coexplore_many needs at least one workload")
    space = space_for_workloads(wls, **(space_overrides or {}))
    method, fn = _method(p, method)
    kwargs = _search_kwargs(
        p, method,
        objectives=p.objectives if objectives is None else tuple(objectives),
        seed=p.seed if seed is None else seed, device=device,
        chunk_size=p.chunk_size if chunk_size is None else chunk_size,
        ref_point=ref_point, accuracy=acc_model,
        weights=p.weights if weights is None else weights,
        sqnr_floor_db=sqnr_floor_db, mesh=mesh)
    _apply_checkpointing(kwargs, method, checkpoint_dir, checkpoint_every)
    kwargs.update(method_kwargs)
    return fn(space, wls, p.budget if budget is None else budget, **kwargs)


# reference knobs the port replaces by design
_REPLACED = ("backend", "use_pallas")


def _refuse_replaced(kwargs: dict) -> None:
    """Refuse the reference's route knobs, which ``run(..., device=)``
    replaces, before they reach the dataclass or an engine."""
    for name in _REPLACED:
        if name in kwargs:
            raise ValueError(
                f"{name}= is replaced by run(..., device=): the port runs "
                f"on the card (device='cuda') or the exact CPU path "
                f"(device='cpu')")


@dataclasses.dataclass(frozen=True)
class ExploreSpec:
    """One declarative exploration campaign.  Build it with
    :meth:`single`, :meth:`mixed` or :meth:`many`; fields that do not
    apply to the chosen mode must stay at their defaults, and
    ``__post_init__`` rejects contradictory fields before any work."""

    workloads: tuple = ()
    precision: str = "uniform"          # "uniform" | "mixed"
    # uniform-precision knobs
    configs: tuple | None = None
    # "batched" (the sweep kernel) | "scalar" (the per-config host
    # oracle, device="cpu" only)
    engine: str = "batched"
    outputs: str = "points"             # "points" | "sweep" | "aggregates"
    cache: object = None                # persisted synthesis cache (chunked)
    save_cache: bool = True
    overlap: bool = True
    # in-flight chunk bound of the streamed pipeline (chunked sweeps)
    prefetch_depth: int = 2
    # mixed-precision (search) knobs
    preset: str | None = None
    method: str | None = None
    budget: int | None = None
    objectives: tuple | None = None
    # a serving trace (name, TrafficPreset or TrafficTrace) and the fleet's
    # slots: serving-fleet objectives (mixed, one workload)
    traffic: object = None
    n_slots: int | None = None
    ref_point: tuple | None = None
    weights: tuple | None = None
    sqnr_floor_db: object = None        # deprecated: accuracy floor_db
    # accuracy model of the accuracy_noise objectives: None (the preset's,
    # else the tier-0 proxy), a spec string ("proxy" / "calibrated:<model>"
    # / "measured:<model>"), an AccuracySpec or a model
    accuracy: object = None
    space_overrides: dict | None = None
    search_kwargs: dict | None = None
    # shared knobs
    seed: int | None = None
    use_cache: bool = True
    chunk_size: int | None = None
    # fault tolerance: periodic snapshots + resume, for chunked uniform
    # sweeps (resume_sweep) and nsga2 searches (generation snapshots)
    checkpoint_dir: str | None = None
    checkpoint_every: int | None = None
    # None leaves the process-wide repro_torch.obs switch untouched;
    # True/False flips span tracing for the run; a dict goes to
    # repro_torch.obs.configure() (e.g. {"jsonl_path": ...,
    # "torch_annotations": True}).  The metrics registry is always on.
    telemetry: object = None
    # shards the config (genome) axis: None, an int (simulated shards,
    # device="cpu") or a DeviceMesh (repro_torch.launch.mesh
    # .make_sweep_mesh), every route bit for bit the unsharded one
    mesh: object = None

    def __post_init__(self):
        if not self.workloads:
            raise ValueError("ExploreSpec needs at least one workload")
        object.__setattr__(self, "workloads", tuple(self.workloads))
        if isinstance(self.mesh, int):
            _mesh_shards(self.mesh)     # refuses a count below 1
        if self.precision not in ("uniform", "mixed"):
            raise ValueError(
                f"precision must be 'uniform' or 'mixed', "
                f"got {self.precision!r}")
        if self.outputs not in _OUTPUT_MODES:
            raise ValueError(
                f"unknown outputs mode {self.outputs!r} "
                f"(choose from {_OUTPUT_MODES})")
        if self.engine not in ("batched", "scalar"):
            raise ValueError(f"unknown DSE engine: {self.engine!r}")
        if self.configs is not None and self.chunk_size is None:
            # chunk-streamed feeds stay lazy; a one-batch sweep
            # materializes its configs once
            object.__setattr__(self, "configs", tuple(self.configs))
        if self.objectives is not None:
            object.__setattr__(self, "objectives", tuple(self.objectives))
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
        if self.checkpoint_every is not None:
            if self.checkpoint_dir is None:
                raise ValueError(
                    "checkpoint_every needs checkpoint_dir")
            if self.checkpoint_every < 1:
                raise ValueError(
                    f"checkpoint_every must be >= 1, "
                    f"got {self.checkpoint_every}")
        if self.checkpoint_dir is not None \
                and self.precision == "uniform" and self.chunk_size is None:
            raise ValueError(
                "checkpoint_dir applies to chunked uniform sweeps "
                "(chunk_size=) or mixed-precision searches; a one-batch "
                "sweep has no resumable stream")
        from repro_torch.obs.trace import check_telemetry
        check_telemetry(self.telemetry)
        if isinstance(self.accuracy, str):
            # validate spec strings early, before any work
            from repro_torch.explore.accuracy import AccuracySpec
            object.__setattr__(self, "accuracy",
                               AccuracySpec.parse(self.accuracy))
        if self.precision == "uniform":
            self._check_uniform()
        else:
            self._check_mixed()

    def _check_uniform(self):
        bad = [n for n, v in (
            ("preset", self.preset), ("method", self.method),
            ("budget", self.budget), ("objectives", self.objectives),
            ("traffic", self.traffic), ("n_slots", self.n_slots),
            ("ref_point", self.ref_point), ("weights", self.weights),
            ("sqnr_floor_db", self.sqnr_floor_db),
            ("accuracy", self.accuracy),
            ("space_overrides", self.space_overrides),
            ("search_kwargs", self.search_kwargs)) if v is not None]
        if bad:
            raise ValueError(
                f"search knob(s) {bad} only apply to "
                f'precision="mixed" specs')
        if self.engine == "scalar" and (self.outputs != "points"
                                        or self.chunk_size is not None):
            raise ValueError(
                'engine="scalar" only supports outputs="points" '
                'without chunking')
        if self.chunk_size is None:
            return
        if len(self.workloads) > 1:
            raise ValueError(
                "chunked streaming (chunk_size=) supports a single "
                "workload; sweep the suite per workload instead")
        if self.configs is None:
            raise ValueError(
                "chunked streaming needs an explicit config feed "
                "(configs=); the default design space fits in one batch")
        if self.outputs != "points":
            raise ValueError(
                "chunked streaming returns a ChunkedSweep (aggregates "
                'only); leave outputs="points"')

    def _check_mixed(self):
        bad = [n for n, v in (("configs", self.configs),
                              ("cache", self.cache)) if v is not None]
        if self.engine != "batched":
            bad.append("engine")
        if self.outputs != "points":
            bad.append("outputs")
        if bad:
            raise ValueError(
                f"sweep knob(s) {bad} only apply to "
                f'precision="uniform" specs')
        if (self.weights is not None or self.sqnr_floor_db is not None) \
                and len(self.workloads) == 1:
            raise ValueError(
                "weights/sqnr_floor_db aggregate across a workload "
                "suite; pass >= 2 workloads")

    # -- constructors ------------------------------------------------------

    @classmethod
    def single(cls, workload, configs=None, *, engine: str = "batched",
               outputs: str = "points",
               chunk_size: int | None = None, use_cache: bool = True,
               cache=None, save_cache: bool = True, overlap: bool = True,
               prefetch_depth: int = 2, checkpoint_dir: str | None = None,
               checkpoint_every: int | None = None, telemetry=None,
               mesh=None, **replaced) -> "ExploreSpec":
        """Uniform-precision sweep of one workload over a config batch
        (the paper's design space when ``configs`` is None).  A
        ``chunk_size`` streams an arbitrary-size feed with bounded memory
        and returns a :class:`~repro_torch.core.dse_batch.ChunkedSweep`;
        a ``checkpoint_dir`` makes the stream preemption-safe (periodic
        snapshots, resumed automatically — ``configs`` should then be a
        re-iterable feed or a zero-arg factory).  ``engine="scalar"``
        runs the per-config host oracle (``device="cpu"`` only).  ``mesh``
        shards the config axis (of every chunk, when streamed)."""
        _refuse_replaced(replaced)
        return cls(workloads=(workload,), configs=configs, engine=engine,
                   outputs=outputs,
                   chunk_size=chunk_size, use_cache=use_cache, cache=cache,
                   save_cache=save_cache, overlap=overlap,
                   prefetch_depth=prefetch_depth,
                   checkpoint_dir=checkpoint_dir,
                   checkpoint_every=checkpoint_every, telemetry=telemetry,
                   mesh=mesh, **replaced)

    @classmethod
    def mixed(cls, workload, *, preset: str | None = None,
              method: str | None = None, budget: int | None = None,
              objectives=None, accuracy=None, seed: int | None = None,
              ref_point=None, space_overrides: dict | None = None,
              chunk_size: int | None = None, traffic=None,
              n_slots: int | None = None, mesh=None,
              checkpoint_dir: str | None = None,
              checkpoint_every: int | None = None, telemetry=None,
              **search_kwargs) -> "ExploreSpec":
        """Guided mixed-precision co-exploration of one workload (preset
        ``"default"`` unless named); extra keywords go to the engine.  A
        ``traffic`` trace switches the objectives to the serving-fleet set
        (tail latency, SLO attainment, throughput, energy per served
        token) over ``n_slots`` slots.  ``accuracy`` picks the accuracy
        tier; ``"measured:<model>"`` also re-scores the final Pareto elites
        with quantized forward passes (``result.validation``).  A
        ``checkpoint_dir`` snapshots the search each ``checkpoint_every``
        generations and resumes from the newest snapshot (nsga2 only)."""
        _refuse_replaced(search_kwargs)
        return cls(workloads=(workload,), precision="mixed",
                   preset=preset, method=method, budget=budget,
                   objectives=objectives, accuracy=accuracy, seed=seed,
                   ref_point=ref_point, space_overrides=space_overrides,
                   chunk_size=chunk_size, traffic=traffic, n_slots=n_slots,
                   mesh=mesh, checkpoint_dir=checkpoint_dir,
                   checkpoint_every=checkpoint_every, telemetry=telemetry,
                   search_kwargs=search_kwargs or None)

    @classmethod
    def many(cls, workloads, *, precision: str = "uniform",
             configs=None, outputs: str = "points",
             preset: str | None = None, method: str | None = None,
             budget: int | None = None, objectives=None,
             weights=None, sqnr_floor_db=None, accuracy=None,
             seed: int | None = None,
             ref_point=None, space_overrides: dict | None = None,
             chunk_size: int | None = None, use_cache: bool = True,
             mesh=None, checkpoint_dir: str | None = None,
             checkpoint_every: int | None = None, telemetry=None,
             **search_kwargs) -> "ExploreSpec":
        """A workload suite.  ``precision="uniform"`` sweeps the config
        batch once per workload (synthesis shared);
        ``precision="mixed"`` searches one shared hardware config with a
        per-workload precision assignment (preset ``"many-default"``
        unless named); ``sqnr_floor_db`` is the deprecated spelling of an
        accuracy ``floor_db`` (it replaces the preset's accuracy)."""
        _refuse_replaced(search_kwargs)
        if precision == "uniform" and search_kwargs:
            raise ValueError(
                f"search kwarg(s) {sorted(search_kwargs)} only apply to "
                f'precision="mixed" specs')
        return cls(workloads=tuple(workloads), precision=precision,
                   configs=None if configs is None else tuple(configs),
                   outputs=outputs, preset=preset, method=method,
                   budget=budget, objectives=objectives, weights=weights,
                   sqnr_floor_db=sqnr_floor_db,
                   accuracy=accuracy, seed=seed, ref_point=ref_point,
                   space_overrides=space_overrides, chunk_size=chunk_size,
                   use_cache=use_cache, mesh=mesh,
                   checkpoint_dir=checkpoint_dir,
                   checkpoint_every=checkpoint_every, telemetry=telemetry,
                   search_kwargs=search_kwargs or None)


def run(spec: ExploreSpec, *, device: str | torch.device = "cuda"):
    """Execute an :class:`ExploreSpec` on ``device``.

    Returns, by mode:

    * uniform, one workload — a :class:`DSEResult` (``outputs="points"``),
      a :class:`~repro_torch.core.dse_batch.BatchedSweep` (``"sweep"`` /
      ``"aggregates"``), or a
      :class:`~repro_torch.core.dse_batch.ChunkedSweep` when
      ``chunk_size`` streams the feed;
    * uniform, many workloads — ``{workload name: result}``;
    * mixed — a :class:`~repro_torch.explore.search.SearchResult`.

    ``device="cuda"`` raises ``RuntimeError`` on a host without CUDA; the
    sweeps' aggregates and every search evaluation then run on the card
    through the CUDA sweep kernel (a serving search's fleets through the
    fleet kernel).  ``engine="scalar"`` is a host loop with no array
    engine and raises unless ``device="cpu"``.  ``spec.telemetry``
    configures span tracing for the duration of the call.
    """
    if not isinstance(spec, ExploreSpec):
        raise TypeError(
            f"run() takes an ExploreSpec, got {type(spec).__name__}; "
            f"build one with ExploreSpec.single/.mixed/.many")
    if spec.engine == "scalar" and torch.device(device).type != "cpu":
        raise ValueError(
            f'engine="scalar" is the per-config host oracle and runs on '
            f'the CPU only; pass device="cpu" (got device={device!r})')
    from repro_torch.obs import trace as obs_trace
    device = resolve_device(device)
    with obs_trace.configured(spec.telemetry):
        return _run_dispatch(spec, device)


def _run_dispatch(spec: ExploreSpec, device: torch.device):
    extra = dict(spec.search_kwargs or {})
    if spec.precision == "mixed":
        common = dict(method=spec.method, budget=spec.budget,
                      seed=spec.seed, device=device,
                      objectives=spec.objectives, ref_point=spec.ref_point,
                      space_overrides=spec.space_overrides,
                      accuracy=spec.accuracy, chunk_size=spec.chunk_size,
                      checkpoint_dir=spec.checkpoint_dir,
                      checkpoint_every=spec.checkpoint_every,
                      mesh=spec.mesh, **extra)
        if len(spec.workloads) == 1:
            return _coexplore(
                spec.workloads[0],
                preset="default" if spec.preset is None else spec.preset,
                traffic=spec.traffic, n_slots=spec.n_slots, **common)
        return _coexplore_many(
            spec.workloads,
            preset="many-default" if spec.preset is None else spec.preset,
            weights=spec.weights, sqnr_floor_db=spec.sqnr_floor_db,
            **common)
    if len(spec.workloads) > 1:
        return _explore_many(spec.workloads, spec.configs,
                             use_cache=spec.use_cache, device=device,
                             outputs=spec.outputs, mesh=spec.mesh)
    wl = _resolve(spec.workloads[0])
    if spec.chunk_size is not None:
        kwargs = dict(device=device, chunk_size=spec.chunk_size,
                      use_cache=spec.use_cache, cache=spec.cache,
                      save_cache=spec.save_cache, overlap=spec.overlap,
                      prefetch_depth=spec.prefetch_depth, mesh=spec.mesh)
        if spec.checkpoint_dir is not None:
            from repro_torch.runtime.dse_checkpoint import resume_sweep
            if spec.checkpoint_every is not None:
                kwargs["checkpoint_every"] = spec.checkpoint_every
            return resume_sweep(wl, spec.configs,
                                checkpoint_dir=spec.checkpoint_dir, **kwargs)
        return _sweep_chunked(wl, spec.configs, **kwargs)
    if spec.engine == "scalar":
        return _explore_scalar(wl, spec.configs, use_cache=spec.use_cache)
    cfgs = tuple(design_space() if spec.configs is None else spec.configs)
    sweep = _sweep_workload(
        wl, cfgs, device=device, use_cache=spec.use_cache, mesh=spec.mesh,
        outputs="aggregates" if spec.outputs == "aggregates" else "full")
    if spec.outputs != "points":
        return sweep
    return DSEResult(workload=wl.name,
                     points=[DSEPoint(config=c, result=sweep.result_view(i))
                             for i, c in enumerate(cfgs)])
