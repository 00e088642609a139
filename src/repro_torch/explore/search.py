"""Guided multi-objective search over the joint design space.

Port of :mod:`repro.explore.search`.  Three engines share one chunked,
memoized :class:`Evaluator` that pushes every genome population through
the mixed-precision sweep (:func:`repro_torch.core.dse_batch._sweep_mixed`
/ :func:`~repro_torch.core.dse_batch._sweep_mixed_many`, aggregates
only) — on the card one sweep-kernel launch per evaluation chunk:

* :func:`random_search` — the baseline at equal evaluation budget;
* :func:`nsga2` — NSGA-II: non-dominated sorting, crowding distance,
  binary tournaments, uniform crossover + resampling mutation, and an
  external archive of every non-dominated genome found;
* :func:`successive_halving` — racing on layer-prefix subsets of the
  workload, promoting the best fraction to full evaluation.

Determinism: every loop threads one explicit ``numpy.random.Generator``,
draws happen in data-independent order and ranking ties break stably by
index, so a seed names one trajectory; on the CPU it is the reference's.
:func:`nsga2` snapshots its generations and resumes from them
(``checkpoint_dir``, :mod:`repro_torch.runtime.dse_checkpoint`).  The
engines record ``explore.evaluate`` / ``random_search.batch`` /
``nsga2.generation`` / ``successive_halving.rung`` spans while
:mod:`repro_torch.obs` tracing is on, and the Evaluator's counters always
land in its metrics registry.

``traffic=`` scores genomes on a serving fleet
(:data:`~repro_torch.explore.objectives.SERVING_OBJECTIVES`): each
chunk's latency and energy aggregates feed the fleet simulator on the
Evaluator's own device, so on the card a chunk is one sweep-kernel launch
and one fleet-kernel launch.  The reference scores serving on host numpy
even under jax; the stamps are integers, bit-identical on every route, so
no result moves.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.dse_batch import (_check_mesh, _mesh_shards,
                                        _sweep_mixed, _sweep_mixed_many)
from repro_torch.core.workloads import Workload, get_workload
from repro_torch.explore.accuracy import AccuracySpec, resolve_accuracy
from repro_torch.explore.objectives import (DEFAULT_MULTI_OBJECTIVES,
                                            DEFAULT_OBJECTIVES,
                                            DEFAULT_SERVING_OBJECTIVES,
                                            SERVING_OBJECTIVES,
                                            multi_objective_matrix,
                                            objective_matrix,
                                            resolve_objectives)
from repro_torch.explore.pareto import (EpsilonDominanceArchive,
                                        crowding_distance,
                                        epsilon_from_reference, hypervolume,
                                        nondominated_sort, pareto_mask_k,
                                        reference_point)
from repro_torch.explore.space import CoExploreManySpace, CoExploreSpace
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class SearchResult:
    """Outcome of one co-exploration run.

    ``genomes`` / ``front_objectives`` hold the final non-dominated set;
    ``history`` is ``(evaluations, hypervolume)`` pairs under
    ``ref_point``; ``all_objectives`` keeps every full-workload objective
    row (successive halving's subset rungs are excluded).
    """

    method: str
    workload: str
    objectives: tuple[str, ...]
    seed: int
    space: CoExploreSpace
    genomes: np.ndarray
    front_objectives: np.ndarray
    ref_point: np.ndarray
    history: list[tuple[int, float]]
    all_objectives: np.ndarray
    n_evals: int
    stats: dict
    # final evolutionary population (nsga2 only): the returned front is
    # the external archive, a superset of this population's own front
    population: np.ndarray | None = None
    population_objectives: np.ndarray | None = None
    # tier-2 quantized-forward elite validation, attached by
    # core.dse._coexplore (explore.accuracy.EliteValidation)
    validation: object | None = None

    @property
    def front_size(self) -> int:
        return len(self.genomes)

    def hypervolume(self, ref: np.ndarray | None = None) -> float:
        """Front hypervolume under ``ref`` (default: the run's own)."""
        return hypervolume(self.front_objectives,
                           self.ref_point if ref is None else ref)

    def front_points(self) -> list[dict]:
        """The front as config objects, per-layer mode names and
        objective values, sorted by the first objective; multi-workload
        runs report ``modes`` keyed by workload name."""
        from repro_torch.core.accelerator import soa_to_configs
        from repro_torch.core.pe import PEType
        types = tuple(PEType)
        soa, assign = self.space.decode(self.genomes)
        cfgs = soa_to_configs(soa)
        order = np.argsort(self.front_objectives[:, 0], kind="stable")
        if isinstance(self.space, CoExploreManySpace):
            names = (self.space.workload_names
                     or tuple(f"workload{w}"
                              for w in range(self.space.n_workloads)))

            def modes_of(i):
                return {nm: tuple(types[j].value for j in assign[i, s:e])
                        for nm, (s, e) in zip(names,
                                              self.space.segment_bounds)}
        else:
            def modes_of(i):
                return tuple(types[j].value for j in assign[i])
        return [{
            "config": cfgs[i],
            "modes": modes_of(i),
            **{name: float(self.front_objectives[i, k])
               for k, name in enumerate(self.objectives)},
        } for i in order]


def traffic_digest(trace) -> str:
    """sha256 of a traffic trace's content (name, arrivals, phase lengths,
    SLO): what a resumed serving search is checked against."""
    import hashlib
    h = hashlib.sha256(trace.name.encode())
    for a in (trace.arrival_s, trace.prompt_tokens, trace.decode_tokens):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(np.float64(trace.slo_s).tobytes())
    return h.hexdigest()


def _fold_floor(accuracy, sqnr_floor_db, *, stacklevel: int = 3):
    """Fold the deprecated ``sqnr_floor_db=`` into an accuracy spec
    (``AccuracySpec(floor_db=...)``), with a ``DeprecationWarning``; both
    spellings at once raise."""
    if sqnr_floor_db is None:
        return accuracy
    warnings.warn(
        "sqnr_floor_db= is deprecated; pass "
        "accuracy=AccuracySpec(floor_db=...) instead",
        DeprecationWarning, stacklevel=stacklevel)
    if accuracy is not None:
        raise ValueError(
            "pass either accuracy= or the deprecated sqnr_floor_db=, not "
            "both; put the floor on the accuracy spec (floor_db=)")
    return AccuracySpec(floor_db=sqnr_floor_db)


class Evaluator:
    """Chunked, memoized genome evaluation through the mixed sweep.

    Populations are decoded to (hardware SoA, assignment) and evaluated
    ``chunk_size`` genomes at a time, on ``device`` (the card unless the
    caller passes ``"cpu"``; CUDA on a host without it raises).  Results
    are memoized by genome digest and layer prefix, so a loop that
    re-visits a genome never re-runs the sweep; re-visited hardware hits
    the digest-keyed synthesis cache.

    A *sequence* of workloads with a
    :class:`~repro_torch.explore.space.CoExploreManySpace` evaluates one
    mode segment per workload in one pass and scores the suite with
    :func:`~repro_torch.explore.objectives.multi_objective_matrix`.
    ``accuracy`` selects the accuracy model of the ``accuracy_noise``
    columns (``None`` = the tier-0 proxy; a tier-1/2 spec calibrates on
    ``device``); ``sqnr_floor_db`` is the deprecated spelling of its
    ``floor_db``.  ``traffic`` (a trace, preset
    or preset name) scores serving objectives on an ``n_slots`` fleet and,
    without explicit ``objectives``, makes the serving set the default;
    serving objectives are single-workload only.  ``mesh`` shards each
    chunk's genome axis (an int on the CPU, a ``DeviceMesh`` from
    :func:`repro_torch.launch.mesh.make_sweep_mesh` on either device),
    bit for bit the unsharded rows.
    """

    def __init__(self, space: CoExploreSpace,
                 workload: Workload | str | Sequence[Workload | str],
                 objectives: Sequence[str] | None = None,
                 *, device: str | torch.device = "cuda",
                 chunk_size: int = 4096, use_cache: bool = True,
                 weights=None, accuracy=None, traffic=None,
                 n_slots: int = 8, sqnr_floor_db=None, mesh=None):
        accuracy = _fold_floor(accuracy, sqnr_floor_db, stacklevel=3)
        self.device = resolve_device(device)
        # mesh= shards every evaluation chunk's genome axis: an int
        # simulates that many shards on the CPU, a DeviceMesh places them
        # on its ranks (dse_batch._on_shards); an int on the card raises
        _check_mesh(mesh, self.device)
        self.mesh = mesh
        self.accuracy = (None if accuracy is None
                         else resolve_accuracy(accuracy, device=self.device))
        self.space = space
        self.multi = isinstance(workload, (list, tuple))
        if self.multi:
            wls = tuple(get_workload(w) if isinstance(w, str) else w
                        for w in workload)
            if not isinstance(space, CoExploreManySpace):
                raise ValueError(
                    "a workload sequence needs a CoExploreManySpace "
                    "(see repro_torch.explore.space.space_for_workloads)")
            counts = tuple(len(w.layers) for w in wls)
            if space.layer_counts != counts:
                raise ValueError(
                    f"space layer_counts {space.layer_counts} != workload "
                    f"layer counts {counts}")
            self.workloads = wls
            self.workload = None
        else:
            wl = (get_workload(workload)
                  if isinstance(workload, str) else workload)
            if space.n_layers != len(wl.layers):
                raise ValueError(
                    f"space has {space.n_layers} layer genes but workload "
                    f"{wl.name!r} has {len(wl.layers)} layers")
            self.workloads = (wl,)
            self.workload = wl
        # traffic= makes the serving triple the default objective set;
        # serving objectives need a trace and one workload (one trace
        # drives one fleet), and a trace needs a serving objective
        if objectives is None:
            if traffic is not None and not self.multi:
                objectives = DEFAULT_SERVING_OBJECTIVES
            else:
                objectives = (DEFAULT_MULTI_OBJECTIVES if self.multi
                              else DEFAULT_OBJECTIVES)
        self.objectives = resolve_objectives(
            objectives, stacklevel=3,
            scope="multi" if self.multi else "single")
        serving = [o for o in self.objectives if o in SERVING_OBJECTIVES]
        if serving and self.multi:
            raise ValueError(
                f"serving objectives {serving} are single-workload only "
                f"(one traffic trace drives one fleet)")
        if serving and traffic is None:
            raise ValueError(
                f"objectives {serving} need traffic= (a TrafficTrace, "
                f"TrafficPreset, or preset name)")
        if traffic is not None and not serving:
            raise ValueError(
                f"traffic= given but no serving objective in "
                f"{self.objectives}; add one of {SERVING_OBJECTIVES} or "
                f"drop traffic=")
        if traffic is not None:
            from repro_torch.serving.traffic import resolve_traffic
            traffic = resolve_traffic(traffic)
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.traffic = traffic
        self.n_slots = int(n_slots)
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.chunk_size = int(chunk_size)
        self.use_cache = use_cache
        self.weights = weights
        self._memo: dict[tuple[bytes, int], np.ndarray] = {}
        self._subsets: dict[int, tuple] = {}
        self.reset_stats()

    @property
    def name(self) -> str:
        """Workload identity for reports: a single name or ``a+b+c``."""
        return "+".join(w.name for w in self.workloads)

    @property
    def full_subset(self) -> int:
        """The ``m`` that means "every layer": the longest workload in
        multi mode, the layer count otherwise."""
        if self.multi:
            return max(self.space.layer_counts)
        return self.space.n_layers

    def _subset(self, m: int) -> tuple:
        """``(workloads, per-workload macs)`` for prefix length ``m``:
        each workload cut to its first ``min(m, L_w)`` layers."""
        if m >= self.full_subset:
            m = self.full_subset
        cached = self._subsets.get(m)
        if cached is None:
            wls = tuple(
                w if m >= len(w.layers) else
                Workload(name=f"{w.name}[:{m}]", layers=w.layers[:m])
                for w in self.workloads)
            macs = tuple(np.array([l.macs for l in w.layers],
                                  dtype=np.float64) for w in wls)
            cached = (wls, macs)
            self._subsets[m] = cached
        return cached

    def _objective_rows(self, wls, macs, soa, assign) -> np.ndarray:
        """One chunk through the sweep -> ``(n, K)``."""
        if self.multi:
            assigns = [assign[:, s:e][:, :len(w.layers)]
                       for (s, e), w in zip(self.space.segment_bounds, wls)]
            agg = _sweep_mixed_many(wls, soa, assigns,
                                    use_cache=self.use_cache,
                                    device=self.device, mesh=self.mesh)
            agg = {k: v for k, v in agg.items() if np.ndim(v) == 2}
            return multi_objective_matrix(
                agg, assigns, macs, self.objectives, weights=self.weights,
                accuracy=self.accuracy)
        wl, = wls
        a = assign[:, :len(wl.layers)]
        agg = _sweep_mixed(wl, soa, a, use_cache=self.use_cache,
                           device=self.device, outputs="aggregates",
                           mesh=self.mesh)
        return objective_matrix(agg, a, macs[0], self.objectives,
                                traffic=self.traffic, n_slots=self.n_slots,
                                device=self.device, accuracy=self.accuracy)

    def evaluate(self, genomes: np.ndarray,
                 subset: int | None = None) -> np.ndarray:
        """``(N, K)`` float64 objective rows for a genome matrix;
        ``subset`` evaluates on the first ``subset`` layers only (per
        workload in multi mode)."""
        t0 = time.perf_counter()
        with obs_trace.span("explore.evaluate", n=len(genomes),
                            subset=subset) as esp:
            g = self.space.validate(genomes, raise_on_invalid=True)
            m = self.full_subset if subset is None else min(
                int(subset), self.full_subset)
            self.n_requested += len(g)
            keys = self.space.genome_keys(g)
            out = np.empty((len(g), len(self.objectives)),
                           dtype=np.float64)
            todo: list[int] = []
            for i, key in enumerate(keys):
                row = self._memo.get((key, m))
                if row is None:
                    todo.append(i)
                else:
                    self.n_memo_hits += 1
                    out[i] = row
            wls, macs = self._subset(m)
            for s in range(0, len(todo), self.chunk_size):
                idx = np.asarray(todo[s:s + self.chunk_size],
                                 dtype=np.intp)
                # rows were validated above
                soa, assign = self.space.decode(g[idx],
                                                skip_validation=True)
                out[idx] = self._objective_rows(wls, macs, soa, assign)
                self.n_kernel += len(idx)
                self.n_chunks += 1
                for i in idx:
                    # a copy: the caller owns `out`
                    self._memo[(keys[i], m)] = out[i].copy()
            esp.set(kernel=len(todo), memo_hits=len(g) - len(todo))
        dt = time.perf_counter() - t0
        self.eval_seconds += dt
        reg = obs_metrics.get_registry()
        reg.inc("explore.requested_evals", len(g))
        reg.inc("explore.kernel_evals", len(todo))
        reg.inc("explore.memo_hits", len(g) - len(todo))
        reg.inc("explore.eval_seconds", dt)
        return out

    def reset_stats(self) -> None:
        """Zero the per-search counters (the memo stays)."""
        self.n_requested = 0
        self.n_kernel = 0
        self.n_chunks = 0
        self.n_memo_hits = 0
        self.eval_seconds = 0.0

    def stats(self) -> dict:
        return {
            "requested_evals": self.n_requested,
            "kernel_evals": self.n_kernel,
            "chunks": self.n_chunks,
            "memo_hits": self.n_memo_hits,
            "eval_seconds": self.eval_seconds,
            "device": str(self.device),
            "n_workloads": len(self.workloads),
            "mesh_shards": (None if self.mesh is None else
                            _mesh_shards(self.mesh)),
            "traffic": (None if self.traffic is None
                        else self.traffic.name),
            "n_slots": (None if self.traffic is None else self.n_slots),
        }


def _front(genomes: np.ndarray, F: np.ndarray
           ) -> tuple[np.ndarray, np.ndarray]:
    keep = pareto_mask_k(F)
    return genomes[keep], F[keep]


def _result(method: str, ev: Evaluator, seed: int, genomes, F,
            ref, history, all_F, n_evals, *, population=None,
            population_objectives=None) -> SearchResult:
    fg, ff = _front(genomes, F)
    return SearchResult(
        method=method, workload=ev.name,
        objectives=ev.objectives, seed=seed, space=ev.space,
        genomes=fg, front_objectives=ff, ref_point=np.asarray(ref),
        history=history, all_objectives=np.concatenate(all_F, axis=0),
        n_evals=n_evals, stats=ev.stats(), population=population,
        population_objectives=population_objectives)


def random_search(space: CoExploreSpace, workload, budget: int, *,
                  objectives: Sequence[str] | None = None,
                  seed: int = 0, device: str | torch.device = "cuda",
                  chunk_size: int = 4096, batch_size: int | None = None,
                  ref_point: np.ndarray | None = None,
                  weights=None, accuracy=None, traffic=None,
                  n_slots: int = 8, sqnr_floor_db=None,
                  batch: int | None = None, mesh=None) -> SearchResult:
    """Uniform-random baseline: ``budget`` independent genomes, a running
    non-dominated reduction, hypervolume recorded per batch.  A workload
    sequence needs a :class:`CoExploreManySpace` (as for every engine);
    ``traffic=`` switches to serving-fleet objectives over an ``n_slots``
    fleet (:class:`Evaluator`), for every engine.  ``batch=`` is the
    deprecated spelling of ``batch_size=``, ``sqnr_floor_db=`` (every
    engine) of ``accuracy=AccuracySpec(floor_db=...)``."""
    if batch is not None:
        warnings.warn(
            "random_search(batch=...) is deprecated; use batch_size=",
            DeprecationWarning, stacklevel=2)
        if batch_size is None:
            batch_size = batch
    accuracy = _fold_floor(accuracy, sqnr_floor_db)
    rng = np.random.default_rng(seed)
    ev = Evaluator(space, workload, objectives, device=device,
                   chunk_size=chunk_size, weights=weights,
                   accuracy=accuracy, traffic=traffic, n_slots=n_slots,
                   mesh=mesh)
    if budget < 1:
        raise ValueError("budget must be >= 1")
    if batch_size is not None and batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    batch_size = (min(budget, 256) if batch_size is None
                  else min(batch_size, budget))
    front_g = np.empty((0, space.genome_width), dtype=np.int64)
    front_F = np.empty((0, len(ev.objectives)), dtype=np.float64)
    history: list[tuple[int, float]] = []
    all_F: list[np.ndarray] = []
    ref = ref_point
    evals = 0
    while evals < budget:
        n = min(batch_size, budget - evals)
        with obs_trace.span("random_search.batch", n=n, evals=evals):
            g = space.random_population(n, rng)
            F = ev.evaluate(g)
            evals += n
            all_F.append(F)
            if ref is None:
                ref = reference_point(F)
            front_g, front_F = _front(np.concatenate([front_g, g]),
                                      np.concatenate([front_F, F]))
            history.append((evals, hypervolume(front_F, ref)))
    return _result("random", ev, seed, front_g, front_F, ref, history,
                   all_F, evals)


def _ranks_and_crowding(F: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    ranks = nondominated_sort(F)
    crowd = np.empty(len(F), dtype=np.float64)
    for r in np.unique(ranks):
        idx = np.nonzero(ranks == r)[0]
        crowd[idx] = crowding_distance(F[idx])
    return ranks, crowd


def _tournament(rng: np.random.Generator, n_pick: int,
                ranks: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """Binary tournament on (rank asc, crowding desc, index asc)."""
    a = rng.integers(0, len(ranks), size=n_pick)
    b = rng.integers(0, len(ranks), size=n_pick)
    a_wins = ((ranks[a] < ranks[b])
              | ((ranks[a] == ranks[b]) & (crowd[a] > crowd[b]))
              | ((ranks[a] == ranks[b]) & (crowd[a] == crowd[b])
                 & (a <= b)))
    return np.where(a_wins, a, b)


def nsga2(space: CoExploreSpace, workload, budget: int, *,
          pop_size: int = 64,
          objectives: Sequence[str] | None = None,
          seed: int = 0, device: str | torch.device = "cuda",
          chunk_size: int = 4096, mutation_rate: float = 0.08,
          ref_point: np.ndarray | None = None,
          weights=None, accuracy=None, archive_epsilon=None,
          traffic=None, n_slots: int = 8,
          checkpoint_dir: str | None = None,
          checkpoint_every: int = 5,
          fail_at_generation: dict[int, int] | None = None,
          sqnr_floor_db=None, mesh=None) -> SearchResult:
    """NSGA-II-style evolutionary multi-objective search.

    Elitist (mu + lambda) survival over non-domination rank then
    crowding distance, binary-tournament parents, uniform crossover,
    per-gene resampling mutation, compatibility repair.  ``budget``
    counts requested genome evaluations (initial population included).

    Every evaluated genome also flows through an external archive, so a
    non-dominated genome that crowding drops from the population is never
    lost: the returned front is the archive's (the final population is
    ``population`` / ``population_objectives``).  ``archive_epsilon``
    bounds the archive with an epsilon-dominance grid: a scalar is a
    relative resolution of each objective's (ideal, reference) span, a
    sequence an absolute per-objective epsilon.

    ``checkpoint_dir`` snapshots the whole search state — generation,
    population, archive, hypervolume history, objective trail and the
    threaded RNG stream — every ``checkpoint_every`` generations
    (:class:`repro_torch.runtime.dse_checkpoint.SearchCheckpointer`); on
    entry the newest valid snapshot is restored and the run continues as
    the uninterrupted one would; a serving search's snapshot carries its
    trace's digest and ``n_slots``, and resuming under another trace
    raises.  ``fail_at_generation`` injects
    :class:`~repro_torch.runtime.fault_tolerance.InjectedFailure`\\ s at
    generation boundaries (decremented in place, so a dict shared across
    restarts fails each boundary ``n`` times in all).
    """
    if budget < 1:
        raise ValueError("budget must be >= 1")
    if pop_size < 4:
        raise ValueError("pop_size must be >= 4")
    fail_at_generation = (fail_at_generation
                          if fail_at_generation is not None else {})

    def maybe_fail(gen: int) -> None:
        if fail_at_generation.get(gen, 0) > 0:
            fail_at_generation[gen] -= 1
            from repro_torch.runtime.fault_tolerance import InjectedFailure
            raise InjectedFailure(
                f"injected failure at generation boundary {gen}")

    ckpt = None
    if checkpoint_dir is not None:
        from repro_torch.runtime.dse_checkpoint import SearchCheckpointer
        ckpt = SearchCheckpointer(checkpoint_dir, every=checkpoint_every)
    accuracy = _fold_floor(accuracy, sqnr_floor_db)
    rng = np.random.default_rng(seed)
    ev = Evaluator(space, workload, objectives, device=device,
                   chunk_size=chunk_size, weights=weights,
                   accuracy=accuracy, traffic=traffic, n_slots=n_slots,
                   mesh=mesh)

    def eps_vector(ref, F0) -> np.ndarray | None:
        if archive_epsilon is None:
            return None
        if np.ndim(archive_epsilon) == 0:
            return epsilon_from_reference(ref, F0.min(axis=0),
                                          float(archive_epsilon))
        return np.asarray(archive_epsilon, dtype=np.float64)

    def scored_under() -> dict:
        out = {}
        if ev.accuracy is not None:
            out.update(accuracy_state=ev.accuracy.state(),
                       accuracy_digest=ev.accuracy.digest())
        if ev.traffic is not None:
            out.update(traffic_digest=traffic_digest(ev.traffic),
                       n_slots=ev.n_slots)
        return out

    eps_archive = None
    snap = ckpt.restore() if ckpt is not None else None
    if snap is not None:
        # pin the accuracy table the interrupted run scored with, and
        # refuse to resume under a different one
        if ev.accuracy is not None \
                and snap.get("accuracy_state") is not None:
            ev.accuracy.restore_state(snap["accuracy_state"])
            want = snap.get("accuracy_digest")
            got = ev.accuracy.digest()
            if want is not None and want != got:
                raise ValueError(
                    f"checkpoint was scored under accuracy digest "
                    f"{want}; this run's accuracy spec yields {got} — "
                    f"refusing to resume against a different calibration")
        want = (snap.get("traffic_digest"), snap.get("n_slots"))
        got = ((traffic_digest(ev.traffic), ev.n_slots)
               if ev.traffic is not None else (None, None))
        if want[0] is not None and want != got:
            raise ValueError(
                f"checkpoint was scored under traffic digest {want[0]} on "
                f"{want[1]} slots; this run's serving setting is {got} — "
                f"refusing to resume against a different trace")
        gen = snap["gen"]
        evals = snap["evals"]
        pop, F = snap["pop"], snap["F"]
        arch_g, arch_F = snap["arch_g"], snap["arch_F"]
        ref = snap["ref"]
        history = snap["history"]
        all_F = snap["all_F"]
        rng.bit_generator.state = snap["rng_state"]
        eps_vec = snap["eps_vec"]
        if eps_vec is not None:
            # re-offering the surviving representatives in stored order
            # rebuilds the grid exactly
            eps_archive = EpsilonDominanceArchive(eps_vec)
            eps_archive.add(arch_g, arch_F)
    else:
        maybe_fail(0)
        pop = space.random_population(min(pop_size, budget), rng)
        F = ev.evaluate(pop)
        evals = len(pop)
        gen = 0
        ref = reference_point(F) if ref_point is None else ref_point
        eps_vec = eps_vector(ref, F)
        if eps_vec is not None:
            eps_archive = EpsilonDominanceArchive(eps_vec)
            eps_archive.add(pop, F)
            arch_g, arch_F = eps_archive.genomes, eps_archive.objectives
        else:
            arch_g, arch_F = _front(pop, F)
        history = [(evals, hypervolume(arch_F, ref))]
        all_F = [F]
        if ckpt is not None and ckpt.should_save(0, done=evals >= budget):
            ckpt.save(gen=0, evals=evals, pop=pop, F=F, arch_g=arch_g,
                      arch_F=arch_F, ref=ref, history=history,
                      all_F=all_F, rng_state=rng.bit_generator.state,
                      eps_vec=eps_vec, **scored_under())
    reg = obs_metrics.get_registry()
    while evals < budget:
        maybe_fail(gen + 1)
        n_off = min(pop_size, budget - evals)
        with obs_trace.span("nsga2.generation", gen=gen + 1, evals=evals,
                            n_off=n_off):
            ranks, crowd = _ranks_and_crowding(F)
            p1 = _tournament(rng, n_off, ranks, crowd)
            p2 = _tournament(rng, n_off, ranks, crowd)
            children = space.crossover(pop[p1], pop[p2], rng)
            children = space.mutate(children, rng, mutation_rate)
            Fc = ev.evaluate(children)
            evals += n_off
            gen += 1
            all_F.append(Fc)
            if eps_archive is not None:
                eps_archive.add(children, Fc)
                arch_g = eps_archive.genomes
                arch_F = eps_archive.objectives
            else:
                comb_g = np.concatenate([arch_g, children])
                comb_F = np.concatenate([arch_F, Fc])
                # a genome re-visited across generations has an identical
                # memoized row; keep its first occurrence, so the archive
                # is the *set* of non-dominated genomes found
                _, uidx = np.unique(comb_g, axis=0, return_index=True)
                uidx.sort()
                arch_g, arch_F = _front(comb_g[uidx], comb_F[uidx])
            comb = np.concatenate([pop, children])
            Fcomb = np.concatenate([F, Fc])
            ranks2, crowd2 = _ranks_and_crowding(Fcomb)
            order = np.lexsort((np.arange(len(comb)), -crowd2, ranks2))
            sel = order[:pop_size]
            pop, F = comb[sel], Fcomb[sel]
            history.append((evals, hypervolume(arch_F, ref)))
        reg.inc("nsga2.generations")
        reg.set("nsga2.archive_size", int(len(arch_F)))
        if ckpt is not None and ckpt.should_save(gen,
                                                 done=evals >= budget):
            ckpt.save(gen=gen, evals=evals, pop=pop, F=F, arch_g=arch_g,
                      arch_F=arch_F, ref=ref, history=history,
                      all_F=all_F, rng_state=rng.bit_generator.state,
                      eps_vec=eps_vec, **scored_under())
    res = _result("nsga2", ev, seed, arch_g, arch_F, ref, history, all_F,
                  evals, population=pop, population_objectives=F)
    res.stats["archive_size"] = int(len(arch_F))
    if eps_vec is not None:
        res.stats["archive_epsilon"] = [float(e) for e in eps_vec]
    return res


def successive_halving(space: CoExploreSpace, workload, budget: int, *,
                       eta: int = 3,
                       objectives: Sequence[str] | None = None,
                       seed: int = 0, device: str | torch.device = "cuda",
                       chunk_size: int = 4096, min_layers: int = 2,
                       ref_point: np.ndarray | None = None,
                       weights=None, accuracy=None, traffic=None,
                       n_slots: int = 8,
                       sqnr_floor_db=None, mesh=None) -> SearchResult:
    """Successive halving over workload layer-prefix subsets.

    Rung ``r`` evaluates its population on the first ``m_r`` layers only
    (per workload in the multi-workload setting), keeps the best
    ``1/eta`` by (non-domination rank, crowding) and promotes them to the
    next, larger subset; the last rung is the full workload.  Every
    requested evaluation counts one unit of ``budget``.
    """
    if budget < 1:
        raise ValueError("budget must be >= 1")
    if eta < 2:
        raise ValueError("eta must be >= 2")
    accuracy = _fold_floor(accuracy, sqnr_floor_db)
    rng = np.random.default_rng(seed)
    ev = Evaluator(space, workload, objectives, device=device,
                   chunk_size=chunk_size, weights=weights,
                   accuracy=accuracy, traffic=traffic, n_slots=n_slots,
                   mesh=mesh)
    L = ev.full_subset
    sizes = [L]
    while sizes[-1] > min(min_layers, L) and len(sizes) < 4:
        nxt = max(min(min_layers, L), -(-sizes[-1] // eta))
        if nxt == sizes[-1]:
            break
        sizes.append(nxt)
    sizes = sizes[::-1]                    # small -> full
    r_count = len(sizes)
    # n0 * (1 + 1/eta + ...) ~= budget
    geo = sum(eta ** -r for r in range(r_count))
    n0 = max(eta ** (r_count - 1), int(budget / geo))
    pops = [max(1, n0 // eta ** r) for r in range(r_count)]
    total = sum(pops)
    if total > budget:                      # trim the cheap first rung
        pops[0] = max(1, pops[0] - (total - budget))
    pop = space.random_population(pops[0], rng)
    evals = 0
    all_F = []
    history: list[tuple[int, float]] = []
    F = None
    for r, (m, n_r) in enumerate(zip(sizes, pops)):
        with obs_trace.span("successive_halving.rung", rung=r, subset=m,
                            n=n_r):
            pop = pop[:n_r]
            F = ev.evaluate(pop, subset=None if m == L else m)
            evals += len(pop)
            if m == L:
                # only full-workload rows are comparable across runs
                all_F.append(F)
            if r < r_count - 1:
                ranks, crowd = _ranks_and_crowding(F)
                order = np.lexsort((np.arange(len(pop)), -crowd, ranks))
                pop = pop[order]
    ref = reference_point(F) if ref_point is None else ref_point
    history.append((evals, hypervolume(F[pareto_mask_k(F)], ref)))
    return _result("successive_halving", ev, seed, pop, F, ref, history,
                   all_F, evals)


SEARCH_METHODS = {
    "random": random_search,
    "nsga2": nsga2,
    "successive_halving": successive_halving,
}
