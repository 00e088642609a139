"""Preemption-safe exploration runtime: checkpoint/resume for streamed
sweeps and evolutionary searches.

Port of :mod:`repro.runtime.dse_checkpoint`.  A week-long
:func:`repro_torch.core.dse_batch._sweep_chunked` stream or NSGA-II run
must survive preemption:

* :class:`SweepCheckpointer` — periodic snapshots of the chunked sweep:
  stream cursor, running Pareto front, and synthesis-cache rows *and*
  hit/miss accounting, in the self-describing state format of
  :mod:`repro_torch.checkpoint.checkpoint` (atomic publish, content
  checksums, keep-N rotation);
* :class:`SearchCheckpointer` — generation snapshots of NSGA-II:
  generation index, population, external archive, hypervolume history,
  per-generation objective trail, and the **threaded RNG state**, so the
  resumed tournament draws continue the exact random stream;
* :func:`resume_sweep` / :func:`resume_search` — restore the newest
  *valid* snapshot, replay, and keep restarting
  (:func:`~repro_torch.runtime.fault_tolerance.restart_loop`) until the
  run completes.  On a device the resumed chunks and generations launch
  the same sweep kernel as an uninterrupted run, so its result equals
  that run's: on the CPU bit for bit the reference's numpy backend,
  Pareto front bytes *and* cache hit/miss counters included.

The snapshot contents and layout are the reference's, so a snapshot
written by either package resumes in the other.  Surfaced on the port's
entry point as ``ExploreSpec(checkpoint_dir=...)`` →
:func:`repro_torch.core.dse.run`.
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.checkpoint.checkpoint import (restore_latest_state,
                                               save_state)
from repro_torch.core.dse_batch import ChunkedSweep, _sweep_chunked
from repro_torch.core.synthesis import PersistentSynthesisCache
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.fault_tolerance import (InjectedFailure,
                                                 restart_loop)


class SweepCheckpointer:
    """Snapshots of the chunked-sweep stream, and their restore.

    Duck-typed against ``_sweep_chunked(checkpoint=...)``: the sweep calls
    :meth:`should_save` with the post-chunk cursor, :meth:`save` with the
    stream state captured *at the synthesis boundary of that cursor* (so
    pipelined lookahead never leaks into a snapshot), and
    :meth:`restore` once on entry.
    """

    def __init__(self, ckpt_dir: str, *, every: int = 8, keep: int = 3):
        if every < 1:
            raise ValueError(f"checkpoint every must be >= 1, got {every}")
        self.ckpt_dir = str(ckpt_dir)
        self.every = int(every)
        self.keep = int(keep)
        self.saves = 0

    def should_save(self, cursor: int) -> bool:
        return cursor > 0 and cursor % self.every == 0

    def save(self, *, cursor: int, n_total: int, front_soa: dict,
             front_metrics: dict, cache_state: dict | None) -> str:
        state = {
            "kind": "sweep",
            "cursor": int(cursor),
            "n_total": int(n_total),
            "front_soa": {k: np.asarray(v)
                          for k, v in (front_soa or {}).items()},
            "front_metrics": {k: np.asarray(v)
                              for k, v in (front_metrics or {}).items()},
        }
        if cache_state is not None:
            state["cache"] = cache_state
        with obs_trace.span("checkpoint.save", kind="sweep",
                            cursor=int(cursor)):
            path = save_state(self.ckpt_dir, cursor, state,
                              keep=self.keep)
        self.saves += 1
        obs_metrics.get_registry().inc("checkpoint.saves")
        return path

    def restore(self) -> dict | None:
        with obs_trace.span("checkpoint.restore", kind="sweep"):
            _, state = restore_latest_state(self.ckpt_dir)
        if state is None or state.get("kind") != "sweep":
            return None
        obs_metrics.get_registry().inc("checkpoint.restores")
        return {
            "cursor": int(state["cursor"]),
            "n_total": int(state["n_total"]),
            "front_soa": state.get("front_soa", {}),
            "front_metrics": state.get("front_metrics", {}),
            "cache_state": state.get("cache"),
        }


class SearchCheckpointer:
    """Generation-boundary snapshots of NSGA-II, and their restore
    (:func:`repro_torch.explore.search.nsga2`, ``checkpoint_dir=...``)."""

    def __init__(self, ckpt_dir: str, *, every: int = 5, keep: int = 3):
        if every < 1:
            raise ValueError(f"checkpoint every must be >= 1, got {every}")
        self.ckpt_dir = str(ckpt_dir)
        self.every = int(every)
        self.keep = int(keep)
        self.saves = 0

    def should_save(self, gen: int, done: bool = False) -> bool:
        return done or gen % self.every == 0

    def save(self, *, gen: int, evals: int, pop: np.ndarray, F: np.ndarray,
             arch_g: np.ndarray, arch_F: np.ndarray, ref: np.ndarray,
             history: list, all_F: list, rng_state: dict,
             eps_vec: np.ndarray | None,
             accuracy_state: dict | None = None,
             accuracy_digest: str | None = None,
             traffic_digest: str | None = None,
             n_slots: int | None = None) -> str:
        state = {
            "kind": "search",
            "gen": int(gen),
            "evals": int(evals),
            "pop": np.asarray(pop),
            "F": np.asarray(F),
            "arch_g": np.asarray(arch_g),
            "arch_F": np.asarray(arch_F),
            "ref": np.asarray(ref, dtype=np.float64),
            "history_evals": np.array([e for e, _ in history],
                                      dtype=np.int64),
            "history_hv": np.array([h for _, h in history],
                                   dtype=np.float64),
            "all_F": np.concatenate(all_F, axis=0),
            "all_F_lens": np.array([len(a) for a in all_F],
                                   dtype=np.int64),
            # PCG64 state round-trips exactly through JSON (arbitrary-
            # precision ints), so resumed tournament draws continue the
            # same stream bit for bit
            "rng_state": json.dumps(rng_state),
        }
        if eps_vec is not None:
            state["eps_vec"] = np.asarray(eps_vec, dtype=np.float64)
        # the exact accuracy table the run was scored with (the accuracy
        # models of repro_torch.explore.accuracy): resume pins it and
        # verifies the digest so a changed calibration can't silently
        # re-score a resumed front
        if accuracy_state is not None:
            state["accuracy_state"] = {k: np.asarray(v)
                                       for k, v in accuracy_state.items()}
        if accuracy_digest is not None:
            state["accuracy_digest"] = str(accuracy_digest)
        # a serving search's trace and fleet (explore.search.traffic_
        # digest): resume refuses another trace
        if traffic_digest is not None:
            state["traffic_digest"] = str(traffic_digest)
            state["n_slots"] = int(n_slots)
        with obs_trace.span("checkpoint.save", kind="search",
                            gen=int(gen)):
            path = save_state(self.ckpt_dir, gen, state, keep=self.keep)
        self.saves += 1
        obs_metrics.get_registry().inc("checkpoint.saves")
        return path

    def restore(self) -> dict | None:
        with obs_trace.span("checkpoint.restore", kind="search"):
            _, state = restore_latest_state(self.ckpt_dir)
        if state is None or state.get("kind") != "search":
            return None
        obs_metrics.get_registry().inc("checkpoint.restores")
        lens = state["all_F_lens"].tolist()
        offs = np.cumsum([0] + lens)
        all_F = [state["all_F"][offs[i]:offs[i + 1]]
                 for i in range(len(lens))]
        history = [(int(e), float(h))
                   for e, h in zip(state["history_evals"],
                                   state["history_hv"])]
        return {
            "gen": int(state["gen"]),
            "evals": int(state["evals"]),
            "pop": state["pop"],
            "F": state["F"],
            "arch_g": state["arch_g"],
            "arch_F": state["arch_F"],
            "ref": state["ref"],
            "history": history,
            "all_F": all_F,
            "rng_state": json.loads(state["rng_state"]),
            "eps_vec": state.get("eps_vec"),
            "accuracy_state": state.get("accuracy_state"),
            "accuracy_digest": state.get("accuracy_digest"),
            "traffic_digest": state.get("traffic_digest"),
            "n_slots": (None if state.get("n_slots") is None
                        else int(state["n_slots"])),
        }


def resume_sweep(workload, configs, *,
                 checkpoint_dir: str,
                 device="cuda",
                 checkpoint_every: int = 8,
                 keep: int = 3,
                 cache=None,
                 max_restarts: int = 10,
                 fail_at: dict[int, int] | None = None,
                 retryable: tuple = (InjectedFailure,),
                 backoff_s: float = 0.0,
                 backoff_factor: float = 2.0,
                 max_backoff_s: float = 30.0,
                 **sweep_kwargs) -> ChunkedSweep:
    """Run a chunked sweep to completion through preemptions.

    ``configs`` must be restartable: a SoA dict, a config sequence, or a
    zero-arg **factory** returning a fresh feed per attempt (a bare
    generator would arrive exhausted at the second attempt).  Each
    attempt restores the newest valid snapshot under ``checkpoint_dir``
    and replays on ``device`` (the card by default; keyword arguments go
    to :func:`~repro_torch.core.dse_batch._sweep_chunked`); the final
    front and cache hit/miss accounting equal an uninterrupted run's.

    Restart policy (``retryable`` / ``backoff_s`` / ...) goes through
    :func:`~repro_torch.runtime.fault_tolerance.restart_loop`; ``fail_at``
    injects deterministic failures at chunk boundaries, shared across
    attempts so each boundary fails exactly ``n_times``.  The restart
    count lands in ``result.timings["restarts"]``.
    """
    fail_at = dict(fail_at or {})
    cache_baseline = None
    if cache is not None and not isinstance(cache, (str, bytes)) \
            and not hasattr(cache, "__fspath__"):
        # a live cache object keeps rows inserted by a *failed* attempt;
        # rewind it to its entry state each attempt so accounting replays
        # exactly (a snapshot restore then overrides this baseline)
        cache_baseline = cache.export_state()

    def attempt() -> ChunkedSweep:
        ckpt = SweepCheckpointer(checkpoint_dir, every=checkpoint_every,
                                 keep=keep)
        c = cache
        if isinstance(c, (str, bytes)) or hasattr(c, "__fspath__"):
            c = PersistentSynthesisCache(c)
        elif c is not None:
            c.import_state(cache_baseline)
        feed = configs() if callable(configs) else configs
        return _sweep_chunked(workload, feed, device=device,
                              checkpoint=ckpt, fail_at=fail_at, cache=c,
                              **sweep_kwargs)

    restarts, sweep = restart_loop(
        attempt, max_restarts=max_restarts, retryable=retryable,
        backoff_s=backoff_s, backoff_factor=backoff_factor,
        max_backoff_s=max_backoff_s)
    if sweep.timings is not None:
        sweep.timings["restarts"] = restarts
    if restarts:
        obs_metrics.get_registry().inc("sweep.restarts", restarts)
    return sweep


def resume_search(space, workload, budget: int, *,
                  checkpoint_dir: str,
                  device="cuda",
                  checkpoint_every: int = 5,
                  method: str = "nsga2",
                  max_restarts: int = 10,
                  fail_at_generation: dict[int, int] | None = None,
                  retryable: tuple = (InjectedFailure,),
                  backoff_s: float = 0.0,
                  backoff_factor: float = 2.0,
                  max_backoff_s: float = 30.0,
                  **search_kwargs):
    """Run an evolutionary search to completion through preemptions.

    Only ``nsga2`` carries resumable state (random search is resumable as
    a sweep; successive halving re-runs cheaply) — anything else raises.
    Each attempt restores the newest valid generation snapshot (including
    the RNG stream) and continues on the search's ``device``; the resumed
    front equals an uninterrupted run's.  The restart count lands
    in ``result.stats["restarts"]``.
    """
    if method != "nsga2":
        raise ValueError(
            f"resume_search supports method='nsga2', got {method!r}")
    from repro_torch.explore.search import nsga2
    fail = dict(fail_at_generation or {})

    def attempt():
        return nsga2(space, workload, budget, device=device,
                     checkpoint_dir=checkpoint_dir,
                     checkpoint_every=checkpoint_every,
                     fail_at_generation=fail, **search_kwargs)

    restarts, res = restart_loop(
        attempt, max_restarts=max_restarts, retryable=retryable,
        backoff_s=backoff_s, backoff_factor=backoff_factor,
        max_backoff_s=max_backoff_s)
    res.stats["restarts"] = restarts
    if restarts:
        obs_metrics.get_registry().inc("search.restarts", restarts)
    return res
