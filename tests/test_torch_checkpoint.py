"""The port's preemption-safe runtime against the reference's.

Snapshots (``repro_torch.checkpoint``), the restart loop and straggler
detector (``repro_torch.runtime.fault_tolerance``), and the resumable
sweep and search (``repro_torch.runtime.dse_checkpoint``), each on the
same inputs as the reference's in the same process:

* ``save_state`` snapshots restore across the two packages, both ways,
  with the same rotation and corrupt-snapshot fallback;
* ``restart_loop`` and ``StragglerDetector`` decide as the reference's;
* a resumed chunked sweep (the ``fail_at`` schedules of the reference's
  ``tests/test_dse_checkpoint.py``) gives the reference numpy backend's
  uninterrupted front and synthesis-cache hit/miss counts bit for bit,
  also when the port resumes a snapshot the reference wrote;
* the watchdog re-dispatches a late chunk on the same device, through
  the same path, and never elsewhere;
* a resumed nsga2 search gives the reference's front, population,
  objective trail and hypervolume history.
"""

import dataclasses
import os

import numpy as np
import pytest

from repro.checkpoint import checkpoint as R_CK
from repro.core.accelerator import AcceleratorConfig as RAC
from repro.core.dse import ExploreSpec as RSpec
from repro.core.dse import run as r_run
from repro.core.dse_batch import _sweep_chunked as r_sweep_chunked
from repro.core.pe import PEType as RPE
from repro.core.synthesis import PersistentSynthesisCache as RCache
from repro.core.workloads import ConvLayer as RConv
from repro.core.workloads import Workload as RWorkload
from repro.core.workloads import get_workload as r_get_workload
from repro.explore import CoExploreSpace as RSpace
from repro.explore import nsga2 as r_nsga2
from repro.runtime import dse_checkpoint as R_DC
from repro.runtime import fault_tolerance as R_FT
from repro_torch.checkpoint import checkpoint as T_CK
from repro_torch.core import dse_batch as TB
from repro_torch.core.accelerator import AcceleratorConfig as TAC
from repro_torch.core.dse import ExploreSpec as TSpec
from repro_torch.core.dse import run as t_run
from repro_torch.core.pe import PEType as TPE
from repro_torch.core.synthesis import PersistentSynthesisCache as TCache
from repro_torch.core.workloads import ConvLayer as TConv
from repro_torch.core.workloads import Workload as TWorkload
from repro_torch.core.workloads import get_workload as t_get_workload
from repro_torch.explore import CoExploreSpace as TSpace
from repro_torch.explore import nsga2 as t_nsga2
from repro_torch.runtime import dse_checkpoint as T_DC
from repro_torch.runtime import fault_tolerance as T_FT

CPU = "cpu"
R_WL, T_WL = r_get_workload("vgg16"), t_get_workload("vgg16")
_POINTS = [(8, 8, 64, 6.4), (12, 14, 128, 12.8), (16, 16, 256, 12.8),
           (32, 32, 512, 25.6)]
R_FEED = [RAC(pe_type=t, pe_rows=r, pe_cols=c, glb_kb=g, dram_bw_gbps=bw)
          for t in tuple(RPE) for (r, c, g, bw) in _POINTS] * 7
T_FEED = [TAC(pe_type=t, pe_rows=r, pe_cols=c, glb_kb=g, dram_bw_gbps=bw)
          for t in tuple(TPE) for (r, c, g, bw) in _POINTS] * 7
CHUNK = 11                       # 112 configs -> 11 chunks
N_CHUNKS = 11

_TINY = (("c1", 58, 58, 64, 64), ("c2", 30, 30, 64, 128, 3, 3, 2),
         ("fc", 1, 1, 512, 1000, 1, 1))
R_TINY = RWorkload("tiny", tuple(RConv(*a) for a in _TINY))
T_TINY = TWorkload("tiny", tuple(TConv(*a) for a in _TINY))
R_SPACE, T_SPACE = RSpace(n_layers=3), TSpace(n_layers=3)
SEARCH = dict(pop_size=16, seed=3)


def _same_sweep(got, ref):
    assert (got.n_configs, got.n_chunks, got.front_size) == (
        ref.n_configs, ref.n_chunks, ref.front_size)
    for m in ref.front_metrics:
        assert got.front_metrics[m].tobytes() == \
            ref.front_metrics[m].tobytes(), m
    for k in ref.front_soa:
        assert got.front_soa[k].tobytes() == ref.front_soa[k].tobytes(), k


def _same_search(got, ref):
    assert np.array_equal(got.genomes, ref.genomes)
    assert got.front_objectives.tobytes() == ref.front_objectives.tobytes()
    assert np.array_equal(got.population, ref.population)
    assert got.population_objectives.tobytes() == \
        ref.population_objectives.tobytes()
    assert got.all_objectives.tobytes() == ref.all_objectives.tobytes()
    assert got.n_evals == ref.n_evals
    assert got.history == ref.history


@pytest.fixture(scope="module")
def ref_sweep():
    return r_sweep_chunked(R_WL, [R_FEED], chunk_size=CHUNK,
                           backend="numpy")


@pytest.fixture(scope="module")
def ref_search():
    return r_nsga2(R_SPACE, R_TINY, 120, backend="numpy", **SEARCH)


# ---------------------------------------------------------------------------
# the snapshot format
# ---------------------------------------------------------------------------

def _state(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"kind": "sweep", "cursor": 4, "ratio": 0.25, "none": None,
            "flag": True, "name": "x", "np_int": np.int64(3),
            "front": {"a": rng.standard_normal(5),
                      "b": np.arange(6, dtype=np.int32).reshape(2, 3),
                      "empty": np.empty((0, 2), dtype=np.uint64)}}


def _assert_state_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_state_equal(got[k], v)
        elif isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            assert np.array_equal(got[k], v)
        elif isinstance(v, np.generic):
            assert got[k] == v.item()
        else:
            assert got[k] == v and type(got[k]) is type(v)


@pytest.mark.parametrize("writer,reader", [(T_CK, R_CK), (R_CK, T_CK),
                                           (T_CK, T_CK)])
def test_state_snapshots_restore_across_packages(tmp_path, writer, reader):
    writer.save_state(str(tmp_path), 7, _state())
    _assert_state_equal(reader.restore_state(str(tmp_path), 7), _state())
    step, st = reader.restore_latest_state(str(tmp_path))
    assert step == 7
    _assert_state_equal(st, _state())
    assert reader.latest_step(str(tmp_path)) == 7


def test_snapshot_files_are_the_reference_bytes(tmp_path):
    T_CK.save_state(str(tmp_path / "t"), 3, _state())
    R_CK.save_state(str(tmp_path / "r"), 3, _state())
    for name in ("arrays.npz", "meta.json"):
        got = (tmp_path / "t" / "step_00000003" / name).read_bytes()
        want = (tmp_path / "r" / "step_00000003" / name).read_bytes()
        assert got == want, name


def test_rotation_and_corrupt_fallback(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        T_CK.save_state(d, s, _state(s), keep=3)
    assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in (3, 4, 5)]
    with open(tmp_path / "step_00000005" / "arrays.npz", "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    for mod in (T_CK, R_CK):
        assert mod.latest_step(d) == 4
        step, st = mod.restore_latest_state(d)
        assert step == 4
        _assert_state_equal(st, _state(4))
    with pytest.raises(IOError):
        T_CK.restore_state(d, 5)
    assert T_CK.restore_latest_state(str(tmp_path / "nope")) == (None, None)


def test_resave_keeps_the_durable_snapshot_and_bad_leaves_raise(tmp_path):
    d = str(tmp_path)
    path = T_CK.save_state(d, 1, _state(0))
    mtime = os.stat(os.path.join(path, "meta.json")).st_mtime_ns
    assert T_CK.save_state(d, 1, _state(0)) == path
    assert os.stat(os.path.join(path, "meta.json")).st_mtime_ns == mtime
    with pytest.raises(ValueError, match="'/'-free"):
        T_CK.save_state(d, 2, {"a/b": 1})
    with pytest.raises(TypeError, match="unsupported type"):
        T_CK.save_state(d, 2, {"a": [1, 2]})


# ---------------------------------------------------------------------------
# restart loop and straggler detector
# ---------------------------------------------------------------------------

def _flaky(fail_times: int, exc=TimeoutError):
    n = {"calls": 0}

    def attempt():
        n["calls"] += 1
        if n["calls"] <= fail_times:
            raise exc("transient")
        return n["calls"]
    return attempt


@pytest.mark.parametrize("fail_times,max_restarts,retryable", [
    (0, 10, (TimeoutError,)), (2, 10, (TimeoutError,)),
    (4, 3, (TimeoutError,)), (1, 10, (KeyError,))])
def test_restart_loop_decides_as_reference(fail_times, max_restarts,
                                           retryable):
    out = []
    for mod in (R_FT, T_FT):
        restarted = []
        try:
            res = mod.restart_loop(
                _flaky(fail_times), max_restarts=max_restarts,
                retryable=retryable,
                on_restart=lambda r, e: restarted.append(r))
        except Exception as exc:
            res = type(exc).__name__
        out.append((res, restarted))
    assert out[0] == out[1]


def test_restart_loop_backoff_as_reference(monkeypatch):
    sleeps = {}
    for mod in (R_FT, T_FT):
        got = sleeps[mod.__name__] = []
        monkeypatch.setattr(mod.time, "sleep", got.append)
        restarts, _ = mod.restart_loop(_flaky(4), retryable=(TimeoutError,),
                                       backoff_s=0.1, backoff_factor=2.0,
                                       max_backoff_s=0.3)
        assert restarts == 4
    assert sleeps[R_FT.__name__] == sleeps[T_FT.__name__]
    np.testing.assert_allclose(sleeps[T_FT.__name__], [0.1, 0.2, 0.3, 0.3])


def test_injected_failure_is_retryable_by_default():
    calls = {"n": 0}

    def attempt():
        calls["n"] += 1
        if calls["n"] == 1:
            raise T_FT.InjectedFailure("boom")
        return "ok"
    assert T_FT.restart_loop(attempt) == (1, "ok")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_detector_decides_as_reference(seed):
    rng = np.random.default_rng(seed)
    dts = np.concatenate([0.1 + 0.01 * rng.standard_normal(30),
                          [1.5] * 12, 1.5 + 0.05 * rng.standard_normal(10),
                          [15.0]])
    r = R_FT.StragglerDetector(alpha=0.3, threshold=3.0, rebaseline_after=8)
    t = T_FT.StragglerDetector(alpha=0.3, threshold=3.0, rebaseline_after=8)
    assert [t.observe(float(x)) for x in dts] == \
        [r.observe(float(x)) for x in dts]
    for f in ("mean", "var", "n", "flagged", "consecutive_flags",
              "rebaselines"):
        assert getattr(t, f) == getattr(r, f), f
    assert t.rebaselines == 1


# ---------------------------------------------------------------------------
# the resumed sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("boundary", range(N_CHUNKS))
def test_sweep_resume_equals_reference_at_every_boundary(
        tmp_path, ref_sweep, overlap, boundary):
    res = T_DC.resume_sweep(T_WL, [T_FEED], checkpoint_dir=str(tmp_path),
                            checkpoint_every=2, fail_at={boundary: 1},
                            chunk_size=CHUNK, device=CPU, overlap=overlap)
    assert res.timings["restarts"] == 1
    _same_sweep(res, ref_sweep)


@pytest.mark.parametrize("fail_at,every,depth", [
    ({3: 1, 6: 2}, 2, 2), ({0: 2, 10: 1}, 1, 3), ({5: 1, 7: 1}, 3, 1),
    ({9: 3}, 4, 4)])
def test_sweep_resume_repeated_failures(tmp_path, ref_sweep, fail_at,
                                        every, depth):
    res = T_DC.resume_sweep(T_WL, [T_FEED], checkpoint_dir=str(tmp_path),
                            checkpoint_every=every, fail_at=dict(fail_at),
                            chunk_size=CHUNK, device=CPU,
                            prefetch_depth=depth, max_restarts=16)
    assert res.timings["restarts"] == sum(fail_at.values())
    _same_sweep(res, ref_sweep)


@pytest.mark.parametrize("fail_at", [{2: 1, 7: 1}, {4: 1}])
def test_sweep_resume_cache_accounting_equals_reference(tmp_path, fail_at):
    """A persisted cache replays the reference's hit/miss counts through
    a preempted-and-resumed stream, rows and file included."""
    r_cache = RCache(tmp_path / "r.npz")
    ref = R_DC.resume_sweep(R_WL, [R_FEED],
                            checkpoint_dir=str(tmp_path / "rck"),
                            checkpoint_every=2, fail_at=dict(fail_at),
                            cache=r_cache, chunk_size=CHUNK,
                            backend="numpy")
    t_cache = TCache(tmp_path / "t.npz")
    got = T_DC.resume_sweep(T_WL, [T_FEED],
                            checkpoint_dir=str(tmp_path / "tck"),
                            checkpoint_every=2, fail_at=dict(fail_at),
                            cache=t_cache, chunk_size=CHUNK, device=CPU)
    assert got.timings["restarts"] == ref.timings["restarts"] == \
        sum(fail_at.values())
    _same_sweep(got, ref)
    for stat in ("hits", "misses", "evictions"):
        assert getattr(t_cache, stat) == getattr(r_cache, stat), stat
    assert len(t_cache) == len(r_cache)
    assert np.array_equal(t_cache.export_state()["keys"],
                          r_cache.export_state()["keys"])
    # the file each wrote loads in the other
    assert len(TCache(tmp_path / "r.npz")) == len(RCache(tmp_path / "t.npz"))


def test_sweep_resume_path_cache_and_live_cache_rewind(tmp_path, ref_sweep):
    clean = TCache()
    TB._sweep_chunked(T_WL, [T_FEED], chunk_size=CHUNK, device=CPU,
                      cache=clean)
    live = TCache()
    res = T_DC.resume_sweep(T_WL, [T_FEED], checkpoint_dir=str(tmp_path),
                            checkpoint_every=3, fail_at={1: 1, 5: 1},
                            cache=live, chunk_size=CHUNK, device=CPU)
    _same_sweep(res, ref_sweep)
    assert (live.hits, live.misses) == (clean.hits, clean.misses)


def test_sweep_resume_after_completion_is_idempotent(tmp_path, ref_sweep):
    first = T_DC.resume_sweep(T_WL, [T_FEED], checkpoint_dir=str(tmp_path),
                              checkpoint_every=4, chunk_size=CHUNK,
                              device=CPU)
    cache = TCache(tmp_path / "c.npz")
    again = T_DC.resume_sweep(T_WL, [T_FEED], checkpoint_dir=str(tmp_path),
                              checkpoint_every=4, cache=cache,
                              chunk_size=CHUNK, device=CPU)
    assert again.timings["restarts"] == 0
    _same_sweep(first, ref_sweep)
    _same_sweep(again, ref_sweep)
    assert cache.misses == 0 and cache.hits == 0


def test_sweep_corrupt_snapshot_falls_back_to_older(tmp_path, ref_sweep):
    ck = T_DC.SweepCheckpointer(str(tmp_path), every=2)
    TB._sweep_chunked(T_WL, [T_FEED], chunk_size=CHUNK, device=CPU,
                      checkpoint=ck)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps and ck.saves >= 2
    with open(tmp_path / steps[-1] / "arrays.npz", "r+b") as f:
        f.seek(8)
        f.write(b"\xde\xad\xbe\xef")
    res = T_DC.resume_sweep(T_WL, [T_FEED], checkpoint_dir=str(tmp_path),
                            checkpoint_every=2, chunk_size=CHUNK,
                            device=CPU)
    assert res.timings["restarts"] == 0
    _same_sweep(res, ref_sweep)


@pytest.mark.parametrize("cursor", [2, 6, N_CHUNKS])
def test_reference_snapshot_resumed_by_the_port(tmp_path, ref_sweep, cursor):
    """A snapshot the reference wrote at ``cursor`` (the terminal one at
    N_CHUNKS) resumes in the port to the reference's uninterrupted front,
    with the reference's cache accounting; and the other way round."""
    r_cache = RCache()
    r_ck = R_DC.SweepCheckpointer(str(tmp_path / "r"), every=cursor,
                                  keep=10)
    if cursor < N_CHUNKS:
        with pytest.raises(R_FT.InjectedFailure):
            r_sweep_chunked(R_WL, [R_FEED], chunk_size=CHUNK,
                            backend="numpy", cache=r_cache, checkpoint=r_ck,
                            fail_at={cursor + 1: 1})
    else:
        r_sweep_chunked(R_WL, [R_FEED], chunk_size=CHUNK, backend="numpy",
                        cache=r_cache, checkpoint=r_ck)
    assert R_CK.latest_step(str(tmp_path / "r")) == cursor
    clean_cache = RCache()
    r_sweep_chunked(R_WL, [R_FEED], chunk_size=CHUNK, backend="numpy",
                    cache=clean_cache)
    t_cache = TCache()
    got = TB._sweep_chunked(T_WL, [T_FEED], chunk_size=CHUNK, device=CPU,
                            cache=t_cache,
                            checkpoint=T_DC.SweepCheckpointer(
                                str(tmp_path / "r"), every=cursor))
    _same_sweep(got, ref_sweep)
    assert (t_cache.hits, t_cache.misses) == (clean_cache.hits,
                                              clean_cache.misses)
    # the port's snapshots resume in the reference
    t_ck = T_DC.SweepCheckpointer(str(tmp_path / "t"), every=2)
    with pytest.raises(T_FT.InjectedFailure):
        TB._sweep_chunked(T_WL, [T_FEED], chunk_size=CHUNK, device=CPU,
                          checkpoint=t_ck, fail_at={5: 1})
    back = r_sweep_chunked(R_WL, [R_FEED], chunk_size=CHUNK,
                           backend="numpy",
                           checkpoint=R_DC.SweepCheckpointer(
                               str(tmp_path / "t"), every=2))
    _same_sweep(back, ref_sweep)


def test_sweep_resume_exhausts_max_restarts(tmp_path):
    with pytest.raises(T_FT.InjectedFailure):
        T_DC.resume_sweep(T_WL, [T_FEED], checkpoint_dir=str(tmp_path),
                          fail_at={0: 5}, max_restarts=2, chunk_size=CHUNK,
                          device=CPU)


def test_sweep_non_retryable_propagates(tmp_path):
    calls = {"n": 0}

    def feed():
        calls["n"] += 1
        raise KeyError("feed exploded")

    with pytest.raises(KeyError):
        T_DC.resume_sweep(T_WL, feed, checkpoint_dir=str(tmp_path),
                          chunk_size=CHUNK, device=CPU)
    assert calls["n"] == 1


def test_checkpointers_ignore_foreign_snapshots(tmp_path):
    rng = np.random.default_rng(0)
    sck = T_DC.SearchCheckpointer(str(tmp_path), every=1)
    sck.save(gen=0, evals=4, pop=np.zeros((4, 7), dtype=np.int64),
             F=np.zeros((4, 2)), arch_g=np.zeros((2, 7), dtype=np.int64),
             arch_F=np.zeros((2, 2)), ref=np.ones(2),
             history=[(4, 0.0)], all_F=[np.zeros((4, 2))],
             rng_state=rng.bit_generator.state, eps_vec=None)
    assert T_DC.SweepCheckpointer(str(tmp_path)).restore() is None
    assert R_DC.SearchCheckpointer(str(tmp_path)).restore()["gen"] == 0
    wck = T_DC.SweepCheckpointer(str(tmp_path / "s"), every=1)
    wck.save(cursor=1, n_total=8, front_soa={}, front_metrics={},
             cache_state=None)
    assert T_DC.SearchCheckpointer(str(tmp_path / "s")).restore() is None
    with pytest.raises(ValueError, match=">= 1"):
        T_DC.SweepCheckpointer(str(tmp_path), every=0)


def test_sweep_does_not_take_degrade_on_failure():
    """The reference's jax->numpy degradation is a fallback that hides
    the device; the port's stream has no such knob."""
    with pytest.raises(TypeError, match="degrade_on_failure"):
        TB._sweep_chunked(T_WL, [T_FEED], chunk_size=CHUNK, device=CPU,
                          degrade_on_failure=True)


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------

def _slow_dispatch(monkeypatch, late: set):
    """Wrap the port's dispatch: the calls numbered in ``late`` return a
    finalize that misses any deadline; every call's device is logged."""
    real = TB._dispatch_chunk
    log = []

    def dispatch(cfg, klay, device):
        log.append(device)
        fin = real(cfg, klay, device)
        if len(log) - 1 not in late:
            return fin

        def late_fin(timeout=None):
            if timeout is not None:
                raise TB.ChunkDeadlineExceeded(f"late after {timeout}s")
            return fin()
        return late_fin

    monkeypatch.setattr(TB, "_dispatch_chunk", dispatch)
    return log


@pytest.mark.parametrize("late,depth", [({2}, 2), ({0, 5, 10}, 3),
                                        ({4}, 1)])
def test_watchdog_redispatches_on_the_same_device(monkeypatch, ref_sweep,
                                                  late, depth):
    log = _slow_dispatch(monkeypatch, late)
    with pytest.warns(RuntimeWarning, match="watchdog deadline"):
        res = TB._sweep_chunked(T_WL, [T_FEED], chunk_size=CHUNK,
                                device=CPU, prefetch_depth=depth,
                                chunk_deadline_s=1e-6)
    t = res.timings
    assert t["watchdog_redispatches"] == len(late)
    assert t["abandoned_finalizers"] == len(late)
    assert t["executor_replacements"] == t["cancelled_recomputes"] == 0
    # one dispatch a chunk, one more a late chunk, all on the stream's
    # device
    assert len(log) == N_CHUNKS + len(late)
    assert {str(d) for d in log} == {CPU}
    _same_sweep(res, ref_sweep)


def test_watchdog_redispatch_failure_raises(monkeypatch):
    real = TB._dispatch_chunk
    calls = {"n": 0}

    def dispatch(cfg, klay, device):
        calls["n"] += 1
        if calls["n"] == 1:
            def late(timeout=None):
                raise TB.ChunkDeadlineExceeded("late")
            return late
        if calls["n"] == 3:                     # the re-dispatch
            raise RuntimeError("kernel launch failed")
        return real(cfg, klay, device)

    monkeypatch.setattr(TB, "_dispatch_chunk", dispatch)
    with pytest.warns(RuntimeWarning, match="watchdog deadline"):
        with pytest.raises(RuntimeError, match="launch failed"):
            TB._sweep_chunked(T_WL, [T_FEED], chunk_size=CHUNK, device=CPU,
                              chunk_deadline_s=1.0)


def test_no_deadline_no_watchdog(ref_sweep):
    res = TB._sweep_chunked(T_WL, [T_FEED], chunk_size=CHUNK, device=CPU,
                            chunk_deadline_s=60.0)
    assert res.timings["watchdog_redispatches"] == 0
    assert res.timings["kernel_busy_s"] >= 0.0
    _same_sweep(res, ref_sweep)


# ---------------------------------------------------------------------------
# the resumed search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("boundary", range(8))   # init + 7 generations
def test_search_resume_equals_reference_at_every_generation(
        tmp_path, ref_search, boundary):
    res = T_DC.resume_search(T_SPACE, T_TINY, 120,
                             checkpoint_dir=str(tmp_path),
                             checkpoint_every=1,
                             fail_at_generation={boundary: 1}, device=CPU,
                             **SEARCH)
    assert res.stats["restarts"] == 1
    _same_search(res, ref_search)


def test_search_resume_repeated_failures(tmp_path, ref_search):
    res = T_DC.resume_search(T_SPACE, T_TINY, 120,
                             checkpoint_dir=str(tmp_path),
                             checkpoint_every=2,
                             fail_at_generation={1: 1, 5: 2, 7: 1},
                             device=CPU, **SEARCH)
    assert res.stats["restarts"] == 4
    _same_search(res, ref_search)


def test_search_resume_with_epsilon_archive(tmp_path):
    ref = r_nsga2(R_SPACE, R_TINY, 120, backend="numpy",
                  archive_epsilon=0.05, **SEARCH)
    res = T_DC.resume_search(T_SPACE, T_TINY, 120,
                             checkpoint_dir=str(tmp_path),
                             checkpoint_every=1,
                             fail_at_generation={2: 1, 5: 1}, device=CPU,
                             archive_epsilon=0.05, **SEARCH)
    assert res.stats["restarts"] == 2
    _same_search(res, ref)
    assert res.stats["archive_epsilon"] == ref.stats["archive_epsilon"]
    assert res.stats["archive_size"] == ref.stats["archive_size"]


def test_reference_search_snapshot_resumed_by_the_port(tmp_path,
                                                       ref_search):
    with pytest.raises(R_FT.InjectedFailure):
        r_nsga2(R_SPACE, R_TINY, 120, backend="numpy",
                checkpoint_dir=str(tmp_path), checkpoint_every=2,
                fail_at_generation={5: 1}, **SEARCH)
    res = t_nsga2(T_SPACE, T_TINY, 120, device=CPU,
                  checkpoint_dir=str(tmp_path), checkpoint_every=2,
                  **SEARCH)
    _same_search(res, ref_search)


def test_search_resume_refuses_a_changed_accuracy_table(tmp_path):
    from repro_torch.explore.accuracy import ProxyAccuracy
    with pytest.raises(T_FT.InjectedFailure):
        t_nsga2(T_SPACE, T_TINY, 64, device=CPU, accuracy=ProxyAccuracy(),
                checkpoint_dir=str(tmp_path), checkpoint_every=1,
                fail_at_generation={2: 1}, **SEARCH)
    _, st = T_CK.restore_latest_state(str(tmp_path))
    st["accuracy_digest"] = "0" * 16
    T_CK.save_state(str(tmp_path), 99, st)
    with pytest.raises(ValueError, match="accuracy digest"):
        t_nsga2(T_SPACE, T_TINY, 64, device=CPU, accuracy=ProxyAccuracy(),
                checkpoint_dir=str(tmp_path), **SEARCH)


@pytest.mark.parametrize("fail_at", [{1: 1}, {3: 1, 6: 2}])
def test_serving_search_resume_equals_uninterrupted(tmp_path, fail_at):
    """A serving search (fleet objectives on the quick trace) resumed
    through injected failures equals the uninterrupted run and the
    reference's numpy run."""
    ref = r_nsga2(R_SPACE, R_TINY, 120, backend="numpy", traffic="quick",
                  n_slots=3, **SEARCH)
    whole = t_nsga2(T_SPACE, T_TINY, 120, device=CPU, traffic="quick",
                    n_slots=3, **SEARCH)
    res = T_DC.resume_search(T_SPACE, T_TINY, 120,
                             checkpoint_dir=str(tmp_path),
                             checkpoint_every=1, fail_at_generation=fail_at,
                             device=CPU, traffic="quick", n_slots=3,
                             **SEARCH)
    assert res.stats["restarts"] == sum(fail_at.values())
    assert (res.stats["traffic"], res.stats["n_slots"]) == ("quick", 3)
    _same_search(res, whole)
    _same_search(res, ref)


def test_serving_search_resume_refuses_another_trace(tmp_path):
    with pytest.raises(T_FT.InjectedFailure):
        t_nsga2(T_SPACE, T_TINY, 64, device=CPU, traffic="quick",
                checkpoint_dir=str(tmp_path), checkpoint_every=1,
                fail_at_generation={2: 1}, **SEARCH)
    _, st = T_CK.restore_latest_state(str(tmp_path))
    assert st["n_slots"] == 8 and len(str(st["traffic_digest"])) == 64
    for kw in (dict(traffic="steady"), dict(traffic="quick", n_slots=4)):
        with pytest.raises(ValueError, match="different trace"):
            t_nsga2(T_SPACE, T_TINY, 64, device=CPU,
                    checkpoint_dir=str(tmp_path), **kw, **SEARCH)
    res = t_nsga2(T_SPACE, T_TINY, 64, device=CPU, traffic="quick",
                  checkpoint_dir=str(tmp_path), **SEARCH)
    _same_search(res, t_nsga2(T_SPACE, T_TINY, 64, device=CPU,
                              traffic="quick", **SEARCH))


def test_resume_search_rejects_non_nsga2(tmp_path):
    with pytest.raises(ValueError, match="nsga2"):
        T_DC.resume_search(T_SPACE, T_TINY, 64,
                           checkpoint_dir=str(tmp_path), method="random",
                           device=CPU)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(chunk_size=CHUNK, checkpoint_every=4), "checkpoint_every needs"),
    (dict(checkpoint_dir="ckpt"), "no resumable stream"),
    (dict(chunk_size=CHUNK, checkpoint_dir="ckpt", checkpoint_every=0),
     "checkpoint_every must be >= 1"),
    (dict(telemetry="yes"), "telemetry must be")])
def test_spec_checkpoint_validation_as_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        RSpec.single(R_WL, [R_FEED], **kw)
    with pytest.raises(ValueError, match=match):
        TSpec.single(T_WL, [T_FEED], **kw)


def test_run_checkpointed_chunked_sweep(tmp_path, ref_sweep):
    spec = TSpec.single(T_WL, [T_FEED], chunk_size=CHUNK, use_cache=False,
                        checkpoint_dir=str(tmp_path), checkpoint_every=2)
    first = t_run(spec, device=CPU)
    _same_sweep(first, ref_sweep)
    assert first.timings["restarts"] == 0
    assert first.timings["watchdog_redispatches"] == 0
    again = t_run(spec, device=CPU)               # the terminal snapshot
    _same_sweep(again, ref_sweep)
    r_again = r_run(RSpec.single(R_WL, [R_FEED], chunk_size=CHUNK,
                                 backend="numpy", use_cache=False,
                                 checkpoint_dir=str(tmp_path)))
    _same_sweep(r_again, ref_sweep)


@pytest.mark.parametrize("many", [False, True])
def test_run_checkpointed_search_as_reference(tmp_path, many):
    """``run(ExploreSpec.mixed / .many(..., checkpoint_dir=...))`` snapshots
    the search and resumes it; its result is the reference's."""
    kw = dict(budget=96, seed=5, pop_size=16, checkpoint_every=2)
    wls = ("vgg16", "resnet34") if many else ("vgg16",)

    def spec(mod, d):
        if many:
            return mod.many(wls, precision="mixed", checkpoint_dir=d, **kw)
        return mod.mixed(wls[0], checkpoint_dir=d, **kw)
    ref = r_run(dataclasses.replace(spec(RSpec, str(tmp_path / "r")),
                                    backend="numpy"))
    got = t_run(spec(TSpec, str(tmp_path / "t")), device=CPU)
    _same_search(got, ref)
    saved = sorted(os.listdir(tmp_path / "t"))
    assert saved == sorted(os.listdir(tmp_path / "r"))
    again = t_run(spec(TSpec, str(tmp_path / "t")), device=CPU)
    _same_search(again, ref)


def test_run_checkpointed_search_requires_nsga2(tmp_path):
    for mod, runner in ((RSpec, r_run), (TSpec, t_run)):
        spec = mod.mixed("vgg16", method="random", budget=32,
                         checkpoint_dir=str(tmp_path))
        with pytest.raises(ValueError, match="nsga2"):
            runner(spec) if mod is RSpec else runner(spec, device=CPU)
