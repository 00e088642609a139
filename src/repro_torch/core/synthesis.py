"""Analytical synthesis oracle (stands in for Synopsys DC + VCS @ 45 nm).

Copy of :mod:`repro.core.synthesis`: batched synthesis over a SoA config
batch with a digest-seeded process jitter, the per-config report
(:func:`synthesize`, :func:`synthesize_many`) behind a bounded in-process
LRU, and the digest-keyed synthesis cache with the same npz format, so a
cache file written by either package loads in the other.  Host numpy
code; the PPA models (:mod:`repro_torch.core.ppa_model`) fit to its
reports.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pathlib
import warnings
from typing import Sequence

import numpy as np

from repro_torch.core.accelerator import AcceleratorConfig, configs_to_soa
from repro_torch.core.confighash import (config_digests, digest_keys,
                                         digests_to_u64, uniform01)
from repro_torch.core.dataflow import leakage_mw_soa
from repro_torch.core.pe import (rf_access_energy_pj, sram_access_energy_pj,
                                 sram_area_um2)
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass(frozen=True)
class SynthesisReport:
    """What the synthesis + simulation flow reports for one design."""

    area_mm2: float            # post-synthesis cell area
    power_mw: float            # dynamic + leakage at nominal activity
    clock_ghz: float           # achieved clock after timing closure
    throughput_gmacs: float    # peak effective GMAC/s at that clock

    def as_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)


# columns of the array-form synthesis result, in stable (npz) order
REPORT_COLUMNS = ("area_mm2", "power_mw", "clock_ghz", "throughput_gmacs")


def synthesize_soa(soa: dict[str, np.ndarray],
                   digests=None) -> dict[str, np.ndarray]:
    """Synthesize a whole config batch; ``{column: (N,) float64}`` over
    :data:`REPORT_COLUMNS`.  Elementwise, so each row equals a length-1
    evaluation of that config."""
    if digests is None:
        digests = config_digests(soa)
    f = np.float64
    jit_area = 1.0 + 0.03 * (2.0 * uniform01(digests[0]) - 1.0)
    jit_clk = 1.0 + 0.02 * (2.0 * uniform01(digests[1]) - 1.0)
    jit_pw = 1.0 + 0.04 * (2.0 * uniform01(digests[2]) - 1.0)

    n = soa["num_pes"].astype(f)
    glb_bits = soa["glb_bits"].astype(f)
    spad_bits = soa["spad_bits"].astype(f)

    # area
    pe_area = soa["mac_area_um2"] + sram_area_um2(spad_bits)
    glb_area = sram_area_um2(glb_bits)
    noc_area = 120.0 * n * (1.0 + 0.004 * np.sqrt(n))
    area_mm2 = (n * pe_area + glb_area + noc_area) * jit_area / 1e6

    # timing: wire delay degrades the clock of very large arrays
    wire_penalty = 1.0 + 0.002 * np.sqrt(n)
    clock_ghz = np.minimum((soa["max_clock_ghz"] / wire_penalty) * jit_clk,
                           soa["clock_cap"])

    # power at nominal activity (70% MAC utilization)
    util = 0.70
    mac_pw = n * util * soa["mac_energy_pj"] * clock_ghz * 1e9 * 1e-12
    e_spad = rf_access_energy_pj(spad_bits)
    spad_pw = n * util * 3.0 * e_spad * clock_ghz * 1e9 * 1e-12
    e_glb = sram_access_energy_pj(glb_bits)
    glb_pw = n * util * (1.0 / 8.0) * e_glb * clock_ghz * 1e9 * 1e-12
    leak_mw = leakage_mw_soa(soa)
    power_mw = (mac_pw + spad_pw + glb_pw + leak_mw) * jit_pw

    return {
        "area_mm2": area_mm2,
        "power_mw": power_mw,
        "clock_ghz": clock_ghz,
        "throughput_gmacs": n * clock_ghz,
    }


def synthesize(cfg: AcceleratorConfig) -> SynthesisReport:
    """Synthesize one design point: a length-1 batch through
    :func:`synthesize_soa`, so scalar and batched results are equal."""
    cols = synthesize_soa(configs_to_soa((cfg,)))
    return SynthesisReport(**{k: float(cols[k][0]) for k in REPORT_COLUMNS})


def config_hash(cfg: AcceleratorConfig) -> str:
    """Hex form of a config's 128-bit packed-field digest (every field,
    ``clock_ghz`` included)."""
    return config_keys((cfg,))[0].hex()


def config_keys(configs: Sequence[AcceleratorConfig],
                soa: dict[str, np.ndarray] | None = None) -> list[bytes]:
    """16-byte digest keys for a config batch."""
    if soa is None:
        soa = configs_to_soa(tuple(configs))
    return digest_keys(config_digests(soa))


# ---------------------------------------------------------------------------
# In-process report cache: bounded LRU keyed by the 16-byte digest.
# ---------------------------------------------------------------------------

_SYNTH_CACHE: collections.OrderedDict[bytes, SynthesisReport] = \
    collections.OrderedDict()
_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_CACHE_LIMIT = 1 << 18          # ~260k reports, bounded


def synthesis_cache_stats() -> dict[str, int]:
    stats = dict(_CACHE_STATS, size=len(_SYNTH_CACHE), limit=_CACHE_LIMIT)
    stats.update(array_hits=_SWEEP_CACHE.hits,
                 array_misses=_SWEEP_CACHE.misses,
                 array_size=len(_SWEEP_CACHE),
                 array_evictions=_SWEEP_CACHE.evictions)
    return stats


def set_synthesis_cache_limit(limit: int) -> int:
    """Cap both in-process synthesis caches (entries / rows); returns the
    old cap.  Shrinking evicts the oldest entries at once."""
    global _CACHE_LIMIT
    old, _CACHE_LIMIT = _CACHE_LIMIT, max(0, int(limit))
    _evict_to_limit()
    _SWEEP_CACHE.max_rows = _CACHE_LIMIT
    _SWEEP_CACHE._compact()
    return old


def clear_synthesis_cache() -> None:
    _SYNTH_CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0, evictions=0)
    _SWEEP_CACHE.clear()


def _evict_to_limit() -> None:
    while len(_SYNTH_CACHE) > _CACHE_LIMIT:
        _SYNTH_CACHE.popitem(last=False)
        _CACHE_STATS["evictions"] += 1


def _cache_put(key: bytes, rep: SynthesisReport) -> None:
    _SYNTH_CACHE[key] = rep
    _evict_to_limit()


def synthesize_cached(cfg: AcceleratorConfig) -> SynthesisReport:
    """:func:`synthesize` through the in-process report cache."""
    key = config_keys((cfg,))[0]
    hit = _SYNTH_CACHE.get(key)
    if hit is not None:
        _CACHE_STATS["hits"] += 1
        _SYNTH_CACHE.move_to_end(key)
        return hit
    _CACHE_STATS["misses"] += 1
    rep = synthesize(cfg)
    _cache_put(key, rep)
    return rep


def synthesize_many(configs: Sequence[AcceleratorConfig],
                    use_cache: bool = True,
                    soa: dict[str, np.ndarray] | None = None
                    ) -> list[SynthesisReport]:
    """Synthesize a batch of design points in one array pass; cached
    configs are skipped.  ``soa`` reuses an existing SoA conversion."""
    configs = list(configs)
    if not configs:
        return []
    if soa is None:
        soa = configs_to_soa(configs)
    out: list[SynthesisReport | None] = [None] * len(configs)
    digests = config_digests(soa)
    if use_cache:
        keys = digest_keys(digests)
        todo = []
        for i, key in enumerate(keys):
            hit = _SYNTH_CACHE.get(key)
            if hit is not None:
                _CACHE_STATS["hits"] += 1
                _SYNTH_CACHE.move_to_end(key)
                out[i] = hit
            else:
                _CACHE_STATS["misses"] += 1
                todo.append(i)
        if not todo:
            return out  # type: ignore[return-value]
        idx = np.array(todo, dtype=np.intp)
        sub = {k: v[idx] for k, v in soa.items()}
        cols = synthesize_soa(sub, digests=tuple(d[idx] for d in digests))
        for j, i in enumerate(todo):
            rep = SynthesisReport(
                **{k: float(cols[k][j]) for k in REPORT_COLUMNS})
            out[i] = rep
            _cache_put(keys[i], rep)
        return out  # type: ignore[return-value]
    cols = synthesize_soa(soa, digests=digests)
    return [SynthesisReport(**{k: float(cols[k][i])
                               for k in REPORT_COLUMNS})
            for i in range(len(configs))]


class PersistentSynthesisCache:
    """Digest-keyed synthesis store with npz persistence.

    ``lookup`` / ``insert`` work on whole chunks; rows live in one growing
    value matrix so hits gather with one fancy index.  ``max_rows`` bounds
    memory: on overflow the oldest half of the rows is dropped (counted in
    ``evictions``).
    """

    def __init__(self, path: str | pathlib.Path | None = None,
                 max_rows: int | None = None):
        self.path = pathlib.Path(path) if path is not None else None
        self.max_rows = max_rows
        self._index: dict[bytes, int] = {}
        self._keys = np.empty((0, 2), dtype=np.uint64)
        self._vals = np.empty((0, len(REPORT_COLUMNS)), dtype=np.float64)
        self._n = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        if self.path is not None and self.path.exists():
            try:
                self.load(self.path)
            except Exception as exc:    # zipfile, pickle, shape errors
                # a corrupt or foreign npz must never poison the cache:
                # start empty (the next save overwrites it); an explicit
                # load() still raises
                warnings.warn(
                    f"persistent synthesis cache at {self.path} is "
                    f"unreadable ({type(exc).__name__}: {exc}); starting "
                    f"with an empty cache and rebuilding",
                    RuntimeWarning, stacklevel=2)

    def clear(self) -> None:
        """Drop all rows and stats; keeps the cap and the save path."""
        path, self.path = self.path, None     # don't reload from disk
        self.__init__(path=None, max_rows=self.max_rows)
        self.path = path

    def _compact(self) -> None:
        if self.max_rows is None or self._n <= self.max_rows:
            return
        keep = self.max_rows // 2           # newest half survives
        drop = self._n - keep
        self._keys[:keep] = self._keys[drop:self._n]
        self._vals[:keep] = self._vals[drop:self._n]
        self._n = keep
        self.evictions += drop
        buf = np.ascontiguousarray(self._keys[:keep]).tobytes()
        self._index = {buf[16 * i:16 * (i + 1)]: i for i in range(keep)}

    def __len__(self) -> int:
        return self._n

    def _grow(self, extra: int) -> None:
        need = self._n + extra
        cap = len(self._keys)
        if need > cap:
            cap = max(need, 2 * cap, 1024)
            self._keys = np.resize(self._keys, (cap, 2))
            self._vals = np.resize(self._vals, (cap, len(REPORT_COLUMNS)))

    def lookup(self, digests) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        """(hit_mask, columns) for a digest batch; missed rows are zero."""
        keys = digest_keys(digests)
        rows = np.array([self._index.get(k, -1) for k in keys],
                        dtype=np.intp)
        mask = rows >= 0
        vals = np.zeros((len(keys), len(REPORT_COLUMNS)), dtype=np.float64)
        if mask.any():
            vals[mask] = self._vals[rows[mask]]
        nh = int(mask.sum())
        nm = len(keys) - nh
        self.hits += nh
        self.misses += nm
        reg = obs_metrics.get_registry()
        reg.inc("synth_cache.hits", nh)
        reg.inc("synth_cache.misses", nm)
        return mask, {c: vals[:, j] for j, c in enumerate(REPORT_COLUMNS)}

    def insert(self, digests, cols: dict[str, np.ndarray]) -> int:
        """Append a digest batch's columns; returns how many keys were new.
        A re-inserted key points the index at its newest row (values for a
        digest are identical by construction)."""
        u64 = np.ascontiguousarray(digests_to_u64(digests))
        vals = np.stack([np.asarray(cols[c], dtype=np.float64)
                         for c in REPORT_COLUMNS], axis=-1)
        m = len(u64)
        if m == 0:
            return 0
        self._grow(m)
        self._keys[self._n:self._n + m] = u64
        self._vals[self._n:self._n + m] = vals
        buf = u64.tobytes()
        before = len(self._index)
        self._index.update(
            zip((buf[16 * i:16 * (i + 1)] for i in range(m)),
                range(self._n, self._n + m)))
        self._n += m
        self._compact()
        return len(self._index) - before

    def save(self, path: str | pathlib.Path | None = None) -> int:
        """Write all rows to ``path`` (default: the constructor path)
        atomically, through a sibling temp file."""
        path = pathlib.Path(path) if path is not None else self.path
        if path is None:
            raise ValueError("PersistentSynthesisCache.save: no path")
        # write through a handle: np.savez would append ".npz" to a
        # suffix-less path
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        try:
            with open(tmp, "wb") as fh:
                np.savez_compressed(
                    fh, keys=self._keys[:self._n],
                    **{c: self._vals[:self._n, j]
                       for j, c in enumerate(REPORT_COLUMNS)})
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        finally:
            if tmp.exists():
                tmp.unlink()
        return self._n

    def export_state(self) -> dict:
        """Rows and accounting as a plain dict of arrays / scalars: the
        synthesis-cache slice of a sweep snapshot
        (:mod:`repro_torch.runtime.dse_checkpoint`), counters included so
        a resumed run's hit/miss accounting equals the uninterrupted
        run's."""
        return {
            "keys": self._keys[:self._n].copy(),
            "vals": self._vals[:self._n].copy(),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

    def import_state(self, state: dict) -> None:
        """Replace rows and counters with an :meth:`export_state`
        snapshot (existing contents are dropped, not merged)."""
        keys = np.ascontiguousarray(state["keys"], dtype=np.uint64)
        vals = np.asarray(state["vals"], dtype=np.float64)
        if keys.ndim != 2 or keys.shape[1] != 2 \
                or vals.shape != (len(keys), len(REPORT_COLUMNS)):
            raise ValueError(
                f"cache snapshot shapes {keys.shape} / {vals.shape} are "
                f"not (N, 2) / (N, {len(REPORT_COLUMNS)})")
        self._keys = keys.copy()
        self._vals = vals.copy()
        self._n = len(keys)
        buf = keys.tobytes()
        self._index = {buf[16 * i:16 * (i + 1)]: i
                       for i in range(self._n)}
        self.hits = int(state["hits"])
        self.misses = int(state["misses"])
        self.evictions = int(state["evictions"])
        self._compact()

    def load(self, path: str | pathlib.Path) -> int:
        """Merge rows from an npz file; returns how many were new.  Raises
        on a structurally wrong file instead of merging it."""
        with np.load(pathlib.Path(path)) as z:
            missing = {"keys", *REPORT_COLUMNS} - set(z.files)
            if missing:
                raise ValueError(
                    f"synthesis cache {path} is missing array(s) "
                    f"{sorted(missing)}")
            keys = np.ascontiguousarray(z["keys"], dtype=np.uint64)
            if keys.ndim != 2 or keys.shape[1] != 2:
                raise ValueError(
                    f"synthesis cache {path}: keys shape {keys.shape} "
                    f"!= (N, 2)")
            vals = np.stack([z[c] for c in REPORT_COLUMNS], axis=-1)
            if vals.shape != (len(keys), len(REPORT_COLUMNS)):
                raise ValueError(
                    f"synthesis cache {path}: {len(keys)} keys but "
                    f"value block {vals.shape}")
            if not np.isfinite(vals).all():
                raise ValueError(
                    f"synthesis cache {path}: non-finite report values")
        before = self._n
        self._grow(len(keys))
        buf = keys.tobytes()
        for i in range(len(keys)):
            key = buf[16 * i:16 * (i + 1)]
            if key in self._index:
                continue
            row = self._n
            self._index[key] = row
            self._keys[row] = keys[i]
            self._vals[row] = vals[i]
            self._n += 1
        self._compact()
        return self._n - before

    def synthesize(self, soa: dict[str, np.ndarray]
                   ) -> dict[str, np.ndarray]:
        """Cache-through batched synthesis: hits gather from the store,
        misses run :func:`synthesize_soa` and are inserted."""
        digests = config_digests(soa)
        mask, cols = self.lookup(digests)
        miss = ~mask
        if miss.any():
            idx = np.nonzero(miss)[0]
            sub = {k: v[idx] for k, v in soa.items()}
            sub_digests = tuple(d[idx] for d in digests)
            fresh = synthesize_soa(sub, digests=sub_digests)
            for c in REPORT_COLUMNS:
                cols[c][idx] = fresh[c]
            self.insert(sub_digests, fresh)
        return cols


# process-wide array store behind use_cache=True, bounded like the
# report cache
_SWEEP_CACHE = PersistentSynthesisCache(max_rows=_CACHE_LIMIT)


def sweep_synthesis_cache() -> PersistentSynthesisCache:
    """The process-wide synthesis cache of the batched sweep."""
    return _SWEEP_CACHE
