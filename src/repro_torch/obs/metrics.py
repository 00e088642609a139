"""Process-local metrics registry: named counters, gauges, histograms.

Copy of :mod:`repro.obs.metrics`.

One flat namespace of cheap instruments shared by every subsystem of the
exploration runtime — the synthesis caches count hits/misses, the
streamed sweep counts chunks/configs/watchdog redispatches, the search
engines count generations and kernel evaluations, the fleet simulator
records SLO attainment.  A single :func:`snapshot` renders everything as
one flat ``{name: number}`` dict that benches embed in their
result provenance and tests assert against.

Unlike span *tracing* (:mod:`repro_torch.obs.trace`, gated behind
``repro_torch.obs.configure()``), the registry is always on: every instrument
is a plain Python attribute add at chunk/generation granularity — never
per design point — so the cost is unmeasurable against the array work it
accounts for.  Instruments are created on first use; a missing name in a
snapshot simply means that code path never ran.

Naming convention: dotted lowercase paths, ``<subsystem>.<thing>``
(``sweep.chunks``, ``synth_cache.hits``, ``explore.eval_seconds``).
Histogram snapshots expand to ``<name>.count/.sum/.min/.max/.mean``.
"""

from __future__ import annotations

import threading


class Counter:
    """Monotone accumulator (ints or floats — e.g. seconds)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Last-write-wins point-in-time value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Streaming summary: count / sum / min / max (O(1) memory).

    Enough to answer "how many, how much, how skewed" for per-chunk and
    per-generation durations without keeping samples; full distributions
    belong in the span ring (:mod:`repro_torch.obs.trace`).
    """

    __slots__ = ("name", "count", "total", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def __repr__(self) -> str:
        return (f"Histogram({self.name}: n={self.count}, "
                f"mean={self.mean:.4g})")


class MetricsRegistry:
    """Name -> instrument store with a flat :meth:`snapshot`.

    Instrument *creation* is locked (threads may race the first use);
    updates on the returned objects are plain attribute math — the
    GIL-level atomicity is sufficient at the chunk/generation
    granularity every caller uses.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    # -- instrument accessors (create on first use) -----------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(name))
        return h

    # -- convenience write paths ------------------------------------------
    def inc(self, name: str, n=1) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v) -> None:
        self.histogram(name).observe(v)

    # -- read side ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Everything as one flat ``{name: number}`` dict (sorted keys).

        Counter/gauge names map straight to their values; histograms
        expand to ``.count/.sum/.min/.max/.mean`` suffixes.  The dict is
        a decoupled copy — JSON-serializable, safe to stash in a bench
        provenance block.
        """
        out: dict = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.value
        for name, h in self._hists.items():
            out[f"{name}.count"] = h.count
            out[f"{name}.sum"] = h.total
            if h.count:
                out[f"{name}.min"] = h.min
                out[f"{name}.max"] = h.max
                out[f"{name}.mean"] = h.mean
        return dict(sorted(out.items()))

    def reset(self) -> None:
        """Drop every instrument (tests and per-run scoping)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem writes to."""
    return _REGISTRY


def snapshot() -> dict:
    """Flat snapshot of the process-wide registry."""
    return _REGISTRY.snapshot()


def reset_metrics() -> None:
    """Zero the process-wide registry."""
    _REGISTRY.reset()
