"""Seeded request-arrival traces for serving-fleet DSE.

Copy of :mod:`repro.serving.traffic` (jax-free numpy): the serving
presets of the co-exploration name these traces, and
:mod:`repro_torch.serving.fleet_sim` replays them.

A :class:`TrafficTrace` is the workload the fleet simulator replays
against every accelerator candidate: per-request arrival times plus the
prefill/decode phase split (prompt tokens replayed one per iteration,
then decode tokens produced one per iteration — exactly the
:class:`repro_torch.serving.scheduler.ContinuousBatcher` semantics).

Traces are generated from named :class:`TrafficPreset`\\ s — Poisson
("steady" memoryless arrivals) or bursty (Poisson burst *starts*, each
burst a tight cluster of requests) — with all randomness flowing through
one explicit ``numpy.random.Generator`` in data-independent draw order, so
a (preset, seed) pair names one exact trace forever.  Arrival rates are
calibrated to the sweep kernel's per-inference latency range
(~0.02–0.9 s on the paper space), so queueing pressure actually
discriminates design points instead of every candidate trivially keeping
up.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficTrace:
    """One replayable serving workload: R requests with arrival times and
    prefill/decode phase lengths.

    ``arrival_s`` must be sorted ascending (FIFO admission is by arrival);
    ``prompt_tokens`` / ``decode_tokens`` are per-request phase lengths in
    tokens (both >= 1).  ``slo_s`` is the per-request completion deadline
    used by the ``slo_attainment`` serving objective.
    """

    name: str
    arrival_s: np.ndarray       # (R,) float64, sorted ascending, >= 0
    prompt_tokens: np.ndarray   # (R,) int64 >= 1
    decode_tokens: np.ndarray   # (R,) int64 >= 1
    slo_s: float = 2.0

    def __post_init__(self):
        arr = np.asarray(self.arrival_s, dtype=np.float64)
        pt = np.asarray(self.prompt_tokens, dtype=np.int64)
        dt = np.asarray(self.decode_tokens, dtype=np.int64)
        if not (arr.ndim == pt.ndim == dt.ndim == 1):
            raise ValueError("trace fields must be 1-D arrays")
        if not (len(arr) == len(pt) == len(dt)):
            raise ValueError(
                f"trace field lengths disagree: {len(arr)} arrivals, "
                f"{len(pt)} prompt lengths, {len(dt)} decode lengths")
        if len(arr) and (not np.isfinite(arr).all() or (arr < 0).any()):
            raise ValueError("arrival times must be finite and >= 0")
        if len(arr) and (np.diff(arr) < 0).any():
            raise ValueError("arrival times must be sorted ascending")
        if len(pt) and ((pt < 1).any() or (dt < 1).any()):
            raise ValueError("prompt/decode token counts must be >= 1")
        if not (np.isfinite(self.slo_s) and self.slo_s > 0):
            raise ValueError(f"slo_s must be positive, got {self.slo_s!r}")
        object.__setattr__(self, "arrival_s", arr)
        object.__setattr__(self, "prompt_tokens", pt)
        object.__setattr__(self, "decode_tokens", dt)

    @property
    def n_requests(self) -> int:
        return len(self.arrival_s)

    @property
    def service_iters(self) -> np.ndarray:
        """Per-request batcher iterations to completion once admitted.

        A request with P prompt tokens and G decode tokens occupies its
        slot for ``P + G - 1`` iterations: the iteration consuming the
        last prompt token also produces the first decode token (the
        :class:`~repro_torch.serving.scheduler.ContinuousBatcher` contract).
        """
        return self.prompt_tokens + self.decode_tokens - 1

    @property
    def total_tokens(self) -> int:
        """Total token-iterations of work in the trace."""
        return int(self.service_iters.sum())


@dataclasses.dataclass(frozen=True)
class TrafficPreset:
    """Named recipe for a trace: arrival process + phase-length mix.

    ``kind="poisson"`` draws exponential inter-arrival gaps at
    ``rate_rps``; ``kind="bursty"`` draws Poisson burst *starts* at
    ``rate_rps / burst_size`` (so the long-run request rate matches the
    steady preset at equal ``rate_rps``) and packs ``burst_size`` requests
    per burst with exponential intra-burst spacing at ``burst_spread_s``
    scale.  Phase lengths are uniform over the inclusive
    ``prompt_tokens`` / ``decode_tokens`` ranges.
    """

    name: str
    kind: str = "poisson"                     # "poisson" | "bursty"
    rate_rps: float = 6.0                     # long-run mean request rate
    n_requests: int = 48
    prompt_tokens: tuple[int, int] = (3, 12)  # inclusive [lo, hi]
    decode_tokens: tuple[int, int] = (4, 12)
    burst_size: int = 8                       # bursty only
    burst_spread_s: float = 0.05              # bursty only
    slo_s: float = 2.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("poisson", "bursty"):
            raise ValueError(
                f"unknown traffic kind {self.kind!r} "
                f"(choose from ('poisson', 'bursty'))")
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.n_requests < 0:
            raise ValueError(
                f"n_requests must be >= 0, got {self.n_requests}")
        for rng_name in ("prompt_tokens", "decode_tokens"):
            lo, hi = getattr(self, rng_name)
            if not (1 <= lo <= hi):
                raise ValueError(
                    f"{rng_name} range must satisfy 1 <= lo <= hi, "
                    f"got ({lo}, {hi})")
        if self.kind == "bursty" and self.burst_size < 1:
            raise ValueError(
                f"burst_size must be >= 1, got {self.burst_size}")


# calibrated against the paper design space's per-inference latencies
# (~0.02-0.9 s/iteration): "steady"/"bursty" load the mid-range designs
# without drowning the fast ones, "interactive" pressures SLO latency,
# "batch" rewards raw throughput, "quick" is the CI smoke trace
TRAFFIC_PRESETS: dict[str, TrafficPreset] = {p.name: p for p in (
    TrafficPreset(name="steady", kind="poisson", rate_rps=6.0,
                  n_requests=48, prompt_tokens=(3, 12),
                  decode_tokens=(4, 12), slo_s=2.0),
    TrafficPreset(name="bursty", kind="bursty", rate_rps=6.0,
                  n_requests=48, prompt_tokens=(3, 12),
                  decode_tokens=(4, 12), burst_size=8,
                  burst_spread_s=0.05, slo_s=2.5),
    TrafficPreset(name="interactive", kind="poisson", rate_rps=10.0,
                  n_requests=64, prompt_tokens=(2, 6),
                  decode_tokens=(3, 8), slo_s=1.0),
    TrafficPreset(name="batch", kind="poisson", rate_rps=1.5,
                  n_requests=24, prompt_tokens=(16, 40),
                  decode_tokens=(12, 32), slo_s=12.0),
    TrafficPreset(name="quick", kind="poisson", rate_rps=8.0,
                  n_requests=16, prompt_tokens=(2, 6),
                  decode_tokens=(3, 6), slo_s=1.0),
)}


def get_traffic(name: str) -> TrafficPreset:
    try:
        return TRAFFIC_PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown traffic preset {name!r} "
            f"(known: {sorted(TRAFFIC_PRESETS)})") from None


def make_trace(preset: TrafficPreset | str, *, seed: int | None = None,
               n_requests: int | None = None) -> TrafficTrace:
    """Materialize a preset into a concrete :class:`TrafficTrace`.

    Draw order is fixed (arrival process, then prompt lengths, then
    decode lengths), so equal (preset, seed) pairs give bit-identical
    traces regardless of numpy version-independent quantities.
    """
    p = get_traffic(preset) if isinstance(preset, str) else preset
    seed = p.seed if seed is None else seed
    n = p.n_requests if n_requests is None else int(n_requests)
    rng = np.random.default_rng(seed)
    if p.kind == "poisson":
        arrival = np.cumsum(rng.exponential(1.0 / p.rate_rps, size=n))
    else:                                   # bursty
        n_bursts = -(-n // p.burst_size)
        burst_rate = p.rate_rps / p.burst_size
        starts = np.cumsum(rng.exponential(1.0 / burst_rate,
                                           size=n_bursts))
        offsets = rng.exponential(p.burst_spread_s,
                                  size=(n_bursts, p.burst_size))
        arrival = np.sort(
            (starts[:, None] + np.cumsum(offsets, axis=1)).ravel()[:n])
    prompt = rng.integers(p.prompt_tokens[0], p.prompt_tokens[1] + 1,
                          size=n, dtype=np.int64)
    decode = rng.integers(p.decode_tokens[0], p.decode_tokens[1] + 1,
                          size=n, dtype=np.int64)
    name = p.name if seed == p.seed and n == p.n_requests \
        else f"{p.name}(seed={seed},n={n})"
    return TrafficTrace(name=name, arrival_s=arrival,
                        prompt_tokens=prompt, decode_tokens=decode,
                        slo_s=p.slo_s)


def resolve_traffic(spec) -> TrafficTrace:
    """Accept a trace, a preset, or a preset name; return the trace."""
    if isinstance(spec, TrafficTrace):
        return spec
    if isinstance(spec, TrafficPreset):
        return make_trace(spec)
    if isinstance(spec, str):
        return make_trace(get_traffic(spec))
    raise TypeError(
        f"traffic must be a TrafficTrace, TrafficPreset, or preset name, "
        f"got {type(spec).__name__}")
