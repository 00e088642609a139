"""Serving-fleet simulator over the (N candidates, R requests) grid.

Port of :mod:`repro.serving.fleet_sim`.  Scores every accelerator
candidate of a sweep on a *serving fleet* instead of a single inference:
each candidate runs an Orca-style continuous batcher
(:mod:`repro_torch.serving.scheduler`) with ``n_slots`` slots against one
shared :class:`~repro_torch.serving.traffic.TrafficTrace`, and the
simulator reports per-request completion iterations, SLO attainment,
throughput under load and energy per served token.

Model
-----
One batcher iteration on candidate *n* takes ``step_s[n]`` seconds (the
candidate's sweep latency aggregate) and advances every busy slot by one
token; a request with P prompt / G decode tokens holds its slot for
``P + G - 1`` iterations (the ``ContinuousBatcher`` contract, which the
tests pin).  Every *active* iteration dispatches the full ``n_slots``
batch and costs ``n_slots * e_token_j[n]`` joules regardless of
occupancy, so energy per served token is occupancy-sensitive.

Routes
------
The stamps are integers once the arrival iterations ``ceil(arrival_s /
step_s)`` are fixed (float64, IEEE), so every route gives the same stamps
bit for bit.  On a CUDA device :func:`simulate_fleet` launches the
hand-written kernel of :mod:`repro_torch.kernels.fleet_sim` (one thread
per candidate, the FIFO walk of :func:`simulate_fleet_scalar`); on
``device="cpu"`` it runs that kernel's plain torch version.  The
reference's own routes are its numpy ``_simulate_numpy`` and the jitted
``fori_loop`` ``_jax_sim``.  :func:`simulate_fleet_scalar` is the
reference's event-driven one-candidate oracle, copied.  Derived metrics
(:meth:`FleetResult.metrics`) stay host numpy, the reference's own
arithmetic (``np.percentile``, ``nan_to_num``), so they equal the
reference's to the bit on the same stamps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.traffic import TrafficTrace, resolve_traffic

_INT32_MAX = np.iinfo(np.int32).max


def _horizon_error(max_arrive: float) -> ValueError:
    return ValueError(
        "trace arrival horizon overflows the iteration grid "
        f"(max arrival iteration {max_arrive:.3g}); step_s is too small "
        "for this trace — shorten the trace or cap max_iters")


def _arrival_iters(step_s: np.ndarray, arrival_s: np.ndarray) -> np.ndarray:
    """(N, R) first iteration index at which each request is admissible:
    request r is queued at the start of iteration k iff ``arrival_s[r] <=
    k * step_s[n]``, i.e. ``k >= ceil(arrival / step)``, in float64."""
    a = np.ceil(np.asarray(arrival_s, np.float64)[None, :]
                / np.asarray(step_s, np.float64)[:, None])
    if a.size and a.max() >= _INT32_MAX:
        raise _horizon_error(a.max())
    return a.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class FleetResult:
    """Raw per-request iteration stamps plus derived serving metrics.

    ``submit_iter[n, r]`` is the iteration at which request r was
    admitted on candidate n (-1 if never admitted within ``n_iters``);
    ``comp_iter[n, r]`` is the iteration count by which it completed
    (``submit + P + G - 1``; 0 if never admitted).  A request counts as
    *served* iff ``0 < comp_iter <= n_iters``.  ``backend`` names the
    route that ran: ``"cuda"``, ``"cpu"`` or ``"scalar"``.
    """

    trace: TrafficTrace
    n_slots: int
    n_iters: int
    backend: str
    step_s: np.ndarray        # (N,) float64 seconds per iteration
    e_token_j: np.ndarray     # (N,) float64 joules per token-slot
    submit_iter: np.ndarray   # (N, R) int64, -1 = never admitted
    comp_iter: np.ndarray     # (N, R) int64, 0 = never admitted
    active_iters: np.ndarray  # (N,) int64 iterations with >=1 busy slot

    @property
    def n_candidates(self) -> int:
        return len(self.step_s)

    @property
    def served(self) -> np.ndarray:
        """(N, R) bool: admitted and completed within the horizon."""
        return (self.comp_iter > 0) & (self.comp_iter <= self.n_iters)

    @property
    def latency_s(self) -> np.ndarray:
        """(N, R) float64 queueing + service latency; +inf if unserved.
        Measured on the iteration grid, ``(comp - arrive_iter) * step``,
        so it stays an exact integer scaled by ``step_s``."""
        arrive = _arrival_iters(self.step_s,
                                np.asarray(self.trace.arrival_s))
        lat = ((self.comp_iter - arrive).astype(np.float64)
               * self.step_s[:, None])
        return np.where(self.served, lat, np.inf)

    def metrics(self, slo_s: float | None = None) -> dict[str, np.ndarray]:
        """Serving objectives, all (N,) float64.  Unserved requests poison
        the latency percentiles to +inf and count against
        ``slo_attainment``; the objectives layer maps the infinities onto
        its finite floor penalty."""
        slo = float(self.trace.slo_s if slo_s is None else slo_s)
        n = self.n_candidates
        r = self.trace.n_requests
        svc = np.asarray(self.trace.service_iters, np.int64)
        if r == 0:
            z = np.zeros(n, np.float64)
            return {"p50_latency_s": z.copy(), "p99_latency_s": z.copy(),
                    "slo_attainment": np.ones(n, np.float64),
                    "throughput_tps": z.copy(),
                    "energy_per_token_j": z.copy(),
                    "served_frac": np.ones(n, np.float64)}
        lat = self.latency_s
        served = self.served
        served_tokens = (svc[None, :] * served).sum(axis=1,
                                                    dtype=np.float64)
        makespan = (np.where(served, self.comp_iter, 0).max(axis=1)
                    .astype(np.float64) * self.step_s)
        energy = (self.active_iters.astype(np.float64) * self.n_slots
                  * self.e_token_j)
        with np.errstate(divide="ignore", invalid="ignore"):
            throughput = np.where(makespan > 0,
                                  served_tokens / makespan, 0.0)
            e_per_tok = np.where(served_tokens > 0,
                                 energy / served_tokens, np.inf)
            # percentile interpolates inf-inf to nan; the right answer
            # for an unserved tail is +inf
            p50 = np.nan_to_num(np.percentile(lat, 50.0, axis=1),
                                nan=np.inf, posinf=np.inf)
            p99 = np.nan_to_num(np.percentile(lat, 99.0, axis=1),
                                nan=np.inf, posinf=np.inf)
        return {
            "p50_latency_s": p50,
            "p99_latency_s": p99,
            "slo_attainment": ((lat <= slo).sum(axis=1)
                               / np.float64(r)),
            "throughput_tps": throughput,
            "energy_per_token_j": e_per_tok,
            "served_frac": served.sum(axis=1) / np.float64(r),
        }


def simulate_fleet(step_s, e_token_j, traffic, *, n_slots: int = 8,
                   max_iters: int | None = None,
                   device: str | torch.device = "cuda") -> FleetResult:
    """Replay ``traffic`` against N candidates; return iteration stamps.

    ``step_s`` / ``e_token_j`` are (N,) per-candidate seconds-per-
    iteration and joules-per-token-slot from the sweep.  With
    ``max_iters=None`` the horizon drains (last arrival plus total
    service, so every request completes); a finite ``max_iters`` models a
    hard serving window, in which stragglers are unserved.  On a CUDA
    ``device`` the stamps come from the fleet kernel (a host without a
    card raises); on ``"cpu"`` from its plain version.
    """
    from repro_torch.kernels.fleet_sim import fleet_stamps

    trace = resolve_traffic(traffic)
    step = np.atleast_1d(np.asarray(step_s, np.float64))
    e_tok = np.atleast_1d(np.asarray(e_token_j, np.float64))
    if step.ndim != 1 or step.shape != e_tok.shape:
        raise ValueError(
            f"step_s and e_token_j must be matching 1-D arrays, got "
            f"shapes {step.shape} and {e_tok.shape}")
    if len(step) and ((step <= 0).any() or not np.isfinite(step).all()):
        raise ValueError("step_s must be finite and > 0")
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1, got {n_slots}")
    dev = resolve_device(device)
    route = dev.type
    n, r = len(step), trace.n_requests
    if n == 0 or r == 0:
        return FleetResult(
            trace=trace, n_slots=n_slots, n_iters=0, backend=route,
            step_s=step, e_token_j=e_tok,
            submit_iter=np.full((n, r), -1, np.int64),
            comp_iter=np.zeros((n, r), np.int64),
            active_iters=np.zeros(n, np.int64))
    arrival = np.asarray(trace.arrival_s, np.float64)
    # the largest arrival iteration, without the (N, R) grid: division is
    # monotone in both operands
    max_arrive = np.ceil(arrival.max() / step.min())
    if max_arrive >= _INT32_MAX:
        raise _horizon_error(max_arrive)
    svc = np.asarray(trace.service_iters, np.int64)
    drain = int(max_arrive) + int(svc.sum()) + 1
    n_iters = drain if max_iters is None else min(int(max_iters), drain)
    if n_iters >= _INT32_MAX:
        raise ValueError(
            f"simulation horizon {n_iters} overflows int32; cap max_iters")
    with obs_trace.span("fleet.simulate", n=n, requests=r,
                        n_iters=n_iters, n_slots=n_slots, backend=route):
        if n_iters < 1:                   # a window of no iterations
            submit = np.full((n, r), -1, np.int64)
            comp = np.zeros((n, r), np.int64)
            active = np.zeros(n, np.int64)
        else:
            stamps = fleet_stamps(
                torch.from_numpy(step).to(dev),
                torch.from_numpy(arrival).to(dev),
                torch.from_numpy(svc).to(dev), n_slots, n_iters)
            submit, comp, active = (t.cpu().numpy() for t in stamps)
    res = FleetResult(trace=trace, n_slots=n_slots, n_iters=n_iters,
                      backend=route, step_s=step, e_token_j=e_tok,
                      submit_iter=submit, comp_iter=comp,
                      active_iters=active)
    reg = obs_metrics.get_registry()
    reg.inc("fleet.simulations")
    reg.inc("fleet.candidates", n)
    served = res.served
    if served.size:
        reg.set("fleet.served_frac", float(served.mean()))
        if obs_trace.is_enabled():
            # percentile math over (N, R) is not free: pay for the SLO
            # gauge only when telemetry is on
            reg.set("fleet.slo_attainment",
                    float(res.metrics()["slo_attainment"].mean()))
    return res


def simulate_fleet_scalar(step_s: float, e_token_j: float, traffic, *,
                          n_slots: int = 8,
                          max_iters: int | None = None) -> FleetResult:
    """Event-driven scalar reference for one candidate (copied).

    Walks requests in FIFO order, admitting each into the
    earliest-freeing slot (lowest index on ties, matching the batcher's
    slot-order ``_admit``).  Arrivals are sorted and a freed slot's next
    admission is never earlier than the previous one's, so FIFO order is
    preserved without an explicit queue.
    """
    trace = resolve_traffic(traffic)
    r = trace.n_requests
    svc = np.asarray(trace.service_iters, np.int64)
    step = np.asarray([step_s], np.float64)
    e_tok = np.asarray([e_token_j], np.float64)
    if r == 0:
        return simulate_fleet(step, e_tok, trace, n_slots=n_slots,
                              max_iters=max_iters, device="cpu")
    arrive = _arrival_iters(step, trace.arrival_s)[0]
    drain = int(arrive.max()) + int(svc.sum()) + 1
    n_iters = drain if max_iters is None else min(int(max_iters), drain)
    free_at = np.zeros(n_slots, np.int64)
    submit = np.full(r, -1, np.int64)
    comp = np.zeros(r, np.int64)
    busy_spans: list[tuple[int, int]] = []
    for i in range(r):
        slot = int(np.argmin(free_at))    # earliest free, lowest index
        start = max(int(arrive[i]), int(free_at[slot]))
        if start >= n_iters:
            break                         # horizon hit; rest never admitted
        submit[i] = start
        comp[i] = start + int(svc[i])
        free_at[slot] = comp[i]
        busy_spans.append((start, int(comp[i])))
    # active iterations = union of [start, end) spans clipped to horizon
    active = 0
    cur_s = cur_e = -1
    for s0, e0 in sorted(busy_spans):
        s0, e0 = s0, min(e0, n_iters)
        if s0 >= e0:
            continue
        if s0 > cur_e:
            active += cur_e - cur_s if cur_e > cur_s else 0
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    active += cur_e - cur_s if cur_e > cur_s else 0
    return FleetResult(trace=trace, n_slots=n_slots, n_iters=n_iters,
                       backend="scalar", step_s=step, e_token_j=e_tok,
                       submit_iter=submit[None, :], comp_iter=comp[None, :],
                       active_iters=np.asarray([active], np.int64))
