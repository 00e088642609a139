"""Fault-tolerant runtime: restart loop, failure injection, straggler
detection.

Port of :mod:`repro.runtime.fault_tolerance`, the part the exploration
runtime (:mod:`repro_torch.runtime.dse_checkpoint`) stands on:

* failure injection raises :class:`InjectedFailure` at a chosen chunk or
  generation boundary to exercise the resume path deterministically;
* the straggler detector keeps an EWMA + variance of step wall-times and
  flags outliers, and re-baselines after a run of consecutive flags so a
  *permanent* distribution shift (slower hardware after resume, a
  migrated host) is adopted as the new normal;
* :func:`restart_loop` is the generic retry loop: a configurable
  retryable-exception set with exponential backoff between restarts.

The reference's ``run_with_restarts`` restarts its training loop from
pytree checkpoints; it waits for the training stack's port (ROADMAP A.8).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, TypeVar

T = TypeVar("T")


class InjectedFailure(RuntimeError):
    """Deterministic fault injection — raised at a chosen step / chunk /
    generation boundary to exercise the restart path."""


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.1
    threshold: float = 3.0        # flag if step > mean + threshold * std
    rebaseline_after: int = 8     # K consecutive flags => adopt new regime
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: int = 0
    consecutive_flags: int = 0
    rebaselines: int = 0

    def observe(self, dt: float) -> bool:
        self.n += 1
        if self.n == 1:
            self.mean = dt
            return False
        # test against the PRE-update statistics: the outlier must not
        # contaminate the baseline it is compared to
        sigma = max(self.var, 1e-12) ** 0.5
        is_straggler = self.n > 5 and \
            dt > self.mean + self.threshold * max(sigma, 0.1 * self.mean)
        delta = dt - self.mean
        if not is_straggler:       # robust EWMA: outliers don't pollute
            self.mean += self.alpha * delta
            self.var = (1 - self.alpha) * (self.var
                                           + self.alpha * delta ** 2)
            self.consecutive_flags = 0
        else:
            self.flagged += 1
            self.consecutive_flags += 1
            if self.consecutive_flags >= self.rebaseline_after:
                # K flags in a row is not K independent outliers — the
                # distribution shifted (e.g. slower hardware after a
                # resume).  Adopt the new level as the baseline and
                # restart the warm-up so flagging resumes only against
                # the new regime.
                self.mean = dt
                self.var = 0.0
                self.n = 1
                self.consecutive_flags = 0
                self.rebaselines += 1
        return is_straggler


def restart_loop(attempt: Callable[[], T], *,
                 max_restarts: int = 10,
                 retryable: tuple = (InjectedFailure,),
                 backoff_s: float = 0.0,
                 backoff_factor: float = 2.0,
                 max_backoff_s: float = 30.0,
                 on_restart: Callable[[int, BaseException], None]
                 | None = None) -> tuple[int, T]:
    """Run ``attempt()`` until it returns, restarting on ``retryable``
    exceptions with exponential backoff.

    Returns ``(restarts, result)``.  Exceptions outside ``retryable``
    propagate immediately; more than ``max_restarts`` retryable failures
    re-raise the last one.  ``backoff_s`` is the first sleep (0 disables
    sleeping entirely — the default, so tests and in-process resume stay
    instant); each restart multiplies it by ``backoff_factor`` up to
    ``max_backoff_s``.
    """
    retryable = tuple(retryable)
    restarts = 0
    while True:
        try:
            return restarts, attempt()
        except retryable as exc:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, exc)
            if backoff_s > 0:
                time.sleep(min(backoff_s * backoff_factor ** (restarts - 1),
                               max_backoff_s))
