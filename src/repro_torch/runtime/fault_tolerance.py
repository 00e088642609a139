"""Fault-tolerant runtime: restart loop, failure injection, straggler
detection.

Port of :mod:`repro.runtime.fault_tolerance`:

* :func:`run_with_restarts` resumes the training loop from the newest
  *valid* checkpoint (:mod:`repro_torch.checkpoint.checkpoint`) and
  replays the data cursor, giving a run equal bit for bit to an
  uninterrupted one.  On a mesh of several ranks every rank runs the
  loop: a placed state's checkpoint is published before the ranks meet
  (``checkpoint.save``), so each rank restores the same step, and an
  injected failure fires on every rank at the top of the same step,
  before any of its collectives;
* failure injection raises :class:`InjectedFailure` at a chosen step,
  chunk or generation boundary to exercise that path deterministically;
* the straggler detector keeps an EWMA + variance of step wall-times and
  flags outliers, and re-baselines after a run of consecutive flags so a
  *permanent* distribution shift (slower hardware after resume, a
  migrated host) is adopted as the new normal;
* :func:`restart_loop` is the generic retry loop shared with the
  exploration runtime (:mod:`repro_torch.runtime.dse_checkpoint`): a
  configurable retryable-exception set with exponential backoff between
  restarts.  Only the exceptions named restart; an error of the device
  is never among the defaults.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, TypeVar

from repro_torch.checkpoint import checkpoint as ckpt_lib

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


@dataclasses.dataclass
class TrainLoopResult:
    final_step: int
    restarts: int
    losses: list
    straggler_flags: int


def run_with_restarts(
    *,
    init_state: Callable[[], dict],
    train_step: Callable[[dict, dict], tuple],   # (state, batch) -> (state, loss)
    data_batch: Callable[[int], dict],
    total_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    fail_at: dict[int, int] | None = None,       # {step: n_times_to_fail}
    max_restarts: int = 10,
    retryable: tuple = (InjectedFailure,),
    backoff_s: float = 0.0,
    backoff_factor: float = 2.0,
    max_backoff_s: float = 30.0,
) -> TrainLoopResult:
    """Checkpoint/restart driver, the reference's step for step.

    Each attempt builds ``init_state()``, restores the newest valid
    checkpoint into it and runs from the step after; a checkpoint is
    saved every ``ckpt_every`` steps and at the last.  ``losses`` keeps
    ``(step, loss)`` of every step run, so the steps a restart replays
    appear twice (ROADMAP C.14).  The straggler detector reads the host's
    clock around ``train_step``, before ``float(loss)`` waits for the
    device.  ``retryable`` names the exceptions that restart from the
    checkpoint (anything else propagates); ``backoff_s`` /
    ``backoff_factor`` / ``max_backoff_s`` space the restarts.
    """
    fail_at = dict(fail_at or {})
    losses: list = []
    detector = StragglerDetector()

    def attempt() -> int:
        state = init_state()
        step, restored = ckpt_lib.restore_latest(ckpt_dir, state)
        if restored is not None:
            state = restored
            start = int(step) + 1
        else:
            start = 0
        for s in range(start, total_steps):
            if fail_at.get(s, 0) > 0:
                fail_at[s] -= 1
                raise InjectedFailure(f"injected failure at step {s}")
            t0 = time.monotonic()
            state, loss = train_step(state, data_batch(s))
            detector.observe(time.monotonic() - t0)
            losses.append((s, float(loss)))
            if (s + 1) % ckpt_every == 0 or s == total_steps - 1:
                ckpt_lib.save(ckpt_dir, s, state)
        return total_steps - 1

    restarts, final_step = restart_loop(
        attempt, max_restarts=max_restarts, retryable=retryable,
        backoff_s=backoff_s, backoff_factor=backoff_factor,
        max_backoff_s=max_backoff_s)
    return TrainLoopResult(final_step=final_step, restarts=restarts,
                           losses=losses,
                           straggler_flags=detector.flagged)
