"""Fault tolerance & straggler mitigation.

Components:
* ``StepWatchdog`` — per-step wall-time tracker with robust outlier detection
  (median + k*MAD).  On a real pod each host reports step times through the
  coordination service; a host flagged as a persistent straggler triggers the
  mitigation policy below.  On one host it still guards against livelock
  (e.g. a wedged data loader) via the hard timeout.
* ``FailureInjector`` — deterministic fault injection for tests/examples:
  raises ``InjectedFailure`` at a configured step so the restart path
  (checkpoint -> auto-resume -> identical loss curve) is exercised end-to-end.
* ``run_with_restarts`` — supervisor loop: run the train function, on failure
  restore from the latest checkpoint and continue, up to ``max_restarts``.

Straggler policy at pod scale (documented contract, enforced by the watchdog
callbacks): (1) flag a host when its step time exceeds median + 6*MAD for 3
consecutive steps; (2) first mitigation is data-reshard-away (skip its input
shard for the next window, covered by the deterministic pipeline); (3) second
is hot-spare swap: the job restarts from the last checkpoint on the standby
slice — identical semantics to the failure path below, which is why the two
share an implementation.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable


class InjectedFailure(RuntimeError):
    pass


@dataclass
class StepWatchdog:
    mad_k: float = 6.0
    window: int = 50
    consecutive: int = 3
    hard_timeout_s: float = 3600.0
    _times: list = field(default_factory=list)
    _flags: int = 0
    stragglers_detected: int = 0

    def observe(self, step_time_s: float) -> bool:
        """Record one step; returns True if this step is a straggler event."""
        self._times.append(step_time_s)
        if len(self._times) > self.window:
            self._times.pop(0)
        if step_time_s > self.hard_timeout_s:
            self.stragglers_detected += 1
            return True
        if len(self._times) < 10:
            return False
        med = statistics.median(self._times)
        mad = statistics.median(abs(t - med) for t in self._times) or 1e-9
        if step_time_s > med + self.mad_k * mad and step_time_s > 1.5 * med:
            self._flags += 1
        else:
            self._flags = 0
        if self._flags >= self.consecutive:
            self._flags = 0
            self.stragglers_detected += 1
            return True
        return False


@dataclass
class FailureInjector:
    fail_at_step: int = -1
    fail_once: bool = True
    _fired: bool = False

    def maybe_fail(self, step: int) -> None:
        if step == self.fail_at_step and not (self.fail_once and self._fired):
            self._fired = True
            raise InjectedFailure(f"injected failure at step {step}")


def run_with_restarts(train_once: Callable[[], None], *,
                      max_restarts: int = 3,
                      on_restart: Callable[[int, Exception], None] | None = None
                      ) -> int:
    """Supervisor: call `train_once` (which auto-resumes from the latest
    checkpoint internally); restart on failure. Returns #restarts used."""
    restarts = 0
    while True:
        try:
            train_once()
            return restarts
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — any failure triggers restart
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart:
                on_restart(restarts, e)
