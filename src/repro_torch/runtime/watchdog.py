"""Straggler detection: per-step wall-time monitoring.

SPMD steps are lockstep, so one slow host slows the fleet; the watchdog
tracks a robust (median/MAD) step-time baseline and raises a structured
``StragglerAlert`` when recent steps breach it persistently. The training
driver responds per policy: log, checkpoint-and-rescale (drop the slow
host via the elastic planner), or abort for the scheduler to replace the
node. Hook points are callbacks so the policy is deployment-specific.

Counterpart of ``repro.runtime.watchdog``, a copy: the step clock is
``time.monotonic`` (tests replace it with a fake clock).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Optional


@dataclasses.dataclass
class StragglerAlert:
    step: int
    step_time_s: float
    baseline_s: float
    ratio: float


class StepWatchdog:
    """Call ``start()``/``stop(step)`` around each step."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 patience: int = 3,
                 on_alert: Optional[Callable[[StragglerAlert], None]] = None):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self.on_alert = on_alert
        self.times: Deque[float] = deque(maxlen=window)
        self._t0: Optional[float] = None
        self._breaches = 0
        self.alerts: list[StragglerAlert] = []

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> Optional[StragglerAlert]:
        assert self._t0 is not None, "stop() without start()"
        dt = time.monotonic() - self._t0
        self._t0 = None
        alert = None
        if len(self.times) >= max(5, self.window // 5):
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.threshold * med:
                self._breaches += 1
                if self._breaches >= self.patience:
                    alert = StragglerAlert(step=step, step_time_s=dt,
                                           baseline_s=med,
                                           ratio=dt / med)
                    self.alerts.append(alert)
                    if self.on_alert:
                        self.on_alert(alert)
                    self._breaches = 0
            else:
                self._breaches = 0
        self.times.append(dt)
        return alert

    @property
    def median_step_s(self) -> float:
        if not self.times:
            return 0.0
        return sorted(self.times)[len(self.times) // 2]
