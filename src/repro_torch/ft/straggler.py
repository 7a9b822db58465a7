"""Straggler detection for the training loop: EWMA of step wall-times with a
multiplicative deadline; slow steps are flagged and a configurable action
fires (log, checkpoint-now, or re-plan trigger). Pure bookkeeping — unit
testable without hardware."""

from __future__ import annotations

import dataclasses
import time

__all__ = ["StragglerMonitor"]


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0      # step slower than threshold * EWMA == straggler
    alpha: float = 0.1
    warmup_steps: int = 5

    ewma: float = 0.0
    n: int = 0
    flagged: int = 0
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> tuple[float, bool]:
        """Returns (duration, is_straggler)."""
        dur = time.perf_counter() - self._t0
        return self.observe(dur)

    def observe(self, dur: float) -> tuple[float, bool]:
        self.n += 1
        if self.n <= self.warmup_steps:
            self.ewma = dur if self.ewma == 0 else \
                (1 - self.alpha) * self.ewma + self.alpha * dur
            return dur, False
        slow = dur > self.threshold * self.ewma
        if slow:
            self.flagged += 1
        else:  # stragglers don't poison the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dur
        return dur, slow
