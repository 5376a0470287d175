"""Straggler watchdog: EWMA step-time tracking + slow-step flagging (the
port's copy of the reference's ``runtime/watchdog.py``; the supervisor
feeds it heartbeat round-trips).

At 1000+-node scale a single slow host gates every synchronous step.  The
watchdog tracks an EWMA of step wall-time; steps exceeding ``threshold x``
the EWMA are flagged.  The runner's policy hooks:
  - log + count (always),
  - replay the step's data (free: stateless pipeline),
  - after ``evict_after`` consecutive flags, signal the launcher to
    reconfigure onto a spare slice (mesh is a constructor argument
    everywhere, so re-instantiating is a restart with a new mesh +
    elastic checkpoint restore).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class StragglerWatchdog:
    threshold: float = 3.0
    alpha: float = 0.2
    evict_after: int = 5
    ewma_s: float | None = None
    flagged_steps: list[int] = field(default_factory=list)
    consecutive: int = 0
    _t0: float = 0.0

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        """Returns True if this step was a straggler."""
        dt = time.monotonic() - self._t0
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma_s is None:
            self.ewma_s = dt
            return False
        slow = dt > self.threshold * self.ewma_s
        if slow:
            self.flagged_steps.append(step)
            self.consecutive += 1
        else:
            self.consecutive = 0
            # only fold healthy steps into the EWMA
            self.ewma_s = (1 - self.alpha) * self.ewma_s + self.alpha * dt
        return slow

    @property
    def should_evict(self) -> bool:
        return self.consecutive >= self.evict_after
