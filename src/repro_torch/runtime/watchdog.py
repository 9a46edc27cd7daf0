"""Straggler watchdog: EWMA step-time tracking with slow-host detection.

In a synchronous data-parallel job every step runs at the pace of the
slowest participant.  The watchdog keeps an exponentially-weighted moving
average and flags steps exceeding `threshold`× the EWMA — the hook the
cluster layer uses to (a) log the event, (b) trigger the elastic path
(checkpoint + reshard without the slow host) when flags persist.

The streaming engine wires one of these around its double-buffered
dispatch (start at dispatch, stop at adjudication): a batch whose
dispatch->verdict time balloons past the EWMA threshold is a straggler
event, and a persistent streak (``should_reshard``) is treated like
eviction advice — the engine degrades to its fallback backend instead of
letting a sick fused path stall the stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 2.0
    alpha: float = 0.05
    warmup: int = 10
    # injectable time source (deterministic tests), like the guard's
    # injectable sleep_fn
    clock: Callable[[], float] = time.perf_counter

    ewma: float = 0.0
    n: int = 0
    slow_streak: int = 0
    events: int = 0
    _t0: Optional[float] = None
    _warm_total: float = 0.0

    def start(self):
        self._t0 = self.clock()

    def stop(self) -> bool:
        """Returns True when this step was a straggler event.

        A ``stop()`` with no interval open (never started, or already
        stopped) returns False without recording a step: the streaming
        engine calls stop defensively from resolution paths that may or
        may not own an open dispatch interval, and a phantom 0-duration
        sample would drag the EWMA toward zero and flag every real step.
        """
        if self._t0 is None:
            return False
        dt = self.clock() - self._t0
        self._t0 = None
        self.n += 1
        if self.n <= self.warmup:
            # true running mean over the warmup window — the previous
            # pairwise blend 0.5*(ewma+dt) weighted the latest warmup
            # step 2^-1, the one before 2^-2, ..., so one slow final
            # warmup step could poison the seed
            self._warm_total += dt
            self.ewma = self._warm_total / self.n
            return False
        slow = dt > self.threshold * self.ewma
        # slow steps do not pollute the EWMA
        if not slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
            self.slow_streak = 0
        else:
            self.events += 1
            self.slow_streak += 1
        return slow

    def should_reshard(self, streak: int = 5) -> bool:
        """Persistent slowness -> advise elastic reconfiguration."""
        return self.slow_streak >= streak
