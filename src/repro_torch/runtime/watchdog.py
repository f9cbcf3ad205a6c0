"""Serving decode-step watchdog (copy of the serving half of
repro/runtime/watchdog.py; the training straggler detector waits for the
training slice).

Per-step latency EWMA, stall detection (a step slower than
`threshold x EWMA` after warmup), and p50/p99 over a bounded window of
recent steps, merged into Engine.stats["watchdog"].  The clock is
injectable so tests drive it deterministically.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class WatchdogConfig:
    ewma_alpha: float = 0.2
    threshold: float = 2.5
    warmup_steps: int = 5
    evict_after: int = 3


class DecodeStepWatchdog:
    """Serving-side step watchdog: EWMA + stall flags + latency percentiles.

    One instance per Engine.  `step_start()` / `step_end()` bracket each
    engine step (step_end is exception-safe via try/finally in the engine
    loop); `summary()` is merged into Engine.stats["watchdog"].  `window`
    bounds the percentile buffer so a long-lived engine never grows state.
    """

    def __init__(
        self,
        cfg: WatchdogConfig = WatchdogConfig(),
        *,
        clock: Callable[[], float] = time.monotonic,
        window: int = 512,
    ):
        self.cfg = cfg
        self.clock = clock
        self.ewma: float | None = None
        self.steps = 0
        self.stalls = 0
        self.last_stalled = False
        self.last_duration: float = 0.0
        self._start: float | None = None
        self._recent: collections.deque[float] = collections.deque(maxlen=window)

    def step_start(self) -> None:
        self._start = self.clock()

    def step_end(self) -> bool:
        """Record one step; returns True when this step counts as a stall
        (post-warmup step slower than threshold x the running EWMA)."""
        if self._start is None:
            return False  # step_start never ran (exception before the bracket)
        dur = max(self.clock() - self._start, 0.0)
        self._start = None
        self.steps += 1
        self.last_duration = dur
        self._recent.append(dur)
        stalled = (
            self.steps > self.cfg.warmup_steps
            and self.ewma is not None
            and dur > self.cfg.threshold * self.ewma
        )
        if stalled:
            self.stalls += 1
            # A stall is an outlier by definition: folding it into the EWMA
            # at full weight would teach the watchdog that stalls are normal.
            # Clamp the sample to the flag threshold before updating.
            dur = self.cfg.threshold * self.ewma
        self.last_stalled = bool(stalled)
        if self.ewma is None:
            self.ewma = dur
        else:
            a = self.cfg.ewma_alpha
            self.ewma = a * dur + (1 - a) * self.ewma
        return bool(stalled)

    def percentile(self, q: float) -> float:
        if not self._recent:
            return 0.0
        return float(np.percentile(np.asarray(self._recent), q))

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "ewma_ms": 1e3 * (self.ewma or 0.0),
            "last_ms": 1e3 * self.last_duration,
            "p50_ms": 1e3 * self.percentile(50),
            "p99_ms": 1e3 * self.percentile(99),
            "stalls": self.stalls,
            "stalled": self.last_stalled,
        }
