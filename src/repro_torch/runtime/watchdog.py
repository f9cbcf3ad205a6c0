"""Straggler detection and mitigation, and the serving decode-step
watchdog (copy of repro/runtime/watchdog.py).

Per-step wall times feed an EWMA; a host whose step exceeds
`threshold x EWMA` is flagged (StepWatchdog).  Mitigation is the caller's:
it may reassign the straggler's data shards to healthy hosts
(DataReassigner: the synthetic pipeline is keyed by (host, shard), so
reassignment is arithmetic) and, after `evict_after` consecutive flags,
ask for a re-mesh (`should_remesh`; the port's elastic re-mesh waits for
tensor parallelism).

DecodeStepWatchdog applies the same EWMA to the serving engine's steps:
per-step latency EWMA, stall detection (a step slower than
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


class StepWatchdog:
    """Training-side straggler detector: a global step-time EWMA and
    per-host flags; a host flagged `evict_after` steps in a row is evicted."""

    def __init__(self, cfg: WatchdogConfig = WatchdogConfig(), *,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.ewma: float | None = None
        self.steps = 0
        self._start: float | None = None
        self.flags: dict[int, int] = {}  # host -> consecutive flags
        self.evicted: set[int] = set()

    def step_start(self) -> None:
        self._start = self.clock()

    def step_end(self, *, host_times: dict[int, float] | None = None) -> list[int]:
        """Record one step; returns the hosts flagged in it.  `host_times`:
        each host's step duration (an all-gather of step times in a
        multi-host run; injected in tests).  Without them only the global
        EWMA updates."""
        if self._start is None:
            raise RuntimeError("step_end without step_start")
        dur = self.clock() - self._start
        self._start = None
        self.steps += 1
        if self.ewma is None:
            self.ewma = dur
        else:
            a = self.cfg.ewma_alpha
            self.ewma = a * dur + (1 - a) * self.ewma

        flagged = []
        if host_times and self.steps > self.cfg.warmup_steps:
            for host, t in host_times.items():
                if host in self.evicted:
                    continue
                if t > self.cfg.threshold * self.ewma:
                    self.flags[host] = self.flags.get(host, 0) + 1
                    flagged.append(host)
                    if self.flags[host] >= self.cfg.evict_after:
                        self.evicted.add(host)
                else:
                    self.flags[host] = 0
        return flagged

    def should_remesh(self) -> bool:
        return bool(self.evicted)


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


class DataReassigner:
    """Maps logical data shards to surviving hosts after eviction."""

    def __init__(self, num_hosts: int):
        self.num_hosts = num_hosts
        self.assignment = {h: [h] for h in range(num_hosts)}  # host -> shards

    def evict(self, host: int) -> None:
        if host not in self.assignment:
            return
        orphaned = self.assignment.pop(host)
        survivors = sorted(self.assignment)
        for i, shard in enumerate(orphaned):
            self.assignment[survivors[i % len(survivors)]].append(shard)

    def shards_for(self, host: int) -> list[int]:
        return sorted(self.assignment.get(host, []))
