"""Deterministic fault injection for the serving engine: the chaos layer
(counterpart of repro/serving/faults.py, kept as the port's own copy).

A `FaultSchedule` is a seeded list of `Fault`s that fire at exact engine
steps through the hooks `Engine(fault_hooks=...)` calls (on_step_begin,
pre_dispatch, corrupt_slots, held_pages), so the engine under test is the
engine in production.  The kinds:

  pool_spike       at step N, seize `pages` free pages for `hold` steps (an
                   exhaustion burst); Engine.audit counts them as held.
  kernel_fail      at step N, the next dispatch whose registry key matches
                   `key` (an fnmatch pattern, e.g. "attn|decode|*") raises
                   KernelFaultError; the engine quarantines the key and
                   retries on the demoted rung.
  nonfinite_logits at step N, request `uid`'s logit row is set to NaN after
                   the dispatch; the finite guard finishes that slot only.
  nonfinite_kv     at step N, request `uid`'s newest KV page or row is
                   poisoned (Engine.poison_slot_kv); its next logits trip
                   the guard.
  cancel           at step N, request `uid` is cancelled: where="begin"
                   between steps, "mid" after the dispatch is set up.
  clock_skew       at step N, the schedule's clock jumps `skew_s` seconds
                   (engines built with `clock=schedule.clock` see it).

Schedules round-trip through JSON (`to_json` / `from_json`), so the
committed schedules of tests/fault_schedules/ replay here as in the JAX
package; `FaultSchedule.random(seed, ...)` draws the same schedule from a
seed as the JAX generator does (the same np.random.RandomState draws, in
the same order).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import time
from typing import Callable

import numpy as np

FAULT_KINDS = (
    "pool_spike",
    "kernel_fail",
    "nonfinite_logits",
    "nonfinite_kv",
    "cancel",
    "clock_skew",
)


class KernelFaultError(RuntimeError):
    """A kernel dispatch failure raised by a fault hook, tagged with the
    registry key the engine should quarantine.  `shard` names the
    tensor-parallel shard the fault is local to, as in the JAX package; the
    port's engine serves one card (it refuses meshes), so it demotes the key
    itself and records the shard in stats["degraded"].  Real CUDA errors
    are not KernelFaultErrors and are never caught by the engine."""

    def __init__(self, key: str, message: str = "injected kernel fault",
                 *, shard: int | None = None):
        suffix = f" (shard {shard})" if shard is not None else ""
        super().__init__(f"{message}: {key}{suffix}")
        self.key = key
        self.shard = shard


@dataclasses.dataclass
class Fault:
    """One injection.  Only the fields its `kind` reads are meaningful."""

    step: int
    kind: str
    uid: int | None = None       # cancel / nonfinite_*: target request
    key: str | None = None       # kernel_fail: registry-key fnmatch pattern
    pages: int = 0               # pool_spike: pages to seize
    hold: int = 1                # pool_spike: steps to hold them
    skew_s: float = 0.0          # clock_skew: seconds to jump forward
    where: str = "begin"         # cancel: "begin" (step boundary) | "mid"
    shard: int | None = None     # kernel_fail: TP shard the fault is local to

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {FAULT_KINDS})")

    def to_dict(self) -> dict:
        out = {"step": self.step, "kind": self.kind}
        defaults = {f.name: f.default for f in dataclasses.fields(Fault)}
        for name in ("uid", "key", "pages", "hold", "skew_s", "where", "shard"):
            val = getattr(self, name)
            if val != defaults[name]:
                out[name] = val
        return out


class FaultSchedule:
    """A deterministic fault plan + the engine-hook implementation that fires
    it.  Pass one instance as `Engine(fault_hooks=schedule)`; drive the engine
    normally.  The schedule keeps its own step counter (one `on_step_begin`
    per engine step), an injection log (`log`), and the pages it is currently
    holding (`held`), which Engine.audit folds into the leak check."""

    def __init__(self, faults: list[Fault], *, seed: int = 0):
        self.faults = sorted(faults, key=lambda f: (f.step, f.kind))
        self.seed = seed
        self.step = -1            # becomes 0 on the first on_step_begin
        self.held: list[tuple[int, list[int]]] = []  # (release_step, pages)
        self.log: list[dict] = []
        self._skew_s = 0.0
        self._base_clock: Callable[[], float] = time.monotonic
        # kernel_fail faults armed for the current step (consumed on fire).
        self._armed_kernel: list[Fault] = []
        self._mid_cancels: list[Fault] = []

    # -- construction / persistence ------------------------------------------

    @classmethod
    def from_dicts(cls, dicts: list[dict], *, seed: int = 0) -> "FaultSchedule":
        return cls([Fault(**d) for d in dicts], seed=seed)

    @classmethod
    def from_json(cls, path: str) -> "FaultSchedule":
        with open(path) as f:
            raw = json.load(f)
        return cls.from_dicts(raw.get("faults", []), seed=int(raw.get("seed", 0)))

    def to_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(
                {"seed": self.seed, "faults": [x.to_dict() for x in self.faults]},
                f, indent=2,
            )
            f.write("\n")
        return path

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        steps: int,
        uids: list[int],
        kinds: tuple[str, ...] = FAULT_KINDS,
        n_faults: int = 6,
        key_pattern: str = "attn|decode|*",
    ) -> "FaultSchedule":
        """Seeded adversarial schedule over the given step/uid ranges — the
        generator the committed schedules came from."""
        rng = np.random.RandomState(seed)
        faults = []
        for _ in range(n_faults):
            kind = kinds[int(rng.randint(len(kinds)))]
            step = int(rng.randint(1, max(2, steps)))
            if kind == "pool_spike":
                faults.append(Fault(step, kind, pages=int(rng.randint(1, 4)),
                                    hold=int(rng.randint(1, 4))))
            elif kind == "kernel_fail":
                faults.append(Fault(step, kind, key=key_pattern))
            elif kind in ("nonfinite_logits", "nonfinite_kv", "cancel"):
                uid = int(uids[int(rng.randint(len(uids)))])
                where = "mid" if kind == "cancel" and rng.rand() < 0.5 else "begin"
                faults.append(Fault(step, kind, uid=uid, where=where))
            else:  # clock_skew
                faults.append(Fault(step, kind, skew_s=float(rng.uniform(0.5, 5.0))))
        return cls(faults, seed=seed)

    # -- the injectable clock -------------------------------------------------

    def clock(self) -> float:
        """Monotonic clock plus every clock_skew fired so far.  Build the
        engine with `clock=schedule.clock` so deadlines and the watchdog see
        the skew."""
        return self._base_clock() + self._skew_s

    # -- engine hooks ---------------------------------------------------------

    def _find_request(self, engine, uid: int):
        """(slot_or_None, request_or_None) for a uid still in flight."""
        for s, req in enumerate(engine.slot_req):
            if req is not None and req.uid == uid:
                return s, req
        for req in engine.queue:
            if req.uid == uid:
                return None, req
        return None, None

    def on_step_begin(self, engine) -> None:
        """Called once at the top of every Engine.step, before admission."""
        self.step += 1
        # Release expired pool seizures first: even a livelocked engine
        # (nothing admissible while pages are held) keeps stepping, so the
        # release below is what bounds every pool_spike's blast radius.
        still = []
        for release_step, pages in self.held:
            if self.step >= release_step:
                engine.alloc.free_pages(pages)
                self.log.append({"step": self.step, "kind": "pool_release",
                                 "pages": len(pages)})
            else:
                still.append((release_step, pages))
        self.held = still
        self._armed_kernel = []
        self._mid_cancels = []
        for fault in self.faults:
            if fault.step != self.step:
                continue
            if fault.kind == "pool_spike" and engine.cache_mode == "paged":
                got = []
                for _ in range(fault.pages):
                    page = engine.alloc.alloc()
                    if page is None:
                        break
                    got.append(page)
                if got:
                    self.held.append((self.step + max(1, fault.hold), got))
                self.log.append({"step": self.step, "kind": fault.kind,
                                 "pages": len(got), "hold": fault.hold})
            elif fault.kind == "kernel_fail":
                self._armed_kernel.append(fault)
            elif fault.kind == "cancel":
                if fault.where == "mid":
                    self._mid_cancels.append(fault)
                else:
                    _, req = self._find_request(engine, fault.uid)
                    if req is not None:
                        req.cancel()
                        self.log.append({"step": self.step, "kind": fault.kind,
                                         "uid": fault.uid, "where": "begin"})
            elif fault.kind == "nonfinite_kv":
                slot, req = self._find_request(engine, fault.uid)
                if slot is not None:
                    engine.poison_slot_kv(slot)
                    self.log.append({"step": self.step, "kind": fault.kind,
                                     "uid": fault.uid, "slot": slot})
            elif fault.kind == "clock_skew":
                self._skew_s += fault.skew_s
                self.log.append({"step": self.step, "kind": fault.kind,
                                 "skew_s": fault.skew_s})
            # nonfinite_logits fires in corrupt_slots (post-dispatch).

    def pre_dispatch(self, engine, kind: str, keys: tuple[str, ...]) -> None:
        """Called immediately before each model dispatch (kind: "prefill" |
        "decode" | "verify"; keys: the registry keys the dispatch resolves
        through).  Raises KernelFaultError to simulate a kernel crash; also
        lands "mid" cancels so the flag is set while the window is in
        flight."""
        for fault in self._mid_cancels:
            _, req = self._find_request(engine, fault.uid)
            if req is not None and not req.cancel_requested:
                req.cancel()
                self.log.append({"step": self.step, "kind": "cancel",
                                 "uid": fault.uid, "where": "mid",
                                 "dispatch": kind})
        for fault in list(self._armed_kernel):
            for key in keys:
                if fnmatch.fnmatch(key, fault.key or "*"):
                    self._armed_kernel.remove(fault)
                    entry = {"step": self.step, "kind": "kernel_fail",
                             "key": key, "dispatch": kind}
                    if fault.shard is not None:
                        entry["shard"] = fault.shard
                    self.log.append(entry)
                    raise KernelFaultError(key, shard=fault.shard)

    def corrupt_slots(self, engine, active: list[int]) -> list[int]:
        """Called after a decode/verify dispatch with the active slot list;
        returns the slots whose logits this step's nonfinite_logits faults
        poison.  The engine NaNs those rows before its finite guard runs, so
        the guard is exercised on real non-finite data."""
        out = []
        for fault in self.faults:
            if fault.step != self.step or fault.kind != "nonfinite_logits":
                continue
            slot, _ = self._find_request(engine, fault.uid)
            if slot is not None and slot in active:
                out.append(slot)
                self.log.append({"step": self.step, "kind": fault.kind,
                                 "uid": fault.uid, "slot": slot})
        return out

    def held_pages(self) -> list[int]:
        """Pages currently seized by pool_spike faults — Engine.audit counts
        them as referenced so the exact-leak check keeps holding."""
        return [p for _, pages in self.held for p in pages]

    def drain(self, engine) -> None:
        """Return any still-held pages (schedules that outlive the stream)."""
        for _, pages in self.held:
            engine.alloc.free_pages(pages)
        self.held = []
