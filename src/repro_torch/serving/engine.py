"""Serving engine for the phase-split paged path (counterpart of
repro/serving/engine.py: Engine with EngineConfig defaults).

Slot-based continuous batching with the paged KV cache: admission charges
only the pages a prompt needs, a radix prefix cache shares full prompt
blocks across requests (serving/paged.py), and a request whose leading
blocks are all cached prefills only its suffix.  Prefill runs one
right-padded batch into a temporary dense cache and scatters the computed
blocks into the pool pages in place.  Decode is vectorized: one dispatch per
step serves every slot at its own position; the first decode step of a
request recomputes the last prompt token (its logits give the first
generated token), exactly as in the JAX engine.  Decode growth preempts the
latest-admitted slot when the pool is dry (its request replays; greedy
decode makes the replay identical).

Lifecycle: bounded admission queue with structured Rejected results,
deadlines and cancel at step boundaries, a non-finite logits guard that
finishes only the offending slot, and kernel quarantine: a dispatch whose
fault hook raises KernelFaultError demotes that registry key for the rest of
the process and retries on the next rung.  Real CUDA errors propagate.

Not in this slice (each raises NotImplementedError at construction, naming
its ROADMAP slice): speculative decode, the token budget, the dense cache,
temperature sampling, kv8/kv4 pools, meshes larger than one card, quantized
weights, and more than 8 slots under the kernel backends.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.encoding import Phase
from repro_torch.core.packed import EncodingConfig
from repro_torch.kernels import registry as registry_lib
from repro_torch.models import transformer as T
from repro_torch.runtime import watchdog as watchdog_lib
from repro_torch.serving import faults as faults_lib
from repro_torch.serving import paged as paged_lib
from repro_torch.serving.config import EngineConfig

_NEXT_SLICE = "ROADMAP, next slice: mmt4d_pallas with spec decode and the token-budget mixed step"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray        # (S,) int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # Decode finishes the slot early when this token is emitted (the EOS
    # itself is kept in `generated`).
    eos_id: int | None = None
    # Wall-clock budget from submit() to last token, in ms of the engine's
    # (injectable) clock; checked at step boundaries.
    deadline_ms: float | None = None
    status: str = "queued"
    error: str | None = None
    cancel_requested: bool = False
    submit_t: float | None = None
    # Tenant for per-tenant page-quota accounting (EngineConfig.tenant_quota).
    tenant: str = "default"

    def cancel(self) -> None:
        """Ask the engine to drop this request at the next step boundary (and
        again at commit time)."""
        self.cancel_requested = True


@dataclasses.dataclass(frozen=True)
class Admitted:
    uid: int

    def __bool__(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Rejected:
    """submit() refused the request: "queue_full" | "unserviceable_seq" |
    "unserviceable_pool" | "unserviceable_quota"."""

    uid: int
    reason: str
    detail: str = ""

    def __bool__(self) -> bool:
        return False


def _check_supported(config: EngineConfig, enc: EncodingConfig) -> None:
    todo = []
    if config.spec_decode:
        todo.append(f"spec_decode ({_NEXT_SLICE})")
    if config.token_budget is not None:
        todo.append(f"token_budget ({_NEXT_SLICE})")
    if config.cache_mode != "paged" or config.decode_mode != "vectorized":
        todo.append("the dense cache / grouped decode (ROADMAP: dense cache with "
                    "dense_decode_attention)")
    if config.sample != "greedy":
        todo.append("temperature sampling (ROADMAP: dense cache slice)")
    if config.kv_quant != "bf16":
        todo.append(f"kv_quant={config.kv_quant} (ROADMAP: quantized weights and KV)")
    if config.mesh_devices > 1:
        todo.append("mesh_shape > 1 (ROADMAP: tensor parallelism)")
    if enc.weight_quant != "none":
        todo.append(f"weight_quant={enc.weight_quant} (ROADMAP: quantized weights and KV)")
    decode = registry_lib.select(quant="none", phase=Phase.DECODE, m=config.slots,
                                 target=enc.target, requested=enc.resolved_backend())
    if decode.backend == "pallas":
        todo.append(f"slots={config.slots} > 8 under backend={enc.backend} ({_NEXT_SLICE})")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


class Engine:
    """Slot-based continuous batching on a fixed decode batch, paged cache.

    Engine(params, cfg, enc, config=EngineConfig(...), device="cuda"); the
    legacy keyword form Engine(params, cfg, enc, slots=4, ...) folds into
    EngineConfig(**kwargs) as in the JAX package.  `clock` (seconds) drives
    deadlines and the watchdog; `fault_hooks` is an object with
    on_step_begin, pre_dispatch and corrupt_slots (and optionally
    held_pages), the JAX package's injection points; `stream_cb(req, token)`
    sees every committed token.
    """

    def __init__(
        self,
        params: dict,
        cfg,
        enc: EncodingConfig,
        config: EngineConfig | None = None,
        *,
        device: torch.device | str = "cuda",
        clock: Callable[[], float] | None = None,
        fault_hooks=None,
        stream_cb: Callable[[Request, int], None] | None = None,
        **kwargs,
    ):
        if config is None:
            config = EngineConfig(**kwargs)
        elif kwargs:
            raise TypeError(
                "pass either config=EngineConfig(...) or the legacy engine "
                f"kwargs, not both (got extra kwargs: {sorted(kwargs)})"
            )
        config = config.resolve(cfg)
        _check_supported(config, enc)
        self.config = config
        self.device = T.resolve_device(device)
        self.params = params
        self.cfg, self.enc = cfg, enc
        self.slots = config.slots
        self.max_seq = config.max_seq
        self.max_queue = config.max_queue
        self.clock = clock if clock is not None else time.monotonic
        self.hooks = fault_hooks
        self.stream_cb = stream_cb
        self.logits_guard = bool(config.logits_guard)
        self.watchdog = watchdog_lib.DecodeStepWatchdog(clock=self.clock)
        self.rejected: list[Request] = []
        self.degraded: list[dict] = []
        self.lifecycle = {
            "rejected": 0, "cancelled": 0, "expired": 0,
            "kernel_faults": 0, "guard_trips": 0,
        }
        self.step_count = 0
        # Dispatches run per kind ("prefill" counts batched and suffix
        # prefills): each runs every layer once, so kernel launches on the
        # main path are these counts times layers times projections.
        self.dispatches: collections.Counter[str] = collections.Counter()

        self.block_size = config.block_size
        self.num_blocks = -(-self.max_seq // self.block_size)
        pool_pages = config.pool_pages
        if pool_pages is None:
            pool_pages = 1 + self.slots * self.num_blocks  # dense worst case
        self.prefix_cache = bool(config.prefix_cache)
        self.tenant_quota = config.tenant_quota
        self.alloc = paged_lib.BlockAllocator(
            pool_pages, self.block_size, "bf16",
            prefix_cache=self.prefix_cache, tenant_quota=self.tenant_quota,
        )
        self.caches = T.cache_init(
            cfg, self.slots, self.max_seq, cache_mode="paged",
            block_size=self.block_size, num_pages=pool_pages, device=self.device,
        )
        self.block_table = np.full(
            (self.slots, self.num_blocks), paged_lib.SCRATCH_PAGE, np.int32
        )
        self.slot_pages: list[list[int]] = [[] for _ in range(self.slots)]
        self._tenant_reserved: dict[str, int] = {}
        self.slot_ticket = np.zeros(self.slots, np.int64)
        self._ticket = 0
        self._tables_dirty = True
        self.preemptions = 0
        self.peak_active = 0
        self.slot_req: list[Request | None] = [None] * self.slots
        self.slot_pos = np.zeros(self.slots, np.int32)
        self.queue: collections.deque[Request] = collections.deque()
        self.finished: list[Request] = []

    # ---- submission / quotas ------------------------------------------------

    def _reject(self, req: Request, reason: str, detail: str) -> Rejected:
        req.status = "rejected"
        req.error = detail
        req.done = True
        self.rejected.append(req)
        self.lifecycle["rejected"] += 1
        return Rejected(req.uid, reason, detail)

    def submit(self, req: Request) -> Admitted | Rejected:
        """Queue `req`, or refuse it: queue full, or a request that could
        never fit the cache, the pool or its tenant's quota."""
        req.submit_t = self.clock()
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return self._reject(
                req, "queue_full",
                f"admission queue at max_queue={self.max_queue}; retry later",
            )
        if len(req.prompt) > self.max_seq:
            return self._reject(
                req, "unserviceable_seq",
                f"prompt of {len(req.prompt)} tokens exceeds max_seq {self.max_seq}",
            )
        if req.max_new_tokens > 0:
            worst = self._worst_pages(req)
            if worst > self.alloc.capacity:
                return self._reject(
                    req, "unserviceable_pool",
                    f"request can need {worst} pages but the pool holds "
                    f"{self.alloc.capacity}; grow pool_pages or shrink the request",
                )
            if self.tenant_quota is not None and worst > self.tenant_quota:
                return self._reject(
                    req, "unserviceable_quota",
                    f"request can need {worst} pages but tenant {req.tenant!r} "
                    f"is capped at {self.tenant_quota}; raise tenant_quota or "
                    "shrink the request",
                )
        self.queue.append(req)
        return Admitted(req.uid)

    def _worst_pages(self, req: Request) -> int:
        worst_pos = min(len(req.prompt) + req.max_new_tokens, self.max_seq) - 1
        return worst_pos // self.block_size + 1

    def _quota_blocked(self, req: Request) -> bool:
        if self.tenant_quota is None:
            return False
        reserved = self._tenant_reserved.get(req.tenant, 0)
        return reserved + self._worst_pages(req) > self.tenant_quota

    def _reserve_quota(self, req: Request) -> None:
        if self.tenant_quota is None:
            return
        pages = self._worst_pages(req)
        req._quota_pages = pages
        self._tenant_reserved[req.tenant] = self._tenant_reserved.get(req.tenant, 0) + pages

    def _release_quota(self, req: Request) -> None:
        pages = getattr(req, "_quota_pages", 0)
        if self.tenant_quota is None or not pages:
            return
        req._quota_pages = 0
        left = self._tenant_reserved.get(req.tenant, 0) - pages
        if left > 0:
            self._tenant_reserved[req.tenant] = left
        else:
            self._tenant_reserved.pop(req.tenant, None)

    # ---- dispatches -----------------------------------------------------------

    def _prefill(self, tokens: torch.Tensor, caches: dict, pos: int = 0) -> None:
        """Prefill `tokens` at offset `pos` into the temporary dense `caches`.
        Serving prefill logits are not used (the first decode step recomputes
        the last prompt token), as in the JAX engine."""
        T.forward(self.params, tokens, cfg=self.cfg, enc=self.enc, phase=Phase.PREFILL,
                  caches=caches, pos=pos, last_logits_only=True)

    def _decode(self, tokens: torch.Tensor, pos: torch.Tensor):
        """One greedy token for every slot: (next (B,) int, logits (B, V))."""
        logits = T.forward(self.params, tokens, cfg=self.cfg, enc=self.enc,
                           phase=Phase.DECODE, caches=self.caches, pos=pos)[:, -1]
        return torch.argmax(logits, dim=-1), logits

    def _attn_s(self, phase: Phase) -> int:
        """The logical KV length the next dispatch of `phase` attends."""
        if phase is Phase.PREFILL:
            return self.max_seq
        return self._live_table_width() * self.block_size

    def _dispatch_keys(self, kind: str) -> tuple[str, str]:
        """Registry keys the imminent dispatch resolves through (what
        pre_dispatch faults match and what a quarantine demotes)."""
        phase = Phase.PREFILL if kind == "prefill" else Phase.DECODE
        target = self.enc.target.name
        m = self.slots * self.max_seq if kind == "prefill" else self.slots
        return (
            registry_lib.attn_dispatch_key(phase, self._attn_s(phase), target),
            registry_lib.dispatch_key("none", phase, m, target),
        )

    def _requested_for(self, key: str) -> str | None:
        if key.startswith(registry_lib.ATTN_OP + "|"):
            return self.enc.attn_backend
        return self.enc.resolved_backend()

    def _quarantine_kernel(self, key: str, reason: str) -> dict:
        """Demote `key` to the next rung of its ladder for the rest of the
        process and record it in stats["degraded"].  The model consults the
        registry on every call, so the next dispatch runs the demoted rung."""
        requested = self._requested_for(key)
        before = registry_lib.resolve_key(key, requested=requested)
        record = registry_lib.demote(key, failing=before.backend, reason=reason,
                                     requested=requested)
        entry = {"key": key, "step": self.step_count, **record}
        self.degraded.append(entry)
        self.lifecycle["kernel_faults"] += 1
        return entry

    def _dispatch(self, kind: str, fn: Callable, *args):
        """Run one dispatch through the fault/quarantine boundary.  Only the
        fault hooks' KernelFaultError is caught (and retried on the demoted
        rung, bounded by the ladder depth); any other error propagates."""
        for _attempt in range(4):
            keys = self._dispatch_keys(kind)
            try:
                if self.hooks is not None:
                    self.hooks.pre_dispatch(self, kind, keys)
            except faults_lib.KernelFaultError as exc:
                self._quarantine_kernel(exc.key, reason=str(exc))
                continue
            self.dispatches[kind] += 1
            return fn(*args)
        raise faults_lib.KernelFaultError(
            keys[0], "kernel dispatch still failing at the fallback rung"
        )

    # ---- lifecycle --------------------------------------------------------------

    def _past_deadline(self, req: Request) -> bool:
        return (
            req.deadline_ms is not None
            and req.submit_t is not None
            and (self.clock() - req.submit_t) * 1e3 > req.deadline_ms
        )

    def _finish_queued(self, req: Request, status: str, error: str | None) -> None:
        req.done = True
        req.status = status
        req.error = error
        self.finished.append(req)
        self.lifecycle[status] = self.lifecycle.get(status, 0) + 1

    def _admission_reap(self, req: Request) -> None:
        """A cancel or deadline that lapsed between the step-boundary sweep
        and admission (caller has popped `req`)."""
        if req.cancel_requested:
            self._finish_queued(req, "cancelled", "cancelled while queued")
        else:
            self._finish_queued(
                req, "expired", f"deadline_ms={req.deadline_ms} exceeded at admission"
            )

    def _reap_lifecycle(self) -> None:
        """Step-boundary sweep: cancelled and expired requests finish now,
        running slots through _finish_slot so pages free exactly."""
        if self.queue and any(r.cancel_requested or self._past_deadline(r) for r in self.queue):
            kept: collections.deque[Request] = collections.deque()
            for req in self.queue:
                if req.cancel_requested:
                    self._finish_queued(req, "cancelled", "cancelled while queued")
                elif self._past_deadline(req):
                    self._finish_queued(
                        req, "expired",
                        f"deadline_ms={req.deadline_ms} exceeded while queued",
                    )
                else:
                    kept.append(req)
            self.queue = kept
        for s in range(self.slots):
            req = self.slot_req[s]
            if req is None:
                continue
            if req.cancel_requested:
                self._finish_slot(s, status="cancelled", error="cancelled mid-flight")
            elif self._past_deadline(req):
                self._finish_slot(
                    s, status="expired",
                    error=f"deadline_ms={req.deadline_ms} exceeded mid-flight",
                )

    def _guard_slots(self, logits: torch.Tensor, active: list[int]) -> frozenset[int]:
        """Slots whose logit rows this step are not finite (hook-injected
        corruption included).  One (B,) reduction and host copy per step."""
        if self.hooks is not None:
            forced = self.hooks.corrupt_slots(self, active)
            if forced:
                logits = logits.clone()
                logits[torch.as_tensor(list(forced), device=logits.device)] = float("nan")
        if not self.logits_guard:
            return frozenset()
        ok = torch.isfinite(logits).all(dim=-1).cpu().numpy()
        bad = frozenset(s for s in active if not ok[s])
        self.lifecycle["guard_trips"] += len(bad)
        return bad

    # ---- paged admission / page management ------------------------------------

    def _finish_degenerate(self, req: Request) -> None:
        req.done = True
        req.status = "ok"
        self.finished.append(req)

    def _admit_paged(self) -> None:
        free = [s for s in range(self.slots) if self.slot_req[s] is None]
        batch: list[tuple[int, Request, paged_lib.PagePlan]] = []
        # Admissions whose whole shared run is already written: prefill
        # computes only the un-cached suffix ((slot, req, plan, lead)).
        suffix: list[tuple[int, Request, paged_lib.PagePlan, int]] = []
        for req in list(self.queue):
            if not free:
                break
            if req.max_new_tokens <= 0:
                self.queue.remove(req)
                self._finish_degenerate(req)
                continue
            if req.cancel_requested or self._past_deadline(req):
                self.queue.remove(req)
                self._admission_reap(req)
                continue
            if self._quota_blocked(req):
                continue  # skip this tenant's request, keep scanning
            nblocks, shared = self.alloc.plan_prompt(req.prompt)
            if not self.alloc.plan_fits(nblocks, shared):
                break  # pool pressure: stop admitting (FIFO order preserved)
            lead = 0
            while lead in shared and self.alloc.is_written(shared[lead]):
                lead += 1
            plan = self.alloc.commit_prompt(req.prompt, nblocks, shared, tenant=req.tenant)
            if plan is None:
                raise paged_lib.AllocatorInvariantError(
                    "commit_prompt failed after plan_fits admitted the plan"
                )
            self.queue.remove(req)
            self._reserve_quota(req)
            s = free.pop(0)
            if lead == len(shared) and lead > 0 and not self.cfg.sliding_window:
                suffix.append((s, req, plan, lead))
            else:
                batch.append((s, req, plan))
        if not batch and not suffix:
            return
        if batch:
            # ONE right-padded batched prefill into a temporary dense cache
            # (pad to a power of two >= block_size, so padded lengths are
            # block-aligned), then scatter the computed blocks into the pool.
            # Shared prefix pages are not rewritten.
            maxlen = max(len(r.prompt) for _, r, _ in batch)
            lp = max(self.block_size,
                     min(1 << (maxlen - 1).bit_length(), self.num_blocks * self.block_size))
            toks = np.zeros((len(batch), lp), np.int32)
            for i, (_, r, _) in enumerate(batch):
                toks[i, : len(r.prompt)] = r.prompt
            tmp = T.cache_init(self.cfg, len(batch), lp, device=self.device)
            self._dispatch("prefill", self._prefill, self._tensor(toks), tmp)
            self._scatter_prefill(tmp, batch)
        for _s, r, plan, lead in suffix:
            self._prefill_suffix(r, plan, lead)
        for s, r, plan in batch + [(s, r, p) for s, r, p, _ in suffix]:
            self.slot_req[s] = r
            r.status = "running"
            self.slot_pos[s] = len(r.prompt)
            self.slot_pages[s] = list(plan.pages)
            self.alloc.claim_owner(plan.pages, s)
            self.alloc.mark_written(plan.pages)
            self.block_table[s, :] = paged_lib.SCRATCH_PAGE
            self.block_table[s, : len(plan.pages)] = plan.pages
            self.slot_ticket[s] = self._ticket
            self._ticket += 1
        self._tables_dirty = True

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of host array `a` (never a view of host state such as
        the block table, which the engine keeps editing)."""
        return torch.from_numpy(np.array(a)).to(self.device)

    def _scatter_prefill(self, tmp: dict, batch) -> None:
        """Write every admitted request's non-shared prompt blocks from the
        temporary dense cache into their pool pages, in place: one gather and
        one index_put_ per layer and K/V."""
        bs = self.block_size
        ri, bi, pgs = [], [], []
        for i, (_, _r, plan) in enumerate(batch):
            for j, (pg, sh) in enumerate(zip(plan.pages, plan.shared)):
                if not sh:
                    ri.append(i)
                    bi.append(j)
                    pgs.append(pg)
        if not pgs:
            return
        ria, bia, pga = (self._tensor(np.asarray(a, np.int64)) for a in (ri, bi, pgs))
        for pool, part in zip(self.caches["layers"], tmp["layers"]):
            for name in ("k", "v"):
                nb, lpad, kvh, hd = part[name].shape
                blocks = part[name].reshape(nb, lpad // bs, bs, kvh, hd)[ria, bia]
                pool[name].index_put_((pga,), blocks)

    def _gather_prefix(self, tmp: dict, pages: list[int]) -> None:
        """Copy written pool pages into the leading rows of a one-row
        temporary dense cache, in place: the cached-prefix K/V a suffix
        prefill attends."""
        n = len(pages)
        if not n:
            return
        pga = self._tensor(np.asarray(pages, np.int64))
        for pool, part in zip(self.caches["layers"], tmp["layers"]):
            for name in ("k", "v"):
                blocks = pool[name][pga]  # (n, bs, KV, HD)
                part[name][0, : n * self.block_size] = blocks.reshape(-1, *blocks.shape[2:])

    def _prefill_suffix(self, req: Request, plan: paged_lib.PagePlan, lead: int) -> None:
        """Admission with the first `lead` blocks already in the pool: gather
        them into a temporary dense cache, prefill only the suffix at offset
        lead*block_size (flash attention with q_offset over the concatenated
        prior K/V), and scatter the suffix blocks into the plan's pages."""
        bs = self.block_size
        skip = lead * bs
        plen = len(req.prompt)
        lp = max(bs, min(1 << (plen - 1).bit_length(), self.num_blocks * bs))
        tmp = T.cache_init(self.cfg, 1, lp, device=self.device)
        self._gather_prefix(tmp, plan.pages[:lead])
        toks = np.zeros((1, lp - skip), np.int32)
        toks[0, : plen - skip] = np.asarray(req.prompt[skip:], np.int32)
        self._dispatch("prefill", self._prefill, self._tensor(toks), tmp, skip)
        self._scatter_prefill(tmp, [(None, req, plan)])

    def _live_table_width(self) -> int:
        """Block-table width the next decode dispatch needs: the most pages
        any active slot holds, bucketed to a power of two (tables of <= 8
        blocks keep their full width)."""
        if self.num_blocks <= 8:
            return self.num_blocks
        live = 1
        for s in range(self.slots):
            if self.slot_req[s] is not None:
                live = max(live, len(self.slot_pages[s]))
        return min(self.num_blocks, 1 << (live - 1).bit_length())

    def _refresh_tables(self) -> None:
        """Copy the host block table (narrowed to the live width) to the
        device table every layer's cache shares."""
        if not self._tables_dirty:
            return
        table = self._tensor(self.block_table[:, : self._live_table_width()])
        for layer in self.caches["layers"]:
            layer["table"] = table
        self._tables_dirty = False

    def _preempt(self, s: int) -> None:
        """Evict slot `s`: free its pages and requeue its request at the
        front; greedy replay emits the same tokens."""
        req = self.slot_req[s]
        req.generated.clear()
        req.status = "queued"
        self._release_quota(req)
        self.alloc.free_pages(self.slot_pages[s], owner=s, tenant=req.tenant)
        self.slot_pages[s] = []
        self.block_table[s, :] = paged_lib.SCRATCH_PAGE
        self.slot_req[s] = None
        self.slot_pos[s] = 0
        self.queue.appendleft(req)
        self._tables_dirty = True
        self.preemptions += 1

    def _ensure_decode_pages(self) -> None:
        """Each active slot must own the page its next token writes into;
        when the pool is dry, the latest-admitted slot is preempted until a
        page frees (possibly the requesting slot itself)."""
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        for s in sorted(active, key=lambda s: self.slot_ticket[s]):
            if self.slot_req[s] is None:
                continue  # preempted while serving an earlier slot
            need = max(int(self.slot_pos[s]) - 1, 0) // self.block_size + 1
            while self.slot_req[s] is not None and len(self.slot_pages[s]) < need:
                page = self.alloc.alloc(owner=s, tenant=self.slot_req[s].tenant)
                if page is None:
                    live = [v for v in range(self.slots) if self.slot_req[v] is not None]
                    self._preempt(max(live, key=lambda v: self.slot_ticket[v]))
                    continue
                self.slot_pages[s].append(page)
                self.block_table[s, len(self.slot_pages[s]) - 1] = page
                self._tables_dirty = True

    # ---- observability ------------------------------------------------------------

    @property
    def stats(self) -> dict:
        astats = self.alloc.stats
        out = {
            "cache_mode": "paged",
            "decode_mode": "vectorized",
            "sample": "greedy",
            "kv_quant": "bf16",
            "weight_quant": self.enc.weight_quant,
            "attn_backend": registry_lib.select_attn(
                phase=Phase.DECODE, s=self._attn_s(Phase.DECODE),
                target=self.enc.target, requested=self.enc.attn_backend,
            ).backend,
            "steps": self.step_count,
            "dispatches": dict(self.dispatches),
            "watchdog": self.watchdog.summary(),
            "lifecycle": dict(self.lifecycle),
            "degraded": [dict(d) for d in self.degraded],
            **astats,
            "pages_total": self.alloc.capacity,
            "pages_in_use": self.alloc.in_use(),
            "pages_free": self.alloc.available(),
            "preemptions": self.preemptions,
            "peak_active": self.peak_active,
            "block_size": self.block_size,
            "prefix_cache": {
                "enabled": self.prefix_cache,
                "hit_blocks": astats["hit_blocks"],
                "hit_tokens": astats["hit_tokens"],
                "lookup_blocks": astats["lookup_blocks"],
                "hit_rate": (astats["hit_blocks"] / astats["lookup_blocks"]
                             if astats["lookup_blocks"] else 0.0),
                "evictions": astats["evictions"],
                "cached_pages": astats["cached_pages"],
            },
        }
        if self.config.downgrades:
            out["config_downgrades"] = list(self.config.downgrades)
        if self.tenant_quota is not None:
            out["prefix_cache"]["tenant_quota"] = self.tenant_quota
            out["prefix_cache"]["tenant_usage"] = self.alloc.tenant_usage()
        return out

    def stats_view(self) -> dict:
        """`stats` with the mesh-stable schema of the JAX package: attn_backend
        and degraded as {shard: value} dicts (one card: shard 0)."""
        out = self.stats
        out["attn_backend"] = {0: out["attn_backend"]}
        out["degraded"] = {0: out["degraded"]}
        return out

    def audit(self) -> None:
        """Assert allocator/table consistency; pages held by a fault hook
        count as one extra table."""
        tables = [self.slot_pages[s] for s in range(self.slots) if self.slot_req[s] is not None]
        if self.hooks is not None and hasattr(self.hooks, "held_pages"):
            held = list(self.hooks.held_pages())
            if held:
                tables.append(held)
        self.alloc.audit(tables)

    # ---- commit ----------------------------------------------------------------------

    def _finish_slot(self, s: int, *, status: str = "ok", error: str | None = None) -> None:
        """Retire slot `s`; every slot exit funnels through here.  Written
        full blocks park in the radix cache when their refcount hits 0."""
        req = self.slot_req[s]
        req.done = True
        req.status = status
        req.error = error
        self.finished.append(req)
        if status != "ok":
            self.lifecycle[status] = self.lifecycle.get(status, 0) + 1
        self.slot_req[s] = None
        self.slot_pos[s] = 0  # freed rows decode (discarded) at pos 0
        self._release_quota(req)
        self.alloc.free_pages(self.slot_pages[s], owner=s, tenant=req.tenant)
        self.slot_pages[s] = []
        self.block_table[s, :] = paged_lib.SCRATCH_PAGE
        self._tables_dirty = True

    def _commit_tokens(self, s: int, toks: list[int]) -> int:
        req = self.slot_req[s]
        emitted = 0
        for t in toks:
            req.generated.append(t)
            self.slot_pos[s] += 1
            emitted += 1
            if self.stream_cb is not None:
                self.stream_cb(req, int(t))
            if (
                (req.eos_id is not None and t == req.eos_id)
                or len(req.generated) >= req.max_new_tokens
                or self.slot_pos[s] >= self.max_seq
            ):
                self._finish_slot(s)
                break
        return emitted

    def _commit(self, slots_sel: list[int], nxt: np.ndarray,
                bad: frozenset[int] = frozenset()) -> int:
        """Commit this dispatch's tokens; `bad` slots (non-finite logits)
        finish with status "error", and a cancel that landed in flight wins."""
        emitted = 0
        for s in slots_sel:
            if self.slot_req[s] is None:
                continue
            if s in bad:
                self._finish_slot(s, status="error", error="non-finite logits (guard tripped)")
                continue
            if self.slot_req[s].cancel_requested:
                self._finish_slot(s, status="cancelled", error="cancelled mid-dispatch")
                continue
            emitted += self._commit_tokens(s, [int(nxt[s])])
        return emitted

    def _last_tokens(self, active: list[int]) -> np.ndarray:
        last = np.zeros((self.slots, 1), np.int32)
        for s in active:
            req = self.slot_req[s]
            last[s, 0] = req.generated[-1] if req.generated else int(req.prompt[-1])
        return last

    # ---- the step loop -------------------------------------------------------------

    def step(self) -> int:
        """One iteration: fault hooks, lifecycle sweep, admission (prefill),
        then ONE decode dispatch for every active slot, bracketed by the
        watchdog.  Returns the tokens emitted."""
        self.step_count += 1
        self.watchdog.step_start()
        try:
            with torch.no_grad():
                return self._step_inner()
        finally:
            self.watchdog.step_end()

    def _step_inner(self) -> int:
        if self.hooks is not None:
            self.hooks.on_step_begin(self)
        self._reap_lifecycle()
        self._admit_paged()
        if not any(r is not None for r in self.slot_req):
            return 0
        self._ensure_decode_pages()
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return 0
        self.peak_active = max(self.peak_active, len(active))
        self._refresh_tables()
        # Inactive rows decode token 0 at pos 0 against the scratch page.
        tokens = self._tensor(self._last_tokens(active))
        pos = self._tensor(np.maximum(self.slot_pos.astype(np.int32) - 1, 0))
        nxt, logits = self._dispatch("decode", self._decode, tokens, pos)
        bad = self._guard_slots(logits, active)
        return self._commit(active, nxt.cpu().numpy(), bad)

    def run(self) -> list[Request]:
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
        return self.finished
