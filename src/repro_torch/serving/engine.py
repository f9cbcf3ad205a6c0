"""Serving engine (counterpart of repro/serving/engine.py: Engine).

Slot-based continuous batching, on one of two KV caches:

  paged (cache_mode="paged", the default)  admission charges only the pages
                a prompt needs, a radix prefix cache shares full prompt
                blocks across requests (serving/paged.py), and a request
                whose leading blocks are all cached prefills only its
                suffix.  Prefill runs one right-padded batch into a
                temporary dense cache and scatters the computed blocks into
                the pool pages in place.  Decode growth preempts the
                lowest-priority slot when the pool is dry (its request
                replays; greedy decode makes the replay identical).  The
                pool is bf16 (the activation dtype) or quantized
                (kv_quant="kv8" | "kv4", core/encoding.KVLayout): pages are
                quantized on write, with float32 scale pages at the same
                page ids, and the decode kernel dequantizes them.
  dense (cache_mode="dense", or decode_mode="grouped")  the worst-case
                (slots, max_seq) reservation in the activation dtype:
                admitted requests prefill into their own rows (one
                right-padded batch through slot_gather / slot_merge), and no
                page is ever allocated, shared or preempted.

Decode is vectorized: one dispatch per step serves every slot at its own
position; decode_mode="grouped" instead dispatches once per group of slots
at the same position and merges only the group's cache rows back.  The
first decode step of a request recomputes the last prompt token (its logits
give the first generated token), exactly as in the JAX engine.

Two step kinds ride the masked-causal decode window (an L > 1 decode-phase
forward, models/layers.py):

  spec_decode   a prompt-lookup drafter (serving/spec.py, or `drafter=`)
                proposes up to draft_k tokens per slot; ONE verify dispatch
                over the (slots, L) window scores them, and each slot
                commits its longest greedy-consistent draft prefix plus the
                model's next token.  Rejected draft pages return to the pool.
  token_budget  every step is ONE mixed dispatch whose window packs decode
                rows (1 token or their verify window) beside chunked-prefill
                rows, so a long prompt streams in without pausing decode;
                admission order, budget split and preemption order come
                from TokenBudgetScheduler (SLO classes with aging).

Both emit the tokens of plain greedy decode, on either cache (a dense cache
keeps rejected draft slots masked until they are overwritten; a paged slot
returns its draft-only pages).  A window of slots x L rows
keys the registry's m32/m64/big buckets, which route to the packed mmt4d
GEMM (kernels/registry.py), as do plain decode steps with more than 8 slots.

Lifecycle: bounded admission queue with structured Rejected results,
deadlines and cancel at step boundaries, a non-finite logits guard that
finishes only the offending slot, and kernel quarantine: a dispatch whose
fault hook raises KernelFaultError demotes that registry key for the rest of
the process and retries on the next rung.  Real CUDA errors propagate.

Quantized weights (EncodingConfig weight_quant "int8" or "int4") serve
through every step kind; their dispatches key the registry as w8a8 / w4a8.
Attention dispatches key it with the cache width and the KV layout
(attn|phase|S-bucket[|kv8|kv4]|target).

Temperature sampling (sample="temperature"): every decode dispatch draws
one fresh key, fold_in(PRNGKey(seed), dispatch index), and each row with
Request.temperature > 0 samples softmax(logits / temperature) through the
JAX engine's Threefry-2x32 Gumbel noise, reproduced bit for bit
(serving/sampling.py); rows at temperature <= 0 stay greedy.  resolve()
switches spec decode and the token budget off under sampling, as in JAX.
A preempted sampled request replays with fresh keys, so sampled engines
under pool pressure are not replay-deterministic.

Sliding-window models (Mixtral) serve on the dense cache as a ring of
min(max_seq, window) slots; resolve() turns the paged cache, batched
prefill, spec decode and the token budget off for them, as in JAX.  MoE
models route every dispatch's rows, dead slots included, through the
capacity-bounded dispatch (models/layers.moe_apply): the engine keeps the
JAX engine's batch shapes in every decode mode, so the same rows drop.

The recurrent families (RWKV-6; RecurrentGemma's RG-LRU layers beside
its windowed attention) serve on the dense cache with grouped decode and
prefill one admission at a time, as resolve() routes them in JAX: their
state has no position mask.  Every dense admission starts its slot's
recurrent state from zero.  The JAX engine prefills from the state the
slot's previous request left behind, so a reused slot emits other tokens
there; the port diverges from it on purpose (ROADMAP Queue 3, item 1).

Tensor parallelism (mesh_shape=(N,), N > 1; the JAX engine's GSPMD path):
one torch.distributed rank a device, each running this engine on the same
requests (launch/mesh.py starts and joins them).  A rank holds its shard
(parallel/sharding.py: query and kv heads, FFN columns, every expert's FFN
columns beside the whole router, and vocabulary rows; params given whole
are sliced at construction) and its kv heads' pages or ring rows,
runs the hand-written kernels on them, and sums the row-parallel outputs
over the group (parallel/collectives.py).  Every host decision is the same
on every rank, or a collective hangs: the scheduler is deterministic, and
the clock (deadlines, the watchdog) is rank 0's reading, broadcast.  Each
rank keeps the allocator of its own shard; audit() compares them across
ranks and names the first that diverged, and checks that every rank holds
the same logits.  A kernel fault tagged with a shard demotes that shard's
registry entry only; every rank dispatches on the max over shards, so all
run the same rung (stats: per-shard attn_backend and degraded).  Unlike
the JAX engine, which routes tp > 1 to its XLA paths because GSPMD cannot
partition a Pallas call, the ranks keep their kernels and kv4.  At tp > 1
the engine serves the attention-only token families and MoE (every rank
routes alike: models/layers.moe_apply); the recurrent blocks raise
NotImplementedError (sharding.check_servable).  At tp > 1,
`stats` and `audit()` are collective: call them on every rank.

Refused at construction, as in the JAX engine, whose batches are tokens
only: the enc-dec and VLM families (check_servable), which run through
models/transformer.forward.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import encoding
from repro_torch.core.encoding import Phase
from repro_torch.core.packed import QUANT_KEYS, EncodingConfig
from repro_torch.kernels import registry as registry_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding
from repro_torch.runtime import watchdog as watchdog_lib
from repro_torch.serving import faults as faults_lib
from repro_torch.serving import paged as paged_lib
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving import spec as spec_lib
from repro_torch.serving.config import EngineConfig


# Every status a Request can hold; all but "queued" and "running" are terminal.
REQUEST_STATUSES = (
    "queued", "running", "ok", "cancelled", "expired", "error", "rejected",
)


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
    # Speculative-decode accounting: drafts offered / drafts accepted.
    draft_proposed: int = 0
    draft_accepted: int = 0
    # Wall-clock budget from submit() to last token, in ms of the engine's
    # (injectable) clock; checked at step boundaries.
    deadline_ms: float | None = None
    status: str = "queued"
    error: str | None = None
    cancel_requested: bool = False
    submit_t: float | None = None
    # SLO class for the token-budget scheduler ("interactive" | "standard" |
    # "batch"; unknown values rank as "standard"); queue order ages by
    # enqueued_step (stamped by submit()) so no class starves.
    slo_class: str = "standard"
    enqueued_step: int | None = None
    # Tenant for per-tenant page-quota accounting (EngineConfig.tenant_quota).
    tenant: str = "default"
    # Sampling temperature (engines built with sample="temperature" only;
    # <= 0 means greedy for this request inside a sampled batch).
    temperature: float = 1.0

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


# Lower rank = more urgent.  Unknown classes rank as "standard".
SLO_CLASSES = {"interactive": 0, "standard": 1, "batch": 2}


class TokenBudgetScheduler:
    """Admission / budget-split / preemption policy of the token-budget
    mixed step (the JAX package's, unchanged).

    Admission order: SLO class rank (interactive < standard < batch) with
    starvation-free aging: every `aging_steps` steps queued promote a
    request one class.  Ties break FIFO (enqueued_step, then submission).
    Budget split per step: decode rows first (1 token each, the zero-stall
    floor), then spec drafts (spec.draft_budget), and chunked prefill takes
    the rest, never less than 1 token per prefill row.  Preemption: the max
    (class rank, admission ticket) is evicted; aging protects queue order
    only."""

    def __init__(self, budget: int, *, aging_steps: int = 64):
        if budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {budget}")
        self.budget = int(budget)
        self.aging_steps = max(1, int(aging_steps))

    def rank(self, req: Request) -> int:
        return SLO_CLASSES.get(req.slo_class, SLO_CLASSES["standard"])

    def queue_key(self, req: Request, now_step: int) -> tuple[int, int]:
        """Sort key for queued requests (lower = admitted first)."""
        enq = req.enqueued_step if req.enqueued_step is not None else now_step
        waited = max(0, now_step - enq)
        return (self.rank(req) - waited // self.aging_steps, enq)

    def victim_key(self, req: Request, ticket: int) -> tuple[int, int]:
        """Sort key for preemption victims (the MAX is evicted)."""
        return (self.rank(req), int(ticket))

    def split_chunks(self, decode_cost: int, remaining: dict[int, int],
                     order: list[int]) -> dict[int, int]:
        """Chunk sizes for this step's prefill rows: `remaining[s]` prompt
        tokens are left on row s, `order` is priority order, decode rows
        (drafts included) already spent `decode_cost`.  Every row gets at
        least 1 token; the leftover goes to the highest-priority rows first."""
        spare = max(self.budget - int(decode_cost), len(order))
        chunks = {s: 1 for s in order}
        spare -= len(order)
        for s in order:
            add = min(remaining[s] - 1, spare)
            if add > 0:
                chunks[s] += add
                spare -= add
        return chunks


def _rows(caches: dict, rows: list[int]) -> torch.Tensor:
    """`rows` as an index tensor on the caches' device."""
    leaf = next(iter(caches["layers"][0].values()))
    return torch.as_tensor(rows, dtype=torch.long, device=leaf.device)


def slot_gather(caches: dict, slots_sel: list[int]) -> dict:
    """Batch rows `slots_sel` of every dense cache leaf (K/V rows and
    recurrent state alike), as one gather per leaf (a copy)."""
    idx = _rows(caches, slots_sel)
    return {"layers": [{name: leaf[idx] for name, leaf in layer.items()}
                       for layer in caches["layers"]]}


def slot_slice(caches: dict, s: int) -> dict:
    return slot_gather(caches, [s])


def slot_merge(caches: dict, part: dict, slots_sel: list[int],
               src_idx: list[int] | None = None) -> None:
    """Write batch rows `src_idx` (default: the same as slots_sel) of `part`
    into rows `slots_sel` of `caches`, in place: one gather and one scatter
    per leaf."""
    dst_t = _rows(caches, slots_sel)
    src_t = _rows(caches, slots_sel if src_idx is None else src_idx)
    for full, p in zip(caches["layers"], part["layers"]):
        for name, leaf in full.items():
            leaf[dst_t] = p[name][src_t]


def make_chunked_prefill_step(cfg, enc: EncodingConfig, *, chunk: int = 512) -> Callable:
    """Prefill long prompts in fixed chunks (bounded activation memory), as
    JAX's make_chunked_prefill_step: each chunk runs as a PREFILL at offset
    `pos`, attending the keys cached before it, so the caches end as a
    single-shot prefill leaves them.

    Returns prefill_chunked(params, tokens, caches) -> (last_logits, caches)
    (the caches are updated in place and returned).  A chunk narrower than
    a sliding window is refused with JAX's message.  Under a window the
    port's chunks attend the last min(pos, S_c) positions of the ring (JAX's
    windowed prefill attends none), so a chunk of at least the window equals
    the single-shot prefill.  Recurrent layers carry their state from chunk
    to chunk in the caches."""
    if 0 < chunk < cfg.sliding_window:
        raise ValueError(
            f"chunked prefill requires sliding_window <= chunk: window "
            f"{cfg.sliding_window} > chunk {chunk} would silently drop "
            "cross-chunk attention (grow chunk, or prefill single-shot)"
        )

    def prefill_chunked(params, tokens, caches):
        logits = None
        with torch.no_grad():
            for lo in range(0, tokens.shape[1], chunk):
                logits = T.forward(params, tokens[:, lo:lo + chunk], cfg=cfg, enc=enc,
                                   phase=Phase.PREFILL, caches=caches, pos=lo,
                                   last_logits_only=True)
        return logits, caches

    return prefill_chunked


def check_servable(cfg) -> None:
    """The engine serves token-only families.  Its batches are tokens, as
    the JAX engine's are (JAX serving/engine.py takes {"tokens": ...} only),
    so an enc-dec model (frames) or a VLM (patches) is refused; both run
    through models/transformer.forward (greedy_generate)."""
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(
            f"the serving engine takes tokens only, as the JAX engine does; family "
            f"{cfg.family!r} ({cfg.name}) needs {'frames' if cfg.family == 'encdec' else 'patches'}"
            " beside them, so it runs through models.transformer.forward "
            "(transformer.greedy_generate), not the engine")


def _rank0_clock(clock: Callable[[], float], group) -> Callable[[], float]:
    """`clock` as rank 0 of `group` reads it, on every rank (one broadcast a
    reading): deadlines and the watchdog decide the same on every rank."""
    def read() -> float:
        return collectives.broadcast_object(clock(), group)
    return read


class Engine:
    """Slot-based continuous batching on a fixed decode batch.

    Engine(params, cfg, enc, config=EngineConfig(...), device="cuda"); the
    legacy keyword form Engine(params, cfg, enc, slots=4, ...) folds into
    EngineConfig(**kwargs) as in the JAX package.  `drafter(context, k)`
    replaces the prompt-lookup drafter of spec decode; `clock` (seconds)
    drives deadlines and the watchdog; `fault_hooks` is an object with
    on_step_begin, pre_dispatch and corrupt_slots (and optionally
    held_pages), the JAX package's injection points, such as a
    serving/faults.FaultSchedule; `stream_cb(req, token)`
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
        drafter: Callable | None = None,
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
        check_servable(cfg)
        # kv4 packs two values a byte; only the decode kernels unpack
        # nibbles in registers.  Under a requested plain attention the
        # gather-and-dequantize of nibbles is not worth the capacity, so kv4
        # rides the kv8 layout there, recorded like a resolve() downgrade.
        if config.kv_quant == "kv4" and enc.attn_backend in ("xla", "reference"):
            config = dataclasses.replace(
                config, kv_quant="kv8", downgrades=config.downgrades + (
                    f"kv_quant:kv8(attn_backend={enc.attn_backend})",))
        self.config = config
        self.kv_quant = config.kv_quant
        self.cache_mode = config.cache_mode
        self.decode_mode = config.decode_mode
        self.batch_prefill = bool(config.batch_prefill)
        self.device = T.resolve_device(device)
        self.cfg, self.enc = cfg, enc
        self.slots = config.slots
        self.max_seq = config.max_seq
        self.max_queue = config.max_queue
        self.clock = clock if clock is not None else time.monotonic
        # Tensor parallelism: this rank's mesh, its shard (None on one
        # card) and the model config of its shard (its heads, FFN columns).
        self.tp_shards = config.tp_shards
        self.mesh = self.shard = None
        self.model_cfg = cfg
        if config.mesh_devices > 1:
            self.mesh = mesh_lib.build_serving_mesh(config.mesh_shape, tp_axis=config.tp_axis)
        if self.tp_shards > 1:
            self.shard = sharding.plan(cfg, enc, self.tp_shards, self.mesh.tp_rank,
                                       group=self.mesh.tp_group)
            self.model_cfg = self.shard.cfg
            self.clock = _rank0_clock(self.clock, self.mesh.host_group)
            mark = params.get("tp_shard")
            if mark is None:
                params = sharding.shard_params(params, cfg, enc, self.shard)
            elif tuple(mark) != (self.shard.tp, self.shard.rank):
                raise ValueError(f"params are the shard {tuple(mark)} (tp, rank) but this rank "
                                 f"is {(self.shard.tp, self.shard.rank)}")
        self.params = params
        self._last_logits: torch.Tensor | None = None
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
        # prefills; "decode", "verify", "mixed"): each runs every layer once,
        # so kernel launches are these counts times layers times projections.
        self.dispatches: collections.Counter[str] = collections.Counter()

        # Temperature sampling: one key per decode dispatch, folded from the
        # base key by a dispatch counter (the JAX engine's _step_idx).
        self.sample = config.sample
        self._base_key = sampling_lib.prng_key(config.seed)
        self._step_idx = 0

        self.draft_k = int(config.draft_k)
        self.spec_decode = bool(config.spec_decode)
        self.drafter = drafter if drafter is not None else spec_lib.propose
        self.token_budget = config.token_budget
        self.scheduler = (
            TokenBudgetScheduler(self.token_budget, aging_steps=config.slo_aging_steps)
            if self.token_budget is not None else None
        )
        self._window_m = self.slots    # M (slots x L) of the imminent verify/mixed dispatch
        self._window_blocks = 0        # table width the mixed window needs
        if self.scheduler is not None:
            self.continuous = {
                "token_budget": self.token_budget,
                "mixed_steps": 0,
                "decode_tokens": 0,        # decode-row window tokens dispatched
                "prefill_tokens": 0,       # prompt chunk tokens dispatched
                "decode_stall_steps": 0,   # steps where live decode rows emitted 0
                "chunked_admissions": 0,
                "completed_prefills": 0,
            }
        if self.spec_decode:
            self.spec_stats = {
                "steps": 0,          # engine steps served by a verify window
                "slot_steps": 0,     # per-slot verify participations
                "proposed": 0,       # draft tokens offered to verify
                "accepted": 0,       # draft tokens matching the greedy target
                "committed": 0,      # tokens emitted by spec steps (incl. bonus)
                "pool_deferred": 0,  # spec steps skipped: draft pages won't fit
            }
            self.slot_proposed = np.zeros(self.slots, np.int64)
            self.slot_accepted = np.zeros(self.slots, np.int64)

        self._tenant_reserved: dict[str, int] = {}
        if self.cache_mode == "paged":
            self.block_size = config.block_size
            self.num_blocks = -(-self.max_seq // self.block_size)
            pool_pages = config.pool_pages
            if pool_pages is None:
                pool_pages = 1 + self.slots * self.num_blocks  # dense worst case
            self.prefix_cache = bool(config.prefix_cache)
            self.tenant_quota = config.tenant_quota
            # Suffix-only prefill gathers pool pages back as bf16 K/V: a
            # kv8/kv4 pool would dequantize and requantize them.  Quantized
            # pools keep the write-skip half of the prefix cache, as do
            # tensor-parallel ones (JAX's rule).
            self._suffix_ok = (self.kv_quant == "bf16" and self.tp_shards == 1
                               and not cfg.sliding_window)
            self.alloc = paged_lib.BlockAllocator(
                pool_pages, self.block_size, self.kv_quant,
                prefix_cache=self.prefix_cache, tenant_quota=self.tenant_quota,
            )
            self.caches = T.cache_init(
                self.model_cfg, self.slots, self.max_seq, cache_mode="paged",
                block_size=self.block_size, num_pages=pool_pages, kv_quant=self.kv_quant,
                device=self.device,
            )
            self.block_table = np.full(
                (self.slots, self.num_blocks), paged_lib.SCRATCH_PAGE, np.int32
            )
            self.slot_pages: list[list[int]] = [[] for _ in range(self.slots)]
        else:
            self.caches = T.cache_init(self.model_cfg, self.slots, self.max_seq,
                                       device=self.device)
            # Prefix caching and page quotas belong to the paged pool; a
            # dense engine carries the neutral values.
            self.prefix_cache = False
            self.tenant_quota = None
        # Admissions that deferred on an unwritten shared prefix and later
        # re-planned into real shares (token-budget admission).
        self.deferred_hits = 0
        self.slot_ticket = np.zeros(self.slots, np.int64)
        self._ticket = 0
        self._tables_dirty = True
        self.preemptions = 0
        self.peak_active = 0
        self.slot_req: list[Request | None] = [None] * self.slots
        self.slot_pos = np.zeros(self.slots, np.int32)
        # Prompt tokens already in the slot's cache: len(prompt) once prefill
        # ran; less only mid-chunked-prefill under the token budget.
        self.slot_prefill_done = np.zeros(self.slots, np.int64)
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
        req.enqueued_step = self.step_count
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
        if self.cache_mode == "paged" and req.max_new_tokens > 0:
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
        T.forward(self.params, tokens, cfg=self.model_cfg, enc=self.enc, phase=Phase.PREFILL,
                  caches=caches, pos=pos, last_logits_only=True, tp=self.shard)

    def _decode(self, tokens: torch.Tensor, pos: torch.Tensor | int, caches: dict,
                temp: torch.Tensor | None = None,
                key: sampling_lib.Key | None = None):
        """One token for every row of `caches`: (next (B,) int, logits (B, V)).
        `pos` is (B,) (vectorized) or an int shared by every row (grouped
        decode).  Greedy, or with `temp` (B,) and `key` (sample="temperature")
        sampled per row as JAX's decode_sampled does."""
        logits = T.forward(self.params, tokens, cfg=self.model_cfg, enc=self.enc,
                           phase=Phase.DECODE, caches=caches, pos=pos, tp=self.shard)[:, -1]
        self._last_logits = logits
        if temp is None:
            return torch.argmax(logits, dim=-1), logits
        return sampling_lib.sample_rows(logits, temp, key), logits

    def _sample_args(self, slots_sel: list[int]) -> tuple:
        """The (temp, key) extras of one decode dispatch: () for a greedy
        engine; else a fresh key per dispatch and each slot's request
        temperature (0 for slots outside `slots_sel`), as JAX's
        _sample_args."""
        if self.sample != "temperature":
            return ()
        key = sampling_lib.fold_in(self._base_key, self._step_idx)
        self._step_idx += 1
        temp = np.zeros(self.slots, np.float32)
        for s in slots_sel:
            temp[s] = self.slot_req[s].temperature
        return torch.from_numpy(temp).to(self.device), key

    def _window(self, tokens: torch.Tensor, pos: torch.Tensor,
                logits_idx: torch.Tensor | None = None) -> torch.Tensor:
        """The verify / mixed dispatch: one decode-phase forward over the
        (B, L) window, row b's tokens at pos[b] .. pos[b]+L-1 (masked-causal
        inside the window, all L K/V pairs written).  Logits (B, L or K, V)."""
        logits = T.forward(self.params, tokens, cfg=self.model_cfg, enc=self.enc,
                           phase=Phase.DECODE, caches=self.caches, pos=pos,
                           logits_idx=logits_idx, tp=self.shard)
        self._last_logits = logits
        return logits

    def _attn_s(self, phase: Phase) -> int:
        """The logical KV length the next dispatch of `phase` attends: the
        live table width of a paged cache, the cache width of a dense one
        (the ring width min(max_seq, window) under a sliding window)."""
        if phase is Phase.PREFILL:
            return self.max_seq
        if self.cache_mode == "paged":
            return self._live_table_width() * self.block_size
        if self.cfg.sliding_window:
            return min(self.max_seq, self.cfg.sliding_window)
        return self.max_seq

    def _dispatch_keys(self, kind: str) -> tuple[str, str]:
        """Registry keys the imminent dispatch resolves through (what
        pre_dispatch faults match and what a quarantine demotes): the
        attention key with the cache width and the KV layout, and the matmul
        key."""
        phase = Phase.PREFILL if kind == "prefill" else Phase.DECODE
        target = self.enc.target.name
        # A verify or mixed window's M is slots x L, set per step: wide
        # windows land in the m32/m64/big buckets (the packed mmt4d GEMM).
        m = {"prefill": self.slots * self.max_seq, "decode": self.slots,
             "verify": self._window_m, "mixed": self._window_m}[kind]
        return (
            registry_lib.attn_dispatch_key(phase, self._attn_s(phase), target, self.kv_quant),
            registry_lib.dispatch_key(QUANT_KEYS[self.enc.weight_quant], phase, m, target),
        )

    def _requested_for(self, key: str) -> str | None:
        if key.startswith(registry_lib.ATTN_OP + "|"):
            return self.enc.attn_backend
        if self.enc.weight_quant != "none":
            return self.enc.quant_backend()
        return self.enc.resolved_backend()

    def _quarantine_kernel(self, key: str, reason: str, shard: int | None = None) -> dict:
        """Demote `key` to the next rung of its ladder for the rest of the
        process and record it in stats["degraded"].  The model consults the
        registry on every call, so the next dispatch runs the demoted rung.
        A shard-tagged fault demotes only that shard's entry ("key@shardN"),
        as in the JAX engine; every rank dispatches on the max over shards,
        so the whole group runs the demoted rung."""
        requested = self._requested_for(key)
        before = registry_lib.resolve_key(key, requested=requested, shard=shard)
        record = registry_lib.demote(key, failing=before.backend, reason=reason,
                                     requested=requested, shard=shard)
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
                self._quarantine_kernel(exc.key, reason=str(exc), shard=exc.shard)
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
        ok = torch.isfinite(logits).reshape(logits.shape[0], -1).all(dim=-1).cpu().numpy()
        bad = frozenset(s for s in active if not ok[s])
        self.lifecycle["guard_trips"] += len(bad)
        return bad

    def poison_slot_kv(self, s: int) -> None:
        """Overwrite slot `s`'s newest KV storage in every layer: the chaos
        layer's cache poisoning (a kernel writing garbage K/V).  Paged: the
        slot's last page of every K and V pool; dense: the slot's newest
        row.  The slot's next logits go non-finite and the guard finishes
        it; co-batched slots see the poison only through a page they share.
        Integer pools (kv8, kv4) cannot hold a NaN: their data pages get the
        dtype's largest value and the float32 scale pages NaN, so the
        dequantized K/V are still non-finite.  Tables are never touched.  A
        dense cache follows the JAX engine's rule on every leaf, K/V rows
        and recurrent state alike: leaf[s, pos mod leaf.shape[1]] = NaN."""
        if self.cache_mode == "paged":
            if not self.slot_pages[s]:
                return
            page = self.slot_pages[s][-1]
            for layer in self.caches["layers"]:
                for name, leaf in layer.items():
                    if name == "table":
                        continue
                    poison = (torch.iinfo(leaf.dtype).max if not leaf.dtype.is_floating_point
                              else float("nan"))
                    leaf[page] = poison
        else:
            pos = max(int(self.slot_pos[s]) - 1, 0)
            for layer in self.caches["layers"]:
                for leaf in layer.values():
                    leaf[s, pos % leaf.shape[1]] = float("nan")

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
            if lead == len(shared) and lead > 0 and self._suffix_ok:
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
            tmp = T.cache_init(self.model_cfg, len(batch), lp, device=self.device)
            self._dispatch("prefill", self._prefill, self._tensor(toks), tmp)
            self._scatter_prefill(tmp, batch)
        for _s, r, plan, lead in suffix:
            self._prefill_suffix(r, plan, lead)
        for s, r, plan in batch + [(s, r, p) for s, r, p, _ in suffix]:
            self.slot_req[s] = r
            r.status = "running"
            self.slot_pos[s] = len(r.prompt)
            self.slot_prefill_done[s] = len(r.prompt)
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
        one index_put_ per layer and K/V.  A kv8/kv4 pool takes the gathered
        blocks quantized, with their scales written to the scale pages at
        the same page ids."""
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
        layout = encoding.kv_layout(self.kv_quant)
        for pool, part in zip(self.caches["layers"], tmp["layers"]):
            for name in ("k", "v"):
                nb, lpad, kvh, hd = part[name].shape
                blocks = part[name].reshape(nb, lpad // bs, bs, kvh, hd)[ria, bia]
                if layout.quantized:
                    blocks, scales = layout.quantize(blocks)
                    pool[f"{name}_scale"].index_put_((pga,), scales)
                pool[name].index_put_((pga,), blocks)

    def _gather_prefix(self, tmp: dict, pages: list[int]) -> None:
        """Copy written pool pages into the leading rows of a one-row
        temporary dense cache, in place: the cached-prefix K/V a suffix
        prefill attends.  bf16 pools only (_suffix_ok)."""
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
        tmp = T.cache_init(self.model_cfg, 1, lp, device=self.device)
        self._gather_prefix(tmp, plan.pages[:lead])
        toks = np.zeros((1, lp - skip), np.int32)
        toks[0, : plen - skip] = np.asarray(req.prompt[skip:], np.int32)
        self._dispatch("prefill", self._prefill, self._tensor(toks), tmp, skip)
        self._scatter_prefill(tmp, [(None, req, plan)])

    def _live_table_width(self) -> int:
        """Block-table width the next decode-phase dispatch needs: the most
        pages any active slot holds, bucketed to a power of two (tables of
        <= 8 blocks keep their full width).  The mixed step widens it to
        cover its whole window, pads included (_window_blocks, 0 outside
        mixed steps): a pad past the width would clamp onto the row's last
        real page and corrupt committed history, while inside the width it
        lands on scratch or a masked future offset of a private page."""
        if self.num_blocks <= 8:
            return self.num_blocks
        live = max(1, self._window_blocks)
        for s in range(self.slots):
            if self.slot_req[s] is not None:
                live = max(live, len(self.slot_pages[s]))
        return min(self.num_blocks, 1 << (live - 1).bit_length())

    def _refresh_tables(self) -> None:
        """Copy the host block table (narrowed to the live width) to the
        device table every layer's cache shares (paged caches only)."""
        if self.cache_mode != "paged" or not self._tables_dirty:
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
        req.draft_proposed = req.draft_accepted = 0  # replay re-accounts
        req.status = "queued"
        self._release_quota(req)
        self.alloc.free_pages(self.slot_pages[s], owner=s, tenant=req.tenant)
        self.slot_pages[s] = []
        self.block_table[s, :] = paged_lib.SCRATCH_PAGE
        self.slot_req[s] = None
        self.slot_pos[s] = 0
        self.slot_prefill_done[s] = 0  # replay re-runs (chunked) prefill
        self.queue.appendleft(req)
        self._tables_dirty = True
        self.preemptions += 1

    def _victim_key(self, v: int):
        """Preemption priority: the max over live slots is evicted.  The
        phase-split engine takes the latest admission ticket; under the token
        budget the SLO class outranks the ticket."""
        if self.scheduler is not None:
            return self.scheduler.victim_key(self.slot_req[v], self.slot_ticket[v])
        return self.slot_ticket[v]

    def _ensure_decode_pages(self, extra: int = 0) -> None:
        """Each active slot must own the page its next token writes into,
        and with `extra` > 0 (a verify window) the pages of the `extra`
        draft positions after it."""
        self._ensure_pages({
            s: max(int(self.slot_pos[s]) - 1, 0) + extra
            for s in range(self.slots) if self.slot_req[s] is not None
        })

    def _ensure_pages(self, ends: dict[int, int]) -> None:
        """Grow each slot's pages to cover its last write position `ends[s]`
        (absolute), in admission order; when the pool is dry, preempt the
        lowest-priority slot (_victim_key) until a page frees, possibly the
        requesting slot itself."""
        for s in sorted(ends, key=lambda s: self.slot_ticket[s]):
            if self.slot_req[s] is None:
                continue  # preempted while serving an earlier slot
            need = ends[s] // self.block_size + 1
            while self.slot_req[s] is not None and len(self.slot_pages[s]) < need:
                page = self.alloc.alloc(owner=s, tenant=self.slot_req[s].tenant)
                if page is None:
                    live = [v for v in range(self.slots) if self.slot_req[v] is not None]
                    self._preempt(max(live, key=self._victim_key))
                    continue
                self.slot_pages[s].append(page)
                self.block_table[s, len(self.slot_pages[s]) - 1] = page
                self._tables_dirty = True

    # ---- observability ------------------------------------------------------------

    @property
    def stats(self) -> dict:
        """The JAX engine's stats, key for key (the resolved modes, KV layout
        and config downgrades included), plus "dispatches": the dispatch
        count per kind.  At tp > 1, JAX's per-shard forms: "attn_backend" and
        "degraded" are {shard: value}, and "tp" holds the shard count, the
        mesh, the axis, the encoding downgrades (none: the ranks keep their
        kernels) and every rank's allocator counters ("per_shard_pages", an
        all-gather: call stats on every rank)."""
        out = {
            "cache_mode": self.cache_mode,
            "decode_mode": self.decode_mode,
            "sample": self.config.sample,
            "kv_quant": self.kv_quant,
            "weight_quant": self.enc.weight_quant,
            "attn_backend": registry_lib.select_attn(
                phase=Phase.DECODE, s=self._attn_s(Phase.DECODE),
                target=self.enc.target, requested=self.enc.attn_backend, kv=self.kv_quant,
            ).backend,
            "steps": self.step_count,
            "dispatches": dict(self.dispatches),
            "watchdog": self.watchdog.summary(),
            "lifecycle": dict(self.lifecycle),
            "degraded": [dict(d) for d in self.degraded],
        }
        if self.tp_shards > 1:
            out["attn_backend"] = {
                k: registry_lib.select_attn(
                    phase=Phase.DECODE, s=self._attn_s(Phase.DECODE), target=self.enc.target,
                    requested=self.enc.attn_backend, kv=self.kv_quant, shard=k,
                ).backend
                for k in range(self.tp_shards)
            }
            out["degraded"] = {k: [dict(d) for d in self.degraded if d.get("shard") in (None, k)]
                               for k in range(self.tp_shards)}
            out["tp"] = {"shards": self.tp_shards, "mesh_shape": list(self.config.mesh_shape),
                         "tp_axis": self.config.tp_axis, "enc_downgrades": []}
            if self.cache_mode == "paged":
                out["tp"]["per_shard_pages"] = collectives.all_gather_object(
                    dict(self.alloc.stats), self.mesh.host_group)
        if self.config.downgrades:
            out["config_downgrades"] = list(self.config.downgrades)
        if self.spec_decode:
            st = dict(self.spec_stats)
            st["acceptance_rate"] = st["accepted"] / max(st["proposed"], 1)
            st["mean_accepted_len"] = st["committed"] / max(st["slot_steps"], 1)
            st["per_slot_proposed"] = self.slot_proposed.tolist()
            st["per_slot_accepted"] = self.slot_accepted.tolist()
            out["spec"] = st
            out["draft_k"] = self.draft_k
        if self.scheduler is not None:
            out["continuous"] = dict(self.continuous)
        if self.cache_mode != "paged":
            return out
        astats = self.alloc.stats
        out.update(astats)
        out.update(
            pages_total=self.alloc.capacity,
            pages_in_use=self.alloc.in_use(),
            pages_free=self.alloc.available(),
            preemptions=self.preemptions,
            peak_active=self.peak_active,
            block_size=self.block_size,
        )
        out["prefix_cache"] = {
            "enabled": self.prefix_cache,
            "hit_blocks": astats["hit_blocks"],
            "hit_tokens": astats["hit_tokens"],
            "lookup_blocks": astats["lookup_blocks"],
            "hit_rate": (astats["hit_blocks"] / astats["lookup_blocks"]
                         if astats["lookup_blocks"] else 0.0),
            "evictions": astats["evictions"],
            "cached_pages": astats["cached_pages"],
            "deferred_hits": self.deferred_hits,
        }
        if self.tenant_quota is not None:
            out["prefix_cache"]["tenant_quota"] = self.tenant_quota
            out["prefix_cache"]["tenant_usage"] = self.alloc.tenant_usage()
        return out

    def stats_view(self) -> dict:
        """`stats` with the mesh-stable schema of the JAX package: attn_backend
        and degraded as {shard: value} dicts (one card: shard 0)."""
        out = self.stats
        if self.tp_shards == 1:
            out["attn_backend"] = {0: out["attn_backend"]}
            out["degraded"] = {0: out["degraded"]}
        return out

    def audit(self) -> None:
        """Assert allocator/table consistency; pages held by a fault hook
        count as one extra table.  A dense cache has nothing to audit.

        At tp > 1 (collective: every rank calls it) every rank's allocator
        counters and audit result are gathered; a rank whose counters differ
        from rank 0's raises AllocatorInvariantError ("diverged", naming the
        first such shard) on every rank, as does a rank whose own audit
        failed, and every rank must hold the same last logits, bit for bit."""
        err = None
        if self.cache_mode == "paged":
            tables = [self.slot_pages[s] for s in range(self.slots)
                      if self.slot_req[s] is not None]
            if self.hooks is not None and hasattr(self.hooks, "held_pages"):
                held = list(self.hooks.held_pages())
                if held:
                    tables.append(held)
            if self.tp_shards == 1:
                self.alloc.audit(tables)
                return
            try:
                self.alloc.audit(tables)
            except AssertionError as exc:
                err = str(exc)
        if self.tp_shards == 1:
            return
        logits = self._last_logits
        digest = (None if logits is None
                  else hashlib.sha256(logits.detach().cpu().numpy().tobytes()).hexdigest())
        stats = dict(self.alloc.stats) if self.cache_mode == "paged" else {}
        rows = collectives.all_gather_object((stats, err, digest), self.mesh.host_group)
        for k, (st, _e, _d) in enumerate(rows[1:], start=1):
            if st != rows[0][0]:
                raise paged_lib.AllocatorInvariantError(
                    f"shard allocators diverged: shard 0 -> {rows[0][0]}, shard {k} -> {st}")
        for k, (_st, e, _d) in enumerate(rows):
            if e is not None:
                raise paged_lib.AllocatorInvariantError(f"shard {k} audit failed: {e}")
        for k, (_st, _e, d) in enumerate(rows[1:], start=1):
            if d != rows[0][2]:
                raise AssertionError(f"ranks hold different logits: shard 0 {rows[0][2]}, "
                                     f"shard {k} {d}")

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
        self.slot_prefill_done[s] = 0
        if self.cache_mode == "paged":
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

    # ---- token-budget admission (no prefill dispatch) ------------------------------

    def _admit_budget(self) -> None:
        """Admission under the token budget: no prefill dispatch here, an
        admitted prompt streams into the cache through the mixed step's chunk
        rows (slot_prefill_done tracks progress).  Candidates go in SLO
        priority order; pool pressure stops admission at the first one that
        does not fit.  Leading prefix-shared pages are reused verbatim only
        once written: a row prefilling from inside an unwritten shared block
        would spray its window-pad writes over the owner's history, so the
        plan is cut at the first unwritten page (or the admission defers to
        let the writer's chunks land)."""
        free = [s for s in range(self.slots) if self.slot_req[s] is None]
        if not free or not self.queue:
            return
        candidates = sorted(self.queue,
                            key=lambda r: self.scheduler.queue_key(r, self.step_count))
        for req in candidates:
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
                continue  # other tenants' work keeps flowing past a capped tenant
            done = 0
            if self.cache_mode == "paged":
                nblocks, shared = self.alloc.plan_prompt(req.prompt)
                lead = 0
                while lead in shared and self.alloc.is_written(shared[lead]):
                    lead += 1
                if lead < len(shared) and self._defer_for_writer(req, lead):
                    continue
                if getattr(req, "_defer_lead", None) is not None:
                    # Admitted after deferring: blocks the wait turned into shares.
                    self.deferred_hits += max(0, lead - req._defer_lead)
                    req._defer_lead = None
                shared = {j: p for j, p in shared.items() if j < lead}
                if not self.alloc.plan_fits(nblocks, shared):
                    break  # pool pressure: the head candidate waits
                plan = self.alloc.commit_prompt(req.prompt, nblocks, shared, tenant=req.tenant)
                if plan is None:
                    raise paged_lib.AllocatorInvariantError(
                        "commit_prompt failed after plan_fits admitted the plan"
                    )
                s = free.pop(0)
                self.slot_pages[s] = list(plan.pages)
                self.alloc.claim_owner(plan.pages, s)
                self.block_table[s, :] = paged_lib.SCRATCH_PAGE
                self.block_table[s, : len(plan.pages)] = plan.pages
                self.slot_ticket[s] = self._ticket
                self._ticket += 1
                self._tables_dirty = True
                done = lead * self.block_size
                self._reserve_quota(req)
            else:
                s = free.pop(0)
            self.queue.remove(req)
            self.slot_req[s] = req
            req.status = "running"
            self.slot_prefill_done[s] = done
            self.slot_pos[s] = done
            self.continuous["chunked_admissions"] += 1

    # A candidate declining unwritten prefix shares re-checks the tree for at
    # most this many admission opportunities before recomputing the prefix
    # privately.
    _DEFER_CAP = 4

    def _defer_for_writer(self, req: Request, lead: int) -> bool:
        """Whether to hold `req` out of this admission round because part of
        its tree-matched prefix is still unwritten; records the written lead
        so the eventual admission can count the blocks the wait recovered."""
        count = getattr(req, "_defer_count", 0)
        if count >= self._DEFER_CAP:
            return False
        req._defer_count = count + 1
        req._defer_lead = lead
        return True

    # ---- speculative decode (prompt-lookup drafts + one verify dispatch) -----------

    def _plan_drafts(self, active: list[int], k_max: int | None = None):
        """(L, {slot: draft}) for this step's verify window, or None for the
        plain one-token path (no headroom, or nothing to propose).  `k_max`
        caps drafts below draft_k (the mixed step's budget share).  One shared
        L: every row's last window write lands at pos-1 + L-1, which must stay
        inside max_seq even for pad rows."""
        k = self.draft_k if k_max is None else min(self.draft_k, int(k_max))
        head = min(self.max_seq - int(self.slot_pos[s]) + 1 for s in active)
        L = min(1 + k, head)
        if L <= 1:
            return None
        drafts: dict[int, np.ndarray] = {}
        any_draft = False
        for s in active:
            req = self.slot_req[s]
            # A commit is at most accepted drafts + 1 bonus token: never draft
            # past the request's remaining budget.
            kk = min(L - 1, max(req.max_new_tokens - len(req.generated) - 1, 0))
            d = spec_lib._EMPTY
            if kk > 0:
                ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                                      np.asarray(req.generated, np.int32)])
                d = np.asarray(self.drafter(ctx, kk), np.int32).ravel()[:kk]
            drafts[s] = d
            any_draft = any_draft or d.size > 0
        return (L, drafts) if any_draft else None

    def _draft_pages_fit(self, active: list[int], L: int) -> bool:
        """Every active slot's draft window (positions through pos-1 + L-1)
        fits the free pool as it is: speculation never preempts a live
        request for pages only unverified drafts need.  available() counts
        evictable cached pages, so drafts may drain cold prefix cache."""
        need = 0
        for s in active:
            pos = max(int(self.slot_pos[s]) - 1, 0) + L - 1
            need += max(0, pos // self.block_size + 1 - len(self.slot_pages[s]))
        return need <= self.alloc.available()

    def _truncate_slot_pages(self, s: int) -> None:
        """Spec rollback: return the pages only rejected drafts touched (the
        committed history plus the next write position, slot_pos - 1, define
        what the slot keeps).  Stale draft K/V in kept pages stays masked
        until overwritten.  Draft pages are trailing decode growth, never
        radix-registered prompt blocks; the assert keeps that contract."""
        need = (int(self.slot_pos[s]) - 1) // self.block_size + 1
        extra = self.slot_pages[s][need:]
        if not extra:
            return
        assert not any(self.alloc.is_registered(p) for p in extra), (
            "spec rollback would free radix-registered pages"
        )
        self.slot_pages[s] = self.slot_pages[s][:need]
        req = self.slot_req[s]
        self.alloc.free_pages(
            extra, owner=s,
            tenant=req.tenant if req is not None else paged_lib.DEFAULT_TENANT,
        )
        self.block_table[s, need:] = paged_lib.SCRATCH_PAGE
        self._tables_dirty = True

    def _accept(self, s: int, d: np.ndarray, tgt_row: np.ndarray, st: dict | None) -> int:
        """Commit slot s's longest greedy-consistent draft prefix plus the
        bonus token and account it; returns the tokens emitted.  A finish
        inside the window (EOS among accepted drafts, max_new_tokens,
        max_seq) truncates the commit, and only the drafts consumed count."""
        a = 0
        while a < d.size and int(d[a]) == int(tgt_row[a]):
            a += 1
        commit = [int(t) for t in d[:a]] + [int(tgt_row[a])]
        req = self.slot_req[s]
        got = self._commit_tokens(s, commit)
        if st is not None:
            if got == len(commit):
                scored, used = int(d.size), a
            else:
                scored = used = min(got, a)
            req.draft_proposed += scored
            req.draft_accepted += used
            self.slot_proposed[s] += scored
            self.slot_accepted[s] += used
            st["slot_steps"] += 1
            st["proposed"] += scored
            st["accepted"] += used
            st["committed"] += got
        if self.cache_mode == "paged" and self.slot_req[s] is not None:
            self._truncate_slot_pages(s)
        return got

    def _spec_step(self, active: list[int], L: int, drafts: dict) -> int:
        """ONE verify dispatch scores every slot's draft window; each slot
        commits its longest greedy-consistent prefix plus the bonus token."""
        mat = np.zeros((self.slots, L), np.int32)
        mat[:, :1] = self._last_tokens(active)
        for s in active:
            mat[s, 1: 1 + drafts[s].size] = drafts[s]
        pos = np.maximum(self.slot_pos.astype(np.int32) - 1, 0)
        self._window_m = self.slots * L
        logits = self._dispatch("verify", self._window, self._tensor(mat), self._tensor(pos))
        bad = self._guard_slots(logits, active)
        # tgt[s, j]: the greedy token after mat[s, :j+1] -- the acceptance
        # target of draft j and the bonus token at the cut.
        tgt = torch.argmax(logits, dim=-1).cpu().numpy()
        st = self.spec_stats
        st["steps"] += 1
        emitted = 0
        for s in active:
            if s in bad:
                self._finish_slot(s, status="error",
                                  error="non-finite logits (guard tripped, verify)")
                continue
            if self.slot_req[s].cancel_requested:
                self._finish_slot(s, status="cancelled", error="cancelled mid-dispatch")
                continue
            emitted += self._accept(s, drafts[s], tgt[s], st)
        return emitted

    # ---- token-budget mixed step (chunked prefill beside decode) --------------------

    def _mixed_step(self) -> int:
        """ONE budget-bounded decode-phase dispatch for every active slot:
        decode rows spend 1 token (or their verify window), prefill rows a
        chunk of their remaining prompt.  Row r's window holds positions
        start_r .. start_r + L - 1 (start = slot_pos - 1 for decode, the
        prefill progress for prefill); the masked-causal window over the
        committed history is chunked-prefill masking.  Pads write garbage K/V
        strictly past every row's real content, L is capped so no pad reaches
        max_seq, and the table is widened to the window (_live_table_width).
        A prefill row's final chunk yields its first token in the same
        dispatch, so output equals sequential prefill-then-decode."""
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return 0
        cont = self.continuous
        decode_rows = [s for s in active
                       if self.slot_prefill_done[s] >= len(self.slot_req[s].prompt)]
        prefill_rows = [s for s in active if s not in decode_rows]
        start = {s: (max(int(self.slot_pos[s]) - 1, 0) if s in decode_rows
                     else int(self.slot_prefill_done[s])) for s in active}
        head = min(self.max_seq - start[s] for s in active)

        # Spec drafts for decode rows, capped by the budget's spare share.
        drafts: dict[int, np.ndarray] = {}
        if self.spec_decode and decode_rows:
            k_cap = spec_lib.draft_budget(self.draft_k, len(decode_rows), self.token_budget)
            plan = (self._plan_drafts(decode_rows, k_max=min(k_cap, head - 1))
                    if k_cap > 0 and head > 1 else None)
            if plan is not None:
                drafts = {s: d for s, d in plan[1].items() if d.size}
            if drafts and self.cache_mode == "paged":
                # Never preempt a live request for pages only drafts need.
                need = sum(max(0, (start[s] + int(drafts[s].size)) // self.block_size
                               + 1 - len(self.slot_pages[s])) for s in drafts)
                if need > self.alloc.available():
                    self.spec_stats["pool_deferred"] += 1
                    drafts = {}

        # Budget split: decode rows first, prefill chunks take the rest (at
        # least 1 token per prefill row).
        empty = spec_lib._EMPTY
        decode_cost = sum(1 + int(drafts.get(s, empty).size) for s in decode_rows)
        chunks: dict[int, int] = {}
        if prefill_rows:
            remaining = {s: len(self.slot_req[s].prompt) - int(self.slot_prefill_done[s])
                         for s in prefill_rows}
            order = sorted(prefill_rows, key=lambda s: (
                self.scheduler.rank(self.slot_req[s]),
                int(self.slot_ticket[s]) if self.cache_mode == "paged" else s))
            chunks = self.scheduler.split_chunks(decode_cost, remaining, order)
            chunks = {s: min(c, head) for s, c in chunks.items()}

        # Shared window width, a power of two (the head cap still rules).
        width = 1
        for s in decode_rows:
            width = max(width, 1 + int(drafts.get(s, empty).size))
        for s in prefill_rows:
            width = max(width, chunks[s])
        L = min(1 << (width - 1).bit_length(), head)

        if self.cache_mode == "paged":
            ends = {s: start[s] + int(drafts.get(s, empty).size) for s in decode_rows}
            ends.update({s: start[s] + chunks[s] - 1 for s in prefill_rows})
            self._ensure_pages(ends)
            if any(self.slot_req[s] is None for s in active):
                # Pool growth preempted someone: replan against the survivors.
                return self._mixed_step()
            self.peak_active = max(self.peak_active, len(active))
            wb = max((start[s] + L - 1) // self.block_size + 1 for s in active)
            if wb != self._window_blocks:
                self._window_blocks = wb
                self._tables_dirty = True
        self._refresh_tables()

        k_cols = 1 + self.draft_k if self.spec_decode else 1
        mat = np.zeros((self.slots, L), np.int32)
        pos = np.zeros(self.slots, np.int32)
        idx = np.zeros((self.slots, k_cols), np.int64)
        for s in decode_rows:
            req = self.slot_req[s]
            mat[s, 0] = req.generated[-1] if req.generated else int(req.prompt[-1])
            d = drafts.get(s, empty)
            mat[s, 1: 1 + d.size] = d
            pos[s] = start[s]
            idx[s] = np.minimum(np.arange(k_cols), L - 1)
        for s in prefill_rows:
            req = self.slot_req[s]
            done, c = int(self.slot_prefill_done[s]), chunks[s]
            mat[s, :c] = np.asarray(req.prompt[done: done + c], np.int32)
            pos[s] = done
            idx[s] = c - 1  # the final chunk's first-token logit; unused otherwise

        self._window_m = self.slots * L
        cont["mixed_steps"] += 1
        cont["decode_tokens"] += decode_cost
        cont["prefill_tokens"] += sum(chunks.values())
        logits = self._dispatch("mixed", self._window, self._tensor(mat), self._tensor(pos),
                                self._tensor(idx))
        bad = self._guard_slots(logits, active)
        # tgt[s, j]: the greedy token after mat[s, :idx[s, j]+1].
        tgt = torch.argmax(logits, dim=-1).cpu().numpy()
        st = self.spec_stats if (self.spec_decode and drafts) else None
        if st is not None:
            st["steps"] += 1
        emitted = decode_emitted = 0
        for s in active:
            if self.slot_req[s] is None:
                continue
            if s in bad:
                self._finish_slot(s, status="error",
                                  error="non-finite logits (guard tripped, mixed)")
                continue
            req = self.slot_req[s]
            if req.cancel_requested:
                self._finish_slot(s, status="cancelled", error="cancelled mid-dispatch")
                continue
            if s in chunks:
                # Prefill row: the chunk's K/V landed this dispatch; fully
                # covered prompt blocks are now shareable prefix content.
                done = int(self.slot_prefill_done[s]) + chunks[s]
                self.slot_prefill_done[s] = done
                self.slot_pos[s] = done
                if self.cache_mode == "paged":
                    self.alloc.mark_written(self.slot_pages[s][: done // self.block_size])
                if done >= len(req.prompt):
                    cont["completed_prefills"] += 1
                    emitted += self._commit_tokens(s, [int(tgt[s, 0])])
                continue
            got = self._accept(s, drafts.get(s, empty), tgt[s], st)
            emitted += got
            decode_emitted += got
        if decode_rows and decode_emitted == 0 and any(
            self.slot_req[s] is not None for s in decode_rows
        ):
            # A live decode row emitted nothing: the stall the budget prevents.
            cont["decode_stall_steps"] += 1
        return emitted

    # ---- the step loop -------------------------------------------------------------

    def step(self) -> int:
        """One iteration: fault hooks, lifecycle sweep, admission, then ONE
        dispatch for every active slot (decode, verify or mixed), bracketed
        by the watchdog.  Returns the tokens emitted."""
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
        if self.scheduler is not None:
            self._admit_budget()
            return self._mixed_step()
        if self.cache_mode == "paged":
            self._admit_paged()
        else:
            self._admit_dense()
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return 0
        spec_plan = self._plan_drafts(active) if self.spec_decode else None
        if self.cache_mode == "paged":
            if spec_plan is not None and not self._draft_pages_fit(active, spec_plan[0]):
                self.spec_stats["pool_deferred"] += 1
                spec_plan = None
            self._ensure_decode_pages(extra=(spec_plan[0] - 1) if spec_plan else 0)
            # Decode growth may have preempted slots (requests requeued).
            active = [s for s in range(self.slots) if self.slot_req[s] is not None]
            if not active:
                return 0
            self.peak_active = max(self.peak_active, len(active))
            if spec_plan is not None:
                L, drafts = spec_plan
                drafts = {s: d for s, d in drafts.items() if s in active}
                spec_plan = (L, drafts) if any(d.size for d in drafts.values()) else None
        self._refresh_tables()
        if spec_plan is not None:
            return self._spec_step(active, *spec_plan)
        tokens = self._tensor(self._last_tokens(active))
        if self.decode_mode == "vectorized":
            # Inactive rows decode token 0 at pos 0 (the scratch page of a
            # paged cache; a dense row's slot 0, rewritten by its next prefill).
            pos = self._tensor(np.maximum(self.slot_pos.astype(np.int32) - 1, 0))
            nxt, logits = self._dispatch("decode", self._decode, tokens, pos, self.caches,
                                         *self._sample_args(active))
            bad = self._guard_slots(logits, active)
            return self._commit(active, nxt.cpu().numpy(), bad)
        # Grouped decode: one dispatch per group of slots at the same
        # position, over a copy of the whole cache at that shared position;
        # only the group's rows merge back, so other rows' histories stay.
        groups: dict[int, list[int]] = {}
        for s in active:
            groups.setdefault(int(self.slot_pos[s]), []).append(s)
        emitted = 0
        for p, group in groups.items():
            part = slot_gather(self.caches, list(range(self.slots)))
            nxt, logits = self._dispatch("decode", self._decode, tokens, p - 1, part,
                                         *self._sample_args(group))
            slot_merge(self.caches, part, group)
            bad = self._guard_slots(logits, group)
            emitted += self._commit(group, nxt.cpu().numpy(), bad)
        return emitted

    # ---- dense admission -------------------------------------------------------------

    def _admit_dense(self) -> None:
        """Admission on the dense cache, FIFO into free slots.  Several
        admissions prefill as ONE right-padded batch (padded to a power of
        two, at most max_seq) through their own cache rows (slot_gather /
        slot_merge): pad tokens write only slots the decode mask never reads
        before a real token lands there.  A lone admission (or batch_prefill
        off) prefills its exact prompt.  Each admission's recurrent state
        starts from zero (T.zero_state), never from its slot's last request."""
        free = [s for s in range(self.slots) if self.slot_req[s] is None]
        batch: list[tuple[int, Request]] = []
        while free and self.queue:
            req = self.queue.popleft()
            if req.max_new_tokens <= 0:
                self._finish_degenerate(req)
                continue
            if req.cancel_requested or self._past_deadline(req):
                self._admission_reap(req)
                continue
            batch.append((free.pop(0), req))
        if not batch:
            return
        if self.batch_prefill and len(batch) > 1:
            slots_sel = [s for s, _ in batch]
            maxlen = max(len(r.prompt) for _, r in batch)
            maxlen = min(1 << (maxlen - 1).bit_length(), self.max_seq)
            toks = np.zeros((len(batch), maxlen), np.int32)
            for i, (_, r) in enumerate(batch):
                toks[i, : len(r.prompt)] = r.prompt
            part = T.zero_state(self.cfg, slot_gather(self.caches, slots_sel))
            self._dispatch("prefill", self._prefill, self._tensor(toks), part)
            slot_merge(self.caches, part, slots_sel, list(range(len(batch))))
        else:
            for s, r in batch:
                part = T.zero_state(self.cfg, slot_slice(self.caches, s))
                toks = np.asarray(r.prompt, np.int32)[None]
                self._dispatch("prefill", self._prefill, self._tensor(toks), part)
                slot_merge(self.caches, part, [s], [0])
        for s, r in batch:
            self.slot_req[s] = r
            r.status = "running"
            self.slot_pos[s] = len(r.prompt)
            self.slot_prefill_done[s] = len(r.prompt)

    def run(self) -> list[Request]:
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
        return self.finished
