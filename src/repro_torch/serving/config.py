"""EngineConfig — the serving engine's consolidated, validated configuration.

A copy of repro/serving/config.py (the port imports nothing of `repro`):
the same fields, validation, resolve() rules and from_args routing, so a
config reads the same in both packages.  The port's Engine raises
NotImplementedError for the fields whose slice has not landed yet
(serving/engine.py).

`Engine.__init__` historically grew ~15 ad-hoc keyword arguments (cache mode,
paging geometry, speculative decode, token budget, SLO aging, sampling, ...),
each validated and cross-downgraded inline in the constructor.  This module
pulls all of that into one frozen dataclass:

  * construction-time validation (`__post_init__`) — bad values fail at the
    config, not three layers into engine setup;
  * `resolve(model_cfg)` — the cross-field auto-downgrade rules (paged->dense
    for sliding-window models, spec-off-under-sampling, grouped decode for
    recurrent families, ...) applied against a concrete model config,
    returning a NEW config whose fields are what the engine will actually
    run, with every applied rule recorded in `downgrades`;
  * `from_args(namespace)` — argparse routing for launch/serve.py;
  * the tensor-parallel fields `mesh_shape` / `tp_axis` for sharded serving
    over a jax device mesh (launch/mesh.build_serving_mesh).

Engine keeps a deprecation shim — `Engine(params, cfg, enc, slots=8, ...)`
still works and is folded into `EngineConfig(**kwargs)` — but new call sites
should build the config explicitly:

    cfg = EngineConfig(slots=8, token_budget=64, mesh_shape=(2,))
    eng = Engine(params, model_cfg, enc, config=cfg)

Callables (drafter, clock, fault_hooks, stream_cb) are runtime wiring, not
configuration: they stay keyword arguments on Engine and never enter the
frozen config (a config must stay hashable/serializable/comparable).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.encoding import KV_QUANTS

SAMPLE_MODES = ("greedy", "temperature")
DECODE_MODES = ("vectorized", "grouped")
CACHE_MODES = ("paged", "dense")

# The weight/cache sharding rules in parallel/sharding.py are keyed to the
# mesh axis literally named "model"; a differently-named TP axis would
# silently shard nothing.
TP_AXIS_NAMES = ("model",)


def _attn_only(model_cfg) -> bool:
    return all(t == "attn" for t in model_cfg.block_pattern)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen serving-engine configuration.  Field semantics match the
    long-standing Engine kwargs (serving/engine.py class docstring);
    `mesh_shape`/`tp_axis` are the tensor-parallel additions."""

    slots: int = 4
    max_seq: int = 256
    decode_mode: str = "vectorized"
    batch_prefill: bool = True
    cache_mode: str = "paged"
    block_size: int = 16
    pool_pages: int | None = None
    # KV-cache storage layout: "bf16" (raw), "kv8" (int8 + per-page scales),
    # "kv4" (packed int4 + per-page scales).  Quantized layouts require the
    # paged cache (scale pages ride the block table); resolve() downgrades
    # to bf16 whenever cache_mode lands on dense, and Engine further
    # downgrades kv4 -> kv8 when the attention backend cannot dequantize
    # packed nibbles in-kernel (xla/reference fallbacks).
    kv_quant: str = "bf16"
    # Radix-tree prefix cache (docs/PERF.md §Prefix caching): finished
    # requests park their immutable full KV blocks in a tree keyed by token
    # blocks; later admissions reuse the longest-common-prefix run and
    # prefill only the suffix.  Cached (refcount-0) pages are reclaimed by
    # refcount-aware LRU eviction only when alloc() would otherwise fail,
    # so the flag trades zero steady-state memory for cross-request reuse.
    # Paged-cache only; the dense engine ignores it.
    prefix_cache: bool = True
    # Per-tenant page quota (None = unlimited): an upper bound on the
    # worst-case page reservation any one tenant may hold across its
    # admitted requests, so one tenant's long-context jobs cannot starve
    # the pool (docs/PERF.md §Prefix caching — tenant quotas).
    tenant_quota: int | None = None
    sample: str = "greedy"
    seed: int = 0
    spec_decode: bool = False
    draft_k: int = 4
    max_queue: int | None = None
    logits_guard: bool = True
    token_budget: int | None = None
    slo_aging_steps: int = 64
    # ---- tensor parallelism (docs/PERF.md §Tensor-parallel capacity) -------
    # Device-mesh shape for sharded serving: (1,) = single device (the
    # default; nothing is device_put), (2,)/(4,) = 2/4-way tensor parallel.
    # A 2-d shape (d, t) adds a leading "data" axis (replicated serving
    # batch; reserved for data-parallel replicas).  The product must not
    # exceed jax.device_count() — launch/mesh.build_serving_mesh raises a
    # clear error instead of silently running mesh=1.
    mesh_shape: tuple[int, ...] = (1,)
    tp_axis: str = "model"
    # Audit trail of resolve()'s applied auto-downgrade rules, e.g.
    # ("cache_mode:dense(sliding_window)", "spec_decode:off(sample)").
    # Empty on a hand-built config; populated only by resolve().
    downgrades: tuple[str, ...] = ()

    def __post_init__(self):
        if self.decode_mode not in DECODE_MODES:
            raise ValueError(
                f"decode_mode must be one of {DECODE_MODES}, "
                f"got {self.decode_mode!r}"
            )
        if self.cache_mode not in CACHE_MODES:
            raise ValueError(
                f"cache_mode must be one of {CACHE_MODES}, "
                f"got {self.cache_mode!r}"
            )
        if self.sample not in SAMPLE_MODES:
            raise ValueError(
                f"sample must be one of {SAMPLE_MODES}, got {self.sample!r}"
            )
        if self.kv_quant not in KV_QUANTS:
            raise ValueError(
                f"kv_quant must be one of {KV_QUANTS}, got {self.kv_quant!r}"
            )
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")
        if self.block_size < 1 or (self.block_size & (self.block_size - 1)):
            raise ValueError(
                f"block_size must be a power of two >= 1, got {self.block_size}"
            )
        if self.pool_pages is not None and self.pool_pages < 2:
            raise ValueError(
                f"pool_pages must be >= 2 (scratch + one page), "
                f"got {self.pool_pages}"
            )
        if self.tenant_quota is not None and self.tenant_quota < 1:
            raise ValueError(
                f"tenant_quota must be >= 1 pages, got {self.tenant_quota}"
            )
        if self.draft_k < 0:
            raise ValueError(f"draft_k must be >= 0, got {self.draft_k}")
        if self.token_budget is not None and self.token_budget < 1:
            raise ValueError(
                f"token_budget must be >= 1, got {self.token_budget}"
            )
        if self.slo_aging_steps < 1:
            raise ValueError(
                f"slo_aging_steps must be >= 1, got {self.slo_aging_steps}"
            )
        if self.max_queue is not None and self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")
        # mesh_shape arrives as a list from argparse / JSON round trips;
        # freeze it to a tuple so the config stays hashable.
        shape = tuple(int(n) for n in self.mesh_shape)
        if not shape or any(n < 1 for n in shape):
            raise ValueError(
                f"mesh_shape must be a non-empty tuple of positive ints, "
                f"got {self.mesh_shape!r}"
            )
        if len(shape) > 3:
            raise ValueError(
                f"mesh_shape supports at most 3 axes (pod, data, tp), "
                f"got {self.mesh_shape!r}"
            )
        object.__setattr__(self, "mesh_shape", shape)
        if self.tp_shards > 1 and self.tp_axis not in TP_AXIS_NAMES:
            raise ValueError(
                f"tp_axis must be one of {TP_AXIS_NAMES} (the sharding rules "
                f"in parallel/sharding.py are keyed to the axis name), "
                f"got {self.tp_axis!r}"
            )
        object.__setattr__(self, "downgrades", tuple(self.downgrades))

    # ---- derived -----------------------------------------------------------

    @property
    def tp_shards(self) -> int:
        """Tensor-parallel degree: the trailing mesh axis (leading axes are
        data/pod replicas)."""
        return int(self.mesh_shape[-1])

    @property
    def mesh_devices(self) -> int:
        return int(math.prod(self.mesh_shape))

    # ---- cross-field auto-downgrade ----------------------------------------

    def resolve(self, model_cfg) -> "EngineConfig":
        """Apply the cross-field downgrade rules against `model_cfg` and
        return the configuration the engine will actually run.  Idempotent;
        every applied rule is appended to `downgrades` (surfaced through
        Engine.stats so a silently-degraded deployment is visible)."""
        changes: dict = {}
        notes: list[str] = list(self.downgrades)
        attn_only = _attn_only(model_cfg)
        window = getattr(model_cfg, "sliding_window", 0)

        # Vectorized decode is only sound for attention KV caches, where an
        # inactive row's write lands at a masked position; recurrent state
        # (rec/rwkv) has no position mask, so those families keep grouped.
        decode_mode = self.decode_mode
        if decode_mode == "vectorized" and not attn_only:
            decode_mode = "grouped"
            changes["decode_mode"] = decode_mode
            notes.append("decode_mode:grouped(recurrent_blocks)")

        # Paged KV needs position-masked attention reads and the per-slot
        # pos vector of the vectorized step.
        cache_mode = self.cache_mode
        if cache_mode == "paged" and (
            not attn_only or window != 0 or decode_mode != "vectorized"
        ):
            cache_mode = "dense"
            changes["cache_mode"] = cache_mode
            why = (
                "recurrent_blocks" if not attn_only
                else "sliding_window" if window != 0
                else "grouped_decode"
            )
            notes.append(f"cache_mode:dense({why})")

        # Quantized KV layouts live in the paged pool (per-page scale
        # storage rides the block table); the dense cache stays raw bf16.
        if self.kv_quant != "bf16" and cache_mode != "paged":
            changes["kv_quant"] = "bf16"
            notes.append("kv_quant:bf16(dense_cache)")

        # Speculation needs greedy-exact acceptance and the masked verify
        # window; sampling has no greedy target, so it switches spec off.
        spec_ok = (
            attn_only and window == 0 and decode_mode == "vectorized"
            and self.sample == "greedy" and self.draft_k > 0
        )
        if self.spec_decode and not spec_ok:
            changes["spec_decode"] = False
            why = (
                "sample" if self.sample != "greedy"
                else "draft_k" if self.draft_k <= 0
                else "model_family"
            )
            notes.append(f"spec_decode:off({why})")

        # The token-budget mixed window rides the same verify machinery.
        budget_ok = (
            attn_only and window == 0 and decode_mode == "vectorized"
            and self.sample == "greedy"
        )
        if self.token_budget is not None and not budget_ok:
            changes["token_budget"] = None
            notes.append("token_budget:off(needs_verify_window)")

        # Batched prefill right-pads; recurrent state and ring-buffer caches
        # would absorb the pad garbage.
        if self.batch_prefill and not (attn_only and window == 0):
            changes["batch_prefill"] = False
            notes.append("batch_prefill:off(model_family)")

        if not changes and tuple(notes) == self.downgrades:
            return self
        return dataclasses.replace(self, downgrades=tuple(notes), **changes)

    # ---- argparse routing (launch/serve.py) --------------------------------

    @classmethod
    def from_args(cls, args) -> "EngineConfig":
        """Build a config from an argparse namespace, mapping any attribute
        that names a config field (missing attributes keep their default).
        `mesh_shape` additionally accepts the CLI string forms "2" and
        "2x4"."""
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name == "downgrades" or not hasattr(args, f.name):
                continue
            kwargs[f.name] = getattr(args, f.name)
        shape = kwargs.get("mesh_shape")
        if isinstance(shape, str):
            kwargs["mesh_shape"] = tuple(
                int(p) for p in shape.replace(",", "x").split("x") if p
            )
        return cls(**kwargs)
