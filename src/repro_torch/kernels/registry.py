"""Dispatch registry (counterpart of repro/kernels/registry.py).

Key formats, the resolution ladder and the quarantine tier are the JAX
package's, so a key, a policy decision or a demotion reads the same in both:

    matmul : "{quant}|{phase}|{M-bucket}|{target}"   M-bucket m1/m8/m32/m64/big
    attn   : "attn|{phase}|{S-bucket}|{target}"      S-bucket s256/s1k/s4k/sbig
             "attn|{phase}|{S-bucket}|{kv}|{target}" kv8/kv4 KV layouts

Resolution order (both op classes):
  1. an explicit `requested` backend (tests and benchmarks pin paths);
  2. the static policy (`default_backend` / `default_attn_backend`) for a
     key of a known target;
  3. the fallback: "reference" for matmul, "xla" (the plain attention) for
     attention.
The JAX ladder's tuned-table rung sits between 1 and 2; the h100 target has
no tuned table, so the rung is absent until the port's kernel benchmark
measures one (ROADMAP, benchmarks).
The h100 target is a known target here; a target missing from
KNOWN_TARGETS would resolve every key to the fallback, i.e. silently run the
plain path on the card.

Quarantine: a key whose dispatch raised is demoted down its ladder for the
rest of the process (`demote`), past every rung that would pick the failing
backend again; the demotion outranks even an explicit request.  The
serving engine records each demotion in Engine.stats["degraded"].  The
quarantine table is process-wide by design: one bad kernel must stay out of
every engine of the process.  A fault tagged with a tensor-parallel shard
demotes that shard's entry only ("key@shardN"), which every rank's dispatch
still honours (JAX's shard-aware quarantine).  Attention keys carry the KV layout (kv8/kv4
insert it before the target), so quarantine is tracked per layout: a kernel
that fails on int4 pages does not quarantine the bf16 path.

Backend names keep the JAX vocabulary.  For matmul: "reference" (un-encoded
torch.matmul), "xla" (plain pack + mmt4d + unpack), "fused" (the CUDA GEMV
at decode, the CUDA GEMM otherwise) and "pallas" (the packed CUDA mmt4d
GEMV for one decode row block or the packed mmt4d GEMM, each entered with
plain rows: the activation pack is its TMA loads', the output unpack its
stores', one launch a projection).  For the quantized keys (w8a8, w4a8):
"fused" (the int8 or int4 CUDA GEMV at decode with at most 8 rows, the
packed q8 or q4 GEMM otherwise), "pallas" (the packed q8 or q4 GEMM; both
packed GEMMs through their plain-row entries) and "xla" (their plain
oracle, the fallback).  For attention: "xla" (plain) and "pallas" (the CUDA
flash-prefill, paged-decode and dense-decode kernels).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import encoding
from repro_torch.core import targets as targets_lib

Phase = encoding.Phase

QUANTS = ("none", "w8a8", "w4a8")
KNOWN_TARGETS = (targets_lib.H100.name,)

BACKENDS_BY_QUANT = {
    "none": ("reference", "xla", "pallas", "fused"),
    "w8a8": ("xla", "pallas", "fused"),
    "w4a8": ("xla", "pallas", "fused"),
}
FALLBACK_BACKEND = {"none": "reference", "w8a8": "xla", "w4a8": "xla"}


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    backend: str
    source: str = "default"  # "requested" | "default" | "fallback" (maybe "quarantined:"-prefixed)


def m_bucket(m: int) -> str:
    if m <= 1:
        return "m1"
    if m <= 8:
        return "m8"
    if m <= 32:
        return "m32"
    if m <= 64:
        return "m64"
    return "big"


def dispatch_key(quant: str, phase: Phase, m: int, target_name: str) -> str:
    return f"{quant}|{phase.value}|{m_bucket(m)}|{target_name}"


def default_backend(quant: str, phase: Phase, bucket: str = "") -> str:
    """Static matmul policy (the JAX package's): decode at one to eight rows
    takes the fused GEMV; more decode rows (spec-verify window, mixed step,
    many slots) take the packed mmt4d GEMM; prefill takes the fused GEMM for
    unquantized weights and the packed kernel for quantized ones."""
    if phase is Phase.DECODE:
        return "pallas" if bucket in ("m32", "m64", "big") else "fused"
    return "fused" if quant == "none" else "pallas"


def default_attn_backend(phase: Phase, bucket: str = "") -> str:
    """Static attention policy: every phase of a known target takes the
    kernels (the paged kernel reads only live pages; the flash kernel skips
    chunks above the diagonal)."""
    return "pallas"


# ---- quarantine ---------------------------------------------------------------
#
# Tensor-parallel serving makes the table shard-aware, as in the JAX
# package: a fault attributed to one shard demotes only that shard's entry,
# stored under "key@shardN", never the key itself.  Every rank dispatches
# with shard=None, which takes the max level over the key and all its shard
# entries (JAX's single SPMD dispatch), so every rank runs the same rung and
# the ranks stay in lockstep.  An explicit shard resolves that shard's view
# only (the key's own entry plus that shard's): Engine.stats reports it.

_quarantine: dict[str, dict] = {}

_SHARD_SEP = "@shard"


def _shard_key(key: str, shard: int) -> str:
    return f"{key}{_SHARD_SEP}{int(shard)}"


def quarantine_level(key: str, shard: int | None = None) -> int:
    """Demotion level of `key`: with shard=None the level every rank's
    dispatch honours (the max over the key and each of its shard entries),
    with shard=k the level seen from shard k alone."""
    entry = _quarantine.get(key)
    lvl = entry["level"] if entry else 0
    if shard is None:
        prefix = key + _SHARD_SEP
        for k, e in _quarantine.items():
            if k.startswith(prefix):
                lvl = max(lvl, e["level"])
    else:
        e = _quarantine.get(_shard_key(key, shard))
        if e is not None:
            lvl = max(lvl, e["level"])
    return lvl


def quarantine_snapshot() -> dict[str, dict]:
    """{key: {"level", "from", "to", "reason"[, "shard"]}} for every demoted
    key; shard-local demotions appear under their "key@shardN" entry."""
    return {k: dict(v) for k, v in _quarantine.items()}


def clear_quarantine() -> None:
    """Reset all demotions (tests; a serving process never un-quarantines)."""
    _quarantine.clear()


def _apply_quarantine(key: str, ladder: list[tuple[str, str]],
                      shard: int | None = None) -> KernelChoice:
    lvl = quarantine_level(key, shard)
    backend, source = ladder[min(lvl, len(ladder) - 1)]
    return KernelChoice(backend, f"quarantined:{source}" if lvl > 0 else source)


# ---- ladders --------------------------------------------------------------------


def _matmul_ladder(quant: str, phase: Phase, bucket: str, target_name: str,
                   requested: str | None) -> list[tuple[str, str]]:
    valid = BACKENDS_BY_QUANT.get(quant, ())
    ladder: list[tuple[str, str]] = []
    if requested not in (None, "auto"):
        if requested not in valid:
            raise ValueError(
                f"backend {requested!r} is not valid for quant={quant!r} "
                f"(valid: {valid}); use 'auto' for registry routing"
            )
        ladder.append((requested, "requested"))
    if quant in QUANTS and isinstance(phase, Phase) and target_name in KNOWN_TARGETS:
        ladder.append((default_backend(quant, phase, bucket), "default"))
    ladder.append((FALLBACK_BACKEND.get(quant, "reference"), "fallback"))
    return ladder


ATTN_OP = "attn"
ATTN_BACKENDS = ("xla", "pallas")
ATTN_FALLBACK_BACKEND = "xla"


def s_bucket(s: int) -> str:
    """Context-length bucket: the logical KV length the dispatch attends."""
    if s <= 256:
        return "s256"
    if s <= 1024:
        return "s1k"
    if s <= 4096:
        return "s4k"
    return "sbig"


def attn_dispatch_key(phase: Phase, s: int, target_name: str, kv: str = "bf16") -> str:
    """Attention dispatch key: the 4-segment form for bf16, the kv8/kv4
    layout inserted before the target otherwise."""
    if kv in (None, "bf16"):
        return f"{ATTN_OP}|{phase.value}|{s_bucket(s)}|{target_name}"
    if kv not in encoding.KV_QUANTS:
        raise ValueError(f"unknown kv_quant {kv!r}; expected one of {encoding.KV_QUANTS}")
    return f"{ATTN_OP}|{phase.value}|{s_bucket(s)}|{kv}|{target_name}"


def split_attn_key(key: str) -> tuple[str, str, str, str]:
    """attn key -> (phase value, S-bucket, kv layout, target name), for the
    4-segment (bf16) and the 5-segment (kv8/kv4) form."""
    parts = key.split("|")
    if parts[0] != ATTN_OP:
        raise ValueError(f"not an attn key: {key!r}")
    if len(parts) == 4:
        return parts[1], parts[2], "bf16", parts[3]
    if len(parts) == 5 and parts[3] in encoding.KV_QUANTS:
        return parts[1], parts[2], parts[3], parts[4]
    raise ValueError(f"malformed attn key: {key!r}")


def _attn_ladder(phase: Phase, bucket: str, target_name: str,
                 requested: str | None) -> list[tuple[str, str]]:
    ladder: list[tuple[str, str]] = []
    if requested not in (None, "auto"):
        if requested not in ATTN_BACKENDS:
            raise ValueError(
                f"attention backend {requested!r} is not valid "
                f"(valid: {ATTN_BACKENDS}); use 'auto' for registry routing"
            )
        ladder.append((requested, "requested"))
    if isinstance(phase, Phase) and target_name in KNOWN_TARGETS:
        ladder.append((default_attn_backend(phase, bucket), "default"))
    ladder.append((ATTN_FALLBACK_BACKEND, "fallback"))
    return ladder


def _ladder_for_key(key: str, requested: str | None) -> list[tuple[str, str]]:
    if key.startswith(ATTN_OP + "|"):
        phase_val, bucket, _kv, target_name = split_attn_key(key)
        return _attn_ladder(Phase(phase_val), bucket, target_name, requested)
    op, phase_val, bucket, target_name = key.split("|", 3)
    return _matmul_ladder(op, Phase(phase_val), bucket, target_name, requested)


# ---- resolution -------------------------------------------------------------------


def select(*, quant: str, phase: Phase, m: int,
           target: targets_lib.TargetSpec = targets_lib.H100,
           requested: str | None = None, shard: int | None = None) -> KernelChoice:
    """Resolve one matmul dispatch; a quarantined key outranks everything."""
    key = dispatch_key(quant, phase, m, target.name)
    return _apply_quarantine(key, _ladder_for_key(key, requested), shard)


def select_attn(*, phase: Phase, s: int,
                target: targets_lib.TargetSpec = targets_lib.H100,
                requested: str | None = None, kv: str = "bf16",
                shard: int | None = None) -> KernelChoice:
    """Resolve one attention dispatch; a quarantined key outranks everything.
    `kv` is the KV layout axis: quarantine is tracked per layout's key."""
    key = attn_dispatch_key(phase, s, target.name, kv)
    return _apply_quarantine(key, _ladder_for_key(key, requested), shard)


def resolve_key(key: str, *, requested: str | None = None,
                shard: int | None = None) -> KernelChoice:
    """What select()/select_attn() return for a key string, quarantine
    included (with `shard`, as that shard sees it)."""
    return _apply_quarantine(key, _ladder_for_key(key, requested), shard)


def demote(key: str, *, failing: str, reason: str = "", requested: str | None = None,
           shard: int | None = None) -> dict:
    """Quarantine `key`: advance its level past every rung that resolves to
    the `failing` backend (the bottom rung clamps).  With `shard` the
    demotion is shard-local ("key@shardN"; the record carries "shard"),
    though every rank's dispatch honours it.  Returns the record {"level",
    "from", "to", "reason"[, "shard"]}."""
    ladder = _ladder_for_key(key, requested)
    start = min(quarantine_level(key, shard), len(ladder) - 1)
    new = start
    while new < len(ladder) - 1:
        new += 1
        if ladder[new][0] != failing:
            break
    record = {"level": new, "from": ladder[start][0], "to": ladder[new][0],
              "reason": reason}
    if shard is not None:
        record["shard"] = int(shard)
    _quarantine[key if shard is None else _shard_key(key, shard)] = record
    return record
