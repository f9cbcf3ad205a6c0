"""Dispatch registry (counterpart of repro/kernels/registry.py).

Key formats, the resolution ladder and the quarantine tier are the JAX
package's, so a key, a policy decision or a demotion reads the same in both:

    matmul : "{quant}|{phase}|{M-bucket}|{target}"   M-bucket m1/m8/m32/m64/big
    attn   : "attn|{phase}|{S-bucket}|{target}"      S-bucket s256/s1k/s4k/sbig

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
every engine of the process.

Backend names keep the JAX vocabulary.  For matmul: "reference" (un-encoded
torch.matmul), "xla" (plain pack + mmt4d + unpack), "fused" (the CUDA GEMV
at decode, the CUDA GEMM otherwise) and "pallas" (the packed mmt4d GEMM,
not ported yet).  For attention: "xla" (plain) and "pallas" (the CUDA
flash-prefill and paged-decode kernels).
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

_quarantine: dict[str, dict] = {}


def quarantine_level(key: str) -> int:
    entry = _quarantine.get(key)
    return entry["level"] if entry else 0


def clear_quarantine() -> None:
    """Reset all demotions (tests; a serving process never un-quarantines)."""
    _quarantine.clear()


def _apply_quarantine(key: str, ladder: list[tuple[str, str]]) -> KernelChoice:
    lvl = quarantine_level(key)
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


def attn_dispatch_key(phase: Phase, s: int, target_name: str) -> str:
    return f"{ATTN_OP}|{phase.value}|{s_bucket(s)}|{target_name}"


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
    op, phase_val, bucket, target_name = key.split("|", 3)
    if op == ATTN_OP:
        return _attn_ladder(Phase(phase_val), bucket, target_name, requested)
    return _matmul_ladder(op, Phase(phase_val), bucket, target_name, requested)


# ---- resolution -------------------------------------------------------------------


def select(*, quant: str, phase: Phase, m: int,
           target: targets_lib.TargetSpec = targets_lib.H100,
           requested: str | None = None) -> KernelChoice:
    """Resolve one matmul dispatch; a quarantined key outranks everything."""
    key = dispatch_key(quant, phase, m, target.name)
    return _apply_quarantine(key, _ladder_for_key(key, requested))


def select_attn(*, phase: Phase, s: int,
                target: targets_lib.TargetSpec = targets_lib.H100,
                requested: str | None = None) -> KernelChoice:
    """Resolve one attention dispatch; a quarantined key outranks everything."""
    key = attn_dispatch_key(phase, s, target.name)
    return _apply_quarantine(key, _ladder_for_key(key, requested))


def resolve_key(key: str, *, requested: str | None = None) -> KernelChoice:
    """What select()/select_attn() return for a key string, quarantine included."""
    return _apply_quarantine(key, _ladder_for_key(key, requested))


def demote(key: str, *, failing: str, reason: str = "", requested: str | None = None) -> dict:
    """Quarantine `key`: advance its level past every rung that resolves to
    the `failing` backend (the bottom rung clamps).  Returns the record
    {"level", "from", "to", "reason"}."""
    ladder = _ladder_for_key(key, requested)
    start = min(quarantine_level(key), len(ladder) - 1)
    new = start
    while new < len(ladder) - 1:
        new += 1
        if ladder[new][0] != failing:
            break
    record = {"level": new, "from": ladder[start][0], "to": ladder[new][0],
              "reason": reason}
    _quarantine[key] = record
    return record
