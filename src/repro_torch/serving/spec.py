"""Model-free prompt-lookup drafting for speculative decode (serving/engine.py).

A copy of repro/serving/spec.py (the port imports nothing of `repro`).

V-Seek-style speculation without a separate draft model: the draft for a
slot's next `k` tokens is read out of the request's OWN token history
(prompt + generated so far).  If the trailing n-gram (the last `ngram`
tokens, falling back to shorter suffixes down to `min_ngram`) occurred
earlier in the history, the tokens that followed its most recent earlier
occurrence are proposed verbatim.

On repetition-heavy workloads (code completion, extraction, templated chat,
greedy loops) acceptance is high; on incompressible text the drafter simply
proposes nothing and the engine falls back to plain one-token decode — a
proposal costs no model dispatch either way (pure host-side numpy, never
traced).  Correctness never depends on draft quality: the verify step commits
a draft token only when it equals the model's own greedy choice, so engine
output is token-identical to plain greedy decode for ANY drafter (the
token-identity harnesses in tests/test_spec_decode.py and
tests/test_torch_spec.py pin this with both this
drafter and an adversarial one).

Interaction with the paged prefix cache: rejected draft tokens roll the
slot's position back, and the engine then returns the pages past the new
block high-water mark to the allocator (`Engine._truncate_slot_pages`).
That rollback path must only ever hand back PRIVATE, unregistered pages —
a page registered in the radix prefix tree holds immutable, fully-written
prompt KV by construction (only whole prompt blocks are ever registered,
and speculation never rolls back into the prompt), so rollback freeing a
tree-cached page would corrupt every future request that hits that prefix.
`_truncate_slot_pages` asserts this contract; the allocator's audit()
cross-checks it after every chaos/property storm.
"""

from __future__ import annotations

import numpy as np

_EMPTY = np.zeros((0,), np.int32)


def propose(
    context: np.ndarray,
    k: int,
    *,
    ngram: int = 3,
    min_ngram: int = 1,
) -> np.ndarray:
    """Up to `k` draft tokens continuing `context` by prompt lookup.

    Matches the longest trailing n-gram (length `ngram` down to `min_ngram`)
    against every earlier position of `context`; on a hit, returns the tokens
    that followed the most recent earlier occurrence that still has a full
    k-token continuation (recency wins — the local pattern beats a stale one
    — but a match flush against the end of the context has nothing left to
    propose, so matches too close to the end defer to the longest available
    continuation: on a periodic tail this is what keeps drafts k tokens
    long).  Returns an empty array when no suffix recurs or there is nothing
    usable to propose.
    """
    ctx = np.asarray(context, np.int32).ravel()
    n_ctx = int(ctx.shape[0])
    if k <= 0 or n_ctx < min_ngram + 1:
        return _EMPTY
    for n in range(min(ngram, n_ctx - 1), min_ngram - 1, -1):
        suffix = ctx[n_ctx - n:]
        windows = np.lib.stride_tricks.sliding_window_view(ctx, n)
        hits = np.flatnonzero((windows == suffix).all(axis=1))
        # Earlier occurrences only, with at least one token following them.
        hits = hits[hits + n < n_ctx]
        if hits.size:
            room = n_ctx - (hits + n)  # continuation tokens after each match
            full = hits[room >= k]
            start = int(full[-1] if full.size else hits[np.argmax(room)]) + n
            return np.ascontiguousarray(ctx[start : start + k], dtype=np.int32)
    return _EMPTY


def draft_budget(draft_k: int, decode_rows: int, token_budget: int | None) -> int:
    """Per-slot draft cap under a token budget (the token-budget mixed step,
    serving/engine.py): spec-verify windows spend the SAME budget as every
    other token in the dispatch, so with `decode_rows` slots decoding, each
    may draft at most

        floor((budget - decode_rows) / decode_rows)

    tokens — the decode rows' own 1-token-per-slot floor is reserved first
    (decode never stalls for drafts), and what remains splits evenly.  The
    result is clamped to [0, draft_k]; with no budget (phase-split engines)
    the full draft_k stands.  Chunked-prefill rows then take what the drafts
    left over, so speculation and prefill compete for one pool instead of
    speculation silently inflating the dispatch past the budget."""
    if token_budget is None or decode_rows <= 0:
        return max(0, int(draft_k))
    spare = (int(token_budget) - decode_rows) // decode_rows
    return max(0, min(int(draft_k), spare))
