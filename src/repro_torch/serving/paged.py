"""Block-paged KV-cache allocator — the serving memory plan behind Engine's
cache_mode="paged".  A copy of repro/serving/paged.py (the port imports
nothing of `repro`), ShardedBlockAllocator included: one process mirroring
every shard's allocator, as JAX's single SPMD process does.  The port's
tensor-parallel engine runs a rank a process, so each rank keeps its own
shard's BlockAllocator and Engine.audit() compares them across ranks.

The dense engine reserves a worst-case (slots, max_seq) KV row per slot; HBM
is spent on sequence positions that mostly never exist (short prompts, early
decode).  The paged plan instead carves the per-layer cache into a global pool
of fixed-size pages (`block_size` tokens each) and gives every slot a block
table mapping logical block j -> physical page.  Capacity then scales with
TOKENS IN FLIGHT, not slots x max_seq (core/encoding.py has the math; the
capacity-vs-dense sweep lives in benchmarks/table2_throughput.py).

This module is the host-side bookkeeping only (pure numpy/python — nothing
here is traced):

  * free-list page allocation with exact refcounts,
  * a RADIX-TREE prefix cache over token-block keys: each tree node is one
    immutable full block, keyed by its block-local tokens under its parent
    (chained identity — equal root paths imply equal K/V content).  Admission
    walks the tree for the longest-common-prefix run of full blocks, so a
    prompt sharing 31 of 32 leading blocks reuses 31 pages (the old flat
    registry only matched an exact whole prefix, reusing nothing there),
  * cache retention: when a finished request releases an immutable written
    block whose refcount hits 0, the page is PARKED in the tree (state
    "cached") instead of freed — a later prompt revives it via share(),
  * refcount-aware LRU eviction: alloc() on a dry free list evicts the
    coldest cached tree LEAF first (never a refcount>0 page, never a chain
    interior), so cold chains unwind tip-first and eviction only ever runs
    when the alternative is failing the alloc or preempting live work,
  * per-tenant accounting: every reference is charged to a tenant; private
    pages charge 1, shared pages 1/refcount, and eviction prefers cold
    chains parked by tenants over their page quota,
  * audit() — the invariant checker the allocator tests drive, including
    tree<->pool cross-invariants.

Only FULL blocks that can never be written again are shareable: decode
re-writes position plen-1 (the engine's first decode step recomputes the last
prompt token's K/V), so a prompt of length P shares at most its first
(P-1)//block_size blocks; everything from the first divergent or appendable
block on is private to the slot.  Page 0 is a reserved scratch page: idle
decode rows point their writes at it, and it is never allocated.

Page state machine (scratch excluded):

    free (on free list, rc==0)
      -- alloc() -->            referenced (rc>=1)
    referenced
      -- free_page() to rc==0, registered+written, prefix_cache on -->
                                cached (rc==0, allocated, parked in tree)
      -- free_page() to rc==0 otherwise -->  free
    cached
      -- share() (revival: a cache hit) -->  referenced
      -- eviction inside alloc() -->         free

Quantized layouts (kv8/kv4) keep `scale_live` in lockstep with the ALLOCATED
set — referenced and cached alike: a cached page's scales must survive until
eviction, or revival would dequantize with someone else's magnitudes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SCRATCH_PAGE = 0
DEFAULT_TENANT = "default"


class AllocatorInvariantError(AssertionError):
    """A page-accounting invariant broke: double free, refcount underflow,
    sharing an unreferenced page, or a stale prefix-cache reference.
    Carries the page id and (when the engine told the allocator) the slot
    that owned the page, so a leak report names the request lifecycle path
    that dropped it.  Subclasses AssertionError: every pre-existing
    `pytest.raises(AssertionError)` / audit() contract still holds."""

    def __init__(self, message: str, *, page: int | None = None,
                 owner: int | None = None):
        suffix = ""
        if page is not None:
            suffix = f" (page {page}" + (
                f", owning slot {owner})" if owner is not None else ")"
            )
        super().__init__(message + suffix)
        self.page = page
        self.owner = owner


@dataclasses.dataclass
class PagePlan:
    """Physical pages covering one prompt, leading `shared` pages reused."""

    pages: list[int]
    shared: list[bool]

    @property
    def new_pages(self) -> list[int]:
        return [p for p, sh in zip(self.pages, self.shared) if not sh]


class _RadixNode:
    """One immutable full block in the prefix tree.

    `key` is the BLOCK-LOCAL token bytes (this block's tokens only): chained
    node identity gives whole-prefix identity, so per-node keys cost
    O(block_size) bytes instead of the old registry's O(prefix) whole-prefix
    keys, and reaping a released page is O(1) through `node_of_page` instead
    of a whole-prefix key round trip."""

    __slots__ = ("key", "page", "parent", "children", "last_use", "tenant")

    def __init__(self, key: bytes, page: int | None,
                 parent: "_RadixNode | None", tenant: str | None):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict[bytes, _RadixNode] = {}
        self.last_use = 0
        self.tenant = tenant


class BlockAllocator:
    """Fixed pool of `num_pages` pages of `block_size` tokens (page 0 scratch)."""

    def __init__(self, num_pages: int, block_size: int,
                 kv_quant: str = "bf16", *, prefix_cache: bool = True,
                 tenant_quota: int | None = None):
        assert num_pages >= 2, "need at least one allocatable page + scratch"
        assert block_size > 0 and (block_size & (block_size - 1)) == 0, (
            "block_size must be a power of two (prefill pads to block multiples)"
        )
        self.num_pages = num_pages
        self.block_size = block_size
        self.kv_quant = kv_quant
        self.prefix_cache = prefix_cache
        self.tenant_quota = tenant_quota
        # LIFO free list: lowest page ids first, scratch excluded.
        self.free: list[int] = list(range(num_pages - 1, SCRATCH_PAGE, -1))
        self.refcount = np.zeros(num_pages, np.int32)
        # Radix tree over token-block keys; the root is a pageless sentinel.
        self.root = _RadixNode(b"", None, None, None)
        self.node_of_page: dict[int, _RadixNode] = {}
        # Pages parked in the tree at refcount 0 (allocated, reclaimable).
        self.cached: set[int] = set()
        # Pages whose KV content has actually landed in the pool (the engine
        # marks them after scatter/chunk commit).  Only written pages may be
        # retained: a registered-but-unwritten page is an in-flight promise,
        # not reusable content.
        self.written: set[int] = set()
        # Last slot the engine charged each live page to (diagnostics only:
        # AllocatorInvariantError names it; shared pages keep the first owner).
        self.page_owner: dict[int, int] = {}
        # Pages whose per-page dequant scales are live (kv8/kv4 layouts only).
        # Scale pages live at the SAME page ids as their data pages, so this
        # set must track the ALLOCATED set (referenced + cached) in lockstep:
        # a page handed out without scale state would dequantize someone
        # else's magnitudes, and a cached page without scales could not be
        # revived.
        self.scale_live: set[int] = set()
        # page -> {tenant: live references}; sums to refcount exactly.
        self._tenant_refs: dict[int, dict[str, int]] = {}
        self._tick = 0
        self.stats = {
            "allocs": 0, "frees": 0, "shared_hits": 0, "cow_events": 0,
            "peak_in_use": 0, "evictions": 0, "hit_blocks": 0,
            "hit_tokens": 0, "lookup_blocks": 0, "cached_pages": 0,
        }

    @property
    def _quantized(self) -> bool:
        return self.kv_quant != "bf16"

    # -- capacity ------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    def available(self) -> int:
        """Pages obtainable without preempting live work: the free list plus
        cached pages evictable leaf-first (a cached page pinned under a live
        chain interior is excluded until the chain above it drains)."""
        return len(self.free) + self._evictable(frozenset())

    def in_use(self) -> int:
        """Pages referenced by live requests (refcount > 0).  Cached pages
        are reclaimable pool headroom, not in-use."""
        return self.capacity - len(self.free) - len(self.cached)

    def blocks_for_tokens(self, tokens: int) -> int:
        return max(1, -(-tokens // self.block_size))

    def _evictable(self, exclude: frozenset) -> int:
        """Cached pages reclaimable by repeated leaf-first eviction.  A
        cached ancestor of a referenced (or `exclude`-reserved) node is
        pinned: evicting it would orphan a live chain."""
        if not self.cached:
            return 0
        pinned: set[int] = set()
        for p, node in self.node_of_page.items():
            if self.refcount[p] > 0 or p in exclude:
                n = node.parent
                while n is not None and n.page is not None \
                        and n.page not in pinned:
                    pinned.add(n.page)
                    n = n.parent
        return sum(1 for p in self.cached
                   if p not in pinned and p not in exclude)

    def plan_fits(self, nblocks: int, shared: dict[int, int]) -> bool:
        """Whether commit_prompt(nblocks, shared) can succeed right now.
        The plan's own shared pages are reserved out of the eviction headroom
        — commit revives them, it must not also count them as reclaimable."""
        reserved = frozenset(shared.values())
        return (nblocks - len(shared)
                <= len(self.free) + self._evictable(reserved))

    # -- raw page ops --------------------------------------------------------

    def alloc(self, *, owner: int | None = None,
              tenant: str = DEFAULT_TENANT) -> int | None:
        if not self.free and self.cached:
            # Eviction runs ONLY here: when the alternative is returning
            # None (and the engine preempting live work).  Cold cache goes
            # before hot requests — docs/ROBUSTNESS.md §Eviction ordering.
            self._evict_one()
        if not self.free:
            return None
        page = self.free.pop()
        if self.refcount[page] != 0:
            raise AllocatorInvariantError(
                "free-list page has live refcount "
                f"{int(self.refcount[page])}", page=page,
                owner=self.page_owner.get(page),
            )
        self.refcount[page] = 1
        self.written.discard(page)  # recycled page: stale marker dies here
        self._tenant_refs[page] = {tenant: 1}
        if self._quantized:
            self.scale_live.add(page)
        if owner is not None:
            self.page_owner[page] = owner
        self.stats["allocs"] += 1
        self.stats["peak_in_use"] = max(self.stats["peak_in_use"], self.in_use())
        return page

    def share(self, page: int, *, owner: int | None = None,
              tenant: str = DEFAULT_TENANT) -> int:
        if self.refcount[page] <= 0:
            if page in self.cached:
                return self._revive(page, owner=owner, tenant=tenant)
            raise AllocatorInvariantError(
                "sharing unreferenced page", page=page,
                owner=self.page_owner.get(page),
            )
        if self._quantized and page not in self.scale_live:
            raise AllocatorInvariantError(
                "sharing a page without live scale state", page=page,
                owner=self.page_owner.get(page),
            )
        self.refcount[page] += 1
        refs = self._tenant_refs.setdefault(page, {})
        refs[tenant] = refs.get(tenant, 0) + 1
        self.stats["shared_hits"] += 1
        self._touch(page)
        if owner is not None:
            self.page_owner.setdefault(page, owner)
        return page

    def _revive(self, page: int, *, owner: int | None, tenant: str) -> int:
        """Cache hit on a parked rc==0 page: cached -> referenced.  Counted
        as BOTH an alloc and a shared hit — every rc 0->1 transition is an
        alloc and every 1->0 a free, so allocs == frees stays an exact
        conservation law whether or not pages detour through the cache."""
        if self._quantized and page not in self.scale_live:
            raise AllocatorInvariantError(
                "reviving a cached page without live scale state", page=page,
                owner=self.page_owner.get(page),
            )
        self.cached.remove(page)
        self.stats["cached_pages"] -= 1
        self.refcount[page] = 1
        self._tenant_refs[page] = {tenant: 1}
        if owner is not None:
            self.page_owner[page] = owner
        self.stats["allocs"] += 1
        self.stats["shared_hits"] += 1
        self.stats["peak_in_use"] = max(self.stats["peak_in_use"], self.in_use())
        self._touch(page)
        return page

    def free_page(self, page: int, *, owner: int | None = None,
                  tenant: str = DEFAULT_TENANT) -> None:
        if page == SCRATCH_PAGE:
            return
        if self.refcount[page] <= 0:
            # Double free / refcount underflow: typed, with the page id and
            # the slot that last owned it — the leak report the chaos harness
            # (docs/ROBUSTNESS.md) pins failures on.
            raise AllocatorInvariantError(
                "double free (refcount underflow)", page=page,
                owner=owner if owner is not None else self.page_owner.get(page),
            )
        self.refcount[page] -= 1
        refs = self._tenant_refs.get(page)
        if refs:
            t = tenant if refs.get(tenant, 0) > 0 else max(refs, key=refs.get)
            refs[t] -= 1
            if refs[t] <= 0:
                del refs[t]
        if self.refcount[page] != 0:
            return
        self._tenant_refs.pop(page, None)
        self.stats["frees"] += 1
        node = self.node_of_page.get(page)
        if node is not None and self.prefix_cache and page in self.written:
            # Retain: immutable content already landed — park in the tree at
            # rc==0 for future LCP hits instead of freeing.  scale_live is
            # intentionally KEPT (revival dequantizes through these scales).
            self.cached.add(page)
            self.stats["cached_pages"] += 1
            node.tenant = tenant
            self.page_owner.pop(page, None)
            self._touch(page)
            return
        if node is not None:
            # Registered but not retainable (unwritten in-flight block from
            # a rolled-back commit, cancelled chunked prefill, or cache off):
            # the node AND its subtree leave the tree — a dangling child
            # chain would advertise content reachable through a dead prefix.
            self._unregister_subtree(node)
        self.page_owner.pop(page, None)
        self.scale_live.discard(page)
        self.written.discard(page)
        self.free.append(page)

    def free_pages(self, pages: list[int], *, owner: int | None = None,
                   tenant: str = DEFAULT_TENANT) -> None:
        for p in pages:
            self.free_page(p, owner=owner, tenant=tenant)

    def claim_owner(self, pages: list[int], owner: int) -> None:
        """Record which slot a plan's pages now serve (diagnostics for
        AllocatorInvariantError; shared pages keep their first owner)."""
        for p in pages:
            self.page_owner.setdefault(p, owner)

    def mark_written(self, pages: list[int]) -> None:
        """Engine callback after KV content lands (prefill scatter / chunked
        commit): these pages now hold reusable bytes.  Only written pages are
        retained at rc==0 or safely shared mid-prefill; alloc() clears the
        marker when a page recycles."""
        for p in pages:
            if p != SCRATCH_PAGE and self.refcount[p] > 0:
                self.written.add(p)

    def is_written(self, page: int) -> bool:
        return page in self.written

    def is_registered(self, page: int) -> bool:
        return page in self.node_of_page

    # -- radix-tree maintenance ----------------------------------------------

    def _touch(self, page: int) -> None:
        node = self.node_of_page.get(page)
        if node is not None:
            self._tick += 1
            node.last_use = self._tick

    def _detach(self, node: _RadixNode) -> None:
        parent = node.parent
        if parent is not None and parent.children.get(node.key) is node:
            del parent.children[node.key]
        node.parent = None

    def _unregister_subtree(self, node: _RadixNode) -> None:
        """Remove a node and its whole subtree from the tree.  Referenced
        descendants (rc>0) just lose their registration and carry on as
        private pages; cached rc==0 descendants return to the free list —
        an orphaned cached page would be allocated, unreferenced, and
        unreachable: a leak by construction."""
        self._detach(node)
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children.clear()
            p = n.page
            if p is None:
                continue
            if self.node_of_page.get(p) is n:
                del self.node_of_page[p]
            if p in self.cached:
                self.cached.remove(p)
                self.stats["cached_pages"] -= 1
                self.scale_live.discard(p)
                self.page_owner.pop(p, None)
                self.written.discard(p)
                self.free.append(p)

    def _over_quota_tenants(self) -> set[str]:
        if self.tenant_quota is None:
            return set()
        return {t for t, u in self.tenant_footprint().items()
                if u > self.tenant_quota}

    def _evict_one(self) -> bool:
        """Evict the coldest evictable cached page: only rc==0 tree LEAVES
        are candidates (never a refcount>0 page, never a chain interior), so
        cold chains unwind tip-first and live chains are untouchable.
        Tenants over their page quota lose their cold leaves first."""
        over = self._over_quota_tenants()
        best: tuple[tuple, _RadixNode] | None = None
        for p in self.cached:
            node = self.node_of_page[p]
            if node.children:
                continue
            rank = (0 if node.tenant in over else 1, node.last_use, p)
            if best is None or rank < best[0]:
                best = (rank, node)
        if best is None:
            return False
        self._unregister_subtree(best[1])
        self.stats["evictions"] += 1
        return True

    # -- tenant accounting ---------------------------------------------------

    def tenant_usage(self) -> dict[str, float]:
        """Charged LIVE usage per tenant: a private page charges its tenant
        1, a shared page charges each reference 1/refcount — the charges sum
        to in_use() exactly, so quotas partition the pool."""
        usage: dict[str, float] = {}
        for p, refs in self._tenant_refs.items():
            rc = int(self.refcount[p])
            if rc <= 0:
                continue
            for t, n in refs.items():
                usage[t] = usage.get(t, 0.0) + n / rc
        return usage

    def tenant_footprint(self) -> dict[str, float]:
        """tenant_usage() plus parked cache pages, each charged in full to
        the tenant that released it last (rc==0: no sharing divisor).  This
        is the quantity eviction compares against the quota."""
        fp = self.tenant_usage()
        for p in self.cached:
            t = self.node_of_page[p].tenant or DEFAULT_TENANT
            fp[t] = fp.get(t, 0.0) + 1.0
        return fp

    # -- prompt planning (LCP reuse + copy-on-write) -------------------------

    def _block_key(self, prompt: np.ndarray, j: int) -> bytes:
        """Tree-edge key for block j: its block-local tokens (the chain of
        ancestor keys supplies the rest of the prefix identity)."""
        return np.ascontiguousarray(
            np.asarray(
                prompt[j * self.block_size:(j + 1) * self.block_size],
                np.int32,
            )
        ).tobytes()

    def shareable_blocks(self, prompt_len: int) -> int:
        """Blocks of this prompt that are immutable under decode (the engine's
        first decode step re-writes position prompt_len - 1)."""
        return max(0, (prompt_len - 1) // self.block_size)

    def plan_prompt(self, prompt: np.ndarray) -> tuple[int, dict[int, int]]:
        """(total blocks covering the prompt, {block j -> reusable page}).
        Walks the radix tree for the longest-common-prefix run of full
        blocks; the run ends at the first miss."""
        nblocks = self.blocks_for_tokens(len(prompt))
        shared: dict[int, int] = {}
        node = self.root
        for j in range(self.shareable_blocks(len(prompt))):
            child = node.children.get(self._block_key(prompt, j))
            if child is None:
                break
            shared[j] = child.page
            node = child
        return nblocks, shared

    def commit_prompt(
        self, prompt: np.ndarray, nblocks: int, shared: dict[int, int],
        *, tenant: str = DEFAULT_TENANT,
    ) -> PagePlan | None:
        """Materialize a plan: refcount (or revive) shared pages, allocate
        private ones, insert newly-allocated immutable blocks into the tree.
        Returns None (and rolls back) if the pool cannot cover the private
        blocks even after draining the evictable cache.

        Shared blocks are the LEADING run, so their shares (which revive any
        cached pages in the plan) always happen before the first alloc() —
        eviction inside alloc() can therefore never reclaim a page this very
        plan is about to reuse."""
        pages: list[int] = []
        is_shared: list[bool] = []
        immutable = self.shareable_blocks(len(prompt))
        cow_done = False
        node: _RadixNode | None = self.root
        for j in range(nblocks):
            if j in shared:
                pages.append(self.share(shared[j], tenant=tenant))
                is_shared.append(True)
                node = self.node_of_page.get(shared[j])
                continue
            page = self.alloc(tenant=tenant)
            if page is None:
                for p in pages:
                    self.free_page(p, tenant=tenant)
                return None
            if shared and not cow_done:
                # First private block after a shared prefix: the
                # copy-on-write point (divergent or appendable block).
                self.stats["cow_events"] += 1
                cow_done = True
            if j < immutable and node is not None:
                key = self._block_key(prompt, j)
                child = node.children.get(key)
                if child is None:
                    child = _RadixNode(key, page, node, tenant)
                    node.children[key] = child
                    self.node_of_page[page] = child
                    self._tick += 1
                    child.last_use = self._tick
                # else: an in-flight writer already owns this block key (the
                # engine declined its unwritten page and we recomputed a
                # private copy).  First writer wins — our copy stays
                # unregistered — and the walk continues down the existing
                # chain so deeper blocks still land in the right subtree.
                node = child
            elif j >= immutable:
                node = None
            pages.append(page)
            is_shared.append(False)
        self.stats["hit_blocks"] += len(shared)
        self.stats["hit_tokens"] += len(shared) * self.block_size
        self.stats["lookup_blocks"] += immutable
        return PagePlan(pages=pages, shared=is_shared)

    # -- invariants ----------------------------------------------------------

    def audit(self, tables_in_use: list[list[int]]) -> None:
        """Raises AssertionError unless the allocator state is exactly
        consistent with the referenced tables:

          * every referenced page is allocated, never on the free list and
            never simultaneously cached,
          * refcounts equal the number of table references exactly, and the
            per-tenant charge ledger sums to the refcount per page,
          * a page referenced by two tables is registered in the radix tree
            (sharing happens only through prefix reuse),
          * free / referenced / cached partitions the pool (scratch
            excluded): an rc==0 allocated page NOT parked in the tree is a
            leak by construction,
          * tree<->pool cross-invariants: every tree node's page is
            allocated (no tree ref to a freed page), an rc==0 page the tree
            reaches is in the cached set (no refcounted-0-but-allocated
            stragglers), each page sits at exactly ONE node (no cached page
            reachable by two keys), `node_of_page` and the root walk agree
            exactly, and every cached page carries the written marker,
          * under a quantized layout (kv8/kv4), scale state tracks the
            ALLOCATED set (referenced + cached) in lockstep: cached pages
            keep their scales for revival, freed pages must not."""
        refs: dict[int, int] = {}
        for table in tables_in_use:
            for p in table:
                assert p != SCRATCH_PAGE, "scratch page referenced as data"
                refs[p] = refs.get(p, 0) + 1
        free_set = set(self.free)
        assert len(free_set) == len(self.free), "duplicate pages on free list"
        for p, n in refs.items():
            assert p not in free_set, f"page {p} both referenced and free"
            assert p not in self.cached, f"page {p} both referenced and cached"
            assert self.refcount[p] == n, (
                f"page {p}: refcount {self.refcount[p]} != {n} references"
            )
            trefs = self._tenant_refs.get(p, {})
            assert sum(trefs.values()) == n, (
                f"page {p}: tenant charges {trefs} do not sum to {n}"
            )
            if n > 1:
                assert p in self.node_of_page, (
                    f"page {p} multiply-owned unregistered"
                )
        for p in range(1, self.num_pages):
            if p in refs:
                continue
            if p in self.cached:
                assert self.refcount[p] == 0, (
                    f"cached page {p} has refcount {self.refcount[p]}"
                )
                assert p not in free_set, f"page {p} both cached and free"
                assert p in self.node_of_page, f"cached page {p} not in tree"
                assert p in self.written, f"cached page {p} never written"
                continue
            if self.refcount[p] != 0:
                raise AllocatorInvariantError(
                    f"page leaked (rc={int(self.refcount[p])}, "
                    "unreferenced)", page=p, owner=self.page_owner.get(p),
                )
            assert p in free_set, f"page {p} neither free, referenced, nor cached"
        assert len(free_set) + len(refs) + len(self.cached) == self.capacity
        # Tree <-> pool cross-invariants, by exhaustive root walk.
        seen: set[int] = set()
        stack = [self.root]
        while stack:
            n = stack.pop()
            for key, c in n.children.items():
                assert c.parent is n and c.key == key, "tree link corrupt"
                p = c.page
                assert p is not None and p != SCRATCH_PAGE
                if p in free_set or self.refcount[p] < 0:
                    raise AllocatorInvariantError(
                        "prefix tree references a freed page", page=p,
                        owner=self.page_owner.get(p),
                    )
                if self.refcount[p] == 0 and p not in self.cached:
                    raise AllocatorInvariantError(
                        "tree reaches an rc==0 page outside the cached set",
                        page=p, owner=self.page_owner.get(p),
                    )
                assert p not in seen, (
                    f"page {p} reachable by two tree keys"
                )
                assert self.node_of_page.get(p) is c, (
                    f"node_of_page disagrees with tree for page {p}"
                )
                seen.add(p)
                stack.append(c)
        assert seen == set(self.node_of_page), (
            "node_of_page and root walk disagree "
            f"({sorted(set(self.node_of_page) - seen)} unreachable)"
        )
        if self._quantized:
            allocated = set(refs) | self.cached
            for p in allocated:
                if p not in self.scale_live:
                    raise AllocatorInvariantError(
                        "allocated page lacks live scale state", page=p,
                        owner=self.page_owner.get(p),
                    )
            for p in self.scale_live:
                if p not in allocated:
                    raise AllocatorInvariantError(
                        "freed page still holds scale state", page=p,
                        owner=self.page_owner.get(p),
                    )


class ShardedBlockAllocator:
    """Per-shard paged bookkeeping for tensor-parallel serving.

    Under head-parallel attention every shard holds ITS OWN head-slice of
    every KV page, so each shard owns a full per-shard pool and block table
    — but page IDENTITY must agree across shards (the block table threaded
    into the SPMD dispatch is one logical table; shard k's gather of page p
    must read shard k's slice of the same request's history).  This class
    drives one `BlockAllocator` per shard in lockstep: every operation
    (alloc, share, free, prompt plan/commit, written markers, tenant
    charges, cache eviction — eviction is deterministic, it runs inside each
    shard's alloc()) is applied to all shards and the results are asserted
    identical.  BlockAllocator is deterministic by construction (LIFO free
    list, exact refcounts, radix-tree walk order fixed by insertion, LRU
    ranks totally ordered by (quota class, tick, page id)), so mirrored
    shards can only diverge through a bookkeeping bug — which this class
    converts into an `AllocatorInvariantError` naming the shard, instead of
    silent cross-shard KV corruption.

    COW, preemption, eviction, and `audit()` therefore stay SHARD-LOCAL:
    each shard's allocator proves its own exact partition (per-shard audit
    is what the JAX package's tests pin after preemption/replay), while the
    engine keeps exactly one host block table.  The interface mirrors
    BlockAllocator, so Engine code is allocator-agnostic."""

    def __init__(self, num_pages: int, block_size: int, *, shards: int,
                 kv_quant: str = "bf16", prefix_cache: bool = True,
                 tenant_quota: int | None = None):
        assert shards >= 1, shards
        self.shards = [
            BlockAllocator(num_pages, block_size, kv_quant,
                           prefix_cache=prefix_cache,
                           tenant_quota=tenant_quota)
            for _ in range(shards)
        ]
        self.num_pages = num_pages
        self.block_size = block_size
        self.kv_quant = kv_quant
        self.prefix_cache = prefix_cache
        self.tenant_quota = tenant_quota

    @property
    def _p(self) -> BlockAllocator:
        return self.shards[0]

    def _mirror(self, results, what: str):
        first = results[0]
        for k, r in enumerate(results[1:], start=1):
            if r != first:
                raise AllocatorInvariantError(
                    f"shard allocators diverged on {what}: shard 0 -> "
                    f"{first!r}, shard {k} -> {r!r}"
                )
        return first

    # -- capacity (identical across shards by construction) ------------------

    @property
    def capacity(self) -> int:
        return self._p.capacity

    def available(self) -> int:
        return self._mirror([a.available() for a in self.shards], "available")

    def in_use(self) -> int:
        return self._p.in_use()

    def blocks_for_tokens(self, tokens: int) -> int:
        return self._p.blocks_for_tokens(tokens)

    def shareable_blocks(self, prompt_len: int) -> int:
        return self._p.shareable_blocks(prompt_len)

    def plan_fits(self, nblocks: int, shared: dict[int, int]) -> bool:
        return self._mirror(
            [a.plan_fits(nblocks, shared) for a in self.shards], "plan_fits"
        )

    # -- mirrored page ops ----------------------------------------------------

    def alloc(self, *, owner: int | None = None,
              tenant: str = DEFAULT_TENANT) -> int | None:
        return self._mirror(
            [a.alloc(owner=owner, tenant=tenant) for a in self.shards],
            "alloc",
        )

    def share(self, page: int, *, owner: int | None = None,
              tenant: str = DEFAULT_TENANT) -> int:
        return self._mirror(
            [a.share(page, owner=owner, tenant=tenant) for a in self.shards],
            "share",
        )

    def free_page(self, page: int, *, owner: int | None = None,
                  tenant: str = DEFAULT_TENANT) -> None:
        for a in self.shards:
            a.free_page(page, owner=owner, tenant=tenant)

    def free_pages(self, pages: list[int], *, owner: int | None = None,
                   tenant: str = DEFAULT_TENANT) -> None:
        for a in self.shards:
            a.free_pages(pages, owner=owner, tenant=tenant)

    def claim_owner(self, pages: list[int], owner: int) -> None:
        for a in self.shards:
            a.claim_owner(pages, owner)

    def mark_written(self, pages: list[int]) -> None:
        for a in self.shards:
            a.mark_written(pages)

    def is_written(self, page: int) -> bool:
        return self._mirror(
            [a.is_written(page) for a in self.shards], "is_written"
        )

    def is_registered(self, page: int) -> bool:
        return self._mirror(
            [a.is_registered(page) for a in self.shards], "is_registered"
        )

    # -- mirrored prompt planning ---------------------------------------------

    def plan_prompt(self, prompt: np.ndarray) -> tuple[int, dict[int, int]]:
        return self._mirror(
            [a.plan_prompt(prompt) for a in self.shards], "plan_prompt"
        )

    def commit_prompt(
        self, prompt: np.ndarray, nblocks: int, shared: dict[int, int],
        *, tenant: str = DEFAULT_TENANT,
    ) -> PagePlan | None:
        plans = [a.commit_prompt(prompt, nblocks, shared, tenant=tenant)
                 for a in self.shards]
        self._mirror(
            [(p.pages, p.shared) if p is not None else None for p in plans],
            "commit_prompt",
        )
        return plans[0]

    # -- mirrored tenant accounting -------------------------------------------

    def tenant_usage(self) -> dict[str, float]:
        return self._mirror(
            [a.tenant_usage() for a in self.shards], "tenant_usage"
        )

    def tenant_footprint(self) -> dict[str, float]:
        return self._mirror(
            [a.tenant_footprint() for a in self.shards], "tenant_footprint"
        )

    # -- observability / invariants -------------------------------------------

    @property
    def stats(self) -> dict:
        """Shard-0 counters (mirrors are identical — asserted on every
        mutating op) plus the shard count, so engine stats stay one dict."""
        return {**self._p.stats, "tp_shards": len(self.shards)}

    def per_shard_stats(self) -> list[dict]:
        return [dict(a.stats) for a in self.shards]

    def audit(self, tables_in_use: list[list[int]]) -> None:
        """Run the exact-partition audit on EVERY shard's allocator: each
        shard must independently account for the same referenced tables."""
        for k, a in enumerate(self.shards):
            try:
                a.audit(tables_in_use)
            except AssertionError as exc:
                raise AllocatorInvariantError(
                    f"shard {k} audit failed: {exc}"
                ) from exc
