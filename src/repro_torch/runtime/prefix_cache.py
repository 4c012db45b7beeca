"""Radix-tree prefix cache over the paged KV block pool.

Production serving traffic is dominated by repeated prompt prefixes
(system prompts, few-shot templates shared by millions of users), and
prefill is the compute-bound phase of the serving roofline — every
prompt token whose KV is already resident is compute the accelerator
never spends.  Block tables decouple each slot's logical KV
layout from physical pool blocks, which makes SGLang/vLLM-style prefix
sharing a pure host-side table construction:

``BlockPool``
    Refcounted allocator over the physical blocks of
    ``api.init_cache(..., paged=True)``.  A block is in exactly one of
    three states: *free* (refcount 0, on the free list), *owned*
    (refcount > 0, mapped into ≥1 slot's block table), or *cached*
    (resident in the radix tree; evictable while its refcount is 0).
    ``free == decref``: a block leaves a slot by dropping one
    reference, and returns to the free list only when no slot and no
    tree node retains it.

``RadixPrefixCache``
    Radix tree keyed on block-aligned token-ID runs; each node's edge
    is a run of FULL blocks (``len(tokens) == len(blocks) *
    block_size``) and children are keyed by their edge's first-block
    token bytes.  ``match`` returns the longest cached prefix of a
    prompt as (full shared blocks, optional partially-matching block):
    the partial block shares only its first ``partial_len`` token
    positions with the prompt, so a request mapping it must
    copy-on-write before its own frontier writes into the block
    (runtime/server.py does the copy with one block-to-block pool
    copy on the device).  ``insert`` adopts a finished request's novel full-block
    suffix into the tree (deduplicating against existing entries) and
    ``evict`` reclaims refcount-0 blocks tail-first in coldest-block
    order when the free list runs dry — LRU stamps are per BLOCK, not
    per node, so a lookup that matched only the head of an edge leaves
    the edge's tail cold and evictable before warmer leaves.

The tree and pool are host-side numpy/python only — the device
``chunk_step`` / ``decode_step`` work units see nothing but the same
fixed-shape block-table operand, so sharing changes no kernel.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import NULL_METRICS
from repro_torch.obs.tracer import NULL_TRACER


def _common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class BlockPool:
    """Refcounted physical-block allocator (host side).

    Invariant partition of ``range(num_blocks)``:
      * free list  == blocks with ``refcount == 0 and not cached``
      * owned      == ``refcount > 0`` (mapped in ≥1 slot table; may
        ALSO be cached when a tree hit pinned a resident block)
      * cached     == resident in the radix tree; evictable iff its
        refcount is 0
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.refcount = np.zeros(num_blocks, np.int32)
        self.cached = np.zeros(num_blocks, bool)
        self._free: List[int] = list(range(num_blocks))

    def num_free(self) -> int:
        return len(self._free)

    def num_cached(self) -> int:
        return int(np.count_nonzero(self.cached))

    def num_evictable(self) -> int:
        """Cached blocks no request currently pins (refcount 0)."""
        return int(np.count_nonzero(self.cached & (self.refcount == 0)))

    def alloc(self) -> int:
        """Pop a free block with an initial reference (caller owns it).
        Callers evict from the radix tree first when the list is dry."""
        assert self._free, "block pool over-committed"
        b = self._free.pop()
        assert self.refcount[b] == 0 and not self.cached[b]
        self.refcount[b] = 1
        return b

    def incref(self, b: int) -> None:
        self.refcount[b] += 1

    def decref(self, b: int) -> None:
        """free == decref: the block returns to the free list only when
        no slot references it AND the radix tree doesn't retain it."""
        assert self.refcount[b] > 0, f"double free of block {b}"
        self.refcount[b] -= 1
        if self.refcount[b] == 0 and not self.cached[b]:
            self._free.append(b)

    def mark_cached(self, b: int) -> None:
        assert not self.cached[b]
        self.cached[b] = True

    def release_cached(self, b: int) -> None:
        """Tree eviction drops residency; a refcount-0 block is free."""
        assert self.cached[b]
        self.cached[b] = False
        if self.refcount[b] == 0:
            self._free.append(b)


class _Node:
    __slots__ = ("parent", "children", "tokens", "blocks", "last_access",
                 "block_access", "key")

    def __init__(self, parent: Optional["_Node"], tokens: np.ndarray,
                 blocks: List[int], last_access: int, bs: int):
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.tokens = tokens            # int32, len == len(blocks) * bs
        self.blocks = blocks
        self.last_access = last_access
        # per-block LRU stamps (parallel to `blocks`): a lookup bumps
        # only the blocks it actually matched, so a node whose head is
        # hot can still have its cold tail evicted before a warmer
        # leaf elsewhere (node-granular stamps pinned whole edges)
        self.block_access = [last_access] * len(blocks)
        # child-map key under `parent`; captured at creation because
        # trailing eviction may shorten `tokens` before unlinking
        self.key = tokens[:bs].tobytes() if len(tokens) else b""


class RadixPrefixCache:
    """Block-aligned radix tree mapping token-ID runs to pool blocks."""

    def __init__(self, pool: BlockPool, block_size: int, *,
                 tracer=None, metrics=None):
        self.pool = pool
        self.bs = block_size
        self.root = _Node(None, np.zeros(0, np.int32), [], 0, block_size)
        self._tick = 0
        self.evicted_blocks = 0         # lifetime eviction counter
        # host-side observability (repro.obs); both default to no-ops
        # so standalone tree usage (tests, fuzz) records nothing
        self.obs = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS

    # -- queries ----------------------------------------------------------

    def cached_block_count(self) -> int:
        return self.pool.num_cached()

    def evictable_blocks(self) -> int:
        return self.pool.num_evictable()

    def match(self, tokens: np.ndarray
              ) -> Tuple[List[int], Optional[int], int]:
        """Longest cached prefix of `tokens` (no refcounting here).

        Returns ``(full_blocks, partial_block, partial_len)``:
        `full_blocks` cover tokens ``[0, len(full_blocks) * bs)``
        exactly; `partial_block` (optional) additionally matches its
        first `partial_len` positions, ``0 < partial_len < bs`` — a
        request mapping it must copy-on-write before writing into the
        block.  Bumps LRU access time along the matched path.
        """
        full, partial, plen = self._match(tokens)
        matched = len(full) * self.bs + plen
        self.metrics.counter("serving.prefix.lookups").inc()
        if matched:
            self.metrics.counter("serving.prefix.hits").inc()
            self.metrics.counter("serving.prefix.hit_tokens").inc(matched)
        if self.obs.enabled:
            self.obs.event("prefix_lookup", matched_tokens=matched,
                           full_blocks=len(full), partial_len=plen)
        return full, partial, plen

    def _match(self, tokens: np.ndarray
               ) -> Tuple[List[int], Optional[int], int]:
        self._tick += 1
        bs = self.bs
        tokens = np.ascontiguousarray(tokens, np.int32)
        node = self.root
        node.last_access = self._tick
        full: List[int] = []
        off = 0
        while True:
            rest = len(tokens) - off
            if rest <= 0:
                return full, None, 0
            child = (node.children.get(tokens[off:off + bs].tobytes())
                     if rest >= bs else None)
            if child is None:
                # no full first-block hit: probe children for the best
                # within-block overlap (small fan-out; linear scan)
                best, best_ov = None, 0
                for c in node.children.values():
                    ov = _common_prefix_len(c.tokens[:bs],
                                            tokens[off:off + bs])
                    if ov > best_ov:
                        best, best_ov = c, ov
                if best is not None:
                    best.last_access = self._tick
                    best.block_access[0] = self._tick
                    return full, best.blocks[0], best_ov
                return full, None, 0
            child.last_access = self._tick
            nb = len(child.blocks)
            f = 1                       # dict hit == first block equal
            while (f < nb and rest >= (f + 1) * bs
                   and np.array_equal(child.tokens[f * bs:(f + 1) * bs],
                                      tokens[off + f * bs:
                                             off + (f + 1) * bs])):
                f += 1
            # only the matched prefix of the edge is hot; the tail
            # keeps its older stamps so eviction can take it first
            child.block_access[:f] = [self._tick] * f
            full.extend(child.blocks[:f])
            off += f * bs
            if f < nb:
                # diverged (or ran out of prompt) mid-edge: at most a
                # partial overlap inside the next block of this edge
                ov = _common_prefix_len(
                    child.tokens[f * bs:(f + 1) * bs],
                    tokens[off:off + bs])
                if ov > 0:
                    child.block_access[f] = self._tick
                    return full, child.blocks[f], ov
                return full, None, 0
            node = child

    # -- insertion --------------------------------------------------------

    def insert(self, tokens: np.ndarray, blocks: List[int]) -> int:
        """Adopt a finished request's full-block run into the tree.

        ``len(tokens) == len(blocks) * bs``; `blocks` hold the KV of
        exactly those token positions.  Prefix ranges the tree already
        covers keep the TREE's blocks (the caller's duplicates simply
        lose their last reference at harvest and return to the free
        list); the novel suffix's blocks are adopted (``mark_cached``)
        while the caller retains its refcount until its own decref.
        Returns the number of newly adopted blocks.
        """
        self._tick += 1
        bs = self.bs
        tokens = np.ascontiguousarray(tokens, np.int32)
        assert len(tokens) == len(blocks) * bs
        node = self.root
        node.last_access = self._tick
        off, bi, adopted = 0, 0, 0
        while bi < len(blocks):
            key = tokens[off:off + bs].tobytes()
            child = node.children.get(key)
            if child is None:
                new = _Node(node, tokens[off:].copy(), list(blocks[bi:]),
                            self._tick, bs)
                node.children[key] = new
                for b in blocks[bi:]:
                    self.pool.mark_cached(b)
                    adopted += 1
                return adopted
            child.last_access = self._tick
            nb = len(child.blocks)
            f = 1
            while (f < nb and bi + f < len(blocks)
                   and np.array_equal(child.tokens[f * bs:(f + 1) * bs],
                                      tokens[off + f * bs:
                                             off + (f + 1) * bs])):
                f += 1
            child.block_access[:f] = [self._tick] * f
            if f < nb:
                # split the edge at block f; the lower half keeps the
                # original node's children, trailing blocks and their
                # (possibly colder) per-block stamps
                lower = _Node(child, child.tokens[f * bs:].copy(),
                              child.blocks[f:], child.last_access, bs)
                lower.block_access = child.block_access[f:]
                lower.children = child.children
                for c in lower.children.values():
                    c.parent = lower
                child.tokens = child.tokens[:f * bs].copy()
                child.blocks = child.blocks[:f]
                child.block_access = child.block_access[:f]
                child.children = {lower.key: lower}
            off += f * bs
            bi += f
            node = child
        return adopted

    # -- eviction ---------------------------------------------------------

    def _leaves(self) -> List["_Node"]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n is not self.root:
                out.append(n)
        return out

    def evict(self, n: int) -> int:
        """Free up to `n` refcount-0 cached blocks, coldest BLOCK first
        (per-block LRU stamps, not per-node: a hot node's cold tail
        goes before a warmer leaf elsewhere).

        Blocks still leave a leaf tail-first so every surviving node
        holds a valid block-aligned prefix run; the heap is keyed by
        each leaf's tail-block stamp and the leaf is re-pushed after
        every pop, so interleaved tails drain in global stamp order.
        A leaf drained to zero blocks is unlinked and may expose its
        parent as the next candidate.  Blocks pinned by an active
        request (refcount > 0) are never touched (a pinned tail also
        shields the blocks above it — tail-first order is what keeps
        runs prefix-valid).  Returns the number of blocks freed.
        """
        freed = 0
        heap = [(leaf.block_access[-1], id(leaf), leaf)
                for leaf in self._leaves() if leaf.blocks]
        heapq.heapify(heap)
        while heap and freed < n:
            _, _, leaf = heapq.heappop(heap)
            if leaf.children or leaf is self.root or not leaf.blocks:
                continue                # became internal since collection
            if self.pool.refcount[leaf.blocks[-1]] > 0:
                continue                # pinned tail: nothing evictable
            self.pool.release_cached(leaf.blocks.pop())
            leaf.block_access.pop()
            leaf.tokens = leaf.tokens[:len(leaf.blocks) * self.bs]
            freed += 1
            self.evicted_blocks += 1
            if leaf.blocks:
                heapq.heappush(heap,
                               (leaf.block_access[-1], id(leaf), leaf))
            else:
                parent = leaf.parent
                del parent.children[leaf.key]
                if (parent is not self.root and not parent.children
                        and parent.blocks):
                    heapq.heappush(
                        heap,
                        (parent.block_access[-1], id(parent), parent))
        if freed:
            self.metrics.counter("serving.prefix.evictions").inc(freed)
            if self.obs.enabled:
                self.obs.event("eviction", blocks=freed, requested=n)
        return freed

    # -- integrity (tests) ------------------------------------------------

    def check_invariants(self) -> None:
        """Walk the tree + pool and assert the refcount/residency
        partition holds (test helper; O(num_blocks + tree))."""
        pool = self.pool
        seen: set = set()
        stack = [self.root]
        while stack:
            node = stack.pop()
            assert len(node.tokens) == len(node.blocks) * self.bs, \
                "edge not block-aligned"
            assert len(node.block_access) == len(node.blocks), \
                "per-block LRU stamps out of sync with blocks"
            for b in node.blocks:
                assert b not in seen, f"block {b} in two nodes"
                seen.add(b)
                assert pool.cached[b], f"tree block {b} not marked cached"
            stack.extend(node.children.values())
        assert len(seen) == pool.num_cached(), \
            "cached flags out of sync with tree residency"
        free = set(pool._free)
        assert len(free) == len(pool._free), "duplicate free-list entry"
        for b in range(pool.num_blocks):
            assert pool.refcount[b] >= 0
            on_free = b in free
            should_be_free = pool.refcount[b] == 0 and not pool.cached[b]
            assert on_free == should_be_free, \
                f"block {b}: free-list membership violates partition"
