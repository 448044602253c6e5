"""Cross-request prefix cache index for the paged KV pool (a copy of
``triton_dist_tpu.models.prefix_cache``; the port imports nothing of the
JAX package, so it keeps its own).

vLLM-style radix/prefix caching flattened onto the block-hash chain:
logical block ``j`` of a prompt is identified by

    h_j = sha1(h_{j-1} || tokens[j*page : (j+1)*page])

so two prompts share block ``j`` iff their first ``(j+1)*page`` tokens
are identical: the radix-tree lookup degenerates to walking the hash
chain until the first miss. The chain is the JAX package's byte for
byte (``tests/test_torch_sp_engine.py``), so the two packages' caches
key the same blocks. Only FULL blocks are ever indexed: the tail
(partial) block of a sequence is written during decode and must stay
private, which makes copy-on-write degenerate to "write-blocks-are-
private-by-construction": an indexed block is immutable for its whole
life in the pool.

This class is the pure host-side INDEX: hash -> (device, slot),
slot -> hash, and a per-device LRU of *evictable* slots (refcount has
dropped to zero in the allocator, data still resident). The refcounts
themselves, and the free stacks the evicted slots return to, live in
``PagedKVCacheManager``, which owns every state transition:

    free --alloc--> active(ref=1) --register--> active+indexed
      ^                |  ^                        |
      +----deref-------+  +--------claim-----------+ deref->0
                                                   v
                                         evictable (LRU) --evict--> free

Thread-safety: none. Exactly one thread drives a stream session
(models/engine.py contract), and the manager calls in from that thread
only.
"""

from __future__ import annotations

import collections
import hashlib


class PrefixCache:
    """Block-hash index + per-device LRU for refcount-zero blocks."""

    def __init__(self, world: int, page_size: int):
        self.world = world
        self.page_size = page_size
        self._map: dict[bytes, tuple[int, int]] = {}    # hash → (r, slot)
        self._by_slot: dict[tuple[int, int], bytes] = {}
        # slot → None, insertion-ordered: front = least recently used.
        self._evictable: list = [collections.OrderedDict()
                                 for _ in range(world)]
        # Block-weighted stats, cumulative over THIS cache object's
        # lifetime (stats()).
        self.lookup_blocks = 0
        self.hit_blocks = 0
        self.evictions = 0

    # -- hashing -----------------------------------------------------------
    def block_hashes(self, tokens) -> list[bytes]:
        """Hash chain over the FULL blocks of ``tokens`` (the partial
        tail block, if any, is not hashable — it is still mutable)."""
        page = self.page_size
        out: list[bytes] = []
        h = b""
        for j in range(len(tokens) // page):
            blk = tokens[j * page:(j + 1) * page]
            m = hashlib.sha1(h)
            m.update(b",".join(str(int(t)).encode() for t in blk))
            h = m.digest()
            out.append(h)
        return out

    # -- lookup ------------------------------------------------------------
    def probe(self, hashes) -> int:
        """Longest indexed prefix of ``hashes`` (STATELESS — no
        counters, no LRU touch): the admission planner uses this to
        size the suffix program before committing to the hits."""
        k = 0
        for h in hashes:
            if h not in self._map:
                break
            k += 1
        return k

    def chain_prefix_match(self, hashes) -> int:
        """Longest locally-held hash-chain prefix of ``hashes``: the
        ``kv_need`` primitive of the JAX package's disaggregated
        handoff. Identical walk to :meth:`probe` (stateless, no LRU
        touch), under the protocol's name."""
        return self.probe(hashes)

    def resolve(self, hashes, max_hits: int | None = None):
        """Resolve the longest indexed prefix to its slots (no counter
        accounting — the allocator accounts only admissions that
        succeed, so a rolled-back admission cannot skew the hit rate).
        Returns ``[(r, slot), ...]`` for the first ``k`` blocks
        (``k <= max_hits`` when given)."""
        k = self.probe(hashes)
        if max_hits is not None:
            k = min(k, max_hits)
        return [self._map[h] for h in hashes[:k]]

    def account(self, lookup_blocks: int, hit_blocks: int) -> None:
        """Fold one successful admission into the cumulative
        block-weighted hit/lookup counters."""
        self.lookup_blocks += lookup_blocks
        self.hit_blocks += hit_blocks

    def lookup(self, hashes, max_hits: int | None = None):
        """``resolve`` + ``account`` in one step, for callers without a
        rollback path."""
        hits = self.resolve(hashes, max_hits=max_hits)
        self.account(len(hashes), len(hits))
        return hits

    def hit_rate(self) -> float:
        """Cumulative block-weighted hit rate in [0, 1]."""
        return (self.hit_blocks / self.lookup_blocks
                if self.lookup_blocks else 0.0)

    # -- index maintenance (driven by the allocator) -----------------------
    def register(self, h: bytes, r: int, slot: int) -> bool:
        """Index a freshly-computed full block. First writer wins: a
        hash already indexed (or a slot already carrying another hash)
        leaves the existing entry — the duplicate block stays private
        and is freed normally at retire."""
        if h in self._map or (r, slot) in self._by_slot:
            return False
        self._map[h] = (r, slot)
        self._by_slot[(r, slot)] = h
        return True

    def is_indexed(self, r: int, slot: int) -> bool:
        return (r, slot) in self._by_slot

    def claim(self, r: int, slot: int) -> None:
        """An indexed block is being re-shared (refcount 0 → 1): pull
        it out of the evictable LRU; the index entry stays."""
        self._evictable[r].pop(slot, None)

    def release(self, r: int, slot: int) -> None:
        """An indexed block's refcount dropped to zero: its data stays
        resident and reusable, but it becomes the eviction candidate
        pool's most-recently-used entry."""
        self._evictable[r].pop(slot, None)
        self._evictable[r][slot] = None

    def evictable_count(self, r: int) -> int:
        return len(self._evictable[r])

    def evict_lru(self, r: int) -> int | None:
        """Drop device ``r``'s least-recently-used refcount-zero block
        from the index and hand its slot to the allocator. ``None``
        when nothing is evictable."""
        if not self._evictable[r]:
            return None
        slot, _ = self._evictable[r].popitem(last=False)
        h = self._by_slot.pop((r, slot))
        del self._map[h]
        self.evictions += 1
        return slot

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        return {"indexed_blocks": len(self._map),
                "evictable_blocks": sum(len(e) for e in self._evictable),
                "lookup_blocks": self.lookup_blocks,
                "hit_blocks": self.hit_blocks,
                "hit_rate": round(self.hit_rate(), 4),
                "evictions": self.evictions}
