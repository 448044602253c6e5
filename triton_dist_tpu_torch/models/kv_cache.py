"""KV caches (the port of ``triton_dist_tpu.models.kv_cache``): the
contiguous :class:`KVCacheManager` (at world 1, and over a rank group of
W > 1: head-sharded for TP, sequence-sharded for SP) and the paged
:class:`PagedKVCacheManager` (W sequence ranks) with its host-side block
allocator.

The contiguous cache is a list of per-layer ``(k, v)`` tensors of shape
(B, T, Hkv, D); the paged cache a list of per-layer ``(pool_k, pool_v)``
page pools of shape (W P, page, Hkv, D) read through a (W, B, n_pages)
block table. Unlike the JAX package, whose arrays are immutable and
threaded through the forward, the port's forward **updates these tensors
in place** (``layers.tp_attn._attention_core``, ``models.dense``): the
model returns the same tensors it was given, a caller that needs the old
contents must copy them first, and every layer's K and V are tensors of
their own (JAX hands out one zero array for all of them).

The allocator is the JAX package's pure-Python one, on the same numpy
state (free stacks, tables, refcounts) so the two can be compared step
by step (``tests/test_torch_sp_engine.py``); the JAX package's native
allocator (``csrc/kvpool``) and the ``obs`` gauges are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_dist_tpu_torch.models.prefix_cache import PrefixCache


class KVCacheManager:
    """Contiguous per-layer caches, global (B, T, Hkv, D) tensors at
    every world.

    ``world`` > 1: the caches are sharded over the ranks, JAX's
    ``P(None, None, axis, None)`` (head-sharded, the TP cache: rank r's
    cache is the view of its Hkv / W heads, the rank group's
    ``shard(cache, 2)``) or, with ``seq_shard`` (the sp engines' cache),
    ``P(None, axis)``: rank r holds positions [r T / W, (r + 1) T / W),
    the view ``shard(cache, 1)``. The layers write the global tensors in
    place, so a write lands on the rank that owns its position."""

    def __init__(self, num_layers: int, batch: int, max_seq: int,
                 num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 device=None, seq_shard: bool = False, world: int = 1):
        if seq_shard and max_seq % world:
            raise ValueError(f"{max_seq} positions do not shard over "
                             f"{world} ranks")
        if not seq_shard and num_kv_heads % world:
            raise ValueError(f"{num_kv_heads} kv heads do not shard over "
                             f"{world} ranks")
        self.world = world
        self.num_layers = num_layers
        self.batch, self.max_seq = batch, max_seq
        self.num_kv_heads, self.head_dim = num_kv_heads, head_dim
        self.dtype = dtype
        self.device = device
        self.seq_shard = seq_shard
        self.offset = 0  # host-side write position

    def init(self, rows: int | None = None):
        """Allocate the caches: [(k, v)] * L, zero-filled, with ``rows``
        batch rows (default: the manager's ``batch``)."""
        rows = self.batch if rows is None else rows
        if not 0 < rows <= self.batch:
            raise ValueError(f"{rows} rows do not fit a batch of "
                             f"{self.batch}")
        shape = (rows, self.max_seq, self.num_kv_heads, self.head_dim)
        return [(torch.zeros(shape, dtype=self.dtype, device=self.device),
                 torch.zeros(shape, dtype=self.dtype, device=self.device))
                for _ in range(self.num_layers)]

    def inc_offset(self, n: int) -> int:
        """Advance the write position."""
        self.offset += n
        if self.offset > self.max_seq:
            raise RuntimeError(f"KV cache overflow: offset {self.offset} > "
                               f"max_seq {self.max_seq}")
        return self.offset

    def reset(self):
        self.offset = 0


class PagedKVCacheManager:
    """Paged KV pools + block tables (JAX ``PagedKVCacheManager``).

    Layout, as the flash-decode kernels read it
    (``ops.flash_decode.gqa_fwd_batch_decode_paged``):

    * ``world`` W devices (ranks) of the sequence axis; device r backs
      global positions [r t_loc, (r + 1) t_loc) of every row, t_loc =
      page_size * pages_per_seq_dev, with a pool of its own.
    * pools: (W phys_slots_per_dev, page_size, Hkv, D) per layer for K
      and for V, device r's its rows [r phys, (r + 1) phys),
      phys_slots_per_dev = slots_per_dev + 1. The last physical page of
      each device is its reserved SENTINEL: stream sessions point
      unoccupied rows at it, and it lies outside the accounted pool, so
      the whole ``slots_per_dev`` capacity stays allocatable.
    * block table: (W, B, pages_per_seq_dev) int32; entry [r, b, i] is
      device r's LOCAL slot of row b's logical page r * pages_per_seq_dev
      + i, as in the JAX layout.

    Two admission disciplines share the pool and never each other's
    state (:meth:`reset_pool` between them): the seq-granular
    :meth:`alloc_seq` / :meth:`free_seq` / :meth:`alloc_many` reserve
    whole rows (``Engine.serve``); the block-granular substrate
    (:meth:`stream_setup`, :meth:`admit_row`, :meth:`ensure_position`,
    :meth:`release_row`, :meth:`register_prefix`) admits by blocks, grows
    rows one block at a time, shares full prompt blocks through the
    prefix cache and returns blocks the moment a row retires
    (stream sessions).

    The device copy of the table (:meth:`block_table`) is dropped on
    every change of the host table and rebuilt on the next read: a stale
    copy would send one row's writes into another row's pages."""

    def __init__(self, num_layers: int, batch: int, page_size: int,
                 pages_per_seq_dev: int, num_kv_heads: int, head_dim: int,
                 dtype=torch.bfloat16, device=None,
                 slots_per_dev: int | None = None, world: int = 1):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = world
        self.num_layers = num_layers
        self.batch = batch
        self.page_size = page_size
        self.pages_per_seq_dev = pages_per_seq_dev
        self.t_loc = page_size * pages_per_seq_dev
        self.max_seq = self.t_loc * self.world
        self.num_kv_heads, self.head_dim = num_kv_heads, head_dim
        self.dtype = dtype
        self.device = device
        self.slots_per_dev = (slots_per_dev if slots_per_dev is not None
                              else batch * pages_per_seq_dev)
        # Pools smaller than one whole row are legal: block-granular
        # sessions admit by blocks, and the seq-granular path fails a
        # too-big request with "device pool exhausted".
        if self.slots_per_dev < 1:
            raise ValueError("pool too small")
        self.phys_slots_per_dev = self.slots_per_dev + 1
        self.offset = 0
        w, slots = self.world, self.slots_per_dev
        self._stack = np.empty((w, slots), np.int32)
        self._top = np.empty((w,), np.int32)
        self._table = np.zeros((w, batch, pages_per_seq_dev), np.int32)
        self._owned = np.zeros((batch,), np.uint8)
        self._init_allocator()
        # Block-granular serving substrate, populated by stream_setup().
        self._blockwise = False
        self.prefix = None           # PrefixCache when enabled
        self._sentinel = None        # (w,) slot ids unowned rows point at
        self._ref = np.zeros((w, slots), np.int32)
        self._row_blocks = np.zeros((batch,), np.int32)
        self._committed = np.zeros((w,), np.int64)
        self._row_commit = np.zeros((batch, w), np.int64)
        self._evicted_total = 0

    def _init_allocator(self) -> None:
        """(Re)initialize the free stacks, tables and ownership flags."""
        self._top[:] = self.slots_per_dev
        self._stack[:] = np.arange(self.slots_per_dev, dtype=np.int32)
        self._table[:] = 0
        self._owned[:] = 0
        self._table_dev = None

    @staticmethod
    def _raise(rc: int, what: str):
        if rc == -1:
            raise RuntimeError(f"row {what}: not allocatable/freeable "
                               "(bad index or ownership state)")
        if rc == -2:
            raise RuntimeError(f"row {what}: device pool exhausted")

    # -- seq-granular allocation -------------------------------------------
    def alloc_seq(self, b: int) -> None:
        """Reserve every logical page of row ``b``, all-or-nothing."""
        self._raise(self._py_alloc_seq(b), str(b))
        self._table_dev = None

    def _py_alloc_seq(self, b: int) -> int:
        if not (0 <= b < self.batch) or self._owned[b]:
            return -1
        pages = self.pages_per_seq_dev
        if any(self._top[r] < pages for r in range(self.world)):
            return -2  # check every device first: no partial pops
        for r in range(self.world):
            for i in range(pages):
                self._top[r] -= 1
                self._table[r, b, i] = self._stack[r, self._top[r]]
        self._owned[b] = 1
        return 0

    def free_seq(self, b: int) -> None:
        self._raise(self._py_free_seq(b), str(b))
        self._table_dev = None

    def _py_free_seq(self, b: int) -> int:
        if not (0 <= b < self.batch) or not self._owned[b]:
            return -1
        for r in range(self.world):
            for i in range(self.pages_per_seq_dev):
                self._stack[r, self._top[r]] = self._table[r, b, i]
                self._top[r] += 1
        self._owned[b] = 0
        return 0

    def owned_rows(self) -> list:
        """Rows currently holding an allocation."""
        return [int(b) for b in range(self.batch) if self._owned[b]]

    def alloc_many(self, rows) -> None:
        """Allocate a whole request of rows all-or-nothing: on a failure
        every row of this call is rolled back before raising."""
        rows = [int(b) for b in rows]
        rc = 0
        done = []
        for b in rows:
            rc = self._py_alloc_seq(b)
            if rc != 0:
                for k in done:
                    self._py_free_seq(k)
                break
            done.append(b)
        self._raise(rc, str(rows))
        self._table_dev = None

    # -- block-granular serving substrate (stream sessions) -----------------
    def reset_pool(self) -> None:
        """Every slot free, tables zeroed, prefix index dropped, both
        serving modes clear. serve() and stream_setup() start here."""
        self._init_allocator()
        self._blockwise = False
        self.prefix = None
        self._sentinel = None
        self._ref[:] = 0
        self._row_blocks[:] = 0
        self._committed[:] = 0
        self._row_commit[:] = 0
        self.offset = 0

    def stream_setup(self, prefix_cache: bool = True) -> None:
        """Reset the pool and enter block-granular mode: every row's
        lanes point at the SENTINEL page (slot ``slots_per_dev``), where
        the shared decode step's writes for unoccupied rows land
        harmlessly, so a retiring row can release its blocks at once."""
        self.reset_pool()
        self._blockwise = True
        if prefix_cache:
            self.prefix = PrefixCache(self.world, self.page_size)
        self._sentinel = np.full((self.world,), self.slots_per_dev,
                                 np.int32)
        for b in range(self.batch):
            self._point_at_sentinel(b)
        self._table_dev = None

    def _point_at_sentinel(self, b: int) -> None:
        self._table[:, b, :] = self._sentinel[:, None]

    def _pop_block(self, r: int) -> int:
        """One free block on device ``r``: the free stack first, then LRU
        eviction of a refcount-zero cached block."""
        if self._top[r] > 0:
            self._top[r] -= 1
            return int(self._stack[r, self._top[r]])
        victim = (self.prefix.evict_lru(r)
                  if self.prefix is not None else None)
        if victim is None:
            raise RuntimeError(f"device {r} pool exhausted")
        self._evicted_total += 1
        return victim

    def _push_block(self, r: int, slot: int) -> None:
        self._stack[r, self._top[r]] = slot
        self._top[r] += 1

    def _deref(self, r: int, slot: int) -> None:
        self._ref[r, slot] -= 1
        if self._ref[r, slot] < 0:
            raise RuntimeError(f"double free: dev {r} slot {slot}")
        if self._ref[r, slot] == 0:
            if self.prefix is not None and self.prefix.is_indexed(r, slot):
                # The data stays resident for future hits; the block is
                # now the most recently used eviction candidate.
                self.prefix.release(r, slot)
            else:
                self._push_block(r, slot)

    # -- admission arithmetic -------------------------------------------------
    def _block_lane(self, j: int):
        """Logical block ``j`` of a row -> (device r, table lane lp)."""
        return j // self.pages_per_seq_dev, j % self.pages_per_seq_dev

    def _blocks_per_dev(self, j0: int, j1: int):
        """Per-device count of logical blocks [j0, j1)."""
        out = np.zeros((self.world,), np.int64)
        js = np.arange(j0, j1) // self.pages_per_seq_dev
        if len(js):
            out += np.bincount(js, minlength=self.world)
        return out

    def need_per_dev(self, prompt_len: int, gen_len: int):
        """Worst-case block demand of one request, per device: blocks
        covering every position it will ever write (prefill writes
        [0, L), decode steps write [L, L+G-1))."""
        last = max(prompt_len + max(gen_len, 1) - 1, prompt_len)
        n = -(-last // self.page_size)
        if n > self.pages_per_seq_dev * self.world:
            raise ValueError(f"request spans {n} blocks > max_seq capacity "
                             f"(check prompt+gen_len <= max_seq first)")
        return self._blocks_per_dev(0, n)

    def available_per_dev(self):
        """Free-stack depth plus evictable (refcount-zero cached) blocks,
        per device: everything an admission could claim."""
        avail = self._top.astype(np.int64).copy()
        if self.prefix is not None:
            avail += np.asarray([self.prefix.evictable_count(r)
                                 for r in range(self.world)], np.int64)
        return avail

    def fits_pool(self, prompt_len: int, gen_len: int) -> bool:
        """Could this request ever be admitted (empty pool)? False means
        reject it, not queue it: it would stall the admission queue."""
        return bool((self.need_per_dev(prompt_len, gen_len)
                     <= self.slots_per_dev).all())

    def can_admit(self, prompt_len: int, gen_len: int,
                  extra=None) -> bool:
        """Enough blocks free (or evictable) for this request's
        worst-case demand, net of what live rows' decode tails hold
        committed and of ``extra`` (same-batch admissions not yet run)."""
        avail = self.available_per_dev() - self._committed
        if extra is not None:
            avail = avail - extra
        return bool((avail >= self.need_per_dev(prompt_len,
                                                gen_len)).all())

    # -- request lifecycle ----------------------------------------------------
    def prefix_hashes(self, prompt) -> list | None:
        """Full block-hash chain for ``prompt`` (``None`` without a
        prefix cache), computed once per admission."""
        if self.prefix is None:
            return None
        return self.prefix.block_hashes(prompt)

    def prefix_lookup_blocks(self, prompt_len: int) -> int:
        """Blocks eligible for a prefix lookup: every full prompt block
        except the last one of an exactly page-aligned prompt, which is
        always recomputed (admission needs the last position's logits)."""
        n = prompt_len // self.page_size
        if n and prompt_len % self.page_size == 0:
            n -= 1
        return n

    def prefix_probe(self, prompt, hashes=None) -> int:
        """Upper bound on cache-hit BLOCKS for ``prompt`` (stateless)."""
        if self.prefix is None:
            return 0
        if hashes is None:
            hashes = self.prefix.block_hashes(prompt)
        return self.prefix.probe(
            hashes[:self.prefix_lookup_blocks(len(prompt))])

    def admit_row(self, b: int, prompt, gen_budget: int = 0,
                  use_hits: int | None = None, hashes=None) -> int:
        """Block-granular admission of ``prompt`` into row ``b``:

        1. map up to ``use_hits`` cached prefix blocks into the row's
           lanes (refcounted, shared, read-only);
        2. allocate private blocks for the rest of the prompt;
        3. commit (without allocating) the decode-tail blocks the
           ``gen_budget`` may still demand.

        All-or-nothing: on exhaustion every hit ref is rolled back and
        the row's lanes return to the sentinel. Returns the number of
        prefix TOKENS served from cache (a page multiple)."""
        if not self._blockwise:
            raise RuntimeError("admit_row needs stream_setup() first")
        if self._row_blocks[b] != 0:
            raise RuntimeError(f"row {b} already holds blocks")
        L = len(prompt)
        page = self.page_size
        hits, n_lookup = [], 0
        if self.prefix is not None:
            if hashes is None:
                hashes = self.prefix.block_hashes(prompt)
            hashes = hashes[:self.prefix_lookup_blocks(L)]
            n_lookup = len(hashes)
            hits = self.prefix.resolve(hashes, max_hits=use_hits)
        k = len(hits)
        n_prompt = -(-L // page)
        last = max(L + max(gen_budget, 1) - 1, L)
        n_total = max(n_prompt, -(-last // page))
        # Map the hits first (claiming them out of the evictable pool) so
        # the availability check sees the exact post-hit state.
        for j, (r, slot) in enumerate(hits):
            rj, lp = self._block_lane(j)
            if r != rj:
                raise RuntimeError("prefix index device/layout mismatch")
            if self._ref[r, slot] == 0:
                self.prefix.claim(r, slot)
            self._ref[r, slot] += 1
            self._table[r, b, lp] = slot
        need = self._blocks_per_dev(k, n_total)
        avail = self.available_per_dev() - self._committed
        if np.any(avail < need):
            for r, slot in hits:                       # roll back
                self._deref(r, slot)
            self._point_at_sentinel(b)
            self._table_dev = None
            raise RuntimeError(
                f"row {b}: device pool exhausted "
                f"(short {int(np.max(need - avail))} block(s); "
                f"{int(self._committed.sum())} committed to live rows)")
        for j in range(k, n_prompt):
            r, lp = self._block_lane(j)
            slot = self._pop_block(r)
            self._ref[r, slot] = 1
            self._table[r, b, lp] = slot
        tail = self._blocks_per_dev(n_prompt, n_total)
        self._row_commit[b] = tail
        self._committed += tail
        self._row_blocks[b] = n_prompt
        if self.prefix is not None:     # account only admissions that
            self.prefix.account(n_lookup, k)    # actually succeeded
        self._table_dev = None
        return k * page

    def ensure_position(self, b: int, pos: int) -> bool:
        """Grow row ``b``'s allocation to cover write position ``pos``
        (called before each decode step), one block per page boundary
        crossed; each new block consumes the row's decode commitment
        where one is left. Returns True when the table changed."""
        j = pos // self.page_size
        n = int(self._row_blocks[b])
        if j < n:
            return False
        for jj in range(n, j + 1):
            r, lp = self._block_lane(jj)
            slot = self._pop_block(r)
            self._ref[r, slot] = 1
            self._table[r, b, lp] = slot
            self._row_blocks[b] = jj + 1
            if self._row_commit[b, r] > 0:   # consume the commitment
                self._row_commit[b, r] -= 1
                self._committed[r] -= 1
        self._table_dev = None
        return True

    def release_row(self, b: int) -> None:
        """Eager retirement: deref every block (shared blocks drop a
        ref; indexed refcount-zero blocks stay cached and evictable;
        private blocks return to the free stack), release the row's
        remaining decode commitment and point its lanes back at the
        sentinel so frozen-row writes stay harmless."""
        for j in range(int(self._row_blocks[b])):
            r, lp = self._block_lane(j)
            self._deref(r, int(self._table[r, b, lp]))
        self._committed -= self._row_commit[b]
        self._row_commit[b] = 0
        self._row_blocks[b] = 0
        self._point_at_sentinel(b)
        self._table_dev = None

    def register_prefix(self, b: int, tokens, hashes=None) -> int:
        """Index row ``b``'s full PROMPT blocks in the prefix cache once
        its admission prefill has written them. The partial tail block
        is mutable (decode writes it) and never indexed. Returns how
        many blocks were newly indexed."""
        if self.prefix is None:
            return 0
        n_full = min(len(tokens) // self.page_size,
                     int(self._row_blocks[b]))
        if hashes is None:
            hashes = self.prefix.block_hashes(tokens)
        new = 0
        for j in range(n_full):
            r, lp = self._block_lane(j)
            new += bool(self.prefix.register(
                hashes[j], r, int(self._table[r, b, lp])))
        return new

    # -- introspection --------------------------------------------------------
    def block_audit(self) -> dict:
        """Pool accounting snapshot: after every request retires, free +
        evictable must equal the whole pool (a stranded block is a slow
        leak). The sentinel page is outside the accounted pool."""
        free = int(self._top.sum())
        evictable = (sum(self.prefix.evictable_count(r)
                         for r in range(self.world))
                     if self.prefix is not None else 0)
        total = self.world * self.slots_per_dev
        return {"free": free, "evictable": evictable,
                "active": total - free - evictable,
                "committed": int(self._committed.sum()),
                "evicted_total": self._evicted_total,
                "total": total}

    def block_table(self) -> torch.Tensor:
        """Device copy of the (W, B, n_pages) int32 table, rebuilt after
        any change of the host table (cached until the next one)."""
        if self._table_dev is None:
            self._table_dev = torch.from_numpy(self._table.copy()).to(
                self.device)
        return self._table_dev

    # -- device state ---------------------------------------------------------
    def init(self):
        """[(pool_k, pool_v)] * L, every slot zeroed; K and V of every
        layer are separate tensors (the forward writes them in place).
        The +1 physical slot is the reserved sentinel page."""
        shape = (self.world * self.phys_slots_per_dev, self.page_size,
                 self.num_kv_heads, self.head_dim)
        return [(torch.zeros(shape, dtype=self.dtype, device=self.device),
                 torch.zeros(shape, dtype=self.dtype, device=self.device))
                for _ in range(self.num_layers)]

    @staticmethod
    def _addr(offset, page_size: int, n_pages: int, world: int = 1):
        """THE page-layout address math: position(s) (a Python int or an
        integer tensor) -> (device r, local page lp, in-page row). r is
        clamped into [0, world), as the JAX package's gather clamps it, so
        a position past max_seq still lands inside the table."""
        t_loc = page_size * n_pages
        if isinstance(offset, int):
            return (min(offset // t_loc, world - 1),
                    offset % t_loc // page_size, offset % page_size)
        r = torch.clamp(torch.div(offset, t_loc, rounding_mode="floor"),
                        max=world - 1)
        return r, torch.div(offset % t_loc, page_size,
                            rounding_mode="floor"), offset % page_size

    @staticmethod
    def position_to_slot(table: torch.Tensor, offset, page_size: int,
                         slots_per_dev: int):
        """Global position(s) -> (pool rows, in-page row(s)). A Python int
        ``offset`` gives rows (B,) and an int (no copy to the device); a
        vector of T positions gives (T, B) and (T,)."""
        r, lp, inpage = PagedKVCacheManager._addr(
            offset, page_size, table.shape[2], table.shape[0])
        table = table.long()
        if isinstance(offset, int):
            return r * slots_per_dev + table[r, :, lp], inpage
        gslots = (r * slots_per_dev)[:, None] + table[r, :, lp]
        return gslots, inpage

    @staticmethod
    def gathered_view(pool: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
        """Contiguous (B, T, Hkv, D) view of one pooled layer through the
        (W, B, n_pages) table, T = W * n_pages * page: device r's pages
        (its pool rows r * P + table[r]) give positions [r t_loc,
        (r + 1) t_loc). The plain paged decode's and the paged chunked
        prefill's read of the pool. Positions past a row's live length
        resolve to sentinel or stale pages that the callers' kv_len masks
        never expose."""
        world, b, n_pages = table.shape
        spd = pool.shape[0] // world
        base = torch.arange(world, device=table.device)[:, None, None] * spd
        pages = pool[table.long() + base]      # (W, B, n_pages, page, ...)
        return pages.transpose(0, 1).reshape(b, world * n_pages
                                             * pool.shape[1],
                                             *pool.shape[2:])

    @staticmethod
    def position_to_slot_rows(table: torch.Tensor, offsets, page_size: int,
                              slots_per_dev: int):
        """Per-row positions (B,) -> (pool rows (B,), in-page rows (B,)):
        row b's position resolves through row b's own table lane (the
        continuous-batching decode step)."""
        r, lp, inpage = PagedKVCacheManager._addr(
            offsets, page_size, table.shape[2], table.shape[0])
        rows = torch.arange(table.shape[1], device=table.device)
        return r * slots_per_dev + table.long()[r, rows, lp], inpage

    def inc_offset(self, n: int) -> int:
        self.offset += n
        if self.offset > self.max_seq:
            raise RuntimeError(f"paged KV overflow: offset {self.offset} > "
                               f"max_seq {self.max_seq}")
        return self.offset

    def reset(self):
        self.offset = 0
