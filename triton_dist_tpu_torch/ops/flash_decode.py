"""GQA flash decode (the port of ``triton_dist_tpu.ops.flash_decode``).

One query position per sequence attends to its KV cache: dense rows
(:func:`gqa_fwd_batch_decode`) or a paged pool read through a block
table (:func:`gqa_fwd_batch_decode_paged`). At world = 1 the JAX
package's cross-rank combine merges nothing but one partial, so the
function is the softmax attention of ``_local_partials`` (:149) and
``_merge`` (:194), kept here as the plain versions
:func:`flash_decode_reference` / :func:`flash_decode_paged_reference`.

At world W (a context over a ``RankGroup`` of W ranks on the one card,
the "sp" axis), rank r holds positions [r t_loc, (r + 1) t_loc) of every
row: the dense cache's columns there, or its own pool rows through its
table (W, B, n_pages). The plain version
:func:`flash_decode_world_reference` takes each rank's
``_local_partials`` with ``first_pos = r t_loc`` (:149) and merges
them in rank order with ``_merge`` (:194); ``impl="xla"`` is JAX's
pmax / psum body (:433-447) over the ranks (:func:`flash_decode_xla`).

The kernels are hand-written CUDA for Hopper in ``csrc/flash_decode.cu``
(the note at its top says what bounds them and what the design does
about it):

* ``tiled`` replaces ``_tiled_decode_kernel`` (:280) with its merge
  (``_exchange_and_merge`` :218): one launch of the split-KV partial
  kernel whose last block of each (row, KV head) merges that row's
  splits in a fixed order (:func:`flash_decode_tiled`); the partial
  alone (:func:`flash_decode_partial`) and the merge as a launch of its
  own (:func:`flash_decode_combine`) stay as entries for checks, and the
  fused launch equals their composition bit for bit;
* ``single`` replaces ``_decode_kernel`` (:262): one pass over the whole
  cache, picked by :meth:`FlashDecodeContext.resolve_variant` exactly
  where the JAX package picks "einsum";
* at world W, ``world_single`` and ``world_tiled`` replace the same two
  kernels with their cross-rank ``_exchange_and_merge`` (:218): one
  cooperative launch of ``tdt_flash_decode_world`` per call, each rank's
  partials pushed into every peer's combine buffer and merged there in
  rank order (:func:`flash_decode_world`).

Each wrapper on a CUDA tensor launches its kernel or raises; only a
tensor that lies on the CPU takes the plain version. ``launches`` counts
each kernel's launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import LaunchCount, num_sms
from triton_dist_tpu_torch.runtime.dist import RankGroup
from triton_dist_tpu_torch.runtime.symm_mem import RingState

_NEG = -1e30
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
#: Kernel limits (csrc/flash_decode.cu kMaxG, kMaxD).
MAX_GROUPS = 8
MAX_HEAD_DIM = 256

#: Launches of each kernel: ``partial`` (the split-KV kernel, with its
#: merge tail in :func:`flash_decode_tiled` or without it in
#: :func:`flash_decode_partial`) and ``single`` keyed by
#: ("paged" | "dense", B, T), ``combine`` by (B, splits); the world-W
#: kernel under its variant, ``world_single`` or ``world_tiled``, keyed by
#: ("paged" | "dense", W, B, t_loc).
launches = {"partial": LaunchCount(), "combine": LaunchCount(),
            "single": LaunchCount(), "world_single": LaunchCount(),
            "world_tiled": LaunchCount()}


@dataclasses.dataclass
class FlashDecodeContext:
    """The JAX context's variant rules.

    ``variant``: "tiled" (the split-KV kernel with its merge), "einsum" (the
    single-pass kernel) or "auto", which takes "einsum" for shards of at
    most ``einsum_max_bytes`` (each rank's ``t_loc * Hkv * D * itemsize *
    B`` bytes, JAX :430-431) and "tiled" above.

    ``paged_variant``: "direct" (the default here) reads pages through
    the block table inside the kernel; "gathered" first copies the pool
    into a contiguous (B, T, Hkv, D) view and decodes that. The JAX
    package defaults to "gathered" only because its direct kernel hit a
    TPU compiler hang (``flash_decode.py:87-99``); the port reads no
    environment variable for it.

    ``group``: the ranks of the sequence axis (``None``: world 1). At
    world W the context keeps the world-W kernel's combine buffers,
    signals and call counter (``state``) across calls, as JAX's
    ``pallas_call`` owns its semaphores; at world 1 the fused tiled
    launch's arrival tickets (``tickets``)."""
    variant: str = "auto"
    einsum_max_bytes: int = 4 * 1024 * 1024
    paged_variant: str = "direct"
    group: RankGroup | None = None
    state: RingState | None = dataclasses.field(default=None, init=False,
                                                repr=False)
    tickets: torch.Tensor | None = dataclasses.field(default=None,
                                                     init=False, repr=False)

    def __post_init__(self):
        if self.variant not in ("tiled", "einsum", "auto"):
            raise ValueError(f"variant {self.variant!r} must be 'tiled', "
                             f"'einsum' or 'auto'")
        if self.paged_variant not in ("direct", "gathered"):
            raise ValueError(f"paged_variant {self.paged_variant!r} must be "
                             f"'direct' or 'gathered'")
        if self.group is not None:
            self.state = RingState(self.group)

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else self.group.world

    def resolve_variant(self, shard_bytes: int) -> str:
        if self.variant != "auto":
            return self.variant
        return "einsum" if shard_bytes <= self.einsum_max_bytes else "tiled"

    def ticket_words(self, n: int, device) -> torch.Tensor:
        """The fused tiled launch's arrival tickets: at least ``n``
        zeroed int32 on ``device``, kept across this context's calls (a
        call's last block of each row sets its ticket back to 0, so calls
        in stream order share them)."""
        t = self.tickets
        if t is None or t.numel() < n or t.device != torch.device(device):
            t = self.tickets = torch.zeros(n, dtype=torch.int32,
                                           device=device)
        return t


def create_flash_decode_context(group: RankGroup | None = None,
                                variant: str = "auto",
                                paged_variant: str = "direct"
                                ) -> FlashDecodeContext:
    """The context over ``group`` (JAX ``create_flash_decode_context``
    over a mesh axis; ``None``: world 1)."""
    return FlashDecodeContext(variant=variant, paged_variant=paged_variant,
                              group=group)


def combine_peer(me: int, p: int, world: int) -> int:
    """Peer that rank ``me``'s combine push ``p`` (1..world-1) targets
    (JAX ``combine_peer`` :203)."""
    return (me + p) % world


def combine_src(me: int, p: int, world: int) -> int:
    """Source rank ``me`` waits on at combine position ``p`` (1..world-1),
    the mirror of :func:`combine_peer` (JAX ``combine_src`` :212)."""
    return (me - p + world) % world


# -- plain versions ---------------------------------------------------------
def _lens(kv_len, b: int, device) -> torch.Tensor:
    """``kv_len`` (a scalar or (B,)) as a contiguous (B,) int32 tensor.
    A Python int becomes a fill on the device, not a copy from the host:
    a blocking copy in every layer would make the host wait for the card
    each time."""
    if isinstance(kv_len, int):
        return torch.full((b,), kv_len, dtype=torch.int32, device=device)
    lens = torch.as_tensor(kv_len, device=device).to(torch.int32)
    return torch.broadcast_to(lens, (b,)).contiguous()


def _local_partials(q, k, v, first_pos: int, kv_len):
    """Unnormalized softmax partial over k/v (B, T, Hkv, D), whose
    positions are ``first_pos + [0, T)``; positions >= ``kv_len`` are
    dead. Returns a (B, Hkv, G, D), l and m (B, Hkv, G), f32.

    Scores: q and the cache meet in the cache dtype when q has it (else
    in f32) and are summed in f32; upcasting both to f32 first gives the
    same products (a product of two bf16 values is exact in f32). p is
    rounded to that dtype before the PV product, as in JAX."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    dt = k.dtype if q.dtype == k.dtype else torch.float32
    qg = q.reshape(b, hkv, hq // hkv, d).to(dt).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k.to(dt).float()) * (
        d ** -0.5)
    lens = _lens(kv_len, b, q.device)
    pos = first_pos + torch.arange(t, device=q.device)
    live = (pos[None, :] < lens[:, None])[:, None, None, :]
    scores = torch.where(live, scores, torch.full_like(scores, _NEG))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None]) * live
    l = p.sum(dim=-1)
    a = torch.einsum("bkgt,btkd->bkgd", p.to(dt).float(), v.to(dt).float())
    return a, l, m


def flash_decode_reference(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, kv_len) -> torch.Tensor:
    """Plain version: (B, Hq, D) attention of q over the first
    ``kv_len[b]`` positions of each row of the (B, T, Hkv, D) caches, in
    q's dtype (the JAX einsum variant at world = 1)."""
    b, hq, d = q.shape
    a, l, _ = _local_partials(q, cache_k, cache_v, 0, kv_len)
    out = a / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def _merge(a, l, m):
    """JAX's ``_merge`` (:194): the log-sum-exp merge of partials stacked
    on the leading (rank) axis, in that axis's order."""
    m_star = m.amax(dim=0, keepdim=True)
    scale = torch.exp(m - m_star)
    num = (a * scale[..., None]).sum(dim=0)
    den = (l * scale).sum(dim=0)
    return num / torch.clamp(den, min=1e-20)[..., None]


def _rank_partials(q, k, v, kv_len, world: int):
    """Each rank's ``_local_partials`` over its t_loc = T / W positions
    of the (B, T, Hkv, D) caches (``first_pos = r * t_loc``)."""
    t_loc = k.shape[1] // world
    return [_local_partials(q, k[:, r * t_loc:(r + 1) * t_loc],
                            v[:, r * t_loc:(r + 1) * t_loc], r * t_loc,
                            kv_len)
            for r in range(world)]


def flash_decode_world_reference(q: torch.Tensor, cache_k: torch.Tensor,
                                 cache_v: torch.Tensor, kv_len,
                                 world: int) -> torch.Tensor:
    """Plain version of the world-W decode: each rank's partial over its
    positions, merged in rank order (JAX ``_exchange_and_merge`` after
    ``_local_partials``). (B, Hq, D) in q's dtype; world 1 is
    :func:`flash_decode_reference`."""
    if world == 1:
        return flash_decode_reference(q, cache_k, cache_v, kv_len)
    parts = _rank_partials(q, cache_k, cache_v, kv_len, world)
    out = _merge(*(torch.stack([p[i] for p in parts]) for i in range(3)))
    return out.reshape(q.shape).to(q.dtype)


def flash_decode_xla(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, kv_len,
                     group: RankGroup | None) -> torch.Tensor:
    """JAX's ``impl="xla"`` body (:433-447): each rank's partial, the
    global max by pmax, then the psum of the rescaled numerators and
    denominators (``RankGroup.psum``: rank order, f32)."""
    world = 1 if group is None else group.world
    if world == 1:
        return flash_decode_reference(q, cache_k, cache_v, kv_len)
    parts = _rank_partials(q, cache_k, cache_v, kv_len, world)
    m_star = torch.stack([m for _, _, m in parts]).amax(dim=0)
    sc = [torch.exp(m - m_star) for _, _, m in parts]
    num = group.psum([a * s[..., None] for (a, _, _), s in zip(parts, sc)])
    den = group.psum([l * s for (_, l, _), s in zip(parts, sc)])
    out = num / torch.clamp(den, min=1e-20)[..., None]
    return out.reshape(q.shape).to(q.dtype)


def flash_decode_paged_reference(q, pool_k, pool_v, block_table,
                                 kv_len) -> torch.Tensor:
    """Plain version of the paged decode: the contiguous view rebuilt
    through the (W, B, n_pages) block table, then
    :func:`flash_decode_world_reference` at world W."""
    from triton_dist_tpu_torch.models.kv_cache import PagedKVCacheManager
    view = PagedKVCacheManager.gathered_view
    return flash_decode_world_reference(
        q, view(pool_k, block_table), view(pool_v, block_table), kv_len,
        block_table.shape[0])


def flash_decode_partials_reference(q, cache_k, cache_v, kv_len,
                                    split_len: int, splits: int):
    """Plain version of the partial kernel: ``_local_partials`` over each
    split's positions [s * split_len, (s + 1) * split_len). Returns
    (a (B, Hkv, splits, G, D), l, m (B, Hkv, splits, G)), f32, the
    kernel's workspace layout."""
    parts = [_local_partials(q, cache_k[:, s * split_len:(s + 1) * split_len],
                             cache_v[:, s * split_len:(s + 1) * split_len],
                             s * split_len, kv_len)
             for s in range(splits)]
    return tuple(torch.stack([p[i] for p in parts], dim=2) for i in range(3))


def flash_decode_combine_reference(a, l, m, dtype) -> torch.Tensor:
    """Plain version of the combine kernel: the ``_merge`` log-sum-exp
    over the split axis of the partials, (B, Hq, D) in ``dtype``."""
    m_star = m.amax(dim=2, keepdim=True)
    scale = torch.exp(m - m_star)
    num = (a * scale[..., None]).sum(dim=2)
    den = (l * scale).sum(dim=2)
    out = num / torch.clamp(den, min=1e-20)[..., None]
    b, hkv, g, d = out.shape
    return out.reshape(b, hkv * g, d).to(dtype)


# -- kernels ----------------------------------------------------------------
class Plan(NamedTuple):
    """How the split kernel runs one call, as ``csrc/flash_decode.cu``
    plans it: ``splits`` splits of ``split_len`` positions."""
    splits: int
    split_len: int


@functools.cache
def plan(b: int, hkv: int, t: int, sms: int) -> Plan:
    """The split plan of a decode over B rows, Hkv KV heads and T
    positions on a card with ``sms`` SMs. It depends on the shape only,
    so equal inputs always sum in the same order."""
    lib = _lib()
    splits, split_len = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.tdt_flash_decode_plan(b, hkv, t, sms,
                                          ctypes.byref(splits),
                                          ctypes.byref(split_len)))
    return Plan(splits.value, split_len.value)


def _check_operands(q, k, v, table=None) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash decode needs q (B, Hq, D) and k/v of one "
                         f"4-D shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape[3] != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not group over the "
                         f"cache's {hkv} heads of dim {k.shape[3]}")
    if table is None and k.shape[0] != b:
        raise ValueError(f"{b} queries for a cache of {k.shape[0]} rows")
    if table is not None and (table.dim() != 2 or table.shape[0] != b):
        raise ValueError(f"block table {tuple(table.shape)} for {b} rows")
    if k.dtype != v.dtype:
        raise ValueError(f"k and v dtypes differ: {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash decode operands lie on different devices")


def _check_cuda(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash decode runs on CUDA or the CPU, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash decode kernels take bf16 or f32, not "
                         f"{q.dtype} / {k.dtype}")
    if q.shape[1] // k.shape[2] > MAX_GROUPS or q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"flash decode kernels take at most {MAX_GROUPS} "
                         f"query heads per KV head and head dim "
                         f"{MAX_HEAD_DIM}, got {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash decode kernels need contiguous operands")
    if q.shape[2] * k.element_size() % 16:
        raise ValueError(f"flash decode kernels copy 16-byte pieces of the "
                         f"cache's rows: head dim {q.shape[2]} of "
                         f"{k.dtype} is not a multiple of "
                         f"{16 // k.element_size()}")


def flash_decode_partial(q, k, v, kv_len, split_len: int, splits: int,
                         table=None):
    """The split-KV partial kernel alone: per (row, KV head, split) the
    unnormalized (a, l, m) of :func:`flash_decode_partials_reference`.
    k/v: (B, T, Hkv, D) rows, or with ``table`` (B, n_pages) int32 the
    (P, page, Hkv, D) pool, T = n_pages * page."""
    if q.device.type == "cpu":
        _check_split(q, k, v, split_len, splits, table)
        if table is not None:
            from triton_dist_tpu_torch.models.kv_cache import (
                PagedKVCacheManager)
            k = PagedKVCacheManager.gathered_view(k, table[None])
            v = PagedKVCacheManager.gathered_view(v, table[None])
        return flash_decode_partials_reference(q, k, v, kv_len, split_len,
                                               splits)
    return _launch_split(q, k, v, kv_len, split_len, splits, table)


def _check_split(q, k, v, split_len: int, splits: int, table) -> int:
    """The positions T of a split call's cache, its operands checked and
    its splits checked to cover T."""
    _check_operands(q, k, v, table)
    t = table.shape[1] * k.shape[1] if table is not None else k.shape[1]
    if splits <= 0 or split_len <= 0 or not (
            (splits - 1) * split_len < t <= splits * split_len):
        raise ValueError(f"{splits} splits of {split_len} do not cover "
                         f"{t} positions")
    return t


def _launch_split(q, k, v, kv_len, split_len: int, splits: int, table,
                  tickets=None, fault: int = -1):
    """One launch of the split-KV kernel on CUDA tensors, counted in
    ``launches["partial"]``: the partials (a, l, m) in a new workspace,
    and with ``tickets`` (B * Hkv zeroed int32) the merge of each row's
    splits, but split ``fault``, into a new (B, Hq, D) output, returned
    instead."""
    t = _check_split(q, k, v, split_len, splits, table)
    _check_cuda(q, k, v)
    lib = _lib()
    b, hq, d = q.shape
    hkv = k.shape[2]
    paged = table is not None
    lens = _lens(kv_len, b, q.device)
    g = hq // hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    ws_a = torch.empty((b, hkv, splits, g, d), **f32)
    ws_l = torch.empty((b, hkv, splits, g), **f32)
    ws_m = torch.empty((b, hkv, splits, g), **f32)
    out = torch.empty_like(q) if tickets is not None else None
    if paged:
        table = table.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _check(lib, lib.tdt_flash_decode_partial(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        table.data_ptr() if paged else None, ws_a.data_ptr(),
        ws_l.data_ptr(), ws_m.data_ptr(),
        out.data_ptr() if out is not None else None,
        tickets.data_ptr() if tickets is not None else None, b, hq, hkv, d,
        t, k.shape[1] if paged else t, k.shape[0] if paged else b,
        split_len, splits, d ** -0.5, _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k.dtype], fault, stream))
    launches["partial"].add(("paged" if paged else "dense", b, t))
    return (ws_a, ws_l, ws_m) if out is None else out


def flash_decode_combine(a, l, m, dtype) -> torch.Tensor:
    """The combine kernel: the fixed-order log-sum-exp merge of the
    partial kernel's (a, l, m) into (B, Hq, D) of ``dtype``."""
    if a.dim() != 5 or l.shape != a.shape[:4] or m.shape != l.shape:
        raise ValueError(f"partials of shapes {tuple(a.shape)}, "
                         f"{tuple(l.shape)}, {tuple(m.shape)}")
    if a.device.type == "cpu":
        return flash_decode_combine_reference(a, l, m, dtype)
    if dtype not in _DTYPE_CODES or any(
            x.dtype != torch.float32 or not x.is_contiguous()
            for x in (a, l, m)):
        raise ValueError("the combine kernel takes contiguous f32 partials "
                         "and writes bf16 or f32")
    lib = _lib()
    b, hkv, splits, g, d = a.shape
    out = torch.empty((b, hkv * g, d), dtype=dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _check(lib, lib.tdt_flash_decode_combine(
        a.data_ptr(), l.data_ptr(), m.data_ptr(), out.data_ptr(), b,
        hkv * g, hkv, d, splits, _DTYPE_CODES[dtype], stream))
    launches["combine"].add((b, splits))
    return out


def flash_decode_single(q, cache_k, cache_v, kv_len) -> torch.Tensor:
    """The single-pass kernel: (B, Hq, D) attention over the whole
    (B, T, Hkv, D) caches in one launch (the plain version is
    :func:`flash_decode_reference`)."""
    _check_operands(q, cache_k, cache_v)
    if q.device.type == "cpu":
        return flash_decode_reference(q, cache_k, cache_v, kv_len)
    _check_cuda(q, cache_k, cache_v)
    lib = _lib()
    b, hq, d = q.shape
    t, hkv = cache_k.shape[1], cache_k.shape[2]
    lens = _lens(kv_len, b, q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _check(lib, lib.tdt_flash_decode_single(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        lens.data_ptr(), out.data_ptr(), b, hq, hkv, d, t, d ** -0.5,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[cache_k.dtype], stream))
    launches["single"].add(("dense", b, t))
    return out


def flash_decode_tiled(q, k, v, kv_len, split_len: int, splits: int,
                       table=None, fault: int | None = None,
                       ctx: FlashDecodeContext | None = None
                       ) -> torch.Tensor:
    """The world-1 tiled decode in one launch, counted in
    ``launches["partial"]``: the split-KV partial kernel, whose last block
    of each (row, KV head) merges the row's splits in the order 0, 1, ...
    into (B, Hq, D) of q's dtype; bit-equal to
    ``flash_decode_combine(*flash_decode_partial(...), q.dtype)``. k/v and
    ``table`` as in :func:`flash_decode_partial`. ``fault`` plants the test
    fault: the merge leaves that split out (on the CPU too). ``ctx`` keeps
    the arrival tickets across calls (``None``: fresh ones)."""
    if fault is not None and not 0 <= fault < splits:
        raise ValueError(f"fault split {fault} of {splits}")
    if q.device.type == "cpu":
        a, l, m = flash_decode_partial(q, k, v, kv_len, split_len, splits,
                                       table)
        if fault is not None:
            a, l, m = a.clone(), l.clone(), m.clone()
            a[:, :, fault], l[:, :, fault], m[:, :, fault] = 0.0, 0.0, _NEG
        return flash_decode_combine_reference(a, l, m, q.dtype)
    tickets = (ctx or FlashDecodeContext()).ticket_words(
        q.shape[0] * k.shape[2], q.device)
    return _launch_split(q, k, v, kv_len, split_len, splits, table, tickets,
                         -1 if fault is None else fault)


def _tiled(q, k, v, kv_len, ctx: FlashDecodeContext,
           table=None) -> torch.Tensor:
    """The fused tiled call over the plan's splits (dense rows, or the
    pool through ``table``)."""
    _lib()                             # build (or fail) before the plan
    b = q.shape[0]
    t = table.shape[1] * k.shape[1] if table is not None else k.shape[1]
    p = plan(b, k.shape[2], t, num_sms(q.device.index))
    return flash_decode_tiled(q, k, v, kv_len, p.split_len, p.splits, table,
                              ctx=ctx)


@functools.cache
def world_grid(q_dtype: torch.dtype, kv_dtype: torch.dtype, d: int) -> int:
    """Blocks the world-W kernel keeps resident on the card at head dim
    ``d`` (its shared memory depends on the types and ``d``): the most its
    cooperative launch takes, and the barrier words it needs."""
    lib = _lib()
    out = ctypes.c_int()
    _check(lib, lib.tdt_flash_decode_world_grid(
        _DTYPE_CODES[q_dtype], _DTYPE_CODES[kv_dtype], d, ctypes.byref(out)))
    return out.value


def flash_decode_world(q, k, v, kv_len, ctx: FlashDecodeContext,
                       variant: str, table=None,
                       fault: bool = False) -> torch.Tensor:
    """One launch of the world-W kernel over every rank of ``ctx.group``,
    counted in ``launches["world_" + variant]``. k/v: the dense
    (B, W t_loc, Hkv, D) caches, or with ``table`` (W, B, n_pages) int32
    the (W P, page, Hkv, D) pool. ``variant``: "single" (one pass over
    each rank's positions, ``_decode_kernel``) or "tiled" (the plan's
    splits, ``_tiled_decode_kernel``). Returns every rank's output as one
    (W, B, Hq, D) tensor; rank 0's is the replicated result. ``fault``
    plants the test fault (rank 0's first push of row 0, KV head 0
    skipped, its signal still set): a fresh context's NaN-filled combine
    buffer then shows it."""
    world = ctx.world_size
    paged = table is not None
    _check_operands(q, k, v, table[0] if paged else None)
    _check_cuda(q, k, v)
    lib = _lib()
    if world < 2 or variant not in ("single", "tiled"):
        raise ValueError(f"the world-W kernel takes world >= 2 and variant "
                         f"'single' or 'tiled', got {world}, {variant!r}")
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if paged:
        if table.dim() != 3 or table.shape[0] != world or k.shape[0] % world:
            raise ValueError(f"block table {tuple(table.shape)} and pool "
                             f"{tuple(k.shape)} do not split over {world} "
                             f"ranks")
        t_loc = table.shape[2] * k.shape[1]
        table = table.to(torch.int32).contiguous()
    else:
        if k.shape[1] % world:
            raise ValueError(f"{k.shape[1]} positions do not split over "
                             f"{world} ranks")
        t_loc = k.shape[1] // world
    if variant == "single":
        splits, split_len = 1, -(-t_loc // 64) * 64
    else:
        splits, split_len = plan(world * b, hkv, t_loc,
                                 num_sms(q.device.index))
    lens = _lens(kv_len, b, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    if splits > 1:
        ws_a = torch.empty((world, b, hkv, splits, g, d), **f32)
        ws_l = torch.empty((world, b, hkv, splits, g), **f32)
        ws_m = torch.empty_like(ws_l)
        ws = [ws_a.data_ptr(), ws_l.data_ptr(), ws_m.data_ptr()]
    else:
        ws = [None, None, None]
    state = ctx.state
    comb_tab = state.table(state.workspace(world * b * hkv * g * (d + 2),
                                           torch.float32))
    sig_tab = state.table(state.signals("fd", world * b * hkv))
    flags = state.signals("barrier", world_grid(q.dtype, k.dtype, d))
    out = torch.empty((world, b, hq, d), dtype=q.dtype, device=q.device)
    epoch = state.next_epoch()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _check(lib, lib.tdt_flash_decode_world(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        table.data_ptr() if paged else None, out.data_ptr(), *ws,
        comb_tab.data_ptr(), sig_tab.data_ptr(), flags.data_ptr(), world, b,
        hq, hkv, d, t_loc, k.shape[1] if paged else t_loc,
        k.shape[0] // world if paged else b, split_len, splits, d ** -0.5,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], epoch, int(fault),
        stream))
    launches["world_" + variant].add(("paged" if paged else "dense", world,
                                      b, t_loc))
    return out


# -- entry points -----------------------------------------------------------
def _check_impl(impl: str) -> None:
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown flash decode impl {impl!r}")


def gqa_fwd_batch_decode(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, kv_len,
                         ctx: FlashDecodeContext | None = None,
                         impl: str = "pallas") -> torch.Tensor:
    """Decode-time GQA over dense caches (JAX ``gqa_fwd_batch_decode``).

    q: (B, Hq, D), replicated over the ranks; cache_k/cache_v:
    (B, T, Hkv, D), T split over ``ctx``'s W ranks; kv_len: live
    positions, a scalar or (B,). Returns (B, Hq, D) in q's dtype.

    ``impl="xla"``: JAX's pmax / psum body in plain torch on any device.
    ``impl="pallas"`` on CUDA tensors: at world 1 the single-pass kernel
    where ``ctx.resolve_variant`` says "einsum" (a shard of at most 4
    MiB), else partial + combine; at world W the world-W kernel in that
    variant. CPU tensors run the plain version
    (:func:`flash_decode_world_reference`)."""
    ctx = ctx or FlashDecodeContext()
    _check_impl(impl)
    _check_operands(q, cache_k, cache_v)
    world = ctx.world_size
    b, t, hkv, d = cache_k.shape
    if t % world:
        raise ValueError(f"{t} cache positions do not split over {world} "
                         f"ranks")
    if impl == "xla":
        return flash_decode_xla(q, cache_k, cache_v, kv_len, ctx.group)
    if q.device.type == "cpu":
        return flash_decode_world_reference(q, cache_k, cache_v, kv_len,
                                            world)
    variant = ctx.resolve_variant(
        t // world * hkv * d * cache_k.element_size() * b)
    if world > 1:
        return flash_decode_world(q, cache_k, cache_v, kv_len, ctx,
                                  "single" if variant == "einsum"
                                  else "tiled")[0]
    if variant == "einsum":
        return flash_decode_single(q, cache_k, cache_v, kv_len)
    return _tiled(q, cache_k, cache_v, kv_len, ctx)


def gqa_fwd_batch_decode_paged(q: torch.Tensor, pool_k: torch.Tensor,
                               pool_v: torch.Tensor,
                               block_table: torch.Tensor, kv_len,
                               ctx: FlashDecodeContext | None = None,
                               impl: str = "pallas") -> torch.Tensor:
    """Paged-KV decode (JAX ``gqa_fwd_batch_decode_paged``).

    pool_k/pool_v: (W P, page, Hkv, D) physical pages, rank r's its rows
    [r P, (r + 1) P); block_table: (W, B, n_pages) int32, page i of row b
    on rank r at its local slot ``block_table[r, b, i]``, rank r backing
    positions [r t_loc, (r + 1) t_loc), t_loc = n_pages * page; kv_len: a
    scalar or (B,). Returns (B, Hq, D). ``impl="xla"`` and
    ``paged_variant="gathered"`` decode the gathered contiguous view (as
    JAX); CUDA tensors otherwise run partial + combine (world 1) or the
    world-W kernel reading pages through the table (``"direct"``); CPU
    tensors run :func:`flash_decode_paged_reference`."""
    ctx = ctx or FlashDecodeContext()
    _check_impl(impl)
    world = ctx.world_size
    if block_table.dim() != 3 or block_table.shape[0] != world:
        raise ValueError(f"block table {tuple(block_table.shape)} is not "
                         f"({world}, B, n_pages)")
    _check_operands(q, pool_k, pool_v, block_table[0])
    if impl == "xla" or ctx.paged_variant == "gathered":
        from triton_dist_tpu_torch.models.kv_cache import PagedKVCacheManager
        view = PagedKVCacheManager.gathered_view
        return gqa_fwd_batch_decode(q, view(pool_k, block_table),
                                    view(pool_v, block_table), kv_len, ctx,
                                    impl)
    if q.device.type == "cpu":
        return flash_decode_paged_reference(q, pool_k, pool_v, block_table,
                                            kv_len)
    if world > 1:
        return flash_decode_world(q, pool_k, pool_v, kv_len, ctx, "tiled",
                                  block_table)[0]
    return _tiled(q, pool_k, pool_v, kv_len, ctx, block_table[0])


# -- the library ------------------------------------------------------------
def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.tdt_flash_decode_error_string(err).decode()
        raise RuntimeError(f"flash_decode kernel call failed: {msg} ({err})")


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    if lib.tdt_flash_decode_partial.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ip = ctypes.POINTER(i)
        lib.tdt_flash_decode_plan.argtypes = [i, i, i, i, ip, ip]
        lib.tdt_flash_decode_plan.restype = i
        lib.tdt_flash_decode_partial.argtypes = (
            [p] * 10 + [i] * 9 + [f, i, i, i, p])
        lib.tdt_flash_decode_partial.restype = i
        lib.tdt_flash_decode_combine.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.tdt_flash_decode_combine.restype = i
        lib.tdt_flash_decode_single.argtypes = (
            [p] * 5 + [i] * 5 + [f, i, i, p])
        lib.tdt_flash_decode_single.restype = i
        lib.tdt_flash_decode_world_grid.argtypes = [i, i, i, ip]
        lib.tdt_flash_decode_world_grid.restype = i
        lib.tdt_flash_decode_world.argtypes = (
            [p] * 12 + [i] * 10 + [f, i, i, ctypes.c_ulonglong, i, p])
        lib.tdt_flash_decode_world.restype = i
        lib.tdt_flash_decode_error_string.argtypes = [i]
        lib.tdt_flash_decode_error_string.restype = ctypes.c_char_p
    return lib
