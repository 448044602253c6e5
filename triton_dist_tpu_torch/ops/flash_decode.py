"""GQA flash decode at world = 1 (the port of
``triton_dist_tpu.ops.flash_decode``).

One query position per sequence attends to its KV cache: dense rows
(:func:`gqa_fwd_batch_decode`) or a paged pool read through a block
table (:func:`gqa_fwd_batch_decode_paged`). At world = 1 the JAX
package's cross-rank combine merges nothing but one partial, so the
function is the softmax attention of ``_local_partials`` (:149) and
``_merge`` (:194), kept here as the plain versions
:func:`flash_decode_reference` / :func:`flash_decode_paged_reference`.

The kernels are hand-written CUDA for Hopper in ``csrc/flash_decode.cu``
(the note at its top says what bounds them and what the design does
about it):

* ``partial`` + ``combine`` replace ``_tiled_decode_kernel`` (:280): a
  split-KV partial per (row, KV head, split), then the fixed-order
  log-sum-exp merge of the splits (``_exchange_and_merge`` :218);
* ``single`` replaces ``_decode_kernel`` (:262): one pass over the whole
  cache, picked by :meth:`FlashDecodeContext.resolve_variant` exactly
  where the JAX package picks "einsum".

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

_NEG = -1e30
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
#: Kernel limits (csrc/flash_decode.cu kMaxG, kMaxD).
MAX_GROUPS = 8
MAX_HEAD_DIM = 256

#: Launches of each kernel: ``partial`` and ``single`` keyed by
#: ("paged" | "dense", B, T), ``combine`` by (B, splits).
launches = {"partial": LaunchCount(), "combine": LaunchCount(),
            "single": LaunchCount()}


@dataclasses.dataclass
class FlashDecodeContext:
    """The JAX context's variant rules at world = 1.

    ``variant``: "tiled" (split-KV partial + combine), "einsum" (the
    single-pass kernel) or "auto", which takes "einsum" for caches of at
    most ``einsum_max_bytes`` (all rows, one device) and "tiled" above.

    ``paged_variant``: "direct" (the default here) reads pages through
    the block table inside the kernel; "gathered" first copies the pool
    into a contiguous (B, T, Hkv, D) view and decodes that. The JAX
    package defaults to "gathered" only because its direct kernel hit a
    TPU compiler hang (``flash_decode.py:87-99``); the port reads no
    environment variable for it."""
    variant: str = "auto"
    einsum_max_bytes: int = 4 * 1024 * 1024
    paged_variant: str = "direct"

    def __post_init__(self):
        if self.variant not in ("tiled", "einsum", "auto"):
            raise ValueError(f"variant {self.variant!r} must be 'tiled', "
                             f"'einsum' or 'auto'")
        if self.paged_variant not in ("direct", "gathered"):
            raise ValueError(f"paged_variant {self.paged_variant!r} must be "
                             f"'direct' or 'gathered'")

    def resolve_variant(self, shard_bytes: int) -> str:
        if self.variant != "auto":
            return self.variant
        return "einsum" if shard_bytes <= self.einsum_max_bytes else "tiled"


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


def flash_decode_paged_reference(q, pool_k, pool_v, block_table,
                                 kv_len) -> torch.Tensor:
    """Plain version of the paged decode: the contiguous view rebuilt
    through the (1, B, n_pages) block table, then
    :func:`flash_decode_reference`."""
    from triton_dist_tpu_torch.models.kv_cache import PagedKVCacheManager
    view = PagedKVCacheManager.gathered_view
    return flash_decode_reference(q, view(pool_k, block_table),
                                  view(pool_v, block_table), kv_len)


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


def flash_decode_partial(q, k, v, kv_len, split_len: int, splits: int,
                         table=None):
    """The split-KV partial kernel: per (row, KV head, split) the
    unnormalized (a, l, m) of :func:`flash_decode_partials_reference`.
    k/v: (B, T, Hkv, D) rows, or with ``table`` (B, n_pages) int32 the
    (P, page, Hkv, D) pool, T = n_pages * page."""
    _check_operands(q, k, v, table)
    b, hq, d = q.shape
    hkv = k.shape[2]
    paged = table is not None
    t = table.shape[1] * k.shape[1] if paged else k.shape[1]
    if splits <= 0 or split_len <= 0 or not (
            (splits - 1) * split_len < t <= splits * split_len):
        raise ValueError(f"{splits} splits of {split_len} do not cover "
                         f"{t} positions")
    if q.device.type == "cpu":
        if paged:
            from triton_dist_tpu_torch.models.kv_cache import (
                PagedKVCacheManager)
            k = PagedKVCacheManager.gathered_view(k, table[None])
            v = PagedKVCacheManager.gathered_view(v, table[None])
        return flash_decode_partials_reference(q, k, v, kv_len, split_len,
                                               splits)
    _check_cuda(q, k, v)
    lib = _lib()
    lens = _lens(kv_len, b, q.device)
    g = hq // hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    ws_a = torch.empty((b, hkv, splits, g, d), **f32)
    ws_l = torch.empty((b, hkv, splits, g), **f32)
    ws_m = torch.empty((b, hkv, splits, g), **f32)
    if paged:
        table = table.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _check(lib, lib.tdt_flash_decode_partial(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        table.data_ptr() if paged else None, ws_a.data_ptr(),
        ws_l.data_ptr(), ws_m.data_ptr(), b, hq, hkv, d, t,
        k.shape[1] if paged else t, k.shape[0] if paged else b, split_len,
        splits, d ** -0.5, _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
        stream))
    launches["partial"].add(("paged" if paged else "dense", b, t))
    return ws_a, ws_l, ws_m


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


def _tiled(q, k, v, kv_len, table=None) -> torch.Tensor:
    """Partial + combine over the plan's splits (dense rows, or the pool
    through ``table``)."""
    _lib()                             # build (or fail) before the plan
    b = q.shape[0]
    t = table.shape[1] * k.shape[1] if table is not None else k.shape[1]
    p = plan(b, k.shape[2], t, num_sms(q.device.index))
    a, l, m = flash_decode_partial(q, k, v, kv_len, p.split_len, p.splits,
                                   table)
    return flash_decode_combine(a, l, m, q.dtype)


# -- entry points -----------------------------------------------------------
def gqa_fwd_batch_decode(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, kv_len,
                         ctx: FlashDecodeContext | None = None
                         ) -> torch.Tensor:
    """Decode-time GQA over dense caches (JAX ``gqa_fwd_batch_decode``).

    q: (B, Hq, D); cache_k/cache_v: (B, T, Hkv, D); kv_len: live
    positions, a scalar or (B,). Returns (B, Hq, D) in q's dtype. CUDA
    tensors run the single-pass kernel where ``ctx.resolve_variant``
    says "einsum" (cache of at most 4 MiB), else partial + combine; CPU
    tensors run :func:`flash_decode_reference`."""
    ctx = ctx or FlashDecodeContext()
    _check_operands(q, cache_k, cache_v)
    if q.device.type == "cpu":
        return flash_decode_reference(q, cache_k, cache_v, kv_len)
    b, t, hkv, d = cache_k.shape
    variant = ctx.resolve_variant(t * hkv * d * cache_k.element_size() * b)
    if variant == "einsum":
        return flash_decode_single(q, cache_k, cache_v, kv_len)
    return _tiled(q, cache_k, cache_v, kv_len)


def gqa_fwd_batch_decode_paged(q: torch.Tensor, pool_k: torch.Tensor,
                               pool_v: torch.Tensor,
                               block_table: torch.Tensor, kv_len,
                               ctx: FlashDecodeContext | None = None
                               ) -> torch.Tensor:
    """Paged-KV decode (JAX ``gqa_fwd_batch_decode_paged`` at w = 1).

    pool_k/pool_v: (P, page, Hkv, D) physical pages; block_table:
    (1, B, n_pages) int32, page i of row b at pool slot
    ``block_table[0, b, i]``; kv_len: a scalar or (B,). Returns
    (B, Hq, D). CUDA tensors run partial + combine reading pages through
    the table (``paged_variant="direct"``), or decode the gathered
    contiguous view (``"gathered"``); CPU tensors run
    :func:`flash_decode_paged_reference`."""
    ctx = ctx or FlashDecodeContext()
    if block_table.dim() != 3 or block_table.shape[0] != 1:
        raise ValueError(f"block table {tuple(block_table.shape)} is not "
                         f"(1, B, n_pages)")
    _check_operands(q, pool_k, pool_v, block_table[0])
    if q.device.type == "cpu":
        return flash_decode_paged_reference(q, pool_k, pool_v, block_table,
                                            kv_len)
    if ctx.paged_variant == "gathered":
        from triton_dist_tpu_torch.models.kv_cache import PagedKVCacheManager
        view = PagedKVCacheManager.gathered_view
        return gqa_fwd_batch_decode(q, view(pool_k, block_table),
                                    view(pool_v, block_table), kv_len, ctx)
    return _tiled(q, pool_k, pool_v, kv_len, block_table[0])


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
            [p] * 8 + [i] * 9 + [f, i, i, p])
        lib.tdt_flash_decode_partial.restype = i
        lib.tdt_flash_decode_combine.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.tdt_flash_decode_combine.restype = i
        lib.tdt_flash_decode_single.argtypes = (
            [p] * 5 + [i] * 5 + [f, i, i, p])
        lib.tdt_flash_decode_single.restype = i
        lib.tdt_flash_decode_error_string.argtypes = [i]
        lib.tdt_flash_decode_error_string.restype = ctypes.c_char_p
    return lib
