"""AllGather-GEMM and the fused AG-SwiGLU.

The port of ``triton_dist_tpu.ops.allgather_gemm``: ``ag_gemm_multi``
(:643), ``ag_gemm`` (:854) and ``ag_swiglu`` (:1088). With one ring
member the all-gather is the identity, and the Pallas kernels
``_ag_gemm_hbm_nb_kernel`` (:265) and ``_ag_swiglu_hbm_kernel`` (:954)
reduce to ``C_i = a @ b_i`` with f32 accumulation and one rounding, and
to ``silu(a @ w_gate + b_gate) * (a @ w_up + b_up)`` in f32 with one
rounding. The kernels are hand-written CUDA for Hopper in
``csrc/ag_gemm.cu``; the note at its top says what bounds them and what
their design does about that.

Weights keep the JAX (in, out) layout and are passed one by one: the
kernel writes each product to its own output, so nothing concatenates
QKV or gate|up per call. ``ag_swiglu`` keeps JAX's rule for when the
fused kernel runs (:func:`swiglu_fuses`), because it decides where bf16
rounds: otherwise it composes ``ag_gemm_multi`` with a plain SwiGLU, as
JAX does (:1193-1205). The VMEM-driven variant choice of
``ag_gemm_multi`` does not change the result at world = 1 and is not
copied.

At world W > 1 (a ``runtime.dist.RankGroup`` of W ranks on one card)
``impl="pallas"`` runs the ring: ``csrc/ag_gemm_ring.cu``, one
cooperative launch over every rank, the counterpart of the ring halves
of ``_ag_gemm_kernel`` (:211), ``_ag_gemm_hbm_nb_kernel`` (:265),
``_ag_gemm_hbm_kernel`` (:379) and ``_ag_swiglu_hbm_kernel`` (:954).
Each output row block is one chunk's full-K product, so the ring's order
does not change the numbers: the plain ring versions
(:func:`ag_gemm_multi_ring_reference`, :func:`ag_swiglu_ring_reference`)
take the chunks in ``ring_chunk_schedule`` order and equal the gathered
product. At decode shapes (:func:`ring_path` "stream") the kernel
gathers every chunk first and streams each rank's column shard of B
once, with the world-1 kernel's decode plan on that shard.

On a CUDA tensor each entry point launches its kernel or raises; only
tensors that lie on the CPU take the plain versions
:func:`ag_gemm_multi_reference` and :func:`ag_swiglu_reference` (and the
ring versions at world W).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import (
    LaunchCount, aligned16, check_ring_dirs, num_sms, ring_chunk_schedule)
from triton_dist_tpu_torch.runtime.dist import RankGroup
from triton_dist_tpu_torch.runtime.symm_mem import RingState

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_OP_GEMM, _OP_SWIGLU = 0, 1
#: The kernel's plans, by the path code of ``tdt_ag_gemm_plan``: the f32 /
#: odd-shape FMA kernel, the B-streaming decode kernel (M <= 64), the
#: tiled tensor-core prefill kernel.
PATHS = ("fma", "decode", "prefill")
#: Products one ``ag_gemm_multi`` launch takes.
MAX_PRODUCTS = 3
#: Largest M of the world-1 decode plan (``csrc/ag_gemm.cu``), and of the
#: B-streaming bodies of ``gemm_rs`` and of both ring kernels.
DECODE_MAX_M = 64

#: JAX's soft VMEM budget of the default path
#: (``triton_dist_tpu/ops/common.py`` DEFAULT_VMEM_BUDGET).
DEFAULT_VMEM_BUDGET = 12 * 1024 * 1024

#: Launches of the AG-GEMM kernel, by (plan, K, widths of the products).
ag_gemm_launches = LaunchCount()
#: Launches of the fused AG-SwiGLU kernel, by (plan, K, (width,)).
ag_swiglu_launches = LaunchCount()
#: Launches of the ring kernel by ``ag_gemm_multi`` at world W > 1, by
#: (body, world, M, K, shard widths); body :func:`ring_path`'s, "stream"
#: (the decode body), "mma" (tensor-core tiles) or "fma".
ag_ring_launches = LaunchCount()
#: Launches of the ring kernel's fused SwiGLU by ``ag_swiglu`` at world
#: W > 1, keyed as :data:`ag_ring_launches`.
ag_swiglu_ring_launches = LaunchCount()
#: Bytes of one piece of a travelling chunk: the grain of the ring's
#: copies and signals.
PIECE_BYTES = 32 * 1024


# -- JAX's fusion rule ---------------------------------------------------------
def _pick_block_k(k: int, want: int) -> int:
    for cand in (want, 512, 256, 128):
        if cand <= k and k % cand == 0:
            return cand
    return k


def _swiglu_footprint(bm: int, bn: int, k: int, itemsize: int) -> int:
    return itemsize * (2 * bm * k + 4 * k * bn + 2 * bm * bn)


def swiglu_fuses(rows: int, k: int, n_loc: int, itemsize: int) -> bool:
    """Whether JAX's ``ag_swiglu`` runs its fused kernel for an (rows, k)
    activation against (k, n_loc) gate/up weights of ``itemsize`` bytes
    (``allgather_gemm.py:1170-1193`` with the default context: block hints
    256 x 512, the 12 MB budget, no trusted blocks).

    Kept for numerics, not for tiling: the fused kernel rounds once after
    the SwiGLU, the composed path rounds gate and up first, so the rule
    decides where bf16 rounds. The CUDA kernel tiles its own way."""
    if rows <= 0 or n_loc <= 0:
        return False
    choice = None
    for bn in (_pick_block_k(n_loc, 512), 512, 256, 128):
        if bn > n_loc or n_loc % bn:
            continue
        for bm in (_pick_block_k(rows, 256), 256, 128):
            if bm > rows or rows % bm:
                continue
            if _swiglu_footprint(bm, bn, k, itemsize) <= DEFAULT_VMEM_BUDGET:
                choice = (bm, bn)
                break
        if choice:
            break
    return choice is not None and rows % 128 == 0 and n_loc % 128 == 0


# -- plain versions ------------------------------------------------------------
def ag_gemm_multi_reference(a: torch.Tensor, bs) -> list:
    """Plain version: ``[(a.f32 @ b.f32) cast to a.dtype for b in bs]``."""
    af = a.float()
    return [(af @ b.float()).to(a.dtype) for b in bs]


def ag_swiglu_reference(a: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor, b_gate=None,
                        b_up=None) -> torch.Tensor:
    """Plain version of the fused kernel: gate and up in f32 (f32 biases
    added first when given), ``gate * sigmoid(gate) * up`` in f32, one
    rounding to ``a.dtype``."""
    af = a.float()
    gate = af @ w_gate.float()
    up = af @ w_up.float()
    if b_gate is not None:
        gate = gate + b_gate.float()
        up = up + b_up.float()
    return (gate * torch.sigmoid(gate) * up).to(a.dtype)


def _ring_rows(a: torch.Tensor, world: int, dirs: int, outs: list,
               fn) -> list:
    """Every rank's column block of ``outs``, chunk by chunk in
    ``ring_chunk_schedule`` order: ``fn(chunk rows, r)`` gives rank r's
    outputs of those rows."""
    rows = a.shape[0] // world
    for r in range(world):
        for s in range(world):
            c = ring_chunk_schedule(r, s, world, dirs)[0]
            for out, v in zip(outs, fn(a[c * rows:(c + 1) * rows], r)):
                n = out.shape[1] // world
                out[c * rows:(c + 1) * rows, r * n:(r + 1) * n] = v
    return outs


def ag_gemm_multi_ring_reference(a: torch.Tensor, bs, world: int,
                                 dirs: int = 2) -> list:
    """Plain version of the ring kernel: rank r multiplies each chunk of
    a, in its ring order, by its column shard of every b (f32 sum, one
    rounding). Equals :func:`ag_gemm_multi_reference` of the gathered a."""
    outs = [a.new_empty((a.shape[0], b.shape[1])) for b in bs]
    shards = [[b.narrow(1, r * (b.shape[1] // world), b.shape[1] // world)
               for b in bs] for r in range(world)]
    return _ring_rows(a, world, dirs, outs,
                      lambda x, r: ag_gemm_multi_reference(x, shards[r]))


def ag_swiglu_ring_reference(a: torch.Tensor, w_gate: torch.Tensor,
                             w_up: torch.Tensor, b_gate=None, b_up=None,
                             world: int = 1, dirs: int = 2) -> torch.Tensor:
    """Plain version of the ring kernel's fused SwiGLU: rank r's column
    shard of :func:`ag_swiglu_reference`, chunk by chunk in ring order."""
    n = w_gate.shape[1] // world

    def fn(x, r):
        cols = slice(r * n, (r + 1) * n)
        biases = (() if b_gate is None else (b_gate[cols], b_up[cols]))
        return [ag_swiglu_reference(x, w_gate[:, cols], w_up[:, cols],
                                    *biases)]
    out = a.new_empty((a.shape[0], w_gate.shape[1]))
    return _ring_rows(a, world, dirs, [out], fn)[0]


# -- entry points ----------------------------------------------------------------
def ag_gemm_multi(a: torch.Tensor, bs, group=None,
                  impl: str = "pallas", ctx=None) -> list:
    """``[allgather(a) @ b for b in bs]``: each product with f32
    accumulation, cast to ``a.dtype``. a: (M, K); bs: one to three
    (K, N_i) weights in the JAX (in, out) layout. Returns the list of
    (M, N_i) outputs.

    At world 1 CUDA tensors run the hand-written kernel, all products in
    one launch (bf16 or f32, contiguous); CPU tensors run
    :func:`ag_gemm_multi_reference`.

    Over a rank group (``runtime.dist.RankGroup``) of W > 1: a is the
    row-sharded global (M, K), each b column-sharded, the results
    column-sharded. ``impl="xla"`` is JAX's XLA body, plain: every rank
    multiplies the gathered a by its column shard
    (:func:`ag_gemm_multi_reference`). ``impl="pallas"`` is the ring
    all-gather under the products: one launch of ``csrc/ag_gemm_ring.cu``
    on CUDA tensors (:func:`launch_ag_ring`),
    :func:`ag_gemm_multi_ring_reference` on CPU ones. ``ctx``: the
    :class:`AllGatherGEMMContext` whose kernel state the call uses (a
    layer keeps one across calls; default: a new one)."""
    bs = list(bs)
    _check_operands("ag_gemm_multi", a, bs)
    if group is not None and group.world > 1:
        _check_world("ag_gemm_multi", a, bs, group, impl)
        if impl == "xla":
            n = len(bs)
            return list(group.per_rank(
                lambda *ws: tuple(ag_gemm_multi_reference(a, ws)), *bs,
                in_dims=(1,) * n, out_dims=(1,) * n))
        ctx = ctx or AllGatherGEMMContext(group)
        if a.device.type == "cpu":
            return ag_gemm_multi_ring_reference(a, bs, group.world,
                                                ctx.ring_dirs)
        return launch_ag_ring("gemm", a, bs, ctx)
    if a.device.type == "cpu":
        return ag_gemm_multi_reference(a, bs)
    return launch_gemm(a, bs, ag_gemm_launches)


def ag_gemm(a: torch.Tensor, b: torch.Tensor, group=None,
            impl: str = "pallas", ctx=None) -> torch.Tensor:
    """``allgather(a) @ b`` (one product of :func:`ag_gemm_multi`)."""
    return ag_gemm_multi(a, [b], group, impl, ctx)[0]


def ag_swiglu(a: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              b_gate=None, b_up=None, group=None, impl: str = "pallas",
              ctx=None) -> torch.Tensor:
    """``silu(allgather(a) @ w_gate + b_gate) * (allgather(a) @ w_up +
    b_up)``. a: (M, K); w_gate/w_up: (K, N); b_gate/b_up: optional (N,)
    biases, both or neither. Returns (M, N) in ``a.dtype``.

    Where :func:`swiglu_fuses` says JAX fuses (on each rank's rows and
    columns), one kernel computes the whole epilogue in f32 and rounds
    once (CPU tensors: :func:`ag_swiglu_reference`). Elsewhere gate and
    up come from :func:`ag_gemm_multi`, round to ``a.dtype`` (biases
    added in f32, rounded again), and the SwiGLU follows in plain
    PyTorch, as JAX composes it (:1193-1205).

    Over a rank group of W > 1: a row-sharded, the weights, biases and
    result column-sharded. ``impl="xla"`` is JAX's XLA body (the fused
    epilogue's arithmetic per rank, plain); ``impl="pallas"`` fuses
    through the ring kernel (:func:`launch_ag_ring`; CPU tensors:
    :func:`ag_swiglu_ring_reference`) or composes through the ring
    ``ag_gemm_multi``."""
    _check_swiglu_operands(a, w_gate, w_up, b_gate, b_up)
    m, k = a.shape
    n = w_gate.shape[1]
    world = group.world if group is not None else 1
    biases = [] if b_gate is None else [b_gate, b_up]
    if world > 1:
        _check_world("ag_swiglu", a, [w_gate, w_up], group, impl)
        if impl == "xla":
            return group.per_rank(
                lambda *ws: ag_swiglu_reference(a, *ws), w_gate, w_up,
                *biases, in_dims=(1, 1) + (0,) * len(biases), out_dims=1)
    if not swiglu_fuses(m // world, k, n // world, a.element_size()):
        gate, up = ag_gemm_multi(a, [w_gate, w_up], group, impl, ctx)
        if b_gate is not None:
            gate = (gate.float() + b_gate.float()).to(a.dtype)
            up = (up.float() + b_up.float()).to(a.dtype)
        return F.silu(gate.float()).to(a.dtype) * up
    if world > 1:
        ctx = ctx or AllGatherGEMMContext(group)
        if a.device.type == "cpu":
            return ag_swiglu_ring_reference(a, w_gate, w_up, b_gate, b_up,
                                            world, ctx.ring_dirs)
        return launch_ag_ring("swiglu", a, [w_gate, w_up], ctx, biases)[0]
    if a.device.type == "cpu":
        return ag_swiglu_reference(a, w_gate, w_up, b_gate, b_up)
    return launch_swiglu(a, w_gate, w_up, b_gate, b_up)


# -- the kernel ------------------------------------------------------------------
class Plan(NamedTuple):
    """How the kernel runs one call, as ``csrc/ag_gemm.cu`` plans it:
    ``path`` (one of :data:`PATHS`), ``tiles`` (output tiles, the blocks
    of one K split) and ``splits`` (K splits of the decode plan; with more
    than one the call needs a workspace of ``splits * M * sum(widths)``
    floats)."""
    path: str
    tiles: int
    splits: int


@functools.cache
def plan(op: str, m: int, widths: tuple, k: int, dtype: torch.dtype,
         num_sms: int) -> Plan:
    """The kernel's launch plan of ``op`` ("gemm": one product per width;
    "swiglu": the fused SwiGLU of one width) for an (m, k) activation of
    ``dtype`` on a card with ``num_sms`` SMs. It depends on the op, the
    dtype and the shape only, so equal inputs always sum in the same
    order."""
    lib = _lib()
    op_code = {"gemm": _OP_GEMM, "swiglu": _OP_SWIGLU}[op]
    w = list(widths) + [0] * (MAX_PRODUCTS - len(widths))
    path, tiles, splits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.tdt_ag_gemm_plan(op_code, m, len(widths), *w, k,
                                     num_sms, _DTYPE_CODES[dtype],
                                     ctypes.byref(path), ctypes.byref(tiles),
                                     ctypes.byref(splits)))
    return Plan(PATHS[path.value], tiles.value, splits.value)


#: The tensor-core tile of ``csrc/tiles.cuh`` (``kPfBM``, ``kPfBN``,
#: ``kPfBNSwiglu``): rows, columns, and columns of gate and of up.
TILE_M, TILE_N, SWIGLU_TILE_N = 128, 128, 64


def tile_count(op: str, rows: int, widths, chunks: int = 1) -> int:
    """Output tiles of the tensor-core tile over ``chunks`` row blocks of
    ``rows`` rows and output widths ``widths`` (op "swiglu": its one width,
    gate and up in one tile): the world-1 prefill kernel's tiles with
    ``chunks`` 1; a rank's items of the AG ring with ``chunks`` = W,
    ``rows`` = M / W and its shard widths, or of the GEMM-RS ring with
    widths (split, N - split)."""
    bn = SWIGLU_TILE_N if op == "swiglu" else TILE_N
    return chunks * -(-rows // TILE_M) * sum(-(-n // bn) for n in widths)


def tile_waves(tiles: int, blocks: int) -> tuple:
    """(waves, idle share of the last wave) of ``tiles`` tiles dealt in
    turn to ``blocks`` persistent blocks: tiles / blocks, and the share of
    the blocks that have no tile in the last wave."""
    if tiles < 1 or blocks < 1:
        raise ValueError(f"need tiles and blocks >= 1, got {tiles}, {blocks}")
    last = tiles - (-(-tiles // blocks) - 1) * blocks
    return tiles / blocks, 1 - last / blocks


def launch_gemm(a: torch.Tensor, bs: list, count: LaunchCount) -> list:
    """The products ``a @ b`` for ``b`` in ``bs`` (checked by the caller)
    in one launch of the AG-GEMM kernel on CUDA tensors, counted in
    ``count`` under (plan, K, widths). Shared with ``gemm_rs``."""
    _check_cuda("ag_gemm_multi", a, bs)
    lib = _lib()
    m, k = a.shape
    widths = tuple(b.shape[1] for b in bs)
    outs = [torch.empty((m, n), dtype=a.dtype, device=a.device)
            for n in widths]
    if m == 0:
        return outs
    sms = num_sms(a.device.index)
    p = plan("gemm", m, widths, k, a.dtype, sms)
    a = aligned16(a)
    bs = [aligned16(b) for b in bs]
    ws = (torch.empty((p.splits, m, sum(widths)), dtype=torch.float32,
                      device=a.device) if p.splits > 1 else None)
    pad = MAX_PRODUCTS - len(bs)
    b_ptrs = [b.data_ptr() for b in bs] + [None] * pad
    c_ptrs = [o.data_ptr() for o in outs] + [None] * pad
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _check(lib, lib.tdt_ag_gemm(a.data_ptr(), len(bs), *b_ptrs, *c_ptrs,
                                *(list(widths) + [0] * pad),
                                ws.data_ptr() if ws is not None else None,
                                m, k, sms, _DTYPE_CODES[a.dtype], stream))
    count.add((p.path, k, widths))
    return outs


def launch_swiglu(a, w_gate, w_up, b_gate, b_up) -> torch.Tensor:
    """One launch of the fused AG-SwiGLU kernel on CUDA tensors (checked
    by the caller), counted in :data:`ag_swiglu_launches`."""
    biases = [] if b_gate is None else [b_gate, b_up]
    _check_cuda("ag_swiglu", a, [w_gate, w_up] + biases)
    lib = _lib()
    m, k = a.shape
    n = w_gate.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0:
        return out
    sms = num_sms(a.device.index)
    p = plan("swiglu", m, (n,), k, a.dtype, sms)
    a, w_gate, w_up = (aligned16(t) for t in (a, w_gate, w_up))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _check(lib, lib.tdt_ag_swiglu(
        a.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        b_gate.data_ptr() if b_gate is not None else None,
        b_up.data_ptr() if b_up is not None else None,
        out.data_ptr(), m, n, k, sms, _DTYPE_CODES[a.dtype], stream))
    ag_swiglu_launches.add((p.path, k, (n,)))
    return out


# -- the ring kernel (world > 1) -------------------------------------------------
@dataclasses.dataclass
class AllGatherGEMMContext:
    """JAX's ``AllGatherGEMMContext`` over a rank group: ``ring_dirs`` (2:
    chunks travel both ways round the ring, ``ring_hop_counts``; 1: one
    way). JAX reads ``TDT_RING_DIRS`` when ``ring_dirs`` is 0; the port
    reads no environment variable, and its default is JAX's default.
    ``state`` holds the kernel's workspaces and signals across calls."""
    group: RankGroup
    ring_dirs: int = 2
    state: RingState = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        check_ring_dirs(self.ring_dirs)
        self.state = RingState(self.group)

    @property
    def world_size(self) -> int:
        return self.group.world


#: The ring kernels' bodies (``csrc/ag_gemm_ring.cu``,
#: ``csrc/gemm_rs_ring.cu``), by the name their ``ring_path`` gives.
RING_PATHS = {"fma": 0, "mma": 1, "stream": 2}


def ring_path(dtype: torch.dtype, m: int, k: int, widths,
              op: str = "gemm") -> str:
    """The ring kernel's body for an (m, k) activation and shard widths
    ``widths``: "stream" (the decode body) for op "gemm" in bf16 with K
    and every shard width multiples of 8 and m <= :data:`DECODE_MAX_M`,
    where the world-1 kernel on one rank's shard runs its decode plan;
    else the tile, "mma" (tensor cores: bf16 with K and every shard width
    multiples of 8) or "fma". It depends on op, dtype and shape only. The
    kernel takes the body's rule and its K splits from the world-1 plan of
    one rank's shard (``csrc/ag_plan.cuh``), and refuses a body that this
    plan does not give."""
    mma = (dtype == torch.bfloat16 and k % 8 == 0
           and all(n % 8 == 0 for n in widths))
    if mma and op == "gemm" and m <= DECODE_MAX_M:
        return "stream"
    return "mma" if mma else "fma"


class RingSizes(NamedTuple):
    """The state one ring launch needs beyond its chunk signals
    (``csrc/ag_gemm_ring.cu``'s ``tdt_ag_ring_sizes``): ``prods``, the
    product signals of a rank, and ``ws``, its f32 products workspace's
    elements (the decode body with more than one K split; else 0)."""
    prods: int
    ws: int


@functools.cache
def _ring_sizes(op: str, dtype: torch.dtype, path: str, world: int,
                rows: int, k: int, widths: tuple, sms: int) -> RingSizes:
    lib = _ring_lib()
    n = list(widths) + [0] * (MAX_PRODUCTS - len(widths))
    prods, ws = ctypes.c_int(), ctypes.c_longlong()
    _check(lib, lib.tdt_ag_ring_sizes(
        {"gemm": _OP_GEMM, "swiglu": _OP_SWIGLU}[op], _DTYPE_CODES[dtype],
        RING_PATHS[path], world, rows, k, len(widths), *n, sms,
        ctypes.byref(prods), ctypes.byref(ws)))
    return RingSizes(prods.value, ws.value)


def launch_ag_ring(op: str, a: torch.Tensor, bs: list,
                   ctx: AllGatherGEMMContext, biases=(),
                   fault: bool = False) -> list:
    """One launch of ``csrc/ag_gemm_ring.cu`` over every rank of
    ``ctx.group``: op "gemm" (``bs`` one to three weights, counted in
    :data:`ag_ring_launches`) or "swiglu" (``bs`` = [w_gate, w_up] and
    optional ``biases`` (b_gate, b_up), counted in
    :data:`ag_swiglu_ring_launches`), the body :func:`ring_path`'s. a (M,
    K), the weights and the outputs are the global tensors (contiguous,
    CUDA, bf16 or f32), M and every width multiples of W. Returns the list
    of outputs. ``fault`` plants the test fault of the kernel (rank 0's
    first push to the right skipped, its signal still set)."""
    _check_cuda(f"ag_{op} ring", a, list(bs) + list(biases))
    lib = _ring_lib()
    world = ctx.world_size
    m, k = a.shape
    rows = m // world
    swiglu = op == "swiglu"
    outs_w = [bs[0].shape[1]] if swiglu else [b.shape[1] for b in bs]
    widths = tuple(n // world for n in outs_w)
    path = ring_path(a.dtype, m, k, widths, op)
    sms = num_sms(a.device.index)
    size = _ring_sizes(op, a.dtype, path, world, rows, k, widths, sms)
    outs = [torch.empty((m, n), dtype=a.dtype, device=a.device)
            for n in outs_w]
    chunk_bytes = rows * k * a.element_size()
    piece = min(PIECE_BYTES, -(-chunk_bytes // 16) * 16)
    pieces = -(-chunk_bytes // piece)
    state = ctx.state
    # The state's tables are made once (RingState.table): a launch queues
    # no kernel but its own.
    ws = state.workspace(m * k, a.dtype)
    ws_tab = state.table(ws)
    sig_tab = state.table(state.signals("ag", world * pieces + size.prods))
    prod_tab = (state.table(state.workspace(size.ws, torch.float32,
                                            "products"))
                if size.ws else None)
    a = aligned16(a)
    bs = [aligned16(b) for b in bs]
    if swiglu:
        wg, wu = bs
        b_ptrs, c_ptrs = [wg.data_ptr(), None, None], [outs[0].data_ptr(),
                                                       None, None]
        n_b, u_ptr = 1, wu.data_ptr()
    else:
        pad = MAX_PRODUCTS - len(bs)
        b_ptrs = [b.data_ptr() for b in bs] + [None] * pad
        c_ptrs = [o.data_ptr() for o in outs] + [None] * pad
        n_b, u_ptr = len(bs), None
    bias_ptrs = ([t.data_ptr() for t in biases] if biases
                 else [None, None])
    n_loc = list(widths) + [0] * (MAX_PRODUCTS - len(widths))
    epoch = state.next_epoch()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _check(lib, lib.tdt_ag_ring(
        _OP_SWIGLU if swiglu else _OP_GEMM, _DTYPE_CODES[a.dtype],
        RING_PATHS[path], a.data_ptr(), ws_tab.data_ptr(),
        sig_tab.data_ptr(), ws.data_ptr(), ws.stride(0),
        prod_tab.data_ptr() if size.ws else None, n_b,
        *b_ptrs, *c_ptrs, *n_loc, u_ptr, *bias_ptrs, world, rows, k, pieces,
        piece, ctx.ring_dirs, sms, epoch, int(fault), stream))
    count = ag_swiglu_ring_launches if swiglu else ag_ring_launches
    count.add((path, world, m, k, widths))
    return outs


def _ring_lib() -> ctypes.CDLL:
    lib = _build.load("ag_gemm_ring")
    if lib.tdt_ag_ring.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tdt_ag_ring_grid.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        lib.tdt_ag_ring_grid.restype = i
        lib.tdt_ag_ring_sizes.argtypes = [i] * 11 + [
            ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong)]
        lib.tdt_ag_ring_sizes.restype = i
        lib.tdt_ag_ring.argtypes = ([i, i, i, p, p, p, p, ctypes.c_longlong,
                                     p, i] + [p] * 6
                                    + [i] * 3 + [p] * 3 + [i] * 4
                                    + [ctypes.c_longlong, i, i,
                                       ctypes.c_ulonglong, i, p])
        lib.tdt_ag_ring.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(op: str, a: torch.Tensor, bs: list) -> None:
    if not 1 <= len(bs) <= MAX_PRODUCTS:
        raise ValueError(f"{op} takes 1 to {MAX_PRODUCTS} weights, got "
                         f"{len(bs)}")
    if a.dim() != 2 or any(b.dim() != 2 or b.shape[0] != a.shape[1]
                           for b in bs):
        raise ValueError(f"{op} needs a (M, K) and weights (K, N_i), got "
                         f"{tuple(a.shape)} and "
                         f"{[tuple(b.shape) for b in bs]}")
    if any(b.shape[1] == 0 for b in bs):
        raise ValueError(f"{op} needs weights of nonzero width")
    if any(b.dtype != a.dtype for b in bs):
        raise ValueError(f"{op} needs one dtype, got {a.dtype} and "
                         f"{[b.dtype for b in bs]}")
    if any(b.device != a.device for b in bs):
        raise ValueError(f"{op} operands on {a.device} and "
                         f"{[str(b.device) for b in bs]}")


def _check_world(op: str, a: torch.Tensor, bs: list, group,
                 impl: str) -> None:
    """What a world > 1 call takes: a known impl, rows and weight columns
    that split over the ranks."""
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown {op} impl {impl!r}")
    if a.shape[0] % group.world:
        raise ValueError(f"{op}: {a.shape[0]} rows do not split over "
                         f"{group.world} ranks")
    if any(b.shape[1] % group.world for b in bs):
        raise ValueError(f"{op}: weight widths {[b.shape[1] for b in bs]} "
                         f"do not split over {group.world} ranks")


def _check_swiglu_operands(a, w_gate, w_up, b_gate, b_up) -> None:
    _check_operands("ag_swiglu", a, [w_gate, w_up])
    if w_gate.shape != w_up.shape:
        raise ValueError(f"ag_swiglu needs gate and up of one shape, got "
                         f"{tuple(w_gate.shape)} and {tuple(w_up.shape)}")
    if (b_gate is None) != (b_up is None):
        raise ValueError("pass both biases or neither")
    n = w_gate.shape[1]
    for bias in ((b_gate, b_up) if b_gate is not None else ()):
        if tuple(bias.shape) != (n,):
            raise ValueError(f"ag_swiglu biases must be ({n},), got "
                             f"{tuple(bias.shape)}")
        if bias.device != a.device:
            raise ValueError(f"ag_swiglu bias on {bias.device}, operands on "
                             f"{a.device}")


def _check_cuda(op: str, a: torch.Tensor, others: list) -> None:
    """What the kernel takes: CUDA, bf16 or f32 throughout, contiguous."""
    if a.device.type != "cuda":
        raise ValueError(f"{op} runs on CUDA or the CPU, not {a.device}")
    if a.dtype not in _DTYPE_CODES:
        raise ValueError(f"{op} kernel takes bf16 or f32, not {a.dtype}")
    if any(t.dtype != a.dtype for t in others):
        raise ValueError(f"{op} kernel needs every operand in {a.dtype}")
    if not all(t.is_contiguous() for t in [a] + others):
        raise ValueError(f"{op} kernel needs contiguous operands")


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.tdt_error_string(err).decode()
        raise RuntimeError(f"ag_gemm kernel call failed: {msg} ({err})")


def _lib() -> ctypes.CDLL:
    lib = _build.load("ag_gemm")
    if lib.tdt_ag_gemm.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        lib.tdt_ag_gemm_plan.argtypes = [i] * 9 + [ip, ip, ip]
        lib.tdt_ag_gemm_plan.restype = i
        lib.tdt_ag_gemm.argtypes = ([p, i] + [p] * 6 + [i] * 3
                                    + [p, i, i, i, i, p])
        lib.tdt_ag_gemm.restype = i
        lib.tdt_ag_swiglu.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.tdt_ag_swiglu.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
