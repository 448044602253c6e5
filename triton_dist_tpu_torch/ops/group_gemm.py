"""Grouped (per-expert) GEMM for MoE (the port of
``triton_dist_tpu.ops.group_gemm``).

``grouped_matmul`` computes ``out[i] = tokens[i] @ w[expert_ids[i]]`` with
f32 accumulation and one rounding (JAX's sort + ``lax.ragged_dot`` +
unsort, :44-64), ``grouped_expert_ffn`` the per-expert SwiGLU FFN (:67-87:
gate and up stay f32 and round once after the SwiGLU). At world = 1
``ag_group_gemm`` is ``grouped_matmul`` in every impl: its all-gather is
the identity, and its Pallas kernel ``_ag_group_gemm_kernel`` (:139)
reduces to the grouped GEMM over the tile-aligned schedule of
:func:`align_tokens_for_tiles`. No layer calls ``ag_group_gemm``:
``TPMoE`` runs ``grouped_matmul`` per rank, as JAX's does.

At world W > 1 (a ``runtime.dist.RankGroup`` of W ranks on one card, the
context's ``group``) ``ag_group_gemm`` takes JAX's layout (:306-403): x
the row-sharded global (M, K), ``expert_ids`` row-sharded like it, w the
global (E, K, N) with N column-sharded (rank r's shard is the view ``w[:,
:, r*N/W:(r+1)*N/W]``, never copied), the result the global (M, N),
column-sharded. Impls "xla" and "ring" are JAX's XLA bodies, plain over
the grouped-GEMM kernel: on one card the gathered rows are the global x,
so each rank runs the kernel once on its shard (CPU tensors:
:func:`ag_group_gemm_reference`, :func:`ag_group_gemm_ring_reference`).
Impl "fused" launches ``csrc/ag_group_gemm.cu``: the ring all-gather of
the chunks inside the launch that runs every rank's grouped products
(:func:`launch_ag_group_gemm`; CPU tensors: the ring version, whose chunk
order the kernel keeps).

On CUDA every grouped product launches the hand-written kernel of
``csrc/group_gemm.cu`` (the note in ``csrc/group_gemm.cuh`` says what
bounds it and what its design does about that), in every mode, as JAX
runs ``ragged_dot`` in every mode. A CPU tensor takes the plain versions
:func:`grouped_matmul_reference` and :func:`grouped_swiglu_reference`.

Rows whose id is the sentinel ``num_experts`` run through the last
expert (``num_experts - 1``), as JAX's ``grouped_matmul`` folds them into
its last group; callers mask them. JAX's fused kernel leaves them
unspecified instead (they collide in a trash tile), which no caller
reads.

``topk`` (a port argument; 1 gives JAX's signature): ``tokens`` holds one
row per ``topk`` consecutive pairs, pair ``i`` reading ``tokens[i //
topk]``. The MoE layers pass their token rows this way, so the (P, K)
expansion ``jnp.repeat`` makes is never written.

The kernel reads the tokens and the weights through their strides (the
last dimension contiguous): under tensor parallelism a rank's shard of
the experts, ``w[:, :, cols]``, is a view of the global weights, as
``runtime.dist`` makes every shard, and is never copied.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import LaunchCount, aligned16
from triton_dist_tpu_torch.ops.moe_utils import bincount
from triton_dist_tpu_torch.runtime.dist import RankGroup
from triton_dist_tpu_torch.runtime.symm_mem import RingState, rank_table

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_EPI_PLAIN, _EPI_SWIGLU = 0, 1
#: The kernel's paths, by the code of ``tdt_group_gemm_plan``.
PATHS = ("fma", "mma")

#: Launches of the grouped-GEMM kernel, by (path, rows per tile,
#: "plain" | "swiglu", pairs, K, widths of the products).
group_gemm_launches = LaunchCount()
#: Calls of the world-W ring kernel (``csrc/ag_group_gemm.cu``: the
#: chunks' expert schedule, then one cooperative launch over every rank),
#: by (path, rows per tile, world, M, K, shard width).
ag_group_gemm_launches = LaunchCount()
#: Bytes of one piece of a travelling chunk: the grain of the ring's
#: copies and signals.
PIECE_BYTES = 32 * 1024


# -- plain versions ------------------------------------------------------------
def _expert_runs(expert_ids: torch.Tensor, num_experts: int):
    """(stable expert order of the pairs, pairs per expert as a list):
    sentinel and out-of-range ids count as the nearest expert. The list
    is read back to the host: plain versions only."""
    eids = expert_ids.reshape(-1).long().clamp(0, num_experts - 1)
    order = torch.argsort(eids, stable=True)
    return order, bincount(eids, num_experts).tolist()


def grouped_matmul_reference(tokens: torch.Tensor, w: torch.Tensor,
                             expert_ids: torch.Tensor, num_experts: int,
                             topk: int = 1, out_dtype=None) -> torch.Tensor:
    """Plain version: one f32 product per live expert over its pairs,
    cast to ``out_dtype`` (default ``tokens.dtype``)."""
    p, n = expert_ids.numel(), w.shape[-1]
    out = torch.empty((p, n), dtype=out_dtype or tokens.dtype,
                      device=tokens.device)
    order, counts = _expert_runs(expert_ids, num_experts)
    rows = tokens[order // topk].float()
    start = 0
    for e, c in enumerate(counts):
        if c:
            sl = slice(start, start + c)
            out[order[sl]] = (rows[sl] @ w[e].float()).to(out.dtype)
        start += c
    return out


def grouped_swiglu_reference(tokens: torch.Tensor, w_gate: torch.Tensor,
                             w_up: torch.Tensor, expert_ids: torch.Tensor,
                             num_experts: int,
                             topk: int = 1) -> torch.Tensor:
    """Plain version of the SwiGLU epilogue: gate and up in f32,
    ``silu(gate) * up`` in f32, one rounding to ``tokens.dtype``."""
    gate = grouped_matmul_reference(tokens, w_gate, expert_ids, num_experts,
                                    topk, torch.float32)
    up = grouped_matmul_reference(tokens, w_up, expert_ids, num_experts,
                                  topk, torch.float32)
    return (F.silu(gate) * up).to(tokens.dtype)


def _rank_products(x, w, world, rows_of) -> torch.Tensor:
    """The global (M, N) of every rank's column shard of ``w``, rank r's
    columns from ``rows_of(r, shard)`` (its (M, N / W) output)."""
    group = RankGroup(world, device=x.device)
    return group.unshard([rows_of(r, wr) for r, wr in
                          enumerate(group.shard(w, 2))], 1)


def ag_group_gemm_reference(x: torch.Tensor, w: torch.Tensor,
                            expert_ids: torch.Tensor, num_experts: int,
                            world: int) -> torch.Tensor:
    """Plain version of JAX's one-shot body (:368-371) at world W: the
    gathered rows (the global x) through :func:`grouped_matmul_reference`
    on each rank's column shard. Returns the global (M, N)."""
    return _rank_products(x, w, world, lambda r, wr: grouped_matmul_reference(
        x, wr, expert_ids, num_experts))


def ag_group_gemm_ring_reference(x: torch.Tensor, w: torch.Tensor,
                                 expert_ids: torch.Tensor, num_experts: int,
                                 world: int) -> torch.Tensor:
    """Plain version of JAX's ring body (:373-396) at world W: rank ``me``
    runs one grouped product per chunk, chunk ``src = me - s`` at step s,
    written at rows ``src * rows`` of its (M, N / W) output.

    Rows are independent and each output element is one f32 full-K sum
    rounded once, so this computes the function of
    :func:`ag_group_gemm_reference`. On the card, where both run the same
    kernel per row, they give equal bits; on the CPU a BLAS may block K
    differently for another row count, so they agree within 1e-6 (f32)."""
    rows = x.shape[0] // world
    ids = expert_ids.reshape(-1)

    def rank(me, wr):
        out = x.new_empty((x.shape[0], wr.shape[2]))
        for s in range(world):
            src = (me - s) % world
            sl = slice(src * rows, (src + 1) * rows)
            out[sl] = grouped_matmul_reference(x[sl], wr, ids[sl],
                                               num_experts)
        return out
    return _rank_products(x, w, world, rank)


# -- entry points ----------------------------------------------------------------
def grouped_matmul(tokens: torch.Tensor, w: torch.Tensor,
                   expert_ids: torch.Tensor, num_experts: int,
                   topk: int = 1) -> torch.Tensor:
    """``out[i] = tokens[i // topk] @ w[expert_ids[i]]``, f32
    accumulation, cast to ``tokens.dtype``. w: (E, K, N); expert_ids: (P,)
    with ``num_experts`` as the sentinel. Returns (P, N)."""
    return grouped_matmul_multi(tokens, [w], expert_ids, num_experts,
                                topk)[0]


def grouped_matmul_multi(tokens: torch.Tensor, ws, expert_ids: torch.Tensor,
                         num_experts: int, topk: int = 1) -> list:
    """:func:`grouped_matmul` of one or two weights sharing the tokens
    and the routing (gate and up), each product rounded on its own; on
    CUDA one launch."""
    ws = list(ws)
    _check_operands("grouped_matmul", tokens, ws, expert_ids, topk)
    if tokens.device.type == "cpu":
        return [grouped_matmul_reference(tokens, w, expert_ids, num_experts,
                                         topk) for w in ws]
    return launch_group_gemm(tokens, ws, expert_ids, num_experts, topk,
                             "plain")


def grouped_swiglu(tokens: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, expert_ids: torch.Tensor,
                   num_experts: int, topk: int = 1) -> torch.Tensor:
    """``silu(tokens @ w_gate[e]) * (tokens @ w_up[e])`` per pair, gate
    and up in f32, one rounding: the first half of
    :func:`grouped_expert_ffn`. Returns (P, I)."""
    _check_operands("grouped_swiglu", tokens, [w_gate, w_up], expert_ids,
                    topk)
    if tokens.device.type == "cpu":
        return grouped_swiglu_reference(tokens, w_gate, w_up, expert_ids,
                                        num_experts, topk)
    return launch_group_gemm(tokens, [w_gate, w_up], expert_ids,
                             num_experts, topk, "swiglu")[0]


def grouped_expert_ffn(tokens: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, w_down: torch.Tensor,
                       expert_ids: torch.Tensor, num_experts: int,
                       topk: int = 1) -> torch.Tensor:
    """Per-expert SwiGLU FFN over a flat pair list (JAX
    ``grouped_expert_ffn``): gate and up in f32, the SwiGLU rounded once,
    then the down product rounded. w_gate/w_up: (E, H, I), w_down: (E, I,
    H). Returns (P, H); on CUDA two launches."""
    act = grouped_swiglu(tokens, w_gate, w_up, expert_ids, num_experts,
                         topk)
    return grouped_matmul(act, w_down, expert_ids, num_experts)


def align_tokens_for_tiles(tokens: torch.Tensor, ids: torch.Tensor,
                           num_experts: int, m_blk: int):
    """Tile-align tokens by expert (JAX ``align_tokens_for_tiles``,
    group_gemm.py:90-136, static shapes): rows expert-sorted, each expert
    group padded to an ``m_blk`` boundary. Returns (padded (M_pad, K),
    tile_experts (M_pad // m_blk,) int32, dest (M,) int32 padded row of
    each row); invalid rows (``ids == num_experts``) go to the trailing
    trash row. The CUDA kernel builds the same schedule on the card
    (``csrc/group_gemm.cuh``) with tiles of its own height; this function
    is its plain statement."""
    m, k = tokens.shape
    e = num_experts
    dev = tokens.device
    m_pad = -(-(m + e * (m_blk - 1)) // m_blk) * m_blk + m_blk
    ids = ids.reshape(-1).long()
    valid = ids < e
    eids = ids.clamp(0, e - 1)
    keyed = torch.where(valid, eids, e)
    sizes = bincount(keyed, e + 1)[:e].long()
    gs_pad = (sizes + m_blk - 1) // m_blk * m_blk
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    offs = torch.cat([zero, torch.cumsum(sizes, 0)[:-1]])
    offs_pad = torch.cat([zero, torch.cumsum(gs_pad, 0)[:-1]])
    order = torch.argsort(keyed, stable=True)
    e_sorted = eids[order]
    rank = torch.arange(m, device=dev) - offs[e_sorted]
    dest_sorted = torch.where(valid[order], offs_pad[e_sorted] + rank,
                              m_pad - 1)
    padded = tokens.new_zeros((m_pad, k))
    padded[dest_sorted] = tokens[order]
    dest = torch.zeros(m, dtype=torch.long, device=dev)
    dest[order] = dest_sorted
    tile_starts = torch.arange(m_pad // m_blk, device=dev) * m_blk
    tile_experts = torch.searchsorted(torch.cumsum(gs_pad, 0), tile_starts,
                                      right=True).clamp(0, e - 1)
    return padded, tile_experts.to(torch.int32), dest.to(torch.int32)


@dataclasses.dataclass
class AGGroupGEMMContext:
    """JAX's context over a rank group (``group``; None: one rank): axis
    name and schedule choice (JAX's Pallas tile sizes belong to its TPU
    kernel; the Hopper kernel tiles its own way). ``state`` holds the
    ring kernel's workspaces and signals across calls (world > 1)."""
    group: RankGroup | None = None
    axis: str = "tp"
    ring: bool = True
    state: RingState | None = dataclasses.field(init=False, repr=False,
                                                default=None)

    def __post_init__(self):
        if self.group is not None and self.group.world > 1:
            self.state = RingState(self.group)

    @property
    def world_size(self) -> int:
        return self.group.world if self.group is not None else 1


def create_ag_group_gemm_context(axis: str = "tp", ring: bool = True,
                                 group: RankGroup | None = None
                                 ) -> AGGroupGEMMContext:
    return AGGroupGEMMContext(group=group, axis=axis, ring=ring)


def ag_group_gemm(x: torch.Tensor, w: torch.Tensor, expert_ids: torch.Tensor,
                  num_experts: int, ctx: AGGroupGEMMContext | None = None,
                  impl: str = "ring") -> torch.Tensor:
    """``group_gemm(allgather(x), w)`` (JAX ``ag_group_gemm``). x: (M, K)
    with one expert id per row; w: (E, K, N). Returns (M, N).

    At world 1: :func:`grouped_matmul` for impl "xla", "ring" and
    "fused". Over the context's group of W > 1 ranks: x and
    ``expert_ids`` row-sharded, w and the result column-sharded (the
    module note); "xla" and "ring" run the grouped-GEMM kernel once a
    rank on its shard, "fused" the ring kernel (one cooperative launch
    for every rank). CPU tensors take the plain versions."""
    ctx = ctx or create_ag_group_gemm_context()
    if impl == "auto":
        raise NotImplementedError(
            "ag_group_gemm impl='auto' measures ring against fused through "
            "the autotuner, which is not ported yet (ROADMAP.md, Queue A "
            "item 19)")
    if impl not in ("xla", "ring", "fused"):
        raise ValueError(f"unknown ag_group_gemm impl {impl!r}")
    world = ctx.world_size
    if world == 1:
        return grouped_matmul(x, w, expert_ids, num_experts)
    _check_operands("ag_group_gemm", x, [w], expert_ids, 1)
    if x.shape[0] % world or w.shape[2] % world:
        raise ValueError(f"ag_group_gemm at world {world}: {x.shape[0]} rows "
                         f"and {w.shape[2]} columns must split over the "
                         f"ranks")
    if x.device.type == "cpu":
        plain = (ag_group_gemm_reference if impl == "xla"
                 else ag_group_gemm_ring_reference)
        return plain(x, w, expert_ids, num_experts, world)
    if impl == "fused":
        return launch_ag_group_gemm(x, w, expert_ids, num_experts, ctx)
    return ctx.group.per_rank(
        lambda wr: grouped_matmul(x, wr, expert_ids, num_experts), w,
        in_dims=(2,), out_dims=1)


# -- the kernel ------------------------------------------------------------------
class Plan(NamedTuple):
    """How the kernel runs one call, as ``csrc/group_gemm.cuh`` plans it:
    ``path`` (one of :data:`PATHS`), ``m_blk`` (pairs per row tile) and
    ``max_tiles`` (row tiles of the grid, the worst case of live ones)."""
    path: str
    m_blk: int
    max_tiles: int


@functools.cache
def plan(pairs: int, num_experts: int, k: int, n: int, dtype: torch.dtype,
         strides: tuple | None = None) -> Plan:
    """The kernel's plan of ``pairs`` (k -> n) products over
    ``num_experts`` experts in ``dtype``, with ``strides`` (elements of a
    token row, a weight row and an expert; default contiguous): a
    function of the shape and strides only."""
    lda, ldb, estride = strides or (k, n, k * n)
    lib = _lib()
    path, m_blk, tiles = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.tdt_group_gemm_plan(pairs, num_experts, k, n,
                                        _DTYPE_CODES[dtype], lda, ldb,
                                        estride, ctypes.byref(path),
                                        ctypes.byref(m_blk),
                                        ctypes.byref(tiles)))
    return Plan(PATHS[path.value], m_blk.value, tiles.value)


def schedule_buffer(pairs: int, p: Plan, device) -> torch.Tensor:
    """The int32 schedule the kernel writes before its product: live
    tiles, the expert-sorted pairs, each tile's expert, first row and
    row count."""
    return torch.empty(1 + pairs + 3 * p.max_tiles, dtype=torch.int32,
                       device=device)


def launch_group_gemm(tokens: torch.Tensor, ws: list,
                      expert_ids: torch.Tensor, num_experts: int, topk: int,
                      epilogue: str) -> list:
    """One call of the grouped-GEMM kernel on CUDA tensors (checked by
    the caller): the products of ``ws`` ("plain", one output each) or the
    SwiGLU of gate ``ws[0]`` and up ``ws[1]`` ("swiglu", one output),
    counted in :data:`group_gemm_launches`."""
    _check_cuda("grouped_matmul", tokens, ws)
    lib = _lib()
    pairs = expert_ids.numel()
    k, n = ws[0].shape[1], ws[0].shape[2]
    swiglu = epilogue == "swiglu"
    outs = [torch.empty((pairs, n), dtype=tokens.dtype, device=tokens.device)
            for _ in range(1 if swiglu else len(ws))]
    if pairs == 0:
        return outs
    tokens = aligned16(tokens)
    ws = [aligned16(w) for w in ws]
    strides = (tokens.stride(0), *weight_strides(ws))
    p = plan(pairs, num_experts, k, n, tokens.dtype, strides)
    ids = expert_ids.reshape(-1).to(torch.int32).contiguous()
    sched = schedule_buffer(pairs, p, tokens.device)
    b1 = ws[1].data_ptr() if len(ws) > 1 else None
    c1 = outs[1].data_ptr() if len(outs) > 1 else None
    stream = torch.cuda.current_stream(tokens.device).cuda_stream
    _check(lib, lib.tdt_group_gemm(
        tokens.data_ptr(), topk, ids.data_ptr(), pairs, num_experts,
        ws[0].data_ptr(), b1, outs[0].data_ptr(), c1, len(ws),
        _EPI_SWIGLU if swiglu else _EPI_PLAIN, k, n, *strides,
        sched.data_ptr(), _DTYPE_CODES[tokens.dtype], stream))
    group_gemm_launches.add((p.path, p.m_blk, epilogue, pairs, k,
                             tuple(w.shape[2] for w in ws)))
    return outs


def ring_workspace(x: torch.Tensor, ctx: AGGroupGEMMContext) -> torch.Tensor:
    """The (W, row) workspace the ring kernel uses for x: every rank's
    (M, K) gathered rows, then the NaN canary tail (``RingState``)."""
    return ctx.state.workspace(x.numel(), x.dtype)


def launch_ag_group_gemm(x: torch.Tensor, w: torch.Tensor,
                         expert_ids: torch.Tensor, num_experts: int,
                         ctx: AGGroupGEMMContext,
                         fault: bool = False) -> torch.Tensor:
    """One call of ``csrc/ag_group_gemm.cu`` over every rank of
    ``ctx.group`` (checked by the caller: M and N multiples of W): the
    chunks' expert schedule, then one cooperative launch; counted once in
    :data:`ag_group_gemm_launches`. x (M, K) and w (E, K, N) are CUDA,
    bf16 or f32, contiguous. Returns the global (M, N). ``fault`` plants
    the kernel's test fault (rank 0's first push skipped, its signal
    still set)."""
    _check_cuda("ag_group_gemm", x, [w])
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("ag_group_gemm kernel needs contiguous x and w")
    lib = _agg_lib()
    world = ctx.world_size
    m, k = x.shape
    e, n = w.shape[0], w.shape[2]
    rows, n_loc = m // world, n // world
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    p = plan(rows, e, k, n_loc, x.dtype, (k, n, k * n))
    x, w = aligned16(x), aligned16(w)
    ids = expert_ids.reshape(-1).to(torch.int32).contiguous()
    sched = torch.empty(world * (1 + rows + 3 * p.max_tiles),
                        dtype=torch.int32, device=x.device)
    chunk_bytes = rows * k * x.element_size()
    piece = min(PIECE_BYTES, -(-chunk_bytes // 16) * 16)
    pieces = -(-chunk_bytes // piece)
    state = ctx.state
    ws = ring_workspace(x, ctx)
    sig = state.signals("agg", world * pieces)
    # The tables stay referenced until the launch is queued: a freed
    # temporary's memory would be handed to the next one.
    ws_tab, sig_tab = rank_table(ws, world), rank_table(sig, world)
    epoch = state.next_epoch()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(lib, lib.tdt_ag_group_gemm(
        x.data_ptr(), ids.data_ptr(), w.data_ptr(), out.data_ptr(),
        ws_tab.data_ptr(), sig_tab.data_ptr(), sched.data_ptr(), world,
        rows, e, k, n, pieces, piece, _DTYPE_CODES[x.dtype], epoch,
        int(fault), stream))
    ag_group_gemm_launches.add((p.path, p.m_blk, world, m, k, n_loc))
    return out


def _check_operands(op: str, tokens: torch.Tensor, ws: list,
                    expert_ids: torch.Tensor, topk: int) -> None:
    if not 1 <= len(ws) <= 2:
        raise ValueError(f"{op} takes one or two weights, got {len(ws)}")
    if tokens.dim() != 2 or any(w.dim() != 3 for w in ws):
        raise ValueError(f"{op} needs tokens (T, K) and weights (E, K, N), "
                         f"got {tuple(tokens.shape)} and "
                         f"{[tuple(w.shape) for w in ws]}")
    if any(w.shape != ws[0].shape for w in ws) or \
            ws[0].shape[1] != tokens.shape[1]:
        raise ValueError(f"{op}: weights {[tuple(w.shape) for w in ws]} do "
                         f"not fit tokens {tuple(tokens.shape)}")
    if topk < 1 or expert_ids.numel() != tokens.shape[0] * topk:
        raise ValueError(f"{op}: {expert_ids.numel()} expert ids for "
                         f"{tokens.shape[0]} token rows x topk {topk}")
    if any(w.dtype != tokens.dtype for w in ws):
        raise ValueError(f"{op} needs one dtype, got {tokens.dtype} and "
                         f"{[w.dtype for w in ws]}")
    if any(t.device != tokens.device for t in ws + [expert_ids]):
        raise ValueError(f"{op} operands on more than one device")


def weight_strides(ws: list) -> tuple:
    """(row stride, expert stride) in elements of the weights ``ws``,
    which must share them and have contiguous rows (a column or row
    shard of contiguous weights has)."""
    st = ws[0].stride()
    if st[2] != 1 or any(w.stride() != st for w in ws):
        raise ValueError(f"grouped GEMM weights need contiguous rows and one "
                         f"set of strides, got {[w.stride() for w in ws]}")
    return st[1], st[0]


def _check_cuda(op: str, tokens: torch.Tensor, ws: list) -> None:
    """What the kernel takes: CUDA, bf16 or f32, contiguous rows (token
    and weight rows may be strided, :func:`weight_strides`)."""
    if tokens.device.type != "cuda":
        raise ValueError(f"{op} runs on CUDA or the CPU, not {tokens.device}")
    if tokens.dtype not in _DTYPE_CODES:
        raise ValueError(f"{op} kernel takes bf16 or f32, not {tokens.dtype}")
    if tokens.stride(1) != 1:
        raise ValueError(f"{op} kernel needs contiguous token rows")
    weight_strides(ws)


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.tdt_error_string(err).decode()
        raise RuntimeError(f"group_gemm kernel call failed: {msg} ({err})")


def _agg_lib() -> ctypes.CDLL:
    lib = _build.load("ag_group_gemm")
    if lib.tdt_ag_group_gemm.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tdt_ag_group_gemm.argtypes = ([p] * 7 + [i] * 6
                                          + [ctypes.c_longlong, i,
                                             ctypes.c_ulonglong, i, p])
        lib.tdt_ag_group_gemm.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    lib = _build.load("group_gemm")
    if lib.tdt_group_gemm.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        ll = ctypes.c_longlong
        lib.tdt_group_gemm_plan.argtypes = [i] * 5 + [ll] * 3 + [ip, ip, ip]
        lib.tdt_group_gemm_plan.restype = i
        lib.tdt_group_gemm.argtypes = ([p, i, p, i, i, p, p, p, p, i, i, i,
                                        i, ll, ll, ll, p, i, p])
        lib.tdt_group_gemm.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
