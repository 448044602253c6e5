"""MoE down projection + top-k reduce + reduce-scatter (the port of
``triton_dist_tpu.ops.moe_reduce_rs``).

``out[t] = sum_j weights[t, j] * (act[t k + j] @ w_down[expert_ids[t k +
j]])``, with I (act's columns, w_down's rows) sharded over the ranks and
the result's rows scattered over them. At world = 1 the reduce-scatter is
the identity and the impls differ only in where bf16 rounds:

* ``"ring"`` and ``"xla"``: JAX's one-shot body (:388): ``grouped_matmul``
  rounds each pair's down product to the activation dtype, then
  ``topk_reduce`` sums in f32 and rounds once;
* ``"fused"``: the numerics of the Pallas kernel ``_moe_rs_fused_kernel``
  (:72; world = 1 branch :203-205): f32 through the weighted sum, one
  rounding.

On CUDA all three launch the hand-written kernel of ``csrc/moe_rs.cu``
with the pair rounding on or off; a CPU tensor takes the plain version
:func:`moe_reduce_rs_reference`.

At world W (``world_size`` ranks, slices of one card as
``runtime.dist`` runs them) ``"ring"`` and ``"xla"`` are JAX's XLA
bodies; no Pallas kernel is involved. Each rank's partial (T, H) is the
world = 1 computation on its I-shard (its columns of ``act`` and its rows
of ``w_down``, both views): the pairs' products rounded, the top-k sum in
f32, rounded, as JAX's ``block_partial`` rounds it. Rows are
independent, so each rank computes all of its T rows in one launch of the
kernel, where JAX's ring computes one row block per step; the exchange of
the partials is plain torch where JAX's is ``lax.ppermute`` /
``psum_scatter``:

* ``"ring"`` (:331-354): row block ``me`` summed in f32 in JAX's ring
  order, rank me + 1 first and rank me last, then rounded once
  (:func:`ring_reduce_scatter`);
* ``"xla"`` (:326-329, the one-shot ``psum_scatter``): the partials
  summed like ``RankGroup.psum``, in f32 in rank order, rounded once.

``"fused"`` at world W is the Pallas kernel's own ring (:207-222), with
its rounding points: each rank's per-chunk partial stays f32 (pair
products and the routing-weighted top-k sum), and the partial of chunk c
travels the ring in the activation dtype (``send_hbm`` / ``recv_hbm``,
:447-453), starting on rank c + 1 and ending on rank c; every hop adds
the received partial in f32 and rounds (:185-196), so chunk c rounds W
times where "ring" rounds once. CPU tensors take the plain version
:func:`moe_reduce_rs_fused_world_reference`; CUDA tensors launch
``csrc/moe_rs_ring.cu`` (:func:`launch_moe_rs_ring`): the pairs' expert
schedule, then one cooperative launch in which every rank computes its
f32 products of all the pairs on its shard and runs the ring. The
context keeps the kernel's workspaces and signals (``RingState``)
between calls.

``impl="auto"`` (the autotuner, ROADMAP Queue A item 19) raises
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import LaunchCount, aligned16
from triton_dist_tpu_torch.ops.group_gemm import (
    grouped_matmul_reference, plan, schedule_buffer)
from triton_dist_tpu_torch.runtime.dist import RankGroup
from triton_dist_tpu_torch.runtime.symm_mem import RingState, rank_table

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
#: The impls whose pair products round to the activation dtype.
ROUNDED_IMPLS = ("ring", "xla")

#: Launches of the MoE-reduce kernel, by (path, rows per tile, "rounded" |
#: "f32" pairs, pairs, I, H).
moe_rs_launches = LaunchCount()
#: Calls of the world-W ring kernel (``csrc/moe_rs_ring.cu``: the pairs'
#: expert schedule, then one cooperative launch over every rank), by
#: (path, rows per tile, world, pairs, I, H).
moe_rs_ring_launches = LaunchCount()
#: Elements of one piece of a travelling chunk partial: the grain of the
#: ring's hops and signals (one row of Qwen3-30B-A3B's hidden 2048, so
#: that at prefill every block of a rank reduces a piece at each step).
PIECE_ELEMS = 2048


@dataclasses.dataclass
class MoEReduceRSContext:
    """The JAX context: axis, its ranks, expert count and top-k.
    ``state`` holds the fused ring kernel's workspaces and signals across
    calls (world > 1, made at the first CUDA call)."""
    world_size: int = 1
    axis: str = "tp"
    num_experts: int = 8
    topk: int = 2
    state: RingState | None = dataclasses.field(init=False, repr=False,
                                                default=None)

    def ring_state(self, device) -> RingState:
        """The ring kernel's state on ``device``."""
        if self.state is None or self.state.group.device != device:
            self.state = RingState(RankGroup(self.world_size, self.axis,
                                             device))
        return self.state


def create_moe_rs_context(axis: str = "tp", num_experts: int = 8,
                          topk: int = 2,
                          world_size: int = 1) -> MoEReduceRSContext:
    return MoEReduceRSContext(world_size=world_size, axis=axis,
                              num_experts=num_experts, topk=topk)


def moe_reduce_rs_reference(act: torch.Tensor, w_down: torch.Tensor,
                            expert_ids: torch.Tensor, weights: torch.Tensor,
                            num_experts: int,
                            round_pairs: bool = True) -> torch.Tensor:
    """Plain version: the grouped down product of every pair (rounded to
    ``act.dtype`` when ``round_pairs``, else kept f32), times its f32
    routing weight, summed over each token's k pairs in f32, rounded
    once."""
    t, k = weights.shape
    pair = grouped_matmul_reference(
        act, w_down, expert_ids, num_experts,
        out_dtype=act.dtype if round_pairs else torch.float32)
    red = (pair.float().reshape(t, k, -1) * weights.float()[..., None])
    return red.sum(dim=1).to(act.dtype)


def ring_reduce_scatter(parts: list) -> torch.Tensor:
    """JAX's ring reduce-scatter of the W ranks' (T, H) partials
    (moe_reduce_rs.py:346-354): row block c of the result sums the ranks'
    block c in f32 in the order c + 1, c + 2, ..., c (mod W), the order
    its accumulator travels the ring, and rounds once."""
    world = len(parts)
    t, h = parts[0].shape
    rows = t // world
    stacked = torch.stack(parts).float().reshape(world, world, rows, h)
    blocks = torch.arange(world, device=parts[0].device)
    acc = stacked[(blocks + 1) % world, blocks]
    for s in range(2, world + 1):
        acc = acc + stacked[(blocks + s) % world, blocks]
    return acc.reshape(t, h).to(parts[0].dtype)


def moe_reduce_rs_world_reference(act: torch.Tensor, w_down: torch.Tensor,
                                  expert_ids: torch.Tensor,
                                  weights: torch.Tensor, num_experts: int,
                                  world: int, impl: str = "ring"
                                  ) -> torch.Tensor:
    """Plain version at world W of impl "ring" or "xla": each rank's
    partial by :func:`moe_reduce_rs_reference` on its I-shard, then the
    impl's sum."""
    return _reduce_ranks(
        [moe_reduce_rs_reference(a, wd, expert_ids, weights, num_experts)
         for a, wd in _rank_shards(act, w_down, world)], impl)


def _fused_partials(act, w_down, expert_ids, weights, num_experts, world):
    """Each rank's f32 (T, H) partial on its I-shard, as the fused kernel
    keeps it: f32 pair products, times the f32 routing weights, summed
    over slots 0..k-1 in that order."""
    t, k = weights.shape
    parts = []
    for a, wd in _rank_shards(act, w_down, world):
        pair = grouped_matmul_reference(a, wd, expert_ids, num_experts,
                                        out_dtype=torch.float32)
        red = pair.reshape(t, k, -1) * weights.float()[..., None]
        acc = red[:, 0]
        for j in range(1, k):
            acc = acc + red[:, j]
        parts.append(acc)
    return parts


def moe_reduce_rs_fused_world_reference(act: torch.Tensor,
                                        w_down: torch.Tensor,
                                        expert_ids: torch.Tensor,
                                        weights: torch.Tensor,
                                        num_experts: int, world: int,
                                        magnitude: bool = False):
    """Plain version of ``"fused"`` at world W: each rank's f32 partial
    (:func:`_fused_partials`), then JAX's ring (moe_reduce_rs.py:207-222):
    chunk c's partial starts on rank c + 1, rounded to ``act.dtype``,
    and moves right; each hop adds the received partial to the rank's own
    in f32 and rounds; it ends on rank c, whose rows of the result it is.
    With ``magnitude`` also returns, per element, the sum of the
    magnitudes of the W values that were rounded (one rounding may flip
    by one ulp of each)."""
    t, h = weights.shape[0], w_down.shape[2]
    rows = t // world
    stacked = torch.stack(_fused_partials(act, w_down, expert_ids, weights,
                                          num_experts, world))
    stacked = stacked.reshape(world, world, rows, h)   # [rank, chunk]
    chunks = torch.arange(world, device=act.device)
    exact = stacked[(chunks + 1) % world, chunks]
    mag = exact.abs()
    acc = exact.to(act.dtype)
    for s in range(2, world + 1):
        exact = stacked[(chunks + s) % world, chunks] + acc.float()
        mag = mag + exact.abs()
        acc = exact.to(act.dtype)
    out = acc.reshape(t, h)
    return (out, mag.reshape(t, h)) if magnitude else out


def _rank_shards(act: torch.Tensor, w_down: torch.Tensor,
                 world: int) -> list:
    """Each rank's (act columns, w_down rows) of the I-shard, as views."""
    group = RankGroup(world, device=act.device)
    return list(zip(group.shard(act, 1), group.shard(w_down, 1)))


def _reduce_ranks(parts: list, impl: str) -> torch.Tensor:
    if impl == "ring":
        return ring_reduce_scatter(parts)
    return RankGroup(len(parts), device=parts[0].device).psum(parts)


def moe_reduce_rs(act: torch.Tensor, w_down: torch.Tensor,
                  expert_ids: torch.Tensor, weights: torch.Tensor,
                  ctx: MoEReduceRSContext, impl: str = "ring") -> torch.Tensor:
    """``reduce_scatter(topk_reduce(grouped_gemm(act, w_down)))``. act:
    (T * topk, I); w_down: (E, I, H), I sharded over ``ctx``'s W ranks;
    expert_ids: (T * topk,) with ``num_experts`` as the sentinel; weights:
    (T, topk), T a multiple of W. Returns (T, H) in ``act.dtype``, rank
    r's rows the r-th block of T / W."""
    if impl == "auto":
        raise NotImplementedError(
            "moe_reduce_rs impl='auto' measures ring against fused through "
            "the autotuner, which is not ported yet (ROADMAP.md, Queue A "
            "item 19)")
    if impl not in ("ring", "xla", "fused"):
        raise ValueError(f"unknown moe_reduce_rs impl {impl!r}")
    world = ctx.world_size
    _check_operands(act, w_down, expert_ids, weights)
    if world != 1:
        t = weights.shape[0]
        if t % world or act.shape[1] % world:
            raise ValueError(f"moe_reduce_rs at world {world} needs T "
                             f"({t}) and I ({act.shape[1]}) to split over "
                             f"the ranks")
        if act.device.type == "cpu":
            if impl == "fused":
                return moe_reduce_rs_fused_world_reference(
                    act, w_down, expert_ids, weights, ctx.num_experts, world)
            return moe_reduce_rs_world_reference(
                act, w_down, expert_ids, weights, ctx.num_experts, world,
                impl)
        if impl == "fused":
            return launch_moe_rs_ring(act, w_down, expert_ids, weights, ctx)
        parts = [launch_moe_rs(a, wd, expert_ids, weights, ctx.num_experts,
                               round_pairs=True)
                 for a, wd in _rank_shards(act, w_down, world)]
        return _reduce_ranks(parts, impl)
    round_pairs = impl in ROUNDED_IMPLS
    if act.device.type == "cpu":
        return moe_reduce_rs_reference(act, w_down, expert_ids, weights,
                                       ctx.num_experts, round_pairs)
    return launch_moe_rs(act, w_down, expert_ids, weights, ctx.num_experts,
                         round_pairs)


def launch_moe_rs(act: torch.Tensor, w_down: torch.Tensor,
                  expert_ids: torch.Tensor, weights: torch.Tensor,
                  num_experts: int, round_pairs: bool) -> torch.Tensor:
    """One call of the MoE-reduce kernel on CUDA tensors (checked by the
    caller), counted in :data:`moe_rs_launches`."""
    if act.device.type != "cuda":
        raise ValueError(f"moe_reduce_rs runs on CUDA or the CPU, not "
                         f"{act.device}")
    if act.dtype not in _DTYPE_CODES:
        raise ValueError(f"moe_reduce_rs kernel takes bf16 or f32, not "
                         f"{act.dtype}")
    if act.stride(1) != 1 or w_down.stride(2) != 1 or \
            w_down.stride(1) != w_down.shape[2]:
        raise ValueError("moe_reduce_rs kernel needs contiguous rows of act "
                         "and w_down (a row shard of the experts has them)")
    lib = _lib()
    t, k = weights.shape
    i, h = w_down.shape[1], w_down.shape[2]
    out = torch.empty((t, h), dtype=act.dtype, device=act.device)
    if t == 0:
        return out
    act, w_down = aligned16(act), aligned16(w_down)
    # The plan of the grouped down product: the same header plans both.
    strides = (act.stride(0), h, w_down.stride(0))
    p = plan(t * k, num_experts, i, h, act.dtype, strides)
    ws = torch.empty((t * k, h), device=act.device,
                     dtype=act.dtype if round_pairs else torch.float32)
    ids = expert_ids.reshape(-1).to(torch.int32).contiguous()
    wts = weights.to(torch.float32).contiguous()
    sched = schedule_buffer(t * k, p, act.device)
    stream = torch.cuda.current_stream(act.device).cuda_stream
    _check(lib, lib.tdt_moe_rs(act.data_ptr(), ids.data_ptr(), wts.data_ptr(),
                               w_down.data_ptr(), ws.data_ptr(),
                               out.data_ptr(), sched.data_ptr(), t, k,
                               num_experts, i, h, act.stride(0),
                               w_down.stride(0), int(round_pairs),
                               _DTYPE_CODES[act.dtype], stream))
    moe_rs_launches.add((p.path, p.m_blk,
                         "rounded" if round_pairs else "f32", t * k, i, h))
    return out


def launch_moe_rs_ring(act: torch.Tensor, w_down: torch.Tensor,
                       expert_ids: torch.Tensor, weights: torch.Tensor,
                       ctx: MoEReduceRSContext,
                       fault: bool = False) -> torch.Tensor:
    """One call of ``csrc/moe_rs_ring.cu`` over every rank of ``ctx``
    (operands checked by the caller: T and I split over the W ranks):
    the pairs' expert schedule, then one cooperative launch; counted once
    in :data:`moe_rs_ring_launches`. act (T k, I) and w_down (E, I, H)
    are CUDA, bf16 or f32, contiguous. Returns the global (T, H), rank
    r's rows the r-th block. ``fault`` plants the kernel's test fault
    (rank 0's first push skipped, its signal still set)."""
    _check_cuda(act)
    if not (act.is_contiguous() and w_down.is_contiguous()):
        raise ValueError("moe_reduce_rs ring kernel needs contiguous act "
                         "and w_down")
    lib = _ring_lib()
    world = ctx.world_size
    t, k = weights.shape
    e, i, h = w_down.shape
    i_loc, rows = i // world, t // world
    out = torch.empty((t, h), dtype=act.dtype, device=act.device)
    if t == 0:
        return out
    act, w_down = aligned16(act), aligned16(w_down)
    p = plan(t * k, e, i_loc, h, act.dtype, (i, h, i * h))
    ids = expert_ids.reshape(-1).to(torch.int32).contiguous()
    wts = weights.to(torch.float32).contiguous()
    sched = schedule_buffer(t * k, p, act.device)
    pieces = -(-rows * h // PIECE_ELEMS)
    state = ctx.ring_state(act.device)
    prods, recv = ring_workspaces(act, w_down, weights, ctx)
    n_tile_sigs = ctypes.c_int()
    _check(lib, lib.tdt_moe_rs_ring_tile_signals(
        t * k, e, i_loc, h, _DTYPE_CODES[act.dtype], i, h, i * h,
        ctypes.byref(n_tile_sigs)))
    sig = state.signals("moe_rs", n_tile_sigs.value + (world - 1) * pieces)
    # The tables stay referenced until the launch is queued: a freed
    # temporary's memory would be handed to the next one.
    prod_tab = rank_table(prods, world)
    recv_tab = rank_table(recv, world)
    sig_tab = rank_table(sig, world)
    epoch = state.next_epoch()
    stream = torch.cuda.current_stream(act.device).cuda_stream
    _check(lib, lib.tdt_moe_rs_ring(
        act.data_ptr(), ids.data_ptr(), wts.data_ptr(), w_down.data_ptr(),
        out.data_ptr(), prod_tab.data_ptr(), recv_tab.data_ptr(),
        sig_tab.data_ptr(), sched.data_ptr(), world, t, k, e, i, h, pieces,
        PIECE_ELEMS, _DTYPE_CODES[act.dtype], epoch, int(fault), stream))
    moe_rs_ring_launches.add((p.path, p.m_blk, world, t * k, i, h))
    return out


def ring_workspaces(act: torch.Tensor, w_down: torch.Tensor,
                    weights: torch.Tensor, ctx: MoEReduceRSContext) -> tuple:
    """The ring kernel's (W, row) workspaces in ``ctx``'s state: every
    rank's f32 pair products (T k, H), and its W - 1 receive slots of a
    chunk partial (T / W, H) in ``act.dtype``; each row ends in the NaN
    canary tail (``RingState``)."""
    world = ctx.world_size
    t, k = weights.shape
    h = w_down.shape[2]
    state = ctx.ring_state(act.device)
    return (state.workspace(t * k * h, torch.float32),
            state.workspace(max(world - 1, 1) * (t // world) * h,
                            act.dtype))


def _check_cuda(act: torch.Tensor) -> None:
    if act.device.type != "cuda":
        raise ValueError(f"moe_reduce_rs runs on CUDA or the CPU, not "
                         f"{act.device}")
    if act.dtype not in _DTYPE_CODES:
        raise ValueError(f"moe_reduce_rs kernel takes bf16 or f32, not "
                         f"{act.dtype}")


def _check_operands(act, w_down, expert_ids, weights) -> None:
    if act.dim() != 2 or w_down.dim() != 3 or weights.dim() != 2:
        raise ValueError(f"moe_reduce_rs needs act (T*k, I), w_down (E, I, "
                         f"H) and weights (T, k), got {tuple(act.shape)}, "
                         f"{tuple(w_down.shape)} and {tuple(weights.shape)}")
    t, k = weights.shape
    if act.shape[0] != t * k or expert_ids.numel() != t * k or \
            w_down.shape[1] != act.shape[1]:
        raise ValueError(f"moe_reduce_rs: act {tuple(act.shape)}, ids "
                         f"{expert_ids.numel()}, w_down "
                         f"{tuple(w_down.shape)} do not fit weights "
                         f"{tuple(weights.shape)}")
    if w_down.dtype != act.dtype:
        raise ValueError(f"moe_reduce_rs needs one dtype, got {act.dtype} "
                         f"and {w_down.dtype}")
    if any(x.device != act.device for x in (w_down, expert_ids, weights)):
        raise ValueError("moe_reduce_rs operands on more than one device")


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.tdt_error_string(err).decode()
        raise RuntimeError(f"moe_rs kernel call failed: {msg} ({err})")


def _ring_lib() -> ctypes.CDLL:
    lib = _build.load("moe_rs_ring")
    if lib.tdt_moe_rs_ring.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.tdt_moe_rs_ring_tile_signals.argtypes = ([i] * 5 + [ll] * 3
                                                     + [ctypes.POINTER(i)])
        lib.tdt_moe_rs_ring_tile_signals.restype = i
        lib.tdt_moe_rs_ring_grid.argtypes = ([i] * 6 + [ll] * 3
                                             + [ctypes.POINTER(i)])
        lib.tdt_moe_rs_ring_grid.restype = i
        lib.tdt_moe_rs_ring.argtypes = ([p] * 9 + [i] * 7
                                        + [ll, i, ctypes.c_ulonglong, i, p])
        lib.tdt_moe_rs_ring.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_rs")
    if lib.tdt_moe_rs.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.tdt_moe_rs.argtypes = [p] * 7 + [i] * 5 + [ll, ll, i, i, p]
        lib.tdt_moe_rs.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
