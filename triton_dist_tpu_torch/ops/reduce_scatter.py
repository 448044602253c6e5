"""Reduce-scatter (the port of ``triton_dist_tpu.ops.reduce_scatter``).

``reduce_scatter(x, ctx, impl="pallas")`` sums the W per-rank partials of
``x`` (W, M, N) and leaves rank r the rows [r M / W, (r + 1) M / W):

* at world 1 it launches the copy kernel of ``csrc/allgather.cu``: the
  world = 1 body of ``_ring_rs_kernel`` (:92) and of
  ``_one_shot_rs_kernel`` (:150) is ``o = x[0 : M]`` (:110-112,
  :157-159);
* at world W it launches ``csrc/reduce_world.cu``
  (``tdt_reduce_scatter_world``), one cooperative launch over every rank
  of the context's group in the method the context resolves: the ring or
  the one-shot push-then-sum (:func:`ReduceScatterContext.resolve_method`,
  JAX's cost model on one chunk's bytes).

Both methods add in the partials' dtype and round after every add, in
their own order, as JAX's kernels do (:func:`reduce_scatter_world_reference`
states the orders), so in bf16 they differ from each other and from
``impl="xla"``, which is ``lax.psum_scatter``: the f32 sum of the
partials in rank order, rounded once (``RankGroup.psum``).

The world-W kernel and ``ops.allreduce``'s share one library; its
launcher (:func:`launch_reduce_world`) and the context's kernel state
(signals, workspaces and the call counter, ``state``) live here.

On a CUDA tensor ``impl="pallas"`` launches a kernel or raises; only a
tensor that lies on the CPU takes the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
import typing

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.allgather import (
    _world_operands, launch_copy, world_state)
from triton_dist_tpu_torch.ops.common import LaunchCount
from triton_dist_tpu_torch.runtime.dist import RankGroup
from triton_dist_tpu_torch.runtime.symm_mem import RingState, rank_span
from triton_dist_tpu_torch.tools.perf_model import (
    ChipSpec, estimate_one_shot_reduce_time_ms,
    estimate_reduce_scatter_time_ms)

#: Launches of the reduce-scatter: the world = 1 copy by (method, rows, N,
#: dtype), the world-W kernel by (method, W, M, N, dtype).
reduce_scatter_launches = LaunchCount()


class ReduceScatterMethod(enum.Enum):
    AUTO = "auto"
    RING = "ring"
    ONE_SHOT = "one_shot"


#: The world-W kernel's kinds (``csrc/reduce_world.cu``): (op, method).
KINDS = {("reduce_scatter", "one_shot"): 0, ("reduce_scatter", "ring"): 1,
         ("all_reduce", "one_shot"): 2, ("all_reduce", "two_shot"): 3,
         ("all_reduce", "recursive_doubling"): 4}
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


@dataclasses.dataclass
class ReduceScatterContext:
    """The JAX context: the axis, its ranks and the method.

    ``group`` (the ranks of the axis) sets ``world_size`` and keeps the
    world-W kernel's signals, workspaces and call counter (``state``)
    across calls; a context without one runs the plain versions at
    ``world_size`` on the CPU."""
    world_size: int = 1
    axis: str = "tp"
    method: ReduceScatterMethod = ReduceScatterMethod.AUTO
    group: RankGroup | None = None
    state: RingState | None = dataclasses.field(default=None, init=False,
                                                repr=False)

    def __post_init__(self):
        self.state = world_state(self, self.group)

    def resolve_method(self, nbytes_per_chunk: int,
                       spec: ChipSpec | None = None) -> ReduceScatterMethod:
        """JAX's choice (``resolve_method`` :62-78) on one rank's chunk:
        the given method, else one-shot at world <= 2, else whichever of
        the one-shot and the ring the cost model (by default the one-card
        H100 spec) prices lower, one-shot on a tie."""
        if self.method is not ReduceScatterMethod.AUTO:
            return self.method
        if self.world_size <= 2:
            return ReduceScatterMethod.ONE_SHOT
        t_one = estimate_one_shot_reduce_time_ms(nbytes_per_chunk,
                                                 self.world_size, spec)
        t_ring = estimate_reduce_scatter_time_ms(nbytes_per_chunk,
                                                 self.world_size, spec)
        return (ReduceScatterMethod.ONE_SHOT if t_one <= t_ring
                else ReduceScatterMethod.RING)


def create_reduce_scatter_context(
        axis: str = "tp",
        method: ReduceScatterMethod = ReduceScatterMethod.AUTO,
        world_size: int = 1,
        group: RankGroup | None = None) -> ReduceScatterContext:
    """The context over ``group`` (JAX ``create_reduce_scatter_context``
    over a mesh axis; ``None``: ``world_size`` ranks, plain versions
    only)."""
    return ReduceScatterContext(world_size=world_size, axis=axis,
                                method=method, group=group)


def add_rounded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` as JAX's kernels add: in f32, rounded to ``a.dtype``."""
    return (a.float() + b.float()).to(a.dtype)


def reduce_scatter_world_reference(x: torch.Tensor,
                                   method: ReduceScatterMethod
                                   ) -> torch.Tensor:
    """Plain version: the (M, N) sums of the W partials of ``x`` (W, M,
    N), chunk c of M / W rows rank c's, each add rounded to the dtype, in
    the method's order (at world 1 a copy of ``x[0]``). Ring: chunk c
    starts as rank c + 1's rows and travels right, adding rank c + h's
    for h = 2..W (JAX :120-141). One-shot: ranks 0..W-1 in order
    (:182-185)."""
    w, m, n = x.shape
    chunks = x.reshape(w, w, m // w, n)              # [rank, chunk]
    c = torch.arange(w, device=x.device)
    if method is ReduceScatterMethod.RING:
        acc = chunks[(c + 1) % w, c]
        for h in range(2, w + 1):
            acc = add_rounded(acc, chunks[(c + h) % w, c])
    else:
        acc = chunks[0]
        for r in range(1, w):
            acc = add_rounded(acc, chunks[r])
    return acc.reshape(m, n).clone()


def reduce_scatter(x: torch.Tensor, ctx: ReduceScatterContext | None = None,
                   impl: str = "pallas") -> torch.Tensor:
    """Reduce the per-rank partials of ``x`` (W, M, N) and scatter the
    rows: rank i gets the summed rows [i M / W, (i + 1) M / W), returned
    as (M, N) rows sharded over ``ctx.axis``. M not divisible by W raises
    ``ValueError``, as JAX asserts (:214).

    ``impl="pallas"``: a new tensor, written on CUDA by the copy kernel at
    world 1 and by the world-W kernel at world W (counted in
    :data:`reduce_scatter_launches` under the method it ran), by the plain
    version on the CPU. ``impl="xla"``: the f32 sum rounded once (a view
    of ``x`` at world 1)."""
    ctx = ctx or create_reduce_scatter_context()
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown reduce_scatter impl {impl!r}")
    world = ctx.world_size
    if x.dim() != 3 or x.shape[0] != world:
        raise ValueError(f"reduce_scatter takes (world, M, N) partials, got "
                         f"{tuple(x.shape)} at world {world}")
    m, n = x.shape[1], x.shape[2]
    if m % world:
        raise ValueError(f"{m} rows do not split over {world} ranks")
    method = ctx.resolve_method(m // world * n * x.element_size())
    if impl == "xla":
        if world == 1:
            return x.reshape(m, n)
        return (ctx.group or RankGroup(world, ctx.axis, x.device)).psum(
            list(x))
    if x.device.type == "cpu":
        return reduce_scatter_world_reference(x, method)
    dtype = str(x.dtype).removeprefix("torch.")
    if world == 1:
        out = launch_copy(x[0])
        reduce_scatter_launches.add((method.value, m, n, dtype))
        return out
    out = launch_reduce_world(x, ctx, "reduce_scatter", method.value)
    reduce_scatter_launches.add((method.value, world, m, n, dtype))
    return out


def world_buffers(x: torch.Tensor, state: RingState, kind: int) -> tuple:
    """(workspace, signals) of a world-W call of ``kind`` on ``x`` in
    ``state``: the (W, row) workspace in ``x.dtype`` (stage or receive
    slots, NaN-filled when made, each row ending in the NaN canary tail)
    and the (W, count) signals, one a hop of each piece of the card's plan
    (:func:`world_grid`). The one-shots' stage slot [r] of rank r is never
    written."""
    lib = _lib()
    world, elems = x.shape[0], x[0].numel()
    ws = state.workspace(lib.tdt_reduce_world_workspace(kind, world, elems),
                         x.dtype)
    return ws, state.signals("reduce", _plan(x, kind).signals)


def launch_reduce_world(x: torch.Tensor, ctx, op: str, method: str,
                        out: torch.Tensor | None = None,
                        fault: bool = False,
                        straggler: tuple | None = None) -> torch.Tensor:
    """One launch of ``csrc/reduce_world.cu`` over every rank of
    ``ctx.group`` on a CUDA tensor ``x`` (W, M, N), bf16 or f32,
    contiguous; ``op`` "reduce_scatter" (method "one_shot" or "ring") or
    "all_reduce" (method "one_shot", "two_shot" or "recursive_doubling").
    Counts nothing: the op counts its launch. Returns the (M, N)
    reduce-scatter or the (W, M, N) copies of the all-reduce: ``out`` when
    given (a contiguous tensor of that shape, e.g. NaN-filled to show a
    missing write), else a new one. ``fault`` plants the kernel's test
    fault (rank 0's first push of its first piece skipped, its signal
    still set); ``straggler`` is JAX's ``straggler_option``, (rank,
    cycles)."""
    state = _world_operands(x, ctx)
    kind = KINDS.get((op, method))
    if kind is None:
        raise ValueError(f"the world-W kernel runs {sorted(KINDS)}, not "
                         f"{(op, method)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the world-W kernel takes bf16 or f32, not "
                         f"{x.dtype}")
    world, m, n = x.shape
    rank, cycles = straggler if straggler is not None else (-1, 0)
    if not (-1 <= rank < world and cycles >= 0):
        raise ValueError(f"straggler {straggler} out of range for world "
                         f"{world}")
    lib = _lib()
    shape = (m, n) if op == "reduce_scatter" else (world, m, n)
    if out is None:
        out = x.new_empty(shape)
    elif (tuple(out.shape) != shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {x.dtype} tensor of "
                         f"shape {shape} on {x.device}")
    ws, sig = world_buffers(x, state, kind)
    epoch = state.next_epoch()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = (lib.tdt_reduce_scatter_world if op == "reduce_scatter"
             else lib.tdt_all_reduce_world)
    _check(lib, entry(
        x.data_ptr(), *rank_span(out, world), *rank_span(ws, world),
        *rank_span(sig, world), m * n, world,
        kind - KINDS[(op, "one_shot")], _DTYPE_CODES[x.dtype], rank, cycles,
        epoch, int(fault), stream))
    return out


class WorldPlan(typing.NamedTuple):
    """The world-W launch plan of a call (``tdt_reduce_world_grid``)."""
    grid: int          # blocks of the cooperative launch, all resident
    resident: int      # blocks the card holds at once
    piece: int         # elements of a piece
    pieces: int        # pieces of a unit (a chunk, or a whole partial)
    signals: int       # signals of a rank's row: one a hop of each piece


def world_grid(x: torch.Tensor, op: str, method: str) -> WorldPlan:
    """The card's plan of a world-W call on ``x`` (W, M, N): a block for
    every piece of every rank, pieces of at most 4 KiB, larger while
    those blocks would not all be resident."""
    return _plan(x, KINDS[(op, method)])


def _plan(x: torch.Tensor, kind: int) -> WorldPlan:
    lib = _lib()
    grid, resident = ctypes.c_int(), ctypes.c_int()
    piece, pieces = ctypes.c_longlong(), ctypes.c_longlong()
    signals = ctypes.c_longlong()
    _check(lib, lib.tdt_reduce_world_grid(
        kind, x.shape[0], x[0].numel(), _DTYPE_CODES[x.dtype],
        ctypes.byref(grid), ctypes.byref(resident), ctypes.byref(piece),
        ctypes.byref(pieces), ctypes.byref(signals)))
    return WorldPlan(grid.value, resident.value, piece.value, pieces.value,
                     signals.value)


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"reduce_world kernel call failed: "
                           f"{lib.tdt_error_string(err).decode()} ({err})")


def _lib() -> ctypes.CDLL:
    lib = _build.load("reduce_world")
    if lib.tdt_reduce_scatter_world.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tdt_reduce_world_workspace.argtypes = [i, i, ll]
        lib.tdt_reduce_world_workspace.restype = ll
        lib.tdt_reduce_world_grid.argtypes = [
            i, i, ll, i, ctypes.POINTER(i), ctypes.POINTER(i),
            ctypes.POINTER(ll), ctypes.POINTER(ll), ctypes.POINTER(ll)]
        lib.tdt_reduce_world_grid.restype = i
        for name in ("tdt_reduce_scatter_world", "tdt_all_reduce_world"):
            getattr(lib, name).argtypes = [p, p, ll, p, ll, p, ll, ll, i, i,
                                           i, i, ll, ctypes.c_ulonglong, i,
                                           p]
            getattr(lib, name).restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
