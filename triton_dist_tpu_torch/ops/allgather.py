"""All-gather and broadcast (the port of ``triton_dist_tpu.ops.allgather``).

``all_gather(x, ctx, impl="pallas")`` gathers the row chunks of ``x``,
one per rank of ``ctx``'s group, onto every rank:

* at world 1 it launches the copy kernel of ``csrc/allgather.cu``
  (``tdt_copy``), the world = 1 body of the Pallas kernels
  ``_full_mesh_push_kernel`` (:254) and ``_ring_ag_kernel`` (:133);
* at world W it launches the world-W kernel (``tdt_all_gather_world``),
  one cooperative launch over every rank in the method the context
  resolves: the full-mesh push, the ring or the bidirectional ring
  (:func:`get_auto_all_gather_method`, JAX's cost model).

``broadcast(x, root, ctx, impl="pallas")`` puts rank ``root``'s chunk on
every rank: the copy kernel at world 1, ``tdt_broadcast_world`` (the
port of ``_broadcast_kernel``, :218) at world W. ``impl="xla"`` is
``lax.all_gather`` / the masked ``psum``: plain torch, no kernel.

Ranks are the W slices of one card (``runtime.dist``): the input is the
global (W rows, ...) tensor whose chunk r is rank r's, and the world-W
kernels write one output buffer per rank, a (W, ...) tensor whose row r
is rank r's copy (``stacked``, as JAX's ``stacked=True``); a replicated
result is one shared tensor, rank 0's copy. The context over a
``RankGroup`` keeps the kernels' signals, their device table and the call
counter (``state``) across calls; each call's outputs are fresh tensors,
reached by the kernel from row 0's address and the row step, so a world-W
call queues its one kernel and nothing else.

The copy kernel (:func:`launch_copy`) also serves the world = 1 bodies of
``ops.allreduce`` and ``ops.reduce_scatter``; each op counts its own
launches.

On a CUDA tensor ``impl="pallas"`` launches a kernel or raises; only a
tensor that lies on the CPU takes the plain version
(:func:`all_gather_reference`, :func:`broadcast_reference`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import LaunchCount, num_sms
from triton_dist_tpu_torch.runtime.dist import RankGroup
from triton_dist_tpu_torch.runtime.symm_mem import RingState, rank_span
from triton_dist_tpu_torch.tools.perf_model import (
    ChipSpec, estimate_all_gather_time_ms, estimate_full_mesh_push_time_ms)

#: Launches of the all-gather kernels: the world = 1 copy by (rows, row
#: bytes), the world-W kernel by (method, W, rows, row bytes).
all_gather_launches = LaunchCount()
#: Launches of the broadcast: the world = 1 copy by (rows, row bytes),
#: the world-W kernel by ("broadcast", W, rows, row bytes).
broadcast_launches = LaunchCount()


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    RING_1D = "ring_1d"
    RING_BIDIR = "ring_bidir"
    FULL_MESH_PUSH = "full_mesh_push"
    BROADCAST = "broadcast"


#: The world-W kernel's method codes.
_METHOD_CODES = {AllGatherMethod.FULL_MESH_PUSH: 0,
                 AllGatherMethod.RING_1D: 1,
                 AllGatherMethod.RING_BIDIR: 2}


def get_auto_all_gather_method(world_size: int, nbytes_per_rank: int,
                               spec: ChipSpec | None = None
                               ) -> AllGatherMethod:
    """JAX's method choice (``get_auto_all_gather_method``, :73-91): the
    full-mesh push at world <= 2, else whichever of the push and the
    bidirectional ring the cost model (``tools.perf_model``, by default
    the one-card H100 spec) prices lower, the push on a tie."""
    if world_size <= 2:
        return AllGatherMethod.FULL_MESH_PUSH
    t_fm = estimate_full_mesh_push_time_ms(nbytes_per_rank, world_size,
                                           spec)
    t_ring = estimate_all_gather_time_ms(nbytes_per_rank, world_size,
                                         spec, bidir=True)
    return (AllGatherMethod.FULL_MESH_PUSH if t_fm <= t_ring
            else AllGatherMethod.RING_BIDIR)


@dataclasses.dataclass
class AllGatherContext:
    """The JAX context: the axis, its ranks and the method.

    ``group`` (the ranks of the axis) sets ``world_size`` and keeps the
    world-W kernels' signals and call counter (``state``) across calls;
    a context without one runs the plain versions at ``world_size`` on
    the CPU."""
    world_size: int = 1
    axis: str = "tp"
    method: AllGatherMethod = AllGatherMethod.AUTO
    group: RankGroup | None = None
    state: RingState | None = dataclasses.field(default=None, init=False,
                                                repr=False)

    def __post_init__(self):
        self.state = world_state(self, self.group)

    def resolve_method(self, nbytes_per_rank: int) -> AllGatherMethod:
        if self.method is AllGatherMethod.AUTO:
            return get_auto_all_gather_method(self.world_size,
                                              nbytes_per_rank)
        return self.method


def world_state(ctx, group: RankGroup | None) -> RingState | None:
    """A collective context's world-W kernel state over ``group``, which
    sets ``ctx.world_size`` (``None``: no state, the plain versions)."""
    if group is not None:
        if ctx.world_size not in (1, group.world):
            raise ValueError(f"world_size {ctx.world_size} and a group of "
                             f"{group.world} ranks disagree")
        ctx.world_size = group.world
    if ctx.world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {ctx.world_size}")
    return RingState(group) if group is not None else None


def create_allgather_context(axis: str = "tp",
                             method: AllGatherMethod = AllGatherMethod.AUTO,
                             world_size: int = 1,
                             group: RankGroup | None = None
                             ) -> AllGatherContext:
    """The context over ``group`` (JAX ``create_allgather_context`` over a
    mesh axis; ``None``: ``world_size`` ranks, plain versions only)."""
    return AllGatherContext(world_size=world_size, axis=axis, method=method,
                            group=group)


def _split(x: torch.Tensor, world: int) -> int:
    """Rows of one rank's chunk of ``x``; raises when they do not split."""
    if x.dim() == 0 or x.shape[0] % world:
        raise ValueError(f"{tuple(x.shape)} does not split into {world} row "
                         f"chunks")
    return x.shape[0] // world


def all_gather_reference(x: torch.Tensor, world: int = 1,
                         stacked: bool = False) -> torch.Tensor:
    """Plain version: every rank's copy is its ranks' chunks joined in
    rank order. ``stacked``: the (W, rows, ...) copies; else one copy."""
    rows = _split(x, world)
    chunks = [x[r * rows:(r + 1) * rows] for r in range(world)]
    if not stacked:
        return torch.cat(chunks)
    return torch.stack([torch.cat(chunks) for _ in range(world)])


def all_gather(x: torch.Tensor, ctx: AllGatherContext | None = None,
               impl: str = "pallas", stacked: bool = False) -> torch.Tensor:
    """Gather ``x`` (rows sharded over ``ctx.axis``) onto every rank (JAX
    ``all_gather`` :306): the gathered (rows, ...) tensor, replicated, or
    with ``stacked`` every rank's copy as one (W, rows, ...) tensor.

    ``impl="pallas"``: new tensors, written on CUDA by the copy kernel at
    world 1 and by the world-W kernel at world W (counted in
    :data:`all_gather_launches`), by :func:`all_gather_reference` on the
    CPU. ``impl="xla"``: ``x`` itself (stacked: W views of it)."""
    ctx = ctx or create_allgather_context()
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown all_gather impl {impl!r}")
    world = ctx.world_size
    _split(x, world)
    if impl == "xla":
        return x.expand(world, *x.shape) if stacked else x
    method = ctx.resolve_method(x.numel() // world * x.element_size())
    if method is AllGatherMethod.BROADCAST:
        raise ValueError("BROADCAST is one-to-all, not an all-gather: call "
                         "ops.allgather.broadcast(x, root, ctx) instead")
    if x.device.type == "cpu":
        return all_gather_reference(x, world, stacked)
    if world == 1:
        out = launch_all_gather(x)
        return out[None] if stacked else out
    out = launch_all_gather_world(x, ctx, method)
    return out if stacked else out[0]


def _row_key(x: torch.Tensor) -> tuple:
    """(rows, row bytes) of ``x``: a launch counter's key."""
    rows = x.shape[0] if x.dim() else 1
    return rows, x.numel() * x.element_size() // max(rows, 1)


def launch_all_gather(x: torch.Tensor) -> torch.Tensor:
    """One launch of the copy kernel on a CUDA tensor: rank 0's chunk
    into the gathered (rows, ...) buffer."""
    out = launch_copy(x)
    all_gather_launches.add(_row_key(x))
    return out


def _world_operands(x: torch.Tensor, ctx: AllGatherContext) -> RingState:
    if x.device.type != "cuda":
        raise ValueError(f"the world-W kernels run on CUDA, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("the world-W kernels need a contiguous input")
    if ctx.state is None or ctx.world_size < 2:
        raise ValueError("the world-W kernels need a context over a group "
                         "of at least two ranks")
    return ctx.state


def launch_all_gather_world(x: torch.Tensor, ctx: AllGatherContext,
                            method: AllGatherMethod,
                            out: torch.Tensor | None = None,
                            fault: bool = False) -> torch.Tensor:
    """One launch of the world-W all-gather over every rank of
    ``ctx.group`` on a CUDA tensor, counted in
    :data:`all_gather_launches`. Returns every rank's copy as one (W,
    rows, ...) tensor: ``out`` when given (a contiguous tensor of that
    shape, e.g. NaN-filled to show a missing push), else a new one.
    ``fault`` plants the test fault (rank 0's first push or forward of
    its first piece skipped, its signal still set)."""
    state = _world_operands(x, ctx)
    if method not in _METHOD_CODES:
        raise ValueError(f"the world-W all-gather runs "
                         f"{[m.value for m in _METHOD_CODES]}, not "
                         f"{method.value}")
    world = ctx.world_size
    _split(x, world)
    lib = _lib()
    out = _world_out(x, (world, *x.shape), out)
    chunk = x.numel() * x.element_size() // world
    sig_tab = state.table(state.signals(
        "ag", lib.tdt_gather_signals(chunk, world)))
    out_base, out_step = rank_span(out, world)
    epoch = state.next_epoch()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(lib, lib.tdt_all_gather_world(
        x.data_ptr(), out_base, out_step, sig_tab.data_ptr(), chunk, world,
        _METHOD_CODES[method], epoch, int(fault), stream))
    all_gather_launches.add((method.value, world, *_row_key(x)))
    return out


def _world_out(x: torch.Tensor, shape: tuple,
               out: torch.Tensor | None) -> torch.Tensor:
    if out is None:
        return x.new_empty(shape)
    if tuple(out.shape) != shape or out.dtype != x.dtype or \
            out.device != x.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {x.dtype} tensor of "
                         f"shape {shape} on {x.device}")
    return out


def broadcast_reference(x: torch.Tensor, root: int = 0,
                        world: int = 1) -> torch.Tensor:
    """Plain version: a copy of rank ``root``'s row chunk."""
    rows = _split(x, world)
    return x[root * rows:(root + 1) * rows].clone()


def broadcast(x: torch.Tensor, root: int = 0,
              ctx: AllGatherContext | None = None,
              impl: str = "pallas") -> torch.Tensor:
    """Rank ``root``'s row chunk of ``x`` (W chunks, one per rank of
    ``ctx.axis``) on every rank (JAX ``broadcast`` :373): a (rows, ...)
    tensor, replicated. A root outside the world raises ``ValueError``,
    as in JAX.

    ``impl="pallas"``: a new tensor, written on CUDA by the copy kernel at
    world 1 and by the world-W kernel at world W (rank 0's copy; counted
    in :data:`broadcast_launches`), by :func:`broadcast_reference` on the
    CPU. ``impl="xla"``: JAX's masked psum, the chunks times a one-hot of
    the root summed in rank order (``x`` itself at world 1)."""
    ctx = ctx or create_allgather_context()
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown broadcast impl {impl!r}")
    world = ctx.world_size
    if not 0 <= root < world:
        raise ValueError(f"root {root} out of range for world {world}")
    rows = _split(x, world)
    if impl == "xla":
        if world == 1:
            return x
        parts = [x[r * rows:(r + 1) * rows] * (1 if r == root else 0)
                 for r in range(world)]
        return RankGroup(world, ctx.axis, x.device).psum(parts)
    if x.device.type == "cpu":
        return broadcast_reference(x, root, world)
    if world == 1:
        out = launch_copy(x)
        broadcast_launches.add(_row_key(x))
        return out
    return launch_broadcast_world(x, root, ctx)[0]


def launch_broadcast_world(x: torch.Tensor, root: int,
                           ctx: AllGatherContext,
                           out: torch.Tensor | None = None,
                           fault: bool = False) -> torch.Tensor:
    """One launch of the world-W broadcast over every rank of
    ``ctx.group`` on a CUDA tensor, counted in
    :data:`broadcast_launches`. Returns every rank's copy of the root's
    chunk as one (W, rows, ...) tensor (``out`` when given, as in
    :func:`launch_all_gather_world`). ``fault`` skips the root's first
    push of its first piece, its signal still set."""
    state = _world_operands(x, ctx)
    world = ctx.world_size
    if not 0 <= root < world:
        raise ValueError(f"root {root} out of range for world {world}")
    rows = _split(x, world)
    lib = _lib()
    out = _world_out(x, (world, rows, *x.shape[1:]), out)
    chunk = x.numel() * x.element_size() // world
    sig_tab = state.table(state.signals(
        "ag", lib.tdt_gather_signals(chunk, world)))
    out_base, out_step = rank_span(out, world)
    epoch = state.next_epoch()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(lib, lib.tdt_broadcast_world(
        x.data_ptr(), out_base, out_step, sig_tab.data_ptr(), chunk, world,
        root, epoch, int(fault), stream))
    broadcast_launches.add(("broadcast", world, *_row_key(x)))
    return out


def launch_copy(x: torch.Tensor) -> torch.Tensor:
    """The copy kernel on a CUDA tensor: a new tensor equal to ``x``. It
    counts nothing: the op that calls it counts its own launch."""
    if x.device.type != "cuda":
        raise ValueError(f"the copy kernel runs on CUDA, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("the copy kernel needs a contiguous tensor")
    lib = _lib()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(lib, lib.tdt_copy(x.data_ptr(), out.data_ptr(),
                             x.numel() * x.element_size(),
                             num_sms(x.device.index), stream))
    return out


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"allgather kernel call failed: "
                           f"{lib.tdt_error_string(err).decode()} ({err})")


def _lib() -> ctypes.CDLL:
    lib = _build.load("allgather")
    if lib.tdt_copy.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tdt_copy.argtypes = [p, p, ll, i, p]
        lib.tdt_copy.restype = i
        lib.tdt_gather_signals.argtypes = [ll, i]
        lib.tdt_gather_signals.restype = ll
        lib.tdt_all_gather_world.argtypes = [p, p, ll, p, ll, i, i,
                                             ctypes.c_ulonglong, i, p]
        lib.tdt_all_gather_world.restype = i
        lib.tdt_broadcast_world.argtypes = [p, p, ll, p, ll, i, i,
                                            ctypes.c_ulonglong, i, p]
        lib.tdt_broadcast_world.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
