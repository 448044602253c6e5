"""Point-to-point pipeline transfers (the port of
``triton_dist_tpu.ops.p2p``).

``pp_shift(x, ctx, delta, impl)`` moves every rank's block of ``x`` one
pipeline hop: ``x`` is the global (W rows, ...) tensor whose row block r
is rank r's (JAX shards it ``P(axis)``), and in the result rank i holds
what rank i - delta held. The wrap entry (rank 0 for delta = +1) carries
rank W - 1's block, the bubble slot of a pipeline schedule.

* at world 1 it returns ``x`` and launches nothing, as JAX's does
  (:101-102);
* ``impl="xla"`` is the plain roll (:func:`pp_shift_reference`), the
  counterpart of JAX's ``lax.ppermute``;
* ``impl="pallas"`` launches ``csrc/p2p.cu`` (``tdt_shift_world``) on a
  CUDA tensor, the port of ``_shift_kernel`` (:70), counted in
  :data:`pp_shift_launches`, and takes the plain roll on a CPU tensor.

The same kernel serves ``serving.kv_stream.symm_ship`` (JAX's
``_ship_kernel``, the same protocol under another collective id):
:func:`launch_shift` takes the launch counter of its caller.

JAX's ``@resilient("pp_shift")`` routing has no counterpart: no entry
point of the port routes around a kernel (ROADMAP.md, deliberate
divergences). JAX's impl argument takes anything that is not "xla" as
"pallas"; the port raises ``ValueError`` on an unknown impl.
"""

from __future__ import annotations

import ctypes
import dataclasses
import typing

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import LaunchCount
from triton_dist_tpu_torch.runtime.dist import RankGroup
from triton_dist_tpu_torch.runtime.symm_mem import RingState, rank_span

#: Launches of the shift kernel through :func:`pp_shift`, by (W, rows, row
#: bytes).
pp_shift_launches = LaunchCount()

IMPLS = ("pallas", "xla")


@dataclasses.dataclass
class P2PContext:
    """The ranks of the pipeline axis. ``group`` sets ``world_size`` and
    keeps the kernel's signals and call counter (``state``, made at the
    first CUDA call) across calls; a context without one runs the plain
    versions at ``world_size`` on the CPU."""
    group: RankGroup | None = None
    axis: str = "pp"
    world_size: int = 1
    state: RingState | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.group is not None:
            if self.world_size not in (1, self.group.world):
                raise ValueError(f"world_size {self.world_size} and a group "
                                 f"of {self.group.world} ranks disagree")
            self.world_size = self.group.world
        if self.world_size < 1:
            raise ValueError(f"world_size must be >= 1, got "
                             f"{self.world_size}")


def create_p2p_context(group: RankGroup | None = None, axis: str = "pp",
                       world_size: int = 1) -> P2PContext:
    """A context over ``group`` (JAX: over a mesh axis; ``None``:
    ``world_size`` ranks, plain versions only)."""
    return P2PContext(group=group, axis=axis, world_size=world_size)


def shift_partners(me: int, delta: int, world: int) -> tuple:
    """(dst, src) of one pipeline hop: push to ``me + delta``, receive
    from ``me - delta``. A copy of JAX's ``shift_partners`` (:58) on
    Python ints, with its ``span`` keeping the remainder's argument
    non-negative; ``csrc/p2p.cu`` (``partner``) computes dst by the same
    rule."""
    span = (abs(delta) // world + 1) * world
    return (me + delta + span) % world, (me - delta + span) % world


def block_rows(x: torch.Tensor, world: int) -> int:
    """Rows of one rank's block of ``x``; ``ValueError`` when the leading
    dimension does not split over ``world`` ranks (JAX's shard_map
    raises)."""
    if x.dim() == 0 or x.shape[0] % world:
        raise ValueError(f"{tuple(x.shape)} does not split into {world} row "
                         f"blocks")
    return x.shape[0] // world


def pp_shift_reference(x: torch.Tensor, world: int,
                       delta: int) -> torch.Tensor:
    """Plain version: ``torch.roll`` of the (W, rows / W, ...) view of
    ``x`` by ``delta`` along its rank dimension, as a new tensor shaped
    like ``x``."""
    rows = block_rows(x, world)
    view = x.reshape(world, rows, *x.shape[1:])
    return torch.roll(view, delta, 0).reshape(x.shape)


def pp_shift(x: torch.Tensor, ctx: P2PContext | None = None, delta: int = 1,
             impl: str = "pallas") -> torch.Tensor:
    """Shift per-stage activations one pipeline hop (JAX ``pp_shift``
    :86; the reference's ``p2p_copy_kernel`` push).

    Args:
      x: (W rows, ...), row block r is rank r's activations.
      delta: +1 forward (stage i -> i + 1), -1 backward; any int.
    Returns:
      the same layout; rank i now holds what rank i - delta had (``x``
      itself at world 1)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown pp_shift impl {impl!r}")
    ctx = ctx or create_p2p_context()
    world = ctx.world_size
    if world == 1:
        return x
    if impl == "xla" or x.device.type == "cpu":
        return pp_shift_reference(x, world, delta)
    return launch_shift(x, ctx, delta, pp_shift_launches)


def launch_shift(x: torch.Tensor, ctx: P2PContext, delta: int,
                 counter: LaunchCount, out: torch.Tensor | None = None,
                 fault: bool = False) -> torch.Tensor:
    """One launch of the shift kernel over every rank of ``ctx.group`` on
    a CUDA tensor, counted in ``counter`` by (W, rows, row bytes).
    Returns the shifted tensor: ``out`` when given (a contiguous tensor
    shaped like ``x``, e.g. NaN-filled to show a missing push), else a
    new one. ``fault`` plants the test fault (rank 0's push of its first
    piece skipped, its signal still set)."""
    if x.device.type != "cuda":
        raise ValueError(f"the shift kernel runs on CUDA, not {x.device}")
    if ctx.group is None or ctx.world_size < 2:
        raise ValueError("the shift kernel needs a context over a group of "
                         "at least two ranks")
    if not x.is_contiguous():
        raise ValueError("the shift kernel needs a contiguous input")
    world = ctx.world_size
    rows = block_rows(x, world)
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {x.dtype} tensor of "
                         f"shape {tuple(x.shape)} on {x.device}")
    chunk = x.numel() * x.element_size() // world
    lib = _lib()
    if ctx.state is None:
        ctx.state = RingState(ctx.group)
    sig = ctx.state.signals("p2p", shift_grid(x, world).pieces)
    epoch = ctx.state.next_epoch()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(lib, lib.tdt_shift_world(
        x.data_ptr(), *rank_span(out, world), *rank_span(sig, world), chunk,
        world, delta, epoch, int(fault), stream))
    counter.add((world, rows, chunk // max(rows, 1)))
    return out


class ShiftPlan(typing.NamedTuple):
    """The launch plan of a shift (``tdt_shift_grid``)."""
    grid: int          # blocks: W x pieces pushes, then W waits
    resident: int      # blocks the card holds at once
    piece: int         # bytes of a piece
    pieces: int        # pieces of one rank's block


def shift_grid(x: torch.Tensor, world: int) -> ShiftPlan:
    """The card's plan of the shift of ``x`` over ``world`` ranks: a push
    block for every piece (up to 16 KiB) of every rank's block (larger pieces
    while the blocks would not all be resident) and a wait block a
    rank."""
    lib = _lib()
    grid, resident = ctypes.c_int(), ctypes.c_int()
    piece, pieces = ctypes.c_longlong(), ctypes.c_longlong()
    _check(lib, lib.tdt_shift_grid(
        x.numel() * x.element_size() // world, world, ctypes.byref(grid),
        ctypes.byref(resident), ctypes.byref(piece), ctypes.byref(pieces)))
    return ShiftPlan(grid.value, resident.value, piece.value, pieces.value)


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"p2p kernel call failed: "
                           f"{lib.tdt_error_string(err).decode()} ({err})")


def _lib() -> ctypes.CDLL:
    lib = _build.load("p2p")
    if lib.tdt_shift_world.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tdt_shift_grid.argtypes = [ll, i, ctypes.POINTER(i),
                                       ctypes.POINTER(i), ctypes.POINTER(ll),
                                       ctypes.POINTER(ll)]
        lib.tdt_shift_grid.restype = i
        lib.tdt_shift_world.argtypes = [p, p, ll, p, ll, ll, i, ll,
                                        ctypes.c_ulonglong, i, p]
        lib.tdt_shift_world.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
