"""All-gather and broadcast at world = 1 (the port of
``triton_dist_tpu.ops.allgather``).

``all_gather(x, impl="pallas")`` launches the hand-written copy kernel
of ``csrc/allgather.cu``: the world = 1 body of the Pallas kernels
``_full_mesh_push_kernel`` (:254), the method JAX picks at world <= 2,
and ``_ring_ag_kernel`` (:133), whose world = 1 body is the same copy of
this rank's chunk into its slot of the gathered buffer.
``broadcast(x, root, impl="pallas")`` launches the same copy kernel: the
world = 1 body of ``_broadcast_kernel`` (:218), the root's buffer.
``impl="xla"`` is ``lax.all_gather`` / the masked ``psum`` at world = 1:
the identity.

The copy kernel (:func:`launch_copy`) also serves the world = 1 bodies
of ``ops.allreduce`` and ``ops.reduce_scatter``; each op counts its own
launches. The pushes to peers and the ring hops, and every world > 1
call, are not ported yet and raise ``NotImplementedError`` (ROADMAP.md,
Queue B item 8).

On a CUDA tensor ``impl="pallas"`` launches the kernel or raises; only a
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

#: Launches of the all-gather kernel, by (rows, row bytes).
all_gather_launches = LaunchCount()
#: Launches of the broadcast's copy, by (rows, row bytes).
broadcast_launches = LaunchCount()

_UNPORTED = "(ROADMAP.md, Queue B item 8)"


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    RING_1D = "ring_1d"
    RING_BIDIR = "ring_bidir"
    FULL_MESH_PUSH = "full_mesh_push"
    BROADCAST = "broadcast"


def get_auto_all_gather_method(world_size: int,
                               nbytes_per_rank: int) -> AllGatherMethod:
    """JAX's method choice (``get_auto_all_gather_method``, allgather.py
    :67-85) where it needs no perf model: full-mesh push at world <= 2.
    Larger worlds choose by modelled time, which is not ported yet."""
    if world_size <= 2:
        return AllGatherMethod.FULL_MESH_PUSH
    raise NotImplementedError(
        f"the all-gather method choice at world {world_size} is not ported "
        f"yet {_UNPORTED}")


@dataclasses.dataclass
class AllGatherContext:
    """The JAX context at world = 1: the axis name and the method."""
    world_size: int = 1
    axis: str = "tp"
    method: AllGatherMethod = AllGatherMethod.AUTO

    def resolve_method(self, nbytes_per_rank: int) -> AllGatherMethod:
        if self.method is AllGatherMethod.AUTO:
            return get_auto_all_gather_method(self.world_size,
                                              nbytes_per_rank)
        return self.method


def create_allgather_context(axis: str = "tp",
                             method: AllGatherMethod = AllGatherMethod.AUTO,
                             world_size: int = 1) -> AllGatherContext:
    return AllGatherContext(world_size=world_size, axis=axis, method=method)


def all_gather_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version at world = 1: a copy of ``x``."""
    return x.clone()


def all_gather(x: torch.Tensor, ctx: AllGatherContext | None = None,
               impl: str = "pallas") -> torch.Tensor:
    """Gather ``x`` (rows sharded over ``ctx.axis``) onto every rank, at
    world = 1: a (rows, ...) tensor equal to ``x``.

    ``impl="pallas"``: a new tensor, written by the copy kernel on CUDA
    (counted in :data:`all_gather_launches`) and by
    :func:`all_gather_reference` on the CPU. ``impl="xla"``: ``x``
    itself."""
    ctx = ctx or create_allgather_context()
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown all_gather impl {impl!r}")
    if ctx.world_size != 1:
        raise NotImplementedError(
            f"all_gather at world {ctx.world_size} is not ported yet "
            f"{_UNPORTED}")
    if impl == "xla":
        return x
    method = ctx.resolve_method(x.numel() * x.element_size())
    if method is AllGatherMethod.BROADCAST:
        raise ValueError("BROADCAST is one-to-all, not an all-gather: call "
                         "ops.allgather.broadcast(x, root, ctx) instead")
    if x.device.type == "cpu":
        return all_gather_reference(x)
    return launch_all_gather(x)


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


def broadcast_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version at world = 1: a copy of the root's (only) chunk."""
    return x.clone()


def broadcast(x: torch.Tensor, root: int = 0,
              ctx: AllGatherContext | None = None,
              impl: str = "pallas") -> torch.Tensor:
    """Rank ``root``'s row chunk of ``x`` (rows sharded over ``ctx.axis``)
    on every rank (JAX ``broadcast`` :373), at world = 1: a tensor equal
    to ``x``. A root outside the world raises ``ValueError``, as in JAX.

    ``impl="pallas"``: a new tensor, written by the copy kernel on CUDA
    (counted in :data:`broadcast_launches`) and by
    :func:`broadcast_reference` on the CPU. ``impl="xla"``: ``x`` itself."""
    ctx = ctx or create_allgather_context()
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown broadcast impl {impl!r}")
    if not 0 <= root < ctx.world_size:
        raise ValueError(f"root {root} out of range for world "
                         f"{ctx.world_size}")
    if ctx.world_size != 1:
        raise NotImplementedError(
            f"broadcast at world {ctx.world_size} is not ported yet "
            f"{_UNPORTED}")
    if impl == "xla":
        return x
    if x.device.type == "cpu":
        return broadcast_reference(x)
    out = launch_copy(x)
    broadcast_launches.add(_row_key(x))
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
    err = lib.tdt_copy(x.data_ptr(), out.data_ptr(),
                       x.numel() * x.element_size(),
                       num_sms(x.device.index), stream)
    if err != 0:
        raise RuntimeError(f"copy kernel call failed: "
                           f"{lib.tdt_error_string(err).decode()} ({err})")
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("allgather")
    if lib.tdt_copy.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tdt_copy.argtypes = [p, p, ctypes.c_longlong, i, p]
        lib.tdt_copy.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
