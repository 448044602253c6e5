"""All-gather at world = 1 (the port of ``triton_dist_tpu.ops.allgather``).

``all_gather(x, impl="pallas")`` launches the hand-written copy kernel
of ``csrc/allgather.cu``: the world = 1 body of the Pallas kernels
``_full_mesh_push_kernel`` (:254), the method JAX picks at world <= 2,
and ``_ring_ag_kernel`` (:133), whose world = 1 body is the same copy of
this rank's chunk into its slot of the gathered buffer. ``impl="xla"``
is ``lax.all_gather`` at world = 1: the identity.

The pushes to peers and the ring hops, ``broadcast`` and every world > 1
call are not ported yet and raise ``NotImplementedError`` (ROADMAP.md,
Queue B item 8).

On a CUDA tensor ``impl="pallas"`` launches the kernel or raises; only a
tensor that lies on the CPU takes the plain version
:func:`all_gather_reference`.
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
        raise NotImplementedError(
            f"broadcast is one-to-all, not an all-gather, and is not "
            f"ported yet {_UNPORTED}")
    if x.device.type == "cpu":
        return all_gather_reference(x)
    return launch_all_gather(x)


def launch_all_gather(x: torch.Tensor) -> torch.Tensor:
    """One launch of the copy kernel on a CUDA tensor: rank 0's chunk
    into the gathered (rows, ...) buffer."""
    if x.device.type != "cuda":
        raise ValueError(f"all_gather runs on CUDA or the CPU, not "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("all_gather kernel needs a contiguous tensor")
    lib = _lib()
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.tdt_all_gather(x.data_ptr(), out.data_ptr(), nbytes, 0,
                             num_sms(x.device.index), stream)
    if err != 0:
        raise RuntimeError(f"all_gather kernel call failed: "
                           f"{lib.tdt_error_string(err).decode()} ({err})")
    rows = x.shape[0] if x.dim() else 1
    all_gather_launches.add((rows, nbytes // max(rows, 1)))
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("allgather")
    if lib.tdt_all_gather.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tdt_all_gather.argtypes = [p, p, ctypes.c_longlong, i, i, p]
        lib.tdt_all_gather.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
