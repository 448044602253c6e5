"""Reduce-scatter at world = 1 (the port of
``triton_dist_tpu.ops.reduce_scatter``).

``reduce_scatter(x, impl="pallas")`` launches, for both methods, the
hand-written copy kernel of ``csrc/allgather.cu``: the world = 1 body of
``_ring_rs_kernel`` (:92) and of ``_one_shot_rs_kernel`` (:150) is
``o = x[0 : M]`` (:110-112, :157-159). ``impl="xla"`` is
``lax.psum_scatter`` at world = 1: the identity.

The ring hops and pushes, the perf-model method choice at world > 2 and
every world > 1 call are not ported yet and raise
``NotImplementedError`` (ROADMAP.md, Queue B item 9).

On a CUDA tensor ``impl="pallas"`` launches the kernel or raises; only a
tensor that lies on the CPU takes the plain version
:func:`reduce_scatter_reference`.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from triton_dist_tpu_torch.ops.allgather import launch_copy
from triton_dist_tpu_torch.ops.common import LaunchCount

#: Launches of the reduce-scatter's copy, by (method, rows, N, dtype).
reduce_scatter_launches = LaunchCount()

_UNPORTED = "(ROADMAP.md, Queue B item 9)"


class ReduceScatterMethod(enum.Enum):
    AUTO = "auto"
    RING = "ring"
    ONE_SHOT = "one_shot"


@dataclasses.dataclass
class ReduceScatterContext:
    """The JAX context at world = 1: the axis name and the method."""
    world_size: int = 1
    axis: str = "tp"
    method: ReduceScatterMethod = ReduceScatterMethod.AUTO

    def resolve_method(self, nbytes_per_chunk: int) -> ReduceScatterMethod:
        """JAX's choice (``resolve_method`` :62-78) where it needs no perf
        model: the given method, else one-shot at world <= 2."""
        if self.method is not ReduceScatterMethod.AUTO:
            return self.method
        if self.world_size <= 2:
            return ReduceScatterMethod.ONE_SHOT
        raise NotImplementedError(
            f"the reduce-scatter method choice at world {self.world_size} "
            f"is not ported yet {_UNPORTED}")


def create_reduce_scatter_context(
        axis: str = "tp",
        method: ReduceScatterMethod = ReduceScatterMethod.AUTO,
        world_size: int = 1) -> ReduceScatterContext:
    return ReduceScatterContext(world_size=world_size, axis=axis,
                                method=method)


def reduce_scatter_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version at world = 1: the one partial's rows, a copy of
    ``x[0]``."""
    return x[0].clone()


def reduce_scatter(x: torch.Tensor, ctx: ReduceScatterContext | None = None,
                   impl: str = "pallas") -> torch.Tensor:
    """Reduce the per-rank partials of ``x`` (w, M, N) and scatter the
    rows: rank i gets the summed rows [i * M / w, (i + 1) * M / w),
    returned as (M, N) rows sharded over ``ctx.axis``.

    ``impl="pallas"``: a new tensor, written by the copy kernel on CUDA
    (counted in :data:`reduce_scatter_launches` under the method it ran)
    and by :func:`reduce_scatter_reference` on the CPU. ``impl="xla"``:
    a view of ``x``."""
    ctx = ctx or create_reduce_scatter_context()
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown reduce_scatter impl {impl!r}")
    if ctx.world_size != 1:
        raise NotImplementedError(
            f"reduce_scatter at world {ctx.world_size} is not ported yet "
            f"{_UNPORTED}")
    if x.dim() != 3 or x.shape[0] != ctx.world_size:
        raise ValueError(f"reduce_scatter takes (world, M, N) partials, got "
                         f"{tuple(x.shape)} at world {ctx.world_size}")
    m, n = x.shape[1], x.shape[2]
    method = ctx.resolve_method(m * n * x.element_size())
    if impl == "xla":
        return x.reshape(m, n)
    if x.device.type == "cpu":
        return reduce_scatter_reference(x)
    out = launch_copy(x[0])
    reduce_scatter_launches.add((method.value, m, n,
                                 str(x.dtype).removeprefix("torch.")))
    return out
