"""All-reduce at world = 1 (the port of ``triton_dist_tpu.ops.allreduce``).

``all_reduce(x, impl="pallas")`` launches, for every method, the
hand-written copy kernel of ``csrc/allgather.cu``: the world = 1 body of
each Pallas kernel JAX launches, ``_one_shot_ar_kernel`` (:114),
``_recursive_doubling_ar_kernel`` (:158) and ``_two_shot_ar_kernel``
(:193), is ``o = x`` (:120-122, :172-174, :203-205). ``impl="xla"`` is
``lax.psum`` at world = 1: the identity.

The pushes to peers, the perf-model method choice at world > 2 and
every world > 1 call are not ported yet and raise
``NotImplementedError`` (ROADMAP.md, Queue B item 7). JAX's
``straggler_option`` delays a rank before it communicates, which no
world = 1 body does; it is not carried over.

On a CUDA tensor ``impl="pallas"`` launches the kernel or raises; only a
tensor that lies on the CPU takes the plain version
:func:`all_reduce_reference`.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from triton_dist_tpu_torch.ops.allgather import launch_copy
from triton_dist_tpu_torch.ops.common import LaunchCount

#: Launches of the all-reduce's copy, by (method, M, N, dtype).
all_reduce_launches = LaunchCount()

_UNPORTED = "(ROADMAP.md, Queue B item 7)"


class AllReduceMethod(enum.Enum):
    AUTO = "auto"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"
    RECURSIVE_DOUBLING = "recursive_doubling"


def get_auto_allreduce_method(world_size: int,
                              nbytes: int) -> AllReduceMethod:
    """JAX's method choice (``get_auto_allreduce_method`` :59) where it
    needs no perf model: one-shot at world <= 2. Larger worlds choose by
    modelled time, which is not ported yet."""
    if world_size <= 2:
        return AllReduceMethod.ONE_SHOT
    raise NotImplementedError(
        f"the all-reduce method choice at world {world_size} is not ported "
        f"yet {_UNPORTED}")


@dataclasses.dataclass
class AllReduceContext:
    """The JAX context at world = 1: the axis name and the method."""
    world_size: int = 1
    axis: str = "tp"
    method: AllReduceMethod = AllReduceMethod.AUTO


def create_allreduce_context(axis: str = "tp",
                             method: AllReduceMethod = AllReduceMethod.AUTO,
                             world_size: int = 1) -> AllReduceContext:
    return AllReduceContext(world_size=world_size, axis=axis, method=method)


def resolve_method(ctx: AllReduceContext, m: int,
                   nbytes: int) -> AllReduceMethod:
    """The method ``all_reduce`` runs, with JAX's fix-ups (:271-279):
    two-shot needs M divisible by the world, recursive doubling a
    power-of-two world; both fall back to one-shot otherwise."""
    method = ctx.method
    world = ctx.world_size
    if method is AllReduceMethod.AUTO:
        method = get_auto_allreduce_method(world, nbytes)
    if method is AllReduceMethod.TWO_SHOT and m % world:
        method = AllReduceMethod.ONE_SHOT
    if method is AllReduceMethod.RECURSIVE_DOUBLING and world & (world - 1):
        method = AllReduceMethod.ONE_SHOT
    return method


def all_reduce_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version at world = 1: the sum of the one partial, a copy of
    ``x[0]``."""
    return x[0].clone()


def all_reduce(x: torch.Tensor, ctx: AllReduceContext | None = None,
               impl: str = "pallas", stacked: bool = False) -> torch.Tensor:
    """Sum the per-rank partials of ``x`` (w, M, N), one per rank, onto
    every rank: (M, N), or (w, M, N) stacked copies with ``stacked``.

    ``impl="pallas"``: a new tensor, written by the copy kernel on CUDA
    (counted in :data:`all_reduce_launches` under the method it ran) and
    by :func:`all_reduce_reference` on the CPU. ``impl="xla"``: a view
    of ``x``."""
    ctx = ctx or create_allreduce_context()
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown all_reduce impl {impl!r}")
    if ctx.world_size != 1:
        raise NotImplementedError(
            f"all_reduce at world {ctx.world_size} is not ported yet "
            f"{_UNPORTED}")
    if x.dim() != 3 or x.shape[0] != ctx.world_size:
        raise ValueError(f"all_reduce takes (world, M, N) partials, got "
                         f"{tuple(x.shape)} at world {ctx.world_size}")
    m, n = x.shape[1], x.shape[2]
    method = resolve_method(ctx, m, m * n * x.element_size())
    if impl == "xla":
        out = x[0]
    elif x.device.type == "cpu":
        out = all_reduce_reference(x)
    else:
        out = launch_copy(x[0])
        all_reduce_launches.add((method.value, m, n,
                                 str(x.dtype).removeprefix("torch.")))
    return out[None] if stacked else out
