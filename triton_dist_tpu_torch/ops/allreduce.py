"""All-reduce (the port of ``triton_dist_tpu.ops.allreduce``).

``all_reduce(x, ctx, impl="pallas")`` sums the W per-rank partials of
``x`` (W, M, N) onto every rank:

* at world 1 it launches, for every method, the copy kernel of
  ``csrc/allgather.cu``: the world = 1 body of each Pallas kernel JAX
  launches, ``_one_shot_ar_kernel`` (:114),
  ``_recursive_doubling_ar_kernel`` (:158) and ``_two_shot_ar_kernel``
  (:193), is ``o = x`` (:120-122, :172-174, :203-205);
* at world W it launches ``csrc/reduce_world.cu``
  (``tdt_all_reduce_world``), one cooperative launch over every rank of
  the context's group in the method :func:`resolve_method` gives: the
  one-shot push-then-sum, the two-shot (the ring reduce-scatter of
  ``ops.reduce_scatter``, then a ring all-gather of the reduced chunks in
  the order of ``ops.allgather``'s ring) or the recursive doubling.

Each method adds in the partials' dtype and rounds after every add, in
its own order, as JAX's kernels do (:func:`all_reduce_world_reference`),
so in bf16 the methods differ from each other and from ``impl="xla"``,
which is ``lax.psum``: the f32 sum of the partials in rank order, rounded
once (``RankGroup.psum``).

JAX's ``straggler_option=(rank, cycles)`` (:85) makes that rank spin
about ``cycles`` clock cycles before it communicates, so the kernel's
waits do their work; it changes no value, and the plain versions ignore
it.

On a CUDA tensor ``impl="pallas"`` launches a kernel or raises; only a
tensor that lies on the CPU takes the plain version.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from triton_dist_tpu_torch.ops.allgather import launch_copy, world_state
from triton_dist_tpu_torch.ops.common import LaunchCount
from triton_dist_tpu_torch.ops.reduce_scatter import (
    ReduceScatterMethod, add_rounded, launch_reduce_world,
    reduce_scatter_world_reference)
from triton_dist_tpu_torch.runtime.dist import RankGroup
from triton_dist_tpu_torch.runtime.symm_mem import RingState
from triton_dist_tpu_torch.tools.perf_model import (
    ChipSpec, estimate_all_reduce_time_ms)

#: Launches of the all-reduce: the world = 1 copy by (method, M, N,
#: dtype), the world-W kernel by (method, W, M, N, dtype).
all_reduce_launches = LaunchCount()


class AllReduceMethod(enum.Enum):
    AUTO = "auto"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"
    RECURSIVE_DOUBLING = "recursive_doubling"


def get_auto_allreduce_method(world_size: int, nbytes: int,
                              spec: ChipSpec | None = None
                              ) -> AllReduceMethod:
    """JAX's method choice (``get_auto_allreduce_method`` :59): one-shot
    at world <= 2, else whichever of the one-shot and the two-shot the
    cost model (``tools.perf_model``, by default the one-card H100 spec)
    prices lower, one-shot on a tie."""
    if world_size <= 2:
        return AllReduceMethod.ONE_SHOT
    t_one = estimate_all_reduce_time_ms(nbytes, world_size, spec,
                                        method="one_shot")
    t_two = estimate_all_reduce_time_ms(nbytes, world_size, spec,
                                        method="two_shot")
    return (AllReduceMethod.ONE_SHOT if t_one <= t_two
            else AllReduceMethod.TWO_SHOT)


@dataclasses.dataclass
class AllReduceContext:
    """The JAX context: the axis, its ranks, the method and the
    straggler.

    ``group`` (the ranks of the axis) sets ``world_size`` and keeps the
    world-W kernel's signals, workspaces and call counter (``state``)
    across calls; a context without one runs the plain versions at
    ``world_size`` on the CPU. ``straggler_option``: (rank, cycles), that
    rank delays before communicating."""
    world_size: int = 1
    axis: str = "tp"
    method: AllReduceMethod = AllReduceMethod.AUTO
    straggler_option: tuple[int, int] | None = None
    group: RankGroup | None = None
    state: RingState | None = dataclasses.field(default=None, init=False,
                                                repr=False)

    def __post_init__(self):
        self.state = world_state(self, self.group)


def create_allreduce_context(axis: str = "tp",
                             method: AllReduceMethod = AllReduceMethod.AUTO,
                             world_size: int = 1,
                             straggler_option: tuple[int, int] | None = None,
                             group: RankGroup | None = None
                             ) -> AllReduceContext:
    """The context over ``group`` (JAX ``create_allreduce_context`` over a
    mesh axis; ``None``: ``world_size`` ranks, plain versions only)."""
    return AllReduceContext(world_size=world_size, axis=axis, method=method,
                            straggler_option=straggler_option, group=group)


def resolve_method(ctx: AllReduceContext, m: int,
                   nbytes: int) -> AllReduceMethod:
    """The method ``all_reduce`` runs, with JAX's fix-ups (:271-279):
    two-shot needs M divisible by the world, recursive doubling a
    power-of-two world; both turn into one-shot otherwise."""
    method = ctx.method
    world = ctx.world_size
    if method is AllReduceMethod.AUTO:
        method = get_auto_allreduce_method(world, nbytes)
    if method is AllReduceMethod.TWO_SHOT and m % world:
        method = AllReduceMethod.ONE_SHOT
    if method is AllReduceMethod.RECURSIVE_DOUBLING and world & (world - 1):
        method = AllReduceMethod.ONE_SHOT
    return method


def all_reduce_world_reference(x: torch.Tensor,
                               method: AllReduceMethod) -> torch.Tensor:
    """Plain version: the (M, N) sum of the W partials of ``x`` (W, M, N),
    each add rounded to the dtype, in the method's order (at world 1 a
    copy of ``x[0]``).
    One-shot: ranks 0..W-1 in order (:143-146). Two-shot: the ring
    reduce-scatter's order per chunk (:209-232), every rank then holding
    every chunk. Recursive doubling (W a power of two): log2 W rounds of
    ``o_r = rnd(o_r + o_(r ^ 2^j))`` (:180-188); every rank ends with the
    same bits, rank 0's returned."""
    w = x.shape[0]
    if method is AllReduceMethod.TWO_SHOT:
        return reduce_scatter_world_reference(x, ReduceScatterMethod.RING)
    if method is AllReduceMethod.RECURSIVE_DOUBLING:
        o, ranks = x, torch.arange(w, device=x.device)
        for j in range(w.bit_length() - 1):
            o = add_rounded(o, o[ranks ^ (1 << j)])
        return o[0].clone()
    acc = x[0]
    for r in range(1, w):
        acc = add_rounded(acc, x[r])
    return acc.clone()


def all_reduce(x: torch.Tensor, ctx: AllReduceContext | None = None,
               impl: str = "pallas", stacked: bool = False) -> torch.Tensor:
    """Sum the per-rank partials of ``x`` (W, M, N), one per rank, onto
    every rank: (M, N), or with ``stacked`` every rank's copy as one
    (W, M, N) tensor, all bit-equal.

    ``impl="pallas"``: new tensors, written on CUDA by the copy kernel at
    world 1 and by the world-W kernel at world W (counted in
    :data:`all_reduce_launches` under the method it ran), by the plain
    version on the CPU. ``impl="xla"``: the f32 sum rounded once (a view
    of ``x`` at world 1)."""
    ctx = ctx or create_allreduce_context()
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown all_reduce impl {impl!r}")
    world = ctx.world_size
    if x.dim() != 3 or x.shape[0] != world:
        raise ValueError(f"all_reduce takes (world, M, N) partials, got "
                         f"{tuple(x.shape)} at world {world}")
    m, n = x.shape[1], x.shape[2]
    method = resolve_method(ctx, m, m * n * x.element_size())
    if impl == "xla":
        if world == 1:
            out = x[0]
        else:
            out = (ctx.group or RankGroup(world, ctx.axis, x.device)).psum(
                list(x))
        return out.expand(world, m, n) if stacked else out
    if x.device.type == "cpu":
        out = all_reduce_world_reference(x, method)
        return torch.stack([out] * world) if stacked else out
    dtype = str(x.dtype).removeprefix("torch.")
    if world == 1:
        out = launch_copy(x[0])
        all_reduce_launches.add((method.value, m, n, dtype))
        return out[None] if stacked else out
    out = launch_reduce_world(x, ctx, "all_reduce", method.value,
                              straggler=ctx.straggler_option)
    all_reduce_launches.add((method.value, world, m, n, dtype))
    return out if stacked else out[0]
