"""Pipeline-parallel communication layer (the port of
``triton_dist_tpu.layers.p2p``).

The ranks of the pipeline axis are W slices of one card
(``runtime.dist.RankGroup``): an activation tensor is the global (W rows,
...) tensor whose row block r is rank r's, and a hop is
``ops.p2p.pp_shift``. JAX runs each stage on its own device inside
``shard_map``; here one process applies the W stages in rank order, each
to its rank's block.

* :class:`CommOp`: a ring of ``num_buffers`` in-flight hops (JAX :25-46).
* :func:`pipeline_forward`: W ticks of "every rank applies its stage to
  its block, then shift by +1" (JAX :45-73); the result sits in rank 0's
  block again.
* :func:`pipeline_schedule`: the GPipe microbatch schedule (JAX :76-142),
  m + W - 1 masked ticks whose hop is the plain roll (JAX's is a
  ``lax.ppermute``, not the kernel).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops.p2p import (
    P2PContext, block_rows, create_p2p_context, pp_shift)
from triton_dist_tpu_torch.runtime.dist import RankGroup


class CommOp:
    """Ring of ``num_buffers`` in-flight pipeline hops (JAX ``CommOp``;
    the buffer count bounds how many shifts are outstanding)."""

    def __init__(self, num_buffers: int = 2, group: RankGroup | None = None,
                 axis: str = "pp", impl: str = "pallas"):
        self.ctx: P2PContext = create_p2p_context(group, axis)
        self.num_buffers = num_buffers
        self.impl = impl
        self._in_flight: list = []

    def send(self, x: torch.Tensor, delta: int = 1) -> None:
        """Send a hop; when the ring is full the oldest hop is dropped
        first, as JAX's is."""
        if len(self._in_flight) >= self.num_buffers:
            self._in_flight.pop(0)
        self._in_flight.append(pp_shift(x, self.ctx, delta=delta,
                                        impl=self.impl))

    def recv(self) -> torch.Tensor:
        """Consume the oldest outstanding hop."""
        return self._in_flight.pop(0)


def pipeline_forward(stage_fn, x: torch.Tensor,
                     group: RankGroup | None = None, axis: str = "pp",
                     impl: str = "xla") -> torch.Tensor:
    """Forward pass through a W-stage pipeline over the ranks of
    ``group`` (JAX ``pipeline_forward``).

    ``stage_fn(stage_idx, h)`` applies stage ``stage_idx`` (a Python int)
    to rank ``stage_idx``'s block ``h`` and returns a block of the same
    shape. ``x``: (W rows, ...); rank 0's block carries the input. Each
    tick is apply (every rank, in rank order) then ``pp_shift`` by +1 in
    ``impl``, so after W ticks rank 0's block has passed stages 0..W-1 and
    sits in rank 0's block again. In ticks 0..W-2 the later stages run on
    blocks of zeros or earlier stages' leftovers, as JAX's do: a stage must
    keep nothing of such a call."""
    ctx = create_p2p_context(group, axis)
    world = ctx.world_size
    rows = block_rows(x, world)
    h = x
    for _ in range(world):
        outs = [stage_fn(r, h.narrow(0, r * rows, rows))
                for r in range(world)]
        h = pp_shift(torch.cat(outs) if world > 1 else outs[0], ctx,
                     delta=1, impl=impl)
    return h


def _stage(tree, s: int):
    """Stage ``s``'s slice of a params tree whose leaves are stacked per
    stage on dim 0 (dicts, lists and tuples of tensors)."""
    if isinstance(tree, dict):
        return {k: _stage(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage(v, s) for v in tree)
    return tree[s]


def pipeline_schedule(stage_fn, stage_params, microbatches: torch.Tensor,
                      group: RankGroup | None = None,
                      axis: str = "pp") -> torch.Tensor:
    """GPipe-style microbatched pipeline forward over the ranks of
    ``group`` (JAX ``pipeline_schedule``).

    Args:
      stage_fn: ``stage_fn(params_s, h) -> h``, one stage; every
        activation keeps the microbatch's shape and dtype.
      stage_params: a tree (dicts, lists, tuples) whose tensors are
        stacked per stage on dim 0 (length W).
      microbatches: (m, ...) microbatch stack.
    Returns:
      (m, ...) outputs of the full stage stack.

    m + W - 1 ticks: at tick t every rank applies its stage to what it
    holds (rank 0 to microbatch min(t, m - 1)), rank W - 1 keeps output
    j = t - (W - 1) when j >= 0, and the results rotate one hop (the
    plain roll, JAX's ``ppermute``). Only the last rank's outputs are
    real; JAX replicates them with a ``psum`` of every rank's outputs
    (zeros elsewhere), and so does this (``RankGroup.psum``)."""
    ctx = create_p2p_context(group, axis)
    w = ctx.world_size
    m = microbatches.shape[0]
    local = [_stage(stage_params, s) for s in range(w)]
    held = [torch.zeros_like(microbatches[0]) for _ in range(w)]
    outs = [torch.zeros_like(microbatches) for _ in range(w)]
    for t in range(m + w - 1):
        mb_t = microbatches[min(t, m - 1)]
        ys = [stage_fn(local[me], mb_t if me == 0 else held[me])
              for me in range(w)]
        j = t - (w - 1)
        if j >= 0:
            outs[w - 1][j] = ys[w - 1]
        held = ys[-1:] + ys[:-1]     # the hop: rank me + 1 gets ys[me]
    return RankGroup(w, axis, microbatches.device).psum(outs)
