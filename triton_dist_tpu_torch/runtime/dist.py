"""Ranks on one device (the port of ``triton_dist_tpu.runtime.dist``).

The JAX package runs W ranks as the W devices of a ``jax.sharding.Mesh``
and writes per-rank code with ``shard_map``: each device sees its local
shard of a global array. The port runs W ranks in one process on one
card. A :class:`RankGroup` names the axis (``"tp"``, or ``"sp"`` for the
sequence axis, whose shards are spans of positions: ``shard(cache, 1)``)
and the world size, and gives the two halves of ``shard_map``:

* :meth:`RankGroup.shard` / :meth:`RankGroup.unshard`, the counterparts
  of an ``in_specs`` / ``out_specs`` entry ``P(axis)`` on one dimension
  (``None`` for ``P()``, replicated): rank r's shard is a view of the
  global tensor, never a copy, and a replicated tensor is one shared
  tensor;
* :meth:`RankGroup.per_rank`, the counterpart of
  ``ops/common.py::nestable_shard_map`` (:401): it calls ``fn`` once per
  rank on that rank's views and joins the results rank-major.

Kernels that exchange data between ranks address every rank's buffer
through a device table of base addresses (``runtime.symm_mem``), so no
kernel assumes that the ranks share one allocation.

``initialize_distributed`` (JAX :172), its multi-host bootstrap and the
global mesh context have no counterpart: one process drives every rank,
and each model or op takes its group explicitly.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.runtime.device import default_device


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """``world`` ranks on one axis of one device."""
    world: int = 1
    axis: str = "tp"
    device: torch.device = dataclasses.field(default=None)

    def __post_init__(self):
        if self.world < 1:
            raise ValueError(f"world must be >= 1, got {self.world}")
        object.__setattr__(self, "device", default_device(self.device))

    def shard(self, x: torch.Tensor, dim: int | None) -> list:
        """Rank r's shard of ``x`` along ``dim`` (a view), for every rank;
        ``dim=None`` (replicated) gives ``x`` itself W times."""
        if dim is None:
            return [x] * self.world
        n = x.shape[dim]
        if n % self.world:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {self.world} ranks")
        step = n // self.world
        return [x.narrow(dim, r * step, step) for r in range(self.world)]

    def unshard(self, parts, dim: int | None) -> torch.Tensor:
        """The global tensor of per-rank ``parts`` joined along ``dim``;
        ``dim=None`` (replicated) gives rank 0's part."""
        parts = list(parts)
        if len(parts) != self.world:
            raise ValueError(f"{len(parts)} parts for {self.world} ranks")
        if dim is None:
            return parts[0]
        if self.world == 1:
            return parts[0]
        return torch.cat(parts, dim=dim)

    def psum(self, parts) -> torch.Tensor:
        """The sum of per-rank ``parts`` (the counterpart of ``lax.psum``
        and, on a row-sharded result, ``psum_scatter``): accumulated in
        f32 in rank order, then cast to the parts' dtype once."""
        parts = list(parts)
        if len(parts) == 1:
            return parts[0]
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.float()
        return acc.to(parts[0].dtype)

    def per_rank(self, fn, *args, in_dims, out_dims):
        """``fn`` once per rank on its shards of ``args`` (split along
        ``in_dims``, one entry per argument, ``None`` for replicated),
        its outputs joined along ``out_dims`` (an int or ``None`` for a
        single output, a tuple for a tuple of outputs)."""
        if len(in_dims) != len(args):
            raise ValueError(f"{len(in_dims)} in_dims for {len(args)} args")
        shards = [self.shard(a, d) for a, d in zip(args, in_dims)]
        outs = [fn(*(s[r] for s in shards)) for r in range(self.world)]
        if isinstance(out_dims, tuple):
            return tuple(self.unshard([o[i] for o in outs], d)
                         for i, d in enumerate(out_dims))
        return self.unshard(outs, out_dims)


def create_rank_group(world: int = 1, axis: str = "tp",
                      device=None) -> RankGroup:
    """A group of ``world`` ranks on ``device`` (``None``: the CUDA card,
    raising when there is none)."""
    return RankGroup(world=world, axis=axis, device=device)
