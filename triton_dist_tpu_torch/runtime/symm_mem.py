"""Symmetric memory for ranks on one device (the port of
``triton_dist_tpu.runtime.symm_mem``).

A symmetric tensor is W equally shaped buffers, one per rank. JAX
returns it as one global array of shape ``(axis_size, *local_shape)``
sharded on its leading dimension, and Pallas kernels reach a peer's
shard by device id. Here the W buffers are separate allocations, and the
tensor carries ``table``, a device ``int64`` tensor of their base
addresses: a kernel reaches rank r's buffer through ``table[r]``
(``csrc/shmem.cuh``: ``tdt_peer_ptr``), never by assuming the ranks lie
side by side. :func:`rank_table` gives the same table for the rank
shards of one global tensor (its leading dimension), and
:func:`rank_span` its two numbers, rank 0's address and the step between
ranks, which a kernel takes by value (``tdt_rank_ptr``): the all-to-all's
send and receive buffers, the world-W all-gather's output, and the
world-W reduce's and the shift's outputs, workspaces and signals go that
way, with no table to build. :class:`RingState` holds the
per-rank workspaces and signals of the ring kernels (AG-GEMM, GEMM-RS /
AR) across calls, with the call counter that stamps the signals.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from triton_dist_tpu_torch.runtime.dist import RankGroup


class SymmTensor:
    """W per-rank buffers of one shape and dtype, with the device table
    of their addresses. ``shape`` is JAX's global shape, ``(world,
    *local_shape)``."""

    def __init__(self, buffers: Sequence[torch.Tensor]):
        buffers = list(buffers)
        if not buffers or any(b.shape != buffers[0].shape
                              or b.dtype != buffers[0].dtype
                              or b.device != buffers[0].device
                              for b in buffers):
            raise ValueError("symmetric buffers need one shape, dtype and "
                             "device")
        self.buffers = buffers
        self.table = torch.tensor([b.data_ptr() for b in buffers],
                                  dtype=torch.int64, device=buffers[0].device)

    @property
    def world(self) -> int:
        return len(self.buffers)

    @property
    def shape(self) -> tuple:
        return (self.world, *self.buffers[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.buffers[0].dtype

    def __getitem__(self, rank: int) -> torch.Tensor:
        return self.buffers[rank]


def symm_tensor(local_shape: Sequence[int], dtype, group: RankGroup,
                fill: float | int = 0) -> SymmTensor:
    """One ``local_shape`` buffer per rank of ``group``, filled with
    ``fill``, on the group's device (JAX ``symm_tensor``)."""
    return SymmTensor([torch.full(tuple(local_shape), fill, dtype=dtype,
                                  device=group.device)
                       for _ in range(group.world)])


def symm_like(x: torch.Tensor, group: RankGroup) -> SymmTensor:
    """A symmetric tensor with per-rank buffers shaped like ``x``."""
    return symm_tensor(x.shape, x.dtype, group)


def local_shard(x: SymmTensor, index: int = 0) -> torch.Tensor:
    """Rank ``index``'s buffer (JAX ``local_shard``)."""
    return x[index]


_ARANGE: dict = {}


def rank_span(x: torch.Tensor, world: int) -> tuple[int, int]:
    """(base address, step in bytes) of the ``world`` rank shards of
    ``x`` along its leading dimension: rank r's shard starts at ``base + r
    * step``. Host arithmetic only, so a launch that takes it queues no
    kernel."""
    if x.dim() == 0 or x.shape[0] % world:
        raise ValueError(f"{tuple(x.shape)} does not split over {world} "
                         f"ranks")
    return x.data_ptr(), x.stride(0) * (x.shape[0] // world) * \
        x.element_size()


def rank_table(x: torch.Tensor, world: int) -> torch.Tensor:
    """The device ``int64`` table of the base addresses of the ``world``
    rank shards of ``x`` along its leading dimension (:func:`rank_span`'s
    ``base + r * step``). Computed on the device: no host-to-device copy,
    so a layer can call it on every forward without a host sync, at the
    cost of two small kernels."""
    base, step = rank_span(x, world)
    key = (x.device, world)
    ar = _ARANGE.get(key)
    if ar is None:
        ar = _ARANGE[key] = torch.arange(world, dtype=torch.int64,
                                         device=x.device)
    return ar * step + base


#: Elements past the live ones in every rank's ring workspace, filled with
#: NaN when the workspace is made: a kernel that writes past its live rows
#: shows there (``chip_smoke.py`` checks them).
CANARY = 64


class RingState:
    """The kernel state a ring op's context keeps across calls: per-rank
    workspaces (one ``(W, row)`` tensor per size and dtype, rank r's
    buffer its row r, NaN-filled when made, so every row ends in
    :data:`CANARY` NaN elements the kernel never touches), 64-bit signal
    buffers (zeroed when made, never reset) and the call counter
    (``epoch``) that stamps them, as ``AllToAllContext`` keeps its own.
    Stream order separates two calls, so one workspace serves them all."""

    def __init__(self, group: RankGroup):
        self.group = group
        self.epoch = 0
        self._buffers: dict = {}
        self._tables: dict = {}

    def workspace(self, numel: int, dtype: torch.dtype,
                  role: str = "ws") -> torch.Tensor:
        """The (W, row) workspace of ``role`` with ``numel`` live elements
        per rank; its rank table is ``rank_table(ws, W)``."""
        key = (role, numel, dtype)
        ws = self._buffers.get(key)
        if ws is None:
            row = -(-numel // CANARY) * CANARY + CANARY
            ws = self._buffers[key] = torch.full(
                (self.group.world, row), float("nan"), dtype=dtype,
                device=self.group.device)
        return ws

    def signals(self, role: str, count: int) -> torch.Tensor:
        """The (W, count) int64 signals of ``role`` (zeroed once)."""
        key = ("sig", role, count)
        sig = self._buffers.get(key)
        if sig is None:
            sig = self._buffers[key] = torch.zeros(
                (self.group.world, count), dtype=torch.int64,
                device=self.group.device)
        return sig

    def table(self, buf: torch.Tensor) -> torch.Tensor:
        """``rank_table(buf, W)`` of one of this state's workspaces or
        signal buffers, made at its first call: the buffers never move,
        so a launch needs no kernel to rebuild it."""
        key = (buf.data_ptr(), buf.shape, buf.dtype)
        tab = self._tables.get(key)
        if tab is None:
            tab = self._tables[key] = rank_table(buf, self.group.world)
        return tab

    def nbytes(self) -> int:
        """Device bytes of every workspace and signal buffer made so far."""
        return sum(b.numel() * b.element_size()
                   for b in self._buffers.values())

    def next_epoch(self) -> int:
        """This call's epoch: one more than the last call's."""
        self.epoch += 1
        return self.epoch
