"""What the port's kernel wrappers share."""

from __future__ import annotations

import collections
import functools

import torch


class LaunchCount:
    """Kernel launches made by a wrapper: ``total`` and ``by_shape`` (a
    key each wrapper chooses from its shapes). A run resets it, drives
    the path and reads it to show that the path went through the
    kernel."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.total = 0
        self.by_shape: collections.Counter = collections.Counter()

    def add(self, shape) -> None:
        self.total += 1
        self.by_shape[tuple(shape)] += 1


@functools.cache
def num_sms(index) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it does not start on 16 bytes (an
    offset view): the GEMM kernels read 16-byte chunks."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# -- the ring schedule of the fused comm-GEMM kernels ----------------------------
# Copies of ``triton_dist_tpu/ops/common.py`` ring_hop_counts (:311) and
# ring_chunk_schedule (:323) on plain ints. JAX's resolve_ring_dirs (:292)
# reads TDT_RING_DIRS; the port reads no environment variable, and the
# contexts carry ``ring_dirs`` (default 2, JAX's value with the variable
# unset).
RING_DIRS = (1, 2)


def check_ring_dirs(ring_dirs: int) -> int:
    """``ring_dirs`` when it is 1 or 2, else ``ValueError``."""
    if ring_dirs not in RING_DIRS:
        raise ValueError(f"ring_dirs must be 1 or 2, got {ring_dirs!r}")
    return ring_dirs


def ring_hop_counts(world: int, dirs: int) -> tuple:
    """(forward, backward) hops of the ring schedule: odd worlds split
    the W - 1 travelling chunks ceil / floor; at world <= 2 the
    bidirectional ring is the unidirectional one."""
    if world <= 1:
        return 0, 0
    if dirs == 1 or world == 2:
        return world - 1, 0
    n_bwd = (world - 1) // 2
    return (world - 1) - n_bwd, n_bwd


def ring_chunk_schedule(me: int, s: int, world: int, dirs: int) -> tuple:
    """Chunk rank ``me`` consumes at position ``s`` of the rank-rotated
    schedule, as ``(chunk, is_bwd, offset)``: dirs 1 takes chunk me - s;
    dirs 2 its own chunk first, then arrivals from the left (me - 1,
    me - 2, ...) and the right (me + 1, ...) in turn, an even world
    ending with a forward-only tail. ``offset`` is the chunk's hop count
    from its origin along its direction."""
    if dirs == 1 or world <= 2:
        return (me - s) % world, False, s
    n_bwd = (world - 1) // 2
    in_alt = s <= 2 * n_bwd
    is_bwd = in_alt and s % 2 == 0 and s > 0
    if in_alt:
        off = s // 2 if is_bwd else (s + 1) // 2
    else:
        off = s - n_bwd
    return ((me + off) if is_bwd else (me - off)) % world, is_bwd, off
