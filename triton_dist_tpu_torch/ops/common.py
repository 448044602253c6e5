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
