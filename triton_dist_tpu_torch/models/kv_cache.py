"""Contiguous KV cache (the port of ``triton_dist_tpu.models.kv_cache``
``KVCacheManager``; the paged pools are not ported yet, ROADMAP.md
Queue A item 6).

The cache is a list of per-layer ``(k, v)`` tensors of shape
(B, T, Hkv, D). Unlike the JAX package, whose arrays are immutable and
threaded through the forward, the port's forward **updates these
tensors in place** (``layers.tp_attn._attention_core``): the model
returns the same tensors it was given, and a caller that needs the old
contents must copy them first.
"""

from __future__ import annotations

import torch


class KVCacheManager:
    def __init__(self, num_layers: int, batch: int, max_seq: int,
                 num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 device=None):
        self.num_layers = num_layers
        self.batch, self.max_seq = batch, max_seq
        self.num_kv_heads, self.head_dim = num_kv_heads, head_dim
        self.dtype = dtype
        self.device = device
        self.offset = 0  # host-side write position

    def init(self, rows: int | None = None):
        """Allocate the caches: [(k, v)] * L, zero-filled, with ``rows``
        batch rows (default: the manager's ``batch``)."""
        rows = self.batch if rows is None else rows
        if not 0 < rows <= self.batch:
            raise ValueError(f"{rows} rows do not fit a batch of "
                             f"{self.batch}")
        shape = (rows, self.max_seq, self.num_kv_heads, self.head_dim)
        return [(torch.zeros(shape, dtype=self.dtype, device=self.device),
                 torch.zeros(shape, dtype=self.dtype, device=self.device))
                for _ in range(self.num_layers)]

    def inc_offset(self, n: int) -> int:
        """Advance the write position."""
        self.offset += n
        if self.offset > self.max_seq:
            raise RuntimeError(f"KV cache overflow: offset {self.offset} > "
                               f"max_seq {self.max_seq}")
        return self.offset

    def reset(self):
        self.offset = 0
