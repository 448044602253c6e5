"""Sequence-parallel attention layers at world = 1 (the port of
``triton_dist_tpu.layers.sp_flash_decode``).

``SpFlashDecodeLayer`` owns a (B, T, Hkv, D) KV cache: ``append`` writes
new positions into it in place, ``__call__`` decodes one query position
per row over it through the flash-decode kernels of ``ops.flash_decode``
(``impl="pallas"``) or their plain math (``impl="xla"``, JAX's XLA
path). ``SpAttentionLayer`` wraps ``ops.sp_attention.sp_ag_attention``
for prefill; ``impl="pallas"`` runs the flash-prefill kernel.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops.flash_decode import (
    FlashDecodeContext, flash_decode_reference, gqa_fwd_batch_decode)
from triton_dist_tpu_torch.ops.sp_attention import (
    IMPLS, create_sp_attention_context, sp_ag_attention)
from triton_dist_tpu_torch.runtime.device import default_device


class SpFlashDecodeLayer:
    """Decode attention over a KV cache (JAX ``SpFlashDecodeLayer``).

    The cache is (B, max_seq, Hkv, D) in ``dtype``; at world = 1 its
    sequence axis is not split."""

    def __init__(self, batch: int, max_seq: int, num_kv_heads: int,
                 head_dim: int, dtype=torch.bfloat16, impl: str = "pallas",
                 device=None):
        if impl not in ("pallas", "xla"):
            raise ValueError(f"unknown flash decode impl {impl!r}")
        self.batch, self.max_seq = batch, max_seq
        self.num_kv_heads, self.head_dim = num_kv_heads, head_dim
        self.dtype, self.impl = dtype, impl
        self.device = default_device(device)
        self.ctx = FlashDecodeContext()

    def init_cache(self):
        """Zeroed (k, v) caches on the layer's device."""
        shape = (self.batch, self.max_seq, self.num_kv_heads, self.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def append(self, kv_cache, k_new: torch.Tensor, v_new: torch.Tensor,
               offset):
        """Write (B, n, Hkv, D) new entries at position ``offset`` (an int
        or a scalar tensor) of the caches, in place, and return them.

        As ``lax.dynamic_update_slice``, an offset outside [0, T - n] is
        clamped into it; a tensor offset is clamped on its device, so the
        host never waits for the card."""
        ck, cv = kv_cache
        n = k_new.shape[1]
        limit = ck.shape[1] - n
        if isinstance(offset, int):
            start = min(max(offset, 0), limit)
            idx = torch.arange(start, start + n, device=ck.device)
        else:
            start = torch.as_tensor(offset, device=ck.device).clamp(0, limit)
            idx = start.to(torch.int64) + torch.arange(n, device=ck.device)
        ck.index_copy_(1, idx, k_new.to(ck.dtype))
        cv.index_copy_(1, idx, v_new.to(cv.dtype))
        return ck, cv

    def __call__(self, q: torch.Tensor, kv_cache, kv_len) -> torch.Tensor:
        """q: (B, Hq, D); returns (B, Hq, D) over the first ``kv_len``
        positions (a scalar or (B,)) of each row."""
        ck, cv = kv_cache
        if self.impl == "xla":
            return flash_decode_reference(q, ck, cv, kv_len)
        return gqa_fwd_batch_decode(q, ck, cv, kv_len, self.ctx)


class SpAttentionLayer:
    """Prefill attention (JAX ``SpAttentionLayer``): q (B, S, Hq, D), k/v
    (B, S, Hkv, D) -> (B, S, Hq, D) through ``sp_ag_attention``."""

    def __init__(self, axis: str = "sp", causal: bool = True,
                 impl: str = "ring"):
        if impl not in IMPLS:
            raise ValueError(f"unknown sp attention impl {impl!r}")
        self.ctx = create_sp_attention_context(axis, causal=causal)
        self.impl = impl

    def __call__(self, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        return sp_ag_attention(q, k, v, self.ctx, impl=self.impl)
