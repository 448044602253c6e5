"""Sequence-parallel attention layers (the port of
``triton_dist_tpu.layers.sp_flash_decode``).

``SpFlashDecodeLayer`` owns a (B, T, Hkv, D) KV cache whose T is split
over the W ranks of its group (rank r holds positions [r T / W,
(r + 1) T / W); the cache stays one global tensor and rank r's shard is a
view): ``append`` writes new positions into it in place, which lands on
the shard owning them, ``__call__`` decodes one query position per row
over it through the flash-decode kernels of ``ops.flash_decode``
(``impl="pallas"``; at world W the world-W kernel) or JAX's XLA body
(``impl="xla"``). ``SpAttentionLayer`` wraps
``ops.sp_attention.sp_ag_attention`` for prefill over the same group;
``impl="pallas"`` runs the flash-prefill kernel (at world W its ring
over the ranks).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.ops.flash_decode import (
    create_flash_decode_context, gqa_fwd_batch_decode)
from triton_dist_tpu_torch.ops.sp_attention import (
    IMPLS, create_sp_attention_context, sp_ag_attention)
from triton_dist_tpu_torch.runtime.device import default_device
from triton_dist_tpu_torch.runtime.dist import RankGroup


class SpFlashDecodeLayer:
    """Decode attention over a sequence-split KV cache (JAX
    ``SpFlashDecodeLayer``).

    The cache is (B, max_seq, Hkv, D) in ``dtype``, its sequence axis
    split over ``group``'s ranks (``None``: world 1 on ``device``);
    max_seq must split over them."""

    def __init__(self, batch: int, max_seq: int, num_kv_heads: int,
                 head_dim: int, dtype=torch.bfloat16, impl: str = "pallas",
                 device=None, group: RankGroup | None = None):
        if impl not in ("pallas", "xla"):
            raise ValueError(f"unknown flash decode impl {impl!r}")
        self.device = (group.device if group is not None
                       else default_device(device))
        world = 1 if group is None else group.world
        if max_seq % world:
            raise ValueError(f"max_seq {max_seq} does not split over "
                             f"{world} ranks")
        self.batch, self.max_seq = batch, max_seq
        self.num_kv_heads, self.head_dim = num_kv_heads, head_dim
        self.dtype, self.impl = dtype, impl
        self.ctx = create_flash_decode_context(
            group if world > 1 else None)

    def init_cache(self):
        """Zeroed (k, v) caches on the layer's device."""
        shape = (self.batch, self.max_seq, self.num_kv_heads, self.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def append(self, kv_cache, k_new: torch.Tensor, v_new: torch.Tensor,
               offset):
        """Write (B, n, Hkv, D) new entries at position ``offset`` (an int
        or a scalar tensor) of the caches, in place, and return them: the
        write lands on the rank whose shard holds those positions.

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
        """q: (B, Hq, D), replicated over the ranks; returns (B, Hq, D)
        over the first ``kv_len`` positions (a scalar or (B,)) of each
        row."""
        ck, cv = kv_cache
        return gqa_fwd_batch_decode(q, ck, cv, kv_len, self.ctx,
                                    impl=self.impl)


class SpAttentionLayer:
    """Prefill attention (JAX ``SpAttentionLayer``): q (B, S, Hq, D), k/v
    (B, S, Hkv, D), S split over ``group``'s ranks (``None``: world 1)
    -> (B, S, Hq, D) through ``sp_ag_attention``."""

    def __init__(self, axis: str = "sp", causal: bool = True,
                 impl: str = "ring", group: RankGroup | None = None):
        if impl not in IMPLS:
            raise ValueError(f"unknown sp attention impl {impl!r}")
        self.ctx = create_sp_attention_context(axis, causal=causal,
                                               group=group)
        self.impl = impl

    def __call__(self, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        return sp_ag_attention(q, k, v, self.ctx, impl=self.impl)
