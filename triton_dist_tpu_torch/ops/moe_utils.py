"""MoE routing utilities (the port of ``triton_dist_tpu.ops.moe_utils``).

The functions the Qwen3-MoE path calls at world = 1: the softmax / top-k
router, the weighted top-k reduce, the static-length bincount and the
stable sort by group. Plain PyTorch with static shapes: none of them
reads a value back to the host, so a layer that calls them never waits
for the card. The expert-parallel helpers (``dispatch_layout``,
``scatter_to_slabs``, ``live_slot_mask``) and ``moe_align_block_size``
come with the EP slice (ROADMAP.md, Queue A item 14).
"""

from __future__ import annotations

import torch


def topk_routing(router_logits: torch.Tensor, topk: int,
                 norm_topk_prob: bool = True):
    """Softmax -> top-k gating (JAX ``topk_routing``, moe_utils.py:29-45).

    router_logits: (T, E). Returns (weights (T, topk) f32, indices (T,
    topk) int32). Ties go to the lower expert index first, as
    ``lax.top_k`` orders them: a stable descending sort, where
    ``torch.topk`` promises no order among equal values."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    weights, indices = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    weights, indices = weights[:, :topk], indices[:, :topk]
    if norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, indices.to(torch.int32)


def topk_reduce(per_pair_out: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum over each token's top-k outputs (JAX ``topk_reduce``,
    moe_utils.py:235-243): (T, K, H) and (T, K) -> (T, H) in the
    outputs' dtype, products and sum in f32, one rounding."""
    w = weights.float()[..., None]
    return (per_pair_out.float() * w).sum(dim=1).to(per_pair_out.dtype)


def bincount(indices: torch.Tensor, length: int) -> torch.Tensor:
    """Static-length bincount (JAX ``bincount``): (length,) int32 counts
    of ``indices``; values outside [0, length) are dropped, as JAX's
    ``mode="drop"`` scatter drops them. The output's length never depends
    on the values (``torch.bincount`` would size it from their maximum,
    a read back to the host)."""
    flat = indices.reshape(-1).long()
    live = (flat >= 0) & (flat < length)
    counts = torch.zeros(length + 1, dtype=torch.int32,
                         device=indices.device)
    counts.index_add_(0, torch.where(live, flat, length),
                      torch.ones_like(flat, dtype=torch.int32))
    return counts[:length]


def sort_by_group(values: torch.Tensor, group_ids: torch.Tensor,
                  num_groups: int):
    """Stable-sort rows by group id -> (sorted values, group_sizes,
    unsort) (JAX ``sort_by_group``). ``group_ids`` may hold
    ``num_groups``, the sentinel of invalid rows: those sort to the end
    and are left out of ``group_sizes``."""
    order = torch.argsort(group_ids, stable=True)
    sizes = bincount(torch.clamp(group_ids, max=num_groups), num_groups)
    unsort = torch.argsort(order, stable=True)
    return values[order], sizes, unsort
