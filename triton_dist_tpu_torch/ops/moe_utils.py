"""MoE routing utilities (the port of ``triton_dist_tpu.ops.moe_utils``).

The softmax / top-k router, the weighted top-k reduce, the static-length
bincount, the stable sort by group, and the expert-parallel helpers of
the all-to-all dispatch: :func:`dispatch_layout`,
:func:`scatter_to_slabs` and :func:`live_slot_mask`. Plain PyTorch with
static shapes: none of them reads a value back to the host, so a layer
that calls them never waits for the card. ``moe_align_block_size`` (a
host tile plan with a native helper) is not ported yet (ROADMAP.md,
Queue A item 14).
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


def live_slot_mask(counts: torch.Tensor, world: int,
                   capacity: int) -> torch.Tensor:
    """(world, capacity) bool: slot s of slab p is live iff ``s <
    counts[p]`` (JAX ``live_slot_mask``, moe_utils.py:48-62), the one
    definition of a live slot of the all-to-all's slab layout."""
    slot = torch.arange(capacity, device=counts.device)
    return slot[None, :] < counts.reshape(world, 1)


def dispatch_layout(exp_indices: torch.Tensor, num_experts: int, world: int,
                    capacity: int) -> dict:
    """The rank-major dispatch layout of expert parallelism (JAX
    ``dispatch_layout``, moe_utils.py:69-111): (token, k) pair i goes to
    rank ``dest = expert // (num_experts // world)`` at slot ``pos``, its
    ordinal among the earlier pairs (token-major) with the same
    destination; pairs at ``pos >= capacity`` are dropped.

    exp_indices: (T, K) global expert ids. Returns a dict of ``dest``,
    ``pos``, ``valid`` (T, K), ``send_counts`` (world,) and
    ``local_expert`` (T, K), all int32 but ``valid`` (bool)."""
    epr = num_experts // world
    t, k = exp_indices.shape
    flat = exp_indices.reshape(-1).long()
    dest = flat // epr
    ranks = torch.arange(world, device=flat.device)
    onehot = (dest[:, None] == ranks[None, :]).to(torch.int32)  # (TK, W)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = pos.gather(1, dest[:, None])[:, 0]
    valid = pos < capacity
    send_counts = (onehot * valid[:, None]).sum(dim=0, dtype=torch.int32)
    return {
        "dest": dest.to(torch.int32).reshape(t, k),
        "pos": pos.reshape(t, k),
        "valid": valid.reshape(t, k),
        "send_counts": send_counts,
        "local_expert": (flat % epr).to(torch.int32).reshape(t, k),
    }


def scatter_to_slabs(x: torch.Tensor, meta: dict, world: int, capacity: int,
                     extra: dict | None = None):
    """Scatter each (token, k) pair's row of ``x`` (T, H) into the
    (world, capacity, H) send buffer of ``meta`` (:func:`dispatch_layout`;
    JAX ``scatter_to_slabs``, moe_utils.py:114-146). ``extra``: name ->
    (T, K) side-band values scattered alongside into (world, capacity).
    Unused slots are zero; dropped pairs land in a spare row that is cut
    off, as JAX's ``mode="drop"`` drops them.

    Returns (send_buf (world, capacity, H), {name: (world, capacity)})."""
    k = meta["dest"].shape[1]
    h = x.shape[-1]
    n = world * capacity
    slot = torch.where(meta["valid"].reshape(-1),
                       (meta["dest"] * capacity + meta["pos"]).reshape(-1),
                       n).long()
    buf = x.new_zeros((n + 1, h))
    buf[slot] = x[:, None, :].expand(x.shape[0], k, h).reshape(-1, h)
    extras = {}
    for name, val in (extra or {}).items():
        e = val.new_zeros((n + 1,))
        e[slot] = val.reshape(-1)
        extras[name] = e[:n].reshape(world, capacity)
    return buf[:n].reshape(world, capacity, h), extras
