"""Expert-parallel all-to-all dispatch and combine (the port of
``triton_dist_tpu.layers.ep_a2a``).

Static shapes, as in JAX: every (token, k) pair of a rank gets a slot in
its rank-major (W, capacity) send layout (``ops.moe_utils``), the payload
rides ``ops.all_to_all.fast_all_to_all`` (the hand-written kernel on the
card) and the int32 side band (each slot's local expert id) the plain
slab transpose. Tensors are the global ones of the JAX layer: token rows
(T, H) row-sharded over the ranks, received slots (W * W * capacity, H)
rank-major. Per-rank steps run once per rank on its views
(``RankGroup.per_rank``); steps that are elementwise over the slots run
on the global tensor at once, which computes the same values.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.ops.all_to_all import (
    AllToAllContext, _xla_a2a, create_all_to_all_context, fast_all_to_all,
    fast_all_to_all_fp8)
from triton_dist_tpu_torch.ops.moe_utils import (
    dispatch_layout, live_slot_mask, scatter_to_slabs, topk_reduce)
from triton_dist_tpu_torch.runtime.dist import RankGroup


@dataclasses.dataclass
class DispatchHandle:
    """What combine needs from dispatch (JAX ``DispatchHandle``)."""
    dest: torch.Tensor         # (T, K) destination rank of each pair
    pos: torch.Tensor          # (T, K) slot in the destination slab
    valid: torch.Tensor        # (T, K) pair kept (not capacity-dropped)
    recv_counts: torch.Tensor  # (W * W,) live rows of each received slab


class EPAll2AllLayer:
    """dispatch(x, indices) -> slots grouped per rank for its local
    experts; combine(expert_out, weights, handle) -> per-token outputs."""

    def __init__(self, max_tokens: int, hidden: int, topk: int,
                 num_experts: int, group: RankGroup,
                 capacity: int | None = None, dtype=torch.bfloat16,
                 impl: str = "pallas", wire_dtype: str | None = None):
        self.group = group
        self.world = group.world
        if num_experts % self.world:
            raise ValueError(f"{num_experts} experts do not shard over "
                             f"{self.world} ranks")
        if wire_dtype not in (None, "fp8"):
            raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
        # wire_dtype "fp8": dispatch tokens travel as e4m3 with per-row
        # scales; combine stays at the model dtype (JAX's choice).
        self.wire_dtype = wire_dtype
        self.max_tokens = max_tokens
        self.hidden = hidden
        self.topk = topk
        self.num_experts = num_experts
        self.experts_per_rank = num_experts // self.world
        # Worst case: every pair a rank routes lands on one peer; slabs
        # aligned to 8 rows (32 for the 1-byte fp8 wire), as in JAX.
        cap = capacity or max_tokens * topk
        align = 32 if wire_dtype == "fp8" else 8
        self.capacity = max(align, -(-cap // align) * align)
        self.dtype = dtype
        self.impl = impl
        self.a2a_ctx: AllToAllContext = create_all_to_all_context(
            group, capacity=self.capacity)

    def dispatch(self, x: torch.Tensor, exp_indices: torch.Tensor):
        """Route token rows to the ranks owning their experts.

        x: (T, H) row-sharded (T = W * tokens per rank); exp_indices: (T,
        topk) global expert ids. Returns (tokens (W * W * capacity, H):
        received slot rows, rank-major, dead slots zero; local_expert
        (W * W * capacity,) int32, ``experts_per_rank`` on dead slots;
        handle for :meth:`combine`)."""
        world, cap = self.world, self.capacity

        def local_pack(xs, ids):
            meta = dispatch_layout(ids, self.num_experts, world, cap)
            buf, extras = scatter_to_slabs(
                xs, meta, world, cap,
                extra={"local_expert": meta["local_expert"]})
            return (buf, extras["local_expert"], meta["send_counts"],
                    meta["dest"], meta["pos"], meta["valid"])

        send_buf, send_exp, send_counts, dest, pos, valid = \
            self.group.per_rank(local_pack, x, exp_indices, in_dims=(0, 0),
                                out_dims=(0,) * 6)
        if self.wire_dtype == "fp8":
            recv_buf, recv_counts = fast_all_to_all_fp8(
                send_buf, send_counts, self.a2a_ctx, impl=self.impl)
        else:
            recv_buf, recv_counts = fast_all_to_all(
                send_buf, send_counts, self.a2a_ctx, impl=self.impl)
        recv_exp = _xla_a2a(send_exp, world)
        # Dead slots: the sentinel expert id and zero rows (the kernel
        # leaves them undefined; JAX zeroes them the same way).
        live = live_slot_mask(recv_counts, world * world, cap)
        local_expert = torch.where(live, recv_exp, self.experts_per_rank)
        tokens = torch.where(live[..., None], recv_buf,
                             torch.zeros((), dtype=recv_buf.dtype,
                                         device=recv_buf.device))
        handle = DispatchHandle(dest=dest, pos=pos, valid=valid,
                                recv_counts=recv_counts)
        return (tokens.reshape(world * world * cap, -1),
                local_expert.reshape(-1).to(torch.int32), handle)

    def combine(self, expert_out: torch.Tensor, weights: torch.Tensor,
                handle: DispatchHandle) -> torch.Tensor:
        """Send processed slot rows back to their source ranks and reduce
        over top-k (JAX ``combine``).

        expert_out: (W * W * capacity, H) in dispatch slot order; weights:
        (T, topk) routing weights. Returns (T, H)."""
        world, cap = self.world, self.capacity
        slabs = expert_out.reshape(world * world, cap, -1)
        # Reverse exchange: slab j goes back to rank j, with the counts
        # received at dispatch.
        back_buf, _ = fast_all_to_all(slabs.contiguous(), handle.recv_counts,
                                      self.a2a_ctx, impl=self.impl)

        def local_gather(bb, dest, pos, valid, wts):
            t, k = dest.shape
            flat = bb.reshape(world * cap, -1)
            slot = (dest.long() * cap + pos.long()).reshape(-1)
            rows = flat[slot.clamp(max=world * cap - 1)]
            rows = torch.where(valid.reshape(-1)[:, None], rows,
                               torch.zeros((), dtype=rows.dtype,
                                           device=rows.device))
            return topk_reduce(rows.reshape(t, k, -1), wts)

        return self.group.per_rank(local_gather, back_buf, handle.dest,
                                   handle.pos, handle.valid, weights,
                                   in_dims=(0,) * 5, out_dims=0)
