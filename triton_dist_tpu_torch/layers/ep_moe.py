"""Expert-parallel MoE FFN (the port of ``triton_dist_tpu.layers.ep_moe``).

The router runs on every token row, :class:`~triton_dist_tpu_torch.layers.
ep_a2a.EPAll2AllLayer` dispatches each (token, expert) pair to the rank
that owns the expert, each rank runs its E / W whole experts over the
slots it received (``ops.group_gemm.grouped_expert_ffn``, the grouped-GEMM
kernel on the card, dead slots on the sentinel id), and combine returns
and top-k-reduces the pair rows.

Parameters are the pytree of ``TPMoE`` (JAX's EP params are the same host
values with another sharding): global tensors, the router replicated and
the experts' stacks (E, H, I) / (E, I, H) sharded on E. Each rank reads
its experts through a view (``RankGroup.per_rank``), never a copy.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.layers.ep_a2a import EPAll2AllLayer
from triton_dist_tpu_torch.layers.tp_moe import TPMoE
from triton_dist_tpu_torch.ops.group_gemm import grouped_expert_ffn
from triton_dist_tpu_torch.ops.moe_utils import topk_routing
from triton_dist_tpu_torch.runtime.dist import RankGroup


class EPMoE:
    """Expert-parallel sparse FFN: dispatch -> local experts -> combine."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int, topk: int, group: RankGroup,
                 dtype=torch.bfloat16, impl: str = "pallas",
                 norm_topk_prob: bool = True, wire_dtype: str | None = None):
        self.group = group
        self.world = group.world
        if num_experts % self.world:
            raise ValueError(f"{num_experts} experts do not shard over "
                             f"{self.world} ranks")
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.experts_per_rank = num_experts // self.world
        self.topk = topk
        self.dtype = dtype
        self.impl = impl
        self.norm_topk_prob = norm_topk_prob
        self.wire_dtype = wire_dtype
        # One a2a layer per per-rank token count (prefill and decode
        # shapes), each with its own capacity and kernel state.
        self._a2a: dict[int, EPAll2AllLayer] = {}

    def set_fwd(self, mode: str):  # the interface of TPMoE
        pass

    def a2a_for(self, t_loc: int) -> EPAll2AllLayer:
        """The dispatch/combine layer of ``t_loc`` tokens per rank."""
        if t_loc not in self._a2a:
            self._a2a[t_loc] = EPAll2AllLayer(
                max_tokens=t_loc, hidden=self.hidden_size, topk=self.topk,
                num_experts=self.num_experts, group=self.group,
                dtype=self.dtype, impl=self.impl,
                wire_dtype=self.wire_dtype)
        return self._a2a[t_loc]

    #: Random params: TPMoE's pytree and draws (JAX's EP params are the
    #: TP params' host values).
    init = TPMoE.init

    def __call__(self, params: dict, x: torch.Tensor,
                 mode: str | None = None) -> torch.Tensor:
        """x: (T, H) -> (T, H). ``mode`` is ignored, as in JAX. Rows are
        padded to a multiple of the ranks (decode batches): pad rows
        route to expert 0 with zero weight and are cut off."""
        t, h = x.shape
        w = self.world
        t_pad = -(-t // w) * w
        logits = x.float() @ params["w_router"]
        weights, indices = topk_routing(logits, self.topk,
                                        self.norm_topk_prob)
        if t_pad != t:
            pad = t_pad - t
            x = torch.cat([x, x.new_zeros((pad, h))])
            weights = torch.cat([weights, weights.new_zeros(
                (pad, self.topk))])
            indices = torch.cat([indices, indices.new_zeros(
                (pad, self.topk))])
        a2a = self.a2a_for(t_pad // w)
        e_loc = self.experts_per_rank
        tokens, local_expert, handle = a2a.dispatch(x, indices)

        def local_ffn(tok, exp, wg, wu, wd):
            return grouped_expert_ffn(tok, wg, wu, wd, exp, e_loc)

        expert_out = self.group.per_rank(
            local_ffn, tokens, local_expert, params["w_gate"],
            params["w_up"], params["w_down"], in_dims=(0,) * 5, out_dims=0)
        out = a2a.combine(expert_out, weights, handle)
        return out[:t] if t_pad != t else out
