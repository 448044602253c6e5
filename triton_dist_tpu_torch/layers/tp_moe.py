"""Tensor-parallel MoE layer (the port of
``triton_dist_tpu.layers.tp_moe``).

The layer of JAX ``TPMoE.__call__`` (tp_moe.py:84-129), step by step:

1. router: an f32 product with the f32 router, then ``topk_routing``;
   the rows are padded to a multiple of the W ranks with zero routing
   weights (:98-107), and cut back at the end;
2. all-gather of the token rows (``ops.allgather``: in mode ``ag_rs`` the
   copy kernel at world 1 and the world-W all-gather kernel at world W,
   every rank receiving its own copy; the identity of ``impl="xla"`` in
   mode ``xla``) and of the routing metadata (:meth:`TPMoE._ag_meta`, the
   plain join of the ranks' rows);
3. gate and up, per rank on its column shard of the experts:
   ``grouped_matmul`` of each, rounded to the activation dtype, then a
   plain SwiGLU in f32, rounded (tp_moe.py:119-124). On CUDA the two
   products share one launch of the grouped-GEMM kernel, which reads
   each pair's token row through the pair -> token index where JAX
   expands the rows with ``jnp.repeat``, and the shard as a strided view;
4. down projection, top-k reduce and reduce-scatter: ``moe_reduce_rs``
   ("ring" in mode ``ag_rs``, "xla" in mode ``xla``) over the ranks'
   I-shards.

Over a ``RankGroup`` of W ranks on one card (``runtime.dist``) the
weights shard as JAX shards them (:meth:`TPMoE.shard_params`: gate and up
by the columns of I, down by its rows, the router replicated; every
shard a view). The input rows are a global (M, H) tensor, row-sharded in
mode ``ag_rs`` and replicated in mode ``gemm_ar``: either way the
all-gather takes rank r's chunk of the rows, as JAX's ``in_specs=P(axis)``
splits a replicated input, and the result's rows are row-sharded.

Weights keep the JAX layout: the router (H, E) in f32, experts stacked
(E, H, I) and (E, I, H).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.layers.common import shard_param
from triton_dist_tpu_torch.ops.allgather import (
    all_gather, create_allgather_context)
from triton_dist_tpu_torch.ops.group_gemm import grouped_matmul_multi
from triton_dist_tpu_torch.ops.moe_reduce_rs import (
    create_moe_rs_context, moe_reduce_rs)
from triton_dist_tpu_torch.ops.moe_utils import topk_routing
from triton_dist_tpu_torch.runtime.dist import RankGroup

#: The modes of the JAX layer.
MODES = ("ag_rs", "xla")
#: The dimension each parameter shards on (JAX ``shard_params``, :77-84).
SHARD_DIMS = {"w_router": None, "w_gate": 2, "w_up": 2, "w_down": 1}


class TPMoE:
    """Qwen3-MoE sparse FFN: softmax top-k routing over ``num_experts``
    SwiGLU experts of width ``intermediate_size``, each expert's width
    sharded over the ranks of ``group`` (default: world 1)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int, topk: int, dtype=torch.bfloat16,
                 fwd_mode: str = "ag_rs", impl: str = "pallas",
                 norm_topk_prob: bool = True,
                 group: RankGroup | None = None):
        self.group = group or RankGroup(1, device="cpu")
        self.world = self.group.world
        if intermediate_size % self.world:
            raise ValueError(f"expert width {intermediate_size} does not "
                             f"shard over {self.world} ranks")
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.topk = topk
        self.dtype = dtype
        self.fwd_mode = fwd_mode
        self.impl = impl
        self.norm_topk_prob = norm_topk_prob
        self.ag_ctx = create_allgather_context(
            group=group if self.world > 1 else None)
        self.rs_ctx = create_moe_rs_context(num_experts=num_experts,
                                            topk=topk, world_size=self.world)

    def set_fwd(self, mode: str):
        self.fwd_mode = mode

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator, device) -> dict:
        """Random params on ``device`` with JAX's scales; the router is
        f32. Global tensors: :meth:`shard_params` gives the ranks' views."""
        h, i, e = self.hidden_size, self.intermediate_size, self.num_experts

        def normal(shape, scale, dtype):
            return torch.randn(shape, generator=generator, device=device,
                               dtype=dtype) * scale

        return {
            "w_router": normal((h, e), h ** -0.5, torch.float32),
            "w_gate": normal((e, h, i), h ** -0.5, self.dtype),
            "w_up": normal((e, h, i), h ** -0.5, self.dtype),
            "w_down": normal((e, i, h), i ** -0.5, self.dtype),
        }

    def shard_params(self, params: dict) -> dict:
        """Each parameter's per-rank shards (views) as JAX shards them:
        gate and up ``P(None, None, ax)``, down ``P(None, ax, None)``,
        the router replicated."""
        return {name: shard_param(params[name], self.group, dim)
                for name, dim in SHARD_DIMS.items()}

    # -- forward -----------------------------------------------------------
    def __call__(self, params: dict, x: torch.Tensor,
                 mode: str | None = None) -> torch.Tensor:
        """x: (M, H) -> (M, H) in x's dtype."""
        mode = mode or self.fwd_mode
        if mode not in MODES:
            raise ValueError(f"unknown fwd mode {mode!r}")
        m, h = x.shape
        k, e, w = self.topk, self.num_experts, self.world
        logits = x.float() @ params["w_router"]
        weights, indices = topk_routing(logits, k, self.norm_topk_prob)
        m_pad = -(-m // w) * w
        if m_pad != m:
            pad = m_pad - m
            x = torch.cat([x, x.new_zeros((pad, h))])
            weights = torch.cat([weights, weights.new_zeros((pad, k))])
            indices = torch.cat([indices, indices.new_zeros((pad, k))])

        impl = "xla" if mode == "xla" else self.impl
        ag_x = all_gather(x.contiguous(), self.ag_ctx, impl=impl,
                          stacked=True)
        pair_ids = self._ag_meta(indices).reshape(-1)
        ag_w = self._ag_meta(weights)

        shards = self.shard_params(params)
        acts = []
        for r in range(w):
            gate, up = grouped_matmul_multi(
                ag_x[r], [shards["w_gate"][r], shards["w_up"][r]], pair_ids,
                e, topk=k)
            acts.append((F.silu(gate.float()) * up.float()).to(x.dtype))
        act = self.group.unshard(acts, 1)
        rs_impl = "xla" if mode == "xla" else "ring"
        out = moe_reduce_rs(act, params["w_down"], pair_ids, ag_w,
                            self.rs_ctx, impl=rs_impl)
        return out[:m] if m_pad != m else out

    def _ag_meta(self, arr: torch.Tensor) -> torch.Tensor:
        """All-gather of the routing metadata (JAX's ``lax.all_gather``,
        tiled): the ranks' row chunks joined in rank order."""
        return self.group.unshard(self.group.shard(arr, 0), 0)
