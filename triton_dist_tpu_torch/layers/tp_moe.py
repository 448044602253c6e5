"""Tensor-parallel MoE layer at world = 1 (the port of
``triton_dist_tpu.layers.tp_moe``).

The layer of JAX ``TPMoE.__call__`` (tp_moe.py:84-129), step by step:

1. router: an f32 product with the f32 router, then ``topk_routing``;
2. all-gather of the token rows (``ops.allgather``: the copy kernel in
   mode ``ag_rs``, the identity of ``impl="xla"`` in mode ``xla``) and of
   the routing metadata (:meth:`TPMoE._ag_meta`, the identity at world 1);
3. gate and up: ``grouped_matmul`` of each, rounded to the activation
   dtype, then a plain SwiGLU in f32, rounded (tp_moe.py:119-124). On
   CUDA the two products share one launch of the grouped-GEMM kernel,
   which reads each pair's token row through the pair -> token index
   where JAX expands the rows with ``jnp.repeat``;
4. down projection and top-k reduce: ``moe_reduce_rs`` ("ring" in mode
   ``ag_rs``, "xla" in mode ``xla``; at world = 1 both are the one-shot
   body: pair products rounded, f32 weighted sum, one rounding).

Weights keep the JAX layout: the router (H, E) in f32, experts stacked
(E, H, I) and (E, I, H).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.ops.allgather import (
    all_gather, create_allgather_context)
from triton_dist_tpu_torch.ops.group_gemm import grouped_matmul_multi
from triton_dist_tpu_torch.ops.moe_reduce_rs import (
    create_moe_rs_context, moe_reduce_rs)
from triton_dist_tpu_torch.ops.moe_utils import topk_routing

#: The modes of the JAX layer.
MODES = ("ag_rs", "xla")


class TPMoE:
    """Qwen3-MoE sparse FFN: softmax top-k routing over ``num_experts``
    SwiGLU experts of width ``intermediate_size``."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int, topk: int, dtype=torch.bfloat16,
                 fwd_mode: str = "ag_rs", impl: str = "pallas",
                 norm_topk_prob: bool = True):
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.topk = topk
        self.dtype = dtype
        self.fwd_mode = fwd_mode
        self.impl = impl
        self.norm_topk_prob = norm_topk_prob
        self.ag_ctx = create_allgather_context()
        self.rs_ctx = create_moe_rs_context(num_experts=num_experts,
                                            topk=topk)

    def set_fwd(self, mode: str):
        self.fwd_mode = mode

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator, device) -> dict:
        """Random params on ``device`` with JAX's scales; the router is
        f32."""
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

    # -- forward -----------------------------------------------------------
    def __call__(self, params: dict, x: torch.Tensor,
                 mode: str | None = None) -> torch.Tensor:
        """x: (M, H) -> (M, H) in x's dtype."""
        mode = mode or self.fwd_mode
        if mode not in MODES:
            raise ValueError(f"unknown fwd mode {mode!r}")
        k, e = self.topk, self.num_experts
        logits = x.float() @ params["w_router"]
        weights, indices = topk_routing(logits, k, self.norm_topk_prob)

        impl = "xla" if mode == "xla" else self.impl
        ag_x = all_gather(x.contiguous(), self.ag_ctx, impl=impl)
        pair_ids = self._ag_meta(indices).reshape(-1)
        ag_w = self._ag_meta(weights)

        gate, up = grouped_matmul_multi(
            ag_x, [params["w_gate"], params["w_up"]], pair_ids, e, topk=k)
        act = (F.silu(gate.float()) * up.float()).to(x.dtype)
        rs_impl = "xla" if mode == "xla" else "ring"
        return moe_reduce_rs(act, params["w_down"], pair_ids, ag_w,
                             self.rs_ctx, impl=rs_impl)

    @staticmethod
    def _ag_meta(arr: torch.Tensor) -> torch.Tensor:
        """All-gather of the routing metadata: the identity at world 1."""
        return arr
