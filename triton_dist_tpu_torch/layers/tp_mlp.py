"""SwiGLU MLP (the port of ``triton_dist_tpu.layers.tp_mlp``).

The modes of the JAX layer:

* ``ag_rs`` (the default, JAX ``_fused_fwd(reduce="rs")``): gate, up,
  biases and SwiGLU through ``ops.allgather_gemm.ag_swiglu`` (the fused
  kernel where JAX fuses, else AG-GEMM and a plain SwiGLU, as JAX
  composes it), the down projection through GEMM-RS, then the down bias
  once, in f32 (JAX ``_add_down_bias``, tp_mlp.py:120-124);
* ``xla`` (JAX ``_xla_fwd``, the golden of ``ag_rs``): gate and up stay
  f32 and round once after the SwiGLU at every M; each rank adds
  ``b_down / W`` to its f32 partial before the partial rounds and the
  ranks' partials are summed (tp_mlp.py:173-177), so at world 1 the
  bias is added once before the one rounding; no kernel;
* ``gemm_ar`` (JAX ``_fused_fwd(reduce="ar")``): column-parallel gate/up
  products, the down projection through ``gemm_ar``, then the down bias;
* ``xla_ar``: plain products throughout, the down bias after the sum.

Over a rank group of W > 1 (``runtime.dist``) the weights shard as JAX
shards them (gate/up by columns, down by rows; every shard a view): the
activations are row-sharded in ``ag_rs`` / ``xla`` and replicated in
``gemm_ar`` / ``xla_ar``, and the fused modes run the ring kernels.

Weights keep the JAX ``(in_features, out_features)`` layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.layers.common import (
    col_parallel_matmul, row_parallel_matmul_ar)
from triton_dist_tpu_torch.layers.tp_attn import (
    check_mode, output_gemm_ar, output_gemm_rs, ring_contexts)
from triton_dist_tpu_torch.ops.allgather_gemm import ag_swiglu
from triton_dist_tpu_torch.runtime.dist import RankGroup


class TPMLP:
    """SwiGLU MLP: ``down( silu(x@gate + bg) * (x@up + bu) + bd )``.

    ``use_bias=True`` adds gate/up/down biases. ``group``: the ranks the
    layer shards over (default: world 1)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 dtype=torch.bfloat16, fwd_mode: str = "ag_rs",
                 use_bias: bool = False, group: RankGroup | None = None):
        self.group = group
        self.world = group.world if group is not None else 1
        self.ag_ctx, self.rs_ctx = ring_contexts(group)
        if intermediate_size % self.world:
            raise ValueError(f"intermediate size {intermediate_size} does "
                             f"not shard over {self.world} ranks")
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.dtype = dtype
        self.fwd_mode = fwd_mode
        self.use_bias = use_bias

    def set_fwd(self, mode: str):
        self.fwd_mode = mode

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator, device) -> dict:
        h, i = self.hidden_size, self.intermediate_size

        def normal(shape, scale):
            return torch.randn(shape, generator=generator, device=device,
                               dtype=self.dtype) * scale

        params = {
            "w_gate": normal((h, i), h ** -0.5),
            "w_up": normal((h, i), h ** -0.5),
            "w_down": normal((i, h), i ** -0.5),
        }
        if self.use_bias:
            for name, n in (("b_gate", i), ("b_up", i), ("b_down", h)):
                params[name] = torch.zeros((n,), dtype=self.dtype,
                                           device=device)
        return params

    # -- forward -----------------------------------------------------------
    def __call__(self, params: dict, x: torch.Tensor,
                 mode: str | None = None) -> torch.Tensor:
        """x: (M, H) -> (M, H)."""
        mode = mode or self.fwd_mode
        check_mode(mode)
        if mode == "ag_rs":
            return self._fused_rs_fwd(params, x)
        if mode == "xla":
            return self._xla_fwd(params, x)
        group = self.group
        gate = col_parallel_matmul(x, params["w_gate"], group)
        up = col_parallel_matmul(x, params["w_up"], group)
        if self._has_bias(params):
            gate = gate + params["b_gate"][None, :].to(gate.dtype)
            up = up + params["b_up"][None, :].to(up.dtype)
        act = F.silu(gate.float()).to(x.dtype) * up
        if mode == "gemm_ar":
            y = output_gemm_ar(act, params["w_down"], self.rs_ctx)
        else:
            y = row_parallel_matmul_ar(act, params["w_down"], group)
        return self._add_down_bias(y, params)

    def _fused_rs_fwd(self, params, x):
        biases = ((params["b_gate"], params["b_up"])
                  if self._has_bias(params) else ())
        act = ag_swiglu(x.contiguous(), params["w_gate"], params["w_up"],
                        *biases, group=self.group, ctx=self.ag_ctx)
        return self._add_down_bias(
            output_gemm_rs(act, params["w_down"], "ag_rs", self.rs_ctx),
            params)

    def _xla_fwd(self, params, x):
        """JAX's shard_map golden: per rank, the gathered x through its
        gate/up column shards, SwiGLU rounded once, its down partial with
        ``b_down / W`` added in f32, rounded; the partials summed."""
        bias = self._has_bias(params)
        world = self.world

        def body(wg, wu, wd, bg=None, bu=None):
            xf = x.float()
            gate = xf @ wg.float()
            up = xf @ wu.float()
            if bias:
                gate = gate + bg.float()
                up = up + bu.float()
            act = (F.silu(gate) * up).to(x.dtype)
            part = act.float() @ wd.float()
            if bias:
                part = part + params["b_down"].float() / world
            return part.to(x.dtype)
        group = self.group or RankGroup(1, device=x.device)
        shards = [group.shard(params["w_gate"], 1),
                  group.shard(params["w_up"], 1),
                  group.shard(params["w_down"], 0)]
        if bias:
            shards += [group.shard(params["b_gate"], 0),
                       group.shard(params["b_up"], 0)]
        return group.psum(body(*(s[r] for s in shards))
                          for r in range(world))

    def _has_bias(self, params) -> bool:
        return self.use_bias and "b_gate" in params

    def _add_down_bias(self, y, params):
        if not self._has_bias(params):
            return y
        return (y.float() + params["b_down"].float()).to(y.dtype)
