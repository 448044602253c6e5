"""SwiGLU MLP at world = 1 (the port of ``triton_dist_tpu.layers.tp_mlp``).

The modes of the JAX layer, at world = 1:

* ``ag_rs`` (the default, JAX ``_fused_fwd(reduce="rs")``): gate, up,
  biases and SwiGLU through ``ops.allgather_gemm.ag_swiglu`` (the fused
  kernel where JAX fuses, else AG-GEMM and a plain SwiGLU, as JAX
  composes it), the down projection through GEMM-RS, then the down bias;
* ``xla`` (JAX ``_xla_fwd``, the golden of ``ag_rs``): gate and up stay
  f32 and round once after the SwiGLU at every M; the down bias is added
  to the f32 product before its one rounding; no kernel;
* ``gemm_ar``: plain gate/up products, the down projection through the
  ``gemm_ar`` kernel;
* ``xla_ar``: plain products throughout.

Weights keep the JAX ``(in_features, out_features)`` layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.layers.common import (
    col_parallel_matmul, row_parallel_matmul_ar)
from triton_dist_tpu_torch.layers.tp_attn import (
    check_mode, output_gemm_ar, output_gemm_rs)
from triton_dist_tpu_torch.ops.allgather_gemm import ag_swiglu


class TPMLP:
    """SwiGLU MLP: ``down( silu(x@gate + bg) * (x@up + bu) + bd )``.

    ``use_bias=True`` adds gate/up/down biases."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 dtype=torch.bfloat16, fwd_mode: str = "ag_rs",
                 use_bias: bool = False):
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
        gate = col_parallel_matmul(x, params["w_gate"])
        up = col_parallel_matmul(x, params["w_up"])
        if self._has_bias(params):
            gate = gate + params["b_gate"][None, :].to(gate.dtype)
            up = up + params["b_up"][None, :].to(up.dtype)
        act = F.silu(gate.float()).to(x.dtype) * up
        if mode == "gemm_ar":
            y = output_gemm_ar(act, params["w_down"])
        else:
            y = row_parallel_matmul_ar(act, params["w_down"])
        return self._add_down_bias(y, params)

    def _fused_rs_fwd(self, params, x):
        biases = ((params["b_gate"], params["b_up"])
                  if self._has_bias(params) else ())
        act = ag_swiglu(x.contiguous(), params["w_gate"], params["w_up"],
                        *biases)
        return self._add_down_bias(
            output_gemm_rs(act, params["w_down"], "ag_rs"), params)

    def _xla_fwd(self, params, x):
        xf = x.float()
        gate = xf @ params["w_gate"].float()
        up = xf @ params["w_up"].float()
        bias = self._has_bias(params)
        if bias:
            gate = gate + params["b_gate"].float()
            up = up + params["b_up"].float()
        act = (F.silu(gate) * up).to(x.dtype)
        part = act.float() @ params["w_down"].float()
        if bias:
            # JAX pre-divides the replicated bias by the world size so the
            # reduce-scatter adds it once; at world = 1 a plain add.
            part = part + params["b_down"].float()
        return part.to(x.dtype)

    def _has_bias(self, params) -> bool:
        return self.use_bias and "b_gate" in params

    def _add_down_bias(self, y, params):
        if not self._has_bias(params):
            return y
        return (y.float() + params["b_down"].float()).to(y.dtype)
