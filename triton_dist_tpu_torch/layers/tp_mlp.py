"""SwiGLU MLP at world = 1 (the port of ``triton_dist_tpu.layers.tp_mlp``).

Gate/up projections as plain products; the down projection is a plain
product in mode ``xla_ar`` and the hand-written ``gemm_ar`` kernel in
mode ``gemm_ar``. Weights keep the JAX ``(in_features, out_features)``
layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.layers.common import (
    col_parallel_matmul, row_parallel_matmul_ar)
from triton_dist_tpu_torch.layers.tp_attn import check_mode, output_gemm_ar


class TPMLP:
    """SwiGLU MLP: ``down( silu(x@gate + bg) * (x@up + bu) + bd )``.

    ``use_bias=True`` adds gate/up/down biases."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 dtype=torch.bfloat16, fwd_mode: str = "xla_ar",
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

    def _has_bias(self, params) -> bool:
        return self.use_bias and "b_gate" in params

    def _add_down_bias(self, y, params):
        if not self._has_bias(params):
            return y
        return (y.float() + params["b_down"].float()).to(y.dtype)
