"""Shared layer math: RMSNorm, rotary embeddings, the world = 1 matmuls.

The port of ``triton_dist_tpu.layers.common``. Norms and rope stay plain
PyTorch, as the JAX package left them to XLA; the f32 upcasts are the
same. At world = 1 the column/row-parallel matmuls carry no collective:
each is one product with f32 accumulation, cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 accumulation."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * w.float()).to(x.dtype)


def precompute_rope_cache(head_dim: int, max_len: int, theta: float = 1e6,
                          device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape (max_len, head_dim//2), fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               position_ids: torch.Tensor) -> torch.Tensor:
    """Neox-style (rotate-half) rotary embedding.

    x: (B, S, H, D); position_ids: (B, S) int64."""
    c = cos[position_ids][:, :, None, :]  # (B, S, 1, D/2)
    s = sin[position_ids][:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def col_parallel_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) at world = 1, in the JAX (in, out) layout.

    f32 inputs multiply in f32. bf16 inputs multiply in bf16 with f32
    accumulation and one rounding of the result (cuBLAS and oneDNN both
    accumulate bf16 products in f32; ``chip_smoke.py`` turns off cuBLAS's
    reduced-precision bf16 reduction)."""
    return torch.matmul(x, w)


def row_parallel_matmul_ar(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) + AllReduce; at world = 1 the reduction is the
    identity, so this is the same product as :func:`col_parallel_matmul`
    (the plain golden of the fused ``gemm_ar`` path)."""
    return torch.matmul(x, w)
