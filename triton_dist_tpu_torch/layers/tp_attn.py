"""GQA attention at world = 1 (the port of ``triton_dist_tpu.layers.tp_attn``).

QKV projections, Qwen3 per-head q/k RMSNorm, rotary embeddings, cached
causal attention, then the output projection. The modes of the JAX
layer, at world = 1:

* ``ag_rs`` (the default, the fused TP path): QKV through the
  hand-written AG-GEMM kernel (``ops.allgather_gemm.ag_gemm_multi``, one
  launch), the output projection through GEMM-RS
  (``ops.gemm_reduce_scatter.gemm_rs``);
* ``xla``: its golden, the same arithmetic through the plain versions
  (f32 products, one rounding each), no kernel;
* ``gemm_ar``: plain QKV products, the output projection through the
  ``gemm_ar`` kernel;
* ``xla_ar``: plain products throughout.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.layers.common import (
    apply_rope, col_parallel_matmul, rms_norm, row_parallel_matmul_ar)
from triton_dist_tpu_torch.ops.allgather_gemm import (
    ag_gemm_multi, ag_gemm_multi_reference)
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import (
    gemm_ar, gemm_rs, gemm_rs_reference)

#: The forward modes of the layers (JAX ``TPAttn`` / ``TPMLP``).
MODES = ("ag_rs", "xla", "gemm_ar", "xla_ar")


def check_mode(mode: str) -> None:
    """Raise for an unknown layer mode."""
    if mode not in MODES:
        raise ValueError(f"unknown fwd mode {mode!r}")


def output_gemm_ar(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The fused row-parallel projection of mode ``gemm_ar``."""
    return gemm_ar(x.contiguous(), w)


def output_gemm_rs(x: torch.Tensor, w: torch.Tensor,
                   mode: str) -> torch.Tensor:
    """The row-parallel projection of the sharded modes: GEMM-RS in
    ``ag_rs``, its plain version in ``xla``."""
    if mode == "xla":
        return gemm_rs_reference(x, w)
    return gemm_rs(x.contiguous(), w)


class TPAttn:
    """GQA attention. No QKV bias (Qwen3 dropped it)."""

    def __init__(self, hidden_size: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, dtype=torch.bfloat16,
                 fwd_mode: str = "ag_rs",
                 qk_norm: bool = True, rms_eps: float = 1e-6):
        if num_heads % num_kv_heads:
            raise ValueError(f"{num_heads} heads do not group over "
                             f"{num_kv_heads} kv heads")
        self.hidden_size = hidden_size
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.fwd_mode = fwd_mode
        self.qk_norm = qk_norm
        self.rms_eps = rms_eps

    def set_fwd(self, mode: str):
        self.fwd_mode = mode

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator, device) -> dict:
        h, d = self.hidden_size, self.head_dim
        nq, nkv = self.num_heads * d, self.num_kv_heads * d

        def normal(shape, scale):
            return torch.randn(shape, generator=generator, device=device,
                               dtype=self.dtype) * scale

        params = {
            "w_q": normal((h, nq), h ** -0.5),
            "w_k": normal((h, nkv), h ** -0.5),
            "w_v": normal((h, nkv), h ** -0.5),
            "w_o": normal((nq, h), nq ** -0.5),
        }
        if self.qk_norm:
            params["q_norm"] = torch.ones((d,), dtype=self.dtype,
                                          device=device)
            params["k_norm"] = torch.ones((d,), dtype=self.dtype,
                                          device=device)
        return params

    # -- forward -----------------------------------------------------------
    def __call__(self, params: dict, x: torch.Tensor,
                 position_ids: torch.Tensor, rope_cache, kv_cache, offset,
                 mode: str | None = None, kv_start=None):
        """One attention block.

        Args:
          x: (M, H) activations, M = B*S.
          position_ids: (B, S) absolute positions.
          rope_cache: (cos, sin) tables (T_max, D/2).
          kv_cache: (k, v) each (B, T, num_kv_heads, D); updated in place.
          offset: write position into the cache: an int, or a (B,) tensor
            of per-row positions (see :func:`_attention_core`).
        Returns:
          (out (M, H), (k_cache, v_cache)).
        """
        mode = mode or self.fwd_mode
        check_mode(mode)
        b, s = position_ids.shape
        d = self.head_dim
        w_qkv = [params["w_q"], params["w_k"], params["w_v"]]
        if mode == "ag_rs":
            q, k, v = ag_gemm_multi(x.contiguous(), w_qkv)
        elif mode == "xla":
            q, k, v = ag_gemm_multi_reference(x, w_qkv)
        else:
            q, k, v = (col_parallel_matmul(x, w) for w in w_qkv)
        q = q.reshape(b, s, self.num_heads, d)
        k = k.reshape(b, s, self.num_kv_heads, d)
        v = v.reshape(b, s, self.num_kv_heads, d)
        # Per-head RMSNorm before rope (Qwen3).
        if self.qk_norm:
            q = rms_norm(q, params["q_norm"], self.rms_eps)
            k = rms_norm(k, params["k_norm"], self.rms_eps)
        cos, sin = rope_cache
        q = apply_rope(q, cos, sin, position_ids)
        k = apply_rope(k, cos, sin, position_ids)
        if kv_start is None:
            kv_start = torch.zeros((b,), dtype=torch.int64, device=x.device)
        attn = _attention_core(q, k, v, kv_cache[0], kv_cache[1], offset,
                               kv_start,
                               groups=self.num_heads // self.num_kv_heads)
        attn = attn.reshape(b * s, self.num_heads * d)
        if mode in ("ag_rs", "xla"):
            out = output_gemm_rs(attn, params["w_o"], mode)
        elif mode == "gemm_ar":
            out = output_gemm_ar(attn, params["w_o"])
        else:
            out = row_parallel_matmul_ar(attn, params["w_o"])
        return out, kv_cache


def write_cache(cache: torch.Tensor, new: torch.Tensor, offset) -> None:
    """Write (B, S, hkv, D) ``new`` into ``cache`` in place at ``offset``.

    Scalar offset: one slice, its start clamped into [0, T - S] as JAX's
    ``dynamic_update_slice`` clamps. (B,) offsets: row b's S positions
    land at offset[b] + [0, S); positions outside [0, T) are dropped, as
    JAX's scatter drops them."""
    b, s = new.shape[:2]
    t = cache.shape[1]
    if not torch.is_tensor(offset) or offset.dim() == 0:
        start = min(max(int(offset), 0), t - s)
        cache[:, start:start + s] = new
        return
    rows = torch.arange(b, device=cache.device)
    if s == 1:
        # One position per row: clamp the index and write the old value
        # back where it was out of range (no host sync, no collisions).
        keep = (offset >= 0) & (offset < t)
        pos = offset.clamp(0, t - 1)
        cache[rows, pos] = torch.where(keep[:, None, None], new[:, 0],
                                       cache[rows, pos])
        return
    pos = offset[:, None] + torch.arange(s, device=cache.device)[None]
    keep = (pos >= 0) & (pos < t)
    cache[rows[:, None].expand(b, s)[keep], pos[keep]] = new[keep]


def _attention_core(q, k, v, cache_k, cache_v, offset, kv_start, *,
                    groups: int):
    """Single-device cached causal GQA (fp32 softmax).

    q: (B, S, hq, D); k/v: (B, S, hkv, D); cache: (B, T, hkv, D), written
    in place. Query i sits at absolute position offset+i and attends to
    cache positions kv_start[b] <= j <= offset+i; ``kv_start`` is the
    left-padding boundary of ragged batches (all zeros = the plain causal
    mask). Fully masked (pad) query rows get finite garbage, not NaN;
    their logits are never consumed.

    ``offset`` is an int (contiguous slice write) or a PER-ROW (B,)
    tensor: each row writes at its own position, one position (S == 1,
    the stream decode step) or a burst of S positions offset[b]+[0, S)
    (the speculative-decoding verify window; positions past T drop).

    Scores: q and the cache are upcast to f32 before the products, which
    equals JAX's cache-dtype contraction with f32 accumulation (a product
    of two bf16 values is exact in f32). Probabilities round to the
    cache dtype before the value contraction, as in JAX."""
    b, s, hq, d = q.shape
    t = cache_k.shape[1]
    hkv = cache_k.shape[2]
    write_cache(cache_k, k, offset)
    write_cache(cache_v, v, offset)
    if torch.is_tensor(offset) and offset.dim() == 1:
        off_b = offset
    else:
        off_b = torch.full((b,), int(offset), dtype=torch.int64,
                           device=q.device)

    dt = cache_k.dtype if q.dtype == cache_k.dtype else torch.float32
    qg = q.reshape(b, s, hkv, groups, d).to(dt).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          cache_k.to(dt).float()) * (d ** -0.5)
    ar_t = torch.arange(t, device=q.device)
    q_pos = off_b[:, None, None] + torch.arange(s, device=q.device)[
        None, :, None]                                       # (B, S, 1)
    causal = ar_t[None, None, :] <= q_pos                    # (B, S, T)
    live = ar_t[None, :] >= kv_start[:, None]                # (B, T)
    mask = causal & live[:, None]                            # (B, S, T)
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(dt).float(),
                       cache_v.to(dt).float())
    return out.reshape(b, s, hq, d).to(q.dtype)
