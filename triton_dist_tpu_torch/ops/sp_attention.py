"""Sequence-parallel prefill attention at world = 1 (the port of
``triton_dist_tpu.ops.sp_attention``).

With one member on the sequence axis the JAX package's "ring" and "xla"
impls both run ``ag_body`` (``sp_attention.py:518-530``, chosen at
:559-560): one masked softmax pass of the local queries over all of K/V,
plain XLA with no Pallas kernel. This module is that math in plain
PyTorch (``_chunk_scores`` :105 with its causal and ``kv_live`` masks),
for whole-prompt prefill and for chunked / prefix-hit prefill over a
partly filled cache (``q_offset``, ``kv_len``).

The fused Pallas kernel (``impl="pallas"``, ``_sp_fused_kernel`` :147),
the two-step ``"ag_pallas"`` and ``"ulysses"`` are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

_NEG = -1e30


@dataclasses.dataclass
class SpAttentionContext:
    """The JAX context at world = 1: only the mask kind remains."""
    causal: bool = True


def _chunk_scores(q, k, q_first, causal: bool, kv_live):
    """Masked scores of q (B, K, G, S, D) against k (B, T, K, D):
    (B, K, G, S, T) f32. Products meet in k's dtype when q has it (else
    in f32) and sum in f32, which upcasting both first reproduces.
    Positions >= ``kv_live`` and, when causal, after the query's own
    position ``q_first + i`` get -1e30."""
    d = q.shape[-1]
    dt = k.dtype if q.dtype == k.dtype else torch.float32
    scores = torch.einsum("bkgsd,btkd->bkgst", q.to(dt).float(),
                          k.to(dt).float()) * (d ** -0.5)
    sq, t = scores.shape[-2], scores.shape[-1]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = k_pos < kv_live
    if causal:
        q_pos = q_first + torch.arange(sq, device=q.device)[:, None]
        mask = mask & (q_pos >= k_pos)
    return torch.where(mask, scores, torch.full_like(scores, _NEG))


def sp_ag_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ctx: SpAttentionContext | None = None,
                    impl: str = "ring", q_offset: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """Prefill attention (JAX ``sp_ag_attention`` at world = 1).

    q: (B, S, Hq, D); k/v: (B, T, Hkv, D), T >= S for a chunk over a
    cache. ``q_offset``: position of q's first row; ``kv_len``: live KV
    positions (default T). Returns (B, S, Hq, D) in q's dtype. A query
    row with no live key gets finite garbage, as in JAX."""
    if impl in ("pallas", "ag_pallas", "ulysses"):
        raise NotImplementedError(
            f"sp attention impl={impl!r} is not ported yet (ROADMAP.md, "
            f"Queue B item 6 for the fused kernel and Queue A item 13 for "
            f"the other sequence-parallel impls)")
    if impl not in ("ring", "xla"):
        raise ValueError(f"unknown sp attention impl {impl!r}")
    ctx = ctx or SpAttentionContext()
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    kv_len = t if kv_len is None else kv_len
    qf = q.reshape(b, s, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)
    scores = _chunk_scores(qf, k, q_offset, ctx.causal, kv_len)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)
