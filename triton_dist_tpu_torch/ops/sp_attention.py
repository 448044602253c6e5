"""Sequence-parallel prefill attention at world = 1 (the port of
``triton_dist_tpu.ops.sp_attention``).

Five impls, as in JAX (``sp_attention.py:12-31``). With one member on
the sequence axis:

* ``"ring"`` and ``"xla"`` both run ``ag_body`` (``:518-530``, chosen at
  :559-560): one masked softmax pass of the local queries over all of
  K/V (``_chunk_scores`` :105 with its causal and ``kv_live`` masks),
  plain XLA in JAX and plain PyTorch here, for whole-prompt prefill and
  for chunked / prefix-hit prefill over a partly filled cache
  (``q_offset``, ``kv_len``).
* ``"ulysses"`` (:572-615): its four all-to-alls are identities, so the
  same full-softmax pass over all heads remains.
* ``"ag_pallas"`` (:621-648): the all-gather kernel of
  ``ops.allgather`` (``csrc/allgather.cu``) on the flattened K and V,
  then the same pass (XLA in JAX, plain PyTorch here).
* ``"pallas"`` (:617-619): :func:`sp_ag_attention_fused`, the fused
  kernel ``_sp_fused_kernel`` (:147). At world = 1 its ring is a single
  step, and what remains is a tiled causal (or full) flash prefill. On a
  CUDA tensor it launches the hand-written kernel of
  ``csrc/sp_attention.cu`` (counted in :data:`sp_attention_launches`) or
  raises; only a tensor that lies on the CPU takes the plain version
  :func:`sp_attention_fused_reference`.

JAX's ``@resilient`` routing (:463) is not carried over: an impl runs
as asked or raises. Worlds above 1 are not ported yet and raise
``NotImplementedError`` (ROADMAP.md, Queue B item 6 and Queue A item 13).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.allgather import (
    all_gather, create_allgather_context)
from triton_dist_tpu_torch.ops.common import LaunchCount, aligned16

_NEG = -1e30
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
#: KV positions per tile of the kernel (``csrc/sp_attention.cu`` kBN): the
#: width at which its p is rounded, where JAX's is ``t_sub``.
KV_TILE = 64
#: Head dims the kernel takes.
HEAD_DIMS = (64, 128)
IMPLS = ("ring", "xla", "ulysses", "ag_pallas", "pallas")
_UNPORTED = "(ROADMAP.md, Queue B item 6 and Queue A item 13)"

#: Launches of the flash-prefill kernel, by (dtype, B, S, Hq, Hkv, D,
#: causal).
sp_attention_launches = LaunchCount()


@dataclasses.dataclass
class SpAttentionContext:
    """The JAX context at world = 1: the mask kind, the sequence axis and
    the optional head axis of 2-D tp x sp attention, which only the ring
    and xla impls take (JAX asserts so at ``:569-570``)."""
    causal: bool = True
    axis: str = "sp"
    head_axis: str | None = None
    world_size: int = 1


def create_sp_attention_context(axis: str = "sp", causal: bool = True,
                                head_axis: str | None = None,
                                world_size: int = 1) -> SpAttentionContext:
    return SpAttentionContext(causal=causal, axis=axis, head_axis=head_axis,
                              world_size=world_size)


# -- plain versions ---------------------------------------------------------
def _fold_q(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, S, Hq, D) -> (B, Hkv, G, S, D): query head h * G + g pairs
    with KV head h."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)


def _unfold_out(out: torch.Tensor, dtype) -> torch.Tensor:
    """(B, Hkv, G, S, D) -> (B, S, Hq, D) in ``dtype``."""
    b, hkv, g, s, d = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hkv * g, d).to(dtype)


def _chunk_scores(q, k, q_first, k_first, causal: bool, kv_live):
    """Masked scores of q (B, K, G, S, D) against k (B, T, K, D):
    (B, K, G, S, T) f32. Products meet in k's dtype when q has it (else
    in f32) and sum in f32, which upcasting both first reproduces; the
    scale multiplies the f32 sums. Key positions are ``k_first + j``;
    those >= ``kv_live`` (when given) and, when causal, after the
    query's own position ``q_first + i`` get -1e30."""
    d = q.shape[-1]
    dt = k.dtype if q.dtype == k.dtype else torch.float32
    scores = torch.einsum("bkgsd,btkd->bkgst", q.to(dt).float(),
                          k.to(dt).float()) * (d ** -0.5)
    sq, t = scores.shape[-2], scores.shape[-1]
    k_pos = k_first + torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((sq, t), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = q_first + torch.arange(sq, device=q.device)[:, None]
        mask = q_pos >= k_pos
    if kv_live is not None:
        mask = mask & (k_pos < kv_live)
    return torch.where(mask, scores, torch.full_like(scores, _NEG))


def _masked_pass(q, k, v, causal: bool, q_offset=0, kv_len=None):
    """One masked softmax pass of q (B, S, Hq, D) over all of k/v
    (B, T, Hkv, D): JAX's ``ag_body`` (and the body of ulysses and
    ag_pallas) at world = 1. p is rounded to v's dtype for the PV
    product; out = acc / max(l, 1e-20) in q's dtype."""
    qf = _fold_q(q, k.shape[2])
    scores = _chunk_scores(qf, k, q_offset, 0, causal, kv_len)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return _unfold_out(out, q.dtype)


def sp_attention_fused_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, causal: bool = True,
                                 t_sub: int = 128) -> torch.Tensor:
    """Plain version of the fused kernel (``_sp_fused_kernel`` at world =
    1): q (B, S, Hq, D), k/v (B, S, Hkv, D) -> (B, S, Hq, D) in q's dtype.

    An online softmax over ``t_sub``-wide KV tiles (the last may be
    shorter) with JAX's rounding points (:265-287): scores in k's dtype
    when q has it, else f32, summed in f32 and scaled; masked entries
    -1e30; p rounded to that dtype for the PV product while l sums the
    f32 p; out = acc / max(l, 1e-20) (:363). Only one (S x t_sub) score
    tile per (batch, head) exists at a time. JAX's q-tile height changes
    no row's result, so every row is processed at once."""
    if t_sub < 1:
        raise ValueError(f"t_sub must be positive, got {t_sub}")
    b, s, hq, d = q.shape
    dt = k.dtype if q.dtype == k.dtype else torch.float32
    qf = _fold_q(q, k.shape[2]).to(dt).float()
    g = qf.shape[2]
    m = torch.full((b, k.shape[2], g, s), _NEG, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, k.shape[2], g, s, d), device=q.device)
    q_pos = torch.arange(s, device=q.device)[:, None]
    for j0 in range(0, k.shape[1], t_sub):
        kt = k[:, j0:j0 + t_sub].to(dt).float()
        vt = v[:, j0:j0 + t_sub].to(dt)
        scores = torch.einsum("bkgsd,btkd->bkgst", qf, kt) * (d ** -0.5)
        if causal:
            k_pos = j0 + torch.arange(kt.shape[1], device=q.device)[None, :]
            scores = torch.where(q_pos >= k_pos, scores,
                                 torch.full_like(scores, _NEG))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(vt.dtype).float(),
                          vt.float())
        m = m_new
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + pv
        del scores, p, pv
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return _unfold_out(out, q.dtype)


# -- tolerances --------------------------------------------------------------
#: |kernel - plain version| allowed for f32 prefill outputs: unit-scale
#: outputs summed over up to 32k terms in another order.
SP_F32_ATOL = 3e-5
_BF16_ULP_REL = 2.0 ** -7


def attention_weight(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True) -> torch.Tensor:
    """sum_j (p_j / l) |v_j| for each element of the prefill output
    (B, S, Hq, D), in f32: the plain version in f32 over |v|. It is what
    bf16 rounding of the probabilities can move that element by, in
    units of the rounding."""
    return sp_attention_fused_reference(q.float(), k.float(),
                                        v.float().abs(), causal,
                                        t_sub=KV_TILE).float()


def bf16_attention_limit(got: torch.Tensor, ref: torch.Tensor,
                         weight) -> torch.Tensor:
    """Elementwise |got - ref| allowed between two bf16 attention outputs
    that each round their probabilities p_j to bf16 for the PV product
    (at the same points or not) and round their f32 result once.

    One bf16 ulp of the larger output (2^-7 of it) covers the last
    rounding. Rounding p_j moves an output by at most 2^-8 (p_j / l)
    |v_j| on each side, so 2^-7 * ``weight`` (``weight`` = sum_j (p_j /
    l) |v_j| elementwise, :func:`attention_weight`; max|v| bounds it) is
    the worst case of the two together; the roundings' signs vary with
    j, and half of that worst case is the limit."""
    return (_BF16_ULP_REL * torch.maximum(got.float().abs(),
                                          ref.float().abs())
            + 2.0 ** -8 * weight)


def sp_attention_tolerance(got: torch.Tensor, ref: torch.Tensor,
                           q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           causal: bool = True) -> torch.Tensor:
    """Elementwise |got - ref| allowed between a flash prefill (the kernel,
    or JAX's) and its plain version on q, k, v: :data:`SP_F32_ATOL` for
    f32 outputs, else :func:`bf16_attention_limit` with the weight of
    :func:`attention_weight`."""
    if got.dtype == torch.float32:
        return torch.full(got.shape, SP_F32_ATOL, device=got.device)
    return bf16_attention_limit(got, ref, attention_weight(q, k, v, causal))


# -- the kernel --------------------------------------------------------------
def _clamp_tile(blk: int, s: int) -> int:
    """JAX's tile clamp (:386-391): at most S, halved until it divides S."""
    blk = min(blk, s)
    while s % blk:
        blk //= 2
    return blk


def _check_operands(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"sp attention needs q (B, S, Hq, D) and k/v of "
                         f"one 4-D shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not group over k/v "
                         f"{tuple(k.shape)}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("sp attention operands lie on different devices")


def launch_sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    """One launch of the flash-prefill kernel on CUDA tensors: q
    (B, S, Hq, D), k/v (B, S, Hkv, D), one dtype (bf16 or f32), D in
    :data:`HEAD_DIMS`. Returns (B, S, Hq, D) in q's dtype."""
    _check_operands(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"the sp attention kernel runs on CUDA, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"the sp attention kernel takes q, k and v all "
                         f"bf16 or all f32, not {q.dtype} / {k.dtype} / "
                         f"{v.dtype}")
    b, s, hq, d = q.shape
    if d not in HEAD_DIMS or k.shape[1] != s:
        raise ValueError(f"the sp attention kernel takes head dim in "
                         f"{HEAD_DIMS} and as many keys as queries, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the sp attention kernel needs contiguous operands")
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    lib = _lib()
    out = torch.empty_like(q)
    hkv = k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.tdt_sp_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), b, s, hq, hkv, d, int(causal),
                               _DTYPE_CODES[q.dtype], d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"sp attention kernel call failed: "
                           f"{lib.tdt_error_string(err).decode()} ({err})")
    sp_attention_launches.add((str(q.dtype).removeprefix("torch."), b, s,
                               hq, hkv, d, bool(causal)))
    return out


def _check_world(ctx: SpAttentionContext) -> None:
    if ctx.world_size != 1:
        raise NotImplementedError(
            f"sp attention at world {ctx.world_size} is not ported yet "
            f"{_UNPORTED}")


def sp_ag_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          ctx: SpAttentionContext | None = None,
                          sq_blk: int = 128, t_sub: int = 128
                          ) -> torch.Tensor:
    """The fused prefill (JAX ``sp_ag_attention_fused`` :373) at world =
    1, with JAX's signature. ``sq_blk`` (JAX's q-tile height) changes no
    result and is only checked. CPU tensors run
    :func:`sp_attention_fused_reference` with ``t_sub`` clamped as JAX
    clamps it, so p is rounded at JAX's points. CUDA tensors launch the
    kernel, whose KV tiles are :data:`KV_TILE` wide: there ``t_sub`` is
    ignored."""
    ctx = ctx or create_sp_attention_context()
    _check_world(ctx)
    _check_operands(q, k, v)
    if sq_blk < 1 or t_sub < 1:
        raise ValueError(f"tile sizes must be positive, got sq_blk "
                         f"{sq_blk}, t_sub {t_sub}")
    if q.device.type == "cpu":
        return sp_attention_fused_reference(q, k, v, ctx.causal,
                                            _clamp_tile(t_sub, q.shape[1]))
    return launch_sp_attention(q, k, v, ctx.causal)


def sp_ag_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ctx: SpAttentionContext | None = None,
                    impl: str = "ring", q_offset=0,
                    kv_len=None) -> torch.Tensor:
    """Prefill attention (JAX ``sp_ag_attention`` :464) at world = 1.

    q: (B, S, Hq, D); k/v: (B, T, Hkv, D), T >= S for a chunk over a
    cache. ``q_offset``: position of q's first row; ``kv_len``: live KV
    positions (default T); both only with impl "ring" or "xla", as in
    JAX. Returns (B, S, Hq, D) in q's dtype. A query row with no live
    key gets finite garbage, as in JAX."""
    if impl not in IMPLS:
        raise ValueError(f"unknown sp attention impl {impl!r}")
    ctx = ctx or create_sp_attention_context()
    _check_world(ctx)
    chunked = (kv_len is not None or k.shape[1] != q.shape[1]
               or not (isinstance(q_offset, int) and q_offset == 0))
    if impl in ("ring", "xla"):
        return _masked_pass(q, k, v, ctx.causal, q_offset,
                            k.shape[1] if kv_len is None else kv_len)
    if chunked:
        raise ValueError(f"q_offset/kv_len (chunked prefill) support impl "
                         f"'ring' and 'xla', not {impl!r}")
    if ctx.head_axis is not None:
        raise ValueError(f"impl={impl!r} does not support head_axis (use "
                         f"'ring' or 'xla')")
    if impl == "ulysses":
        return _masked_pass(q, k, v, ctx.causal)
    if impl == "pallas":
        return sp_ag_attention_fused(q, k, v, ctx)
    # ag_pallas: the all-gather kernel on K/V flattened to (S, B*Hkv*D).
    b, s, hkv, d = k.shape
    ag_ctx = create_allgather_context(ctx.axis)
    kg, vg = (all_gather(t.transpose(0, 1).reshape(s, b * hkv * d), ag_ctx,
                         impl="pallas").reshape(s, b, hkv, d).transpose(0, 1)
              for t in (k, v))
    return _masked_pass(q, kg, vg, ctx.causal)


# -- zigzag ------------------------------------------------------------------
def _zigzag_index(s: int, world: int) -> list:
    if s % (2 * world):
        raise ValueError(f"zigzag needs a length divisible by 2 * world, "
                         f"got {s} for world {world}")
    c = s // (2 * world)
    idx = []
    for r in range(world):
        idx.extend(range(r * c, (r + 1) * c))
        idx.extend(range((2 * world - 1 - r) * c, (2 * world - r) * c))
    return idx


def zigzag_reorder(x: torch.Tensor, world: int,
                   seq_axis: int = 1) -> torch.Tensor:
    """Zigzag sequence permutation for causal load balance (JAX :653):
    shard r gets chunks (r, 2w-1-r) so early and late positions pair up."""
    idx = torch.tensor(_zigzag_index(x.shape[seq_axis], world),
                       device=x.device)
    return torch.index_select(x, seq_axis, idx)


def zigzag_restore(x: torch.Tensor, world: int,
                   seq_axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_reorder` (JAX :667)."""
    idx = _zigzag_index(x.shape[seq_axis], world)
    inv = [0] * len(idx)
    for new, old in enumerate(idx):
        inv[old] = new
    return torch.index_select(x, seq_axis,
                              torch.tensor(inv, device=x.device))


# -- the library ---------------------------------------------------------------
def _lib() -> ctypes.CDLL:
    lib = _build.load("sp_attention")
    if lib.tdt_sp_attention.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tdt_sp_attention.argtypes = [p] * 4 + [i] * 7 + [ctypes.c_float,
                                                             p]
        lib.tdt_sp_attention.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
