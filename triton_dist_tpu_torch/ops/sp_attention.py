"""Sequence-parallel prefill attention (the port of
``triton_dist_tpu.ops.sp_attention``).

Five impls, as in JAX (``sp_attention.py:12-31``). q and k/v are global
(B, S, H, D) tensors whose S is split over the W ranks of the context's
group (rank r holds positions [r S / W, (r + 1) S / W)); each rank's
shard is a view. With one member on the sequence axis the ring is one
step; at world W:

* ``"ring"`` (``ring_body`` :532-557): rank r folds K/V chunks
  src = r, r - 1, ..., r - W + 1 (mod W, the W - 1 hops of its ring)
  into an online softmax with ``_chunk_scores`` (:105)'s causal and
  ``kv_live`` masks at global positions. At world 1 JAX takes
  ``ag_body`` for it (:559-560).
* ``"xla"`` (``ag_body`` :518-530): the all-gathered K/V and one masked
  softmax pass of each rank's queries at their global positions; the
  ranks' rows are independent, so this is one pass over all rows.
* ``"ulysses"`` (:572-615): its four all-to-alls trade the sequence
  split for a head split; rank r runs the full-sequence pass on its
  Hq / W query and Hkv / W KV heads.
* ``"ag_pallas"`` (:621-648): the all-gather kernels of
  ``ops.allgather`` (``csrc/allgather.cu``: the copy at world 1, the
  world-W kernel at world W) on K and V flattened to (S, B Hkv D), then
  each rank's masked pass over its own gathered copy, its queries at
  their global offset.
* ``"pallas"`` (:617-619): :func:`sp_ag_attention_fused`, the fused
  kernel ``_sp_fused_kernel`` (:147). At world 1 its ring is a single
  step and what remains is a tiled causal (or full) flash prefill, the
  hand-written kernel of ``csrc/sp_attention.cu`` (counted in
  :data:`sp_attention_launches`); at world W the same file's ring
  kernel, which forwards each K/V chunk around the ranks while it
  consumes it (:data:`sp_ring_launches`). On a CUDA tensor each
  launches or raises; only a tensor that lies on the CPU takes the
  plain version :func:`sp_attention_fused_reference`.

The ring, xla and ulysses impls are XLA collectives in JAX, not Pallas
kernels, so plain PyTorch is their port. JAX's ``@resilient`` routing
(:463) is not carried over: an impl runs as asked or raises. The 2-D tp
x sp attention (``head_axis`` at world > 1) is not ported yet (ROADMAP.md,
Queue A item 13).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.allgather import (
    AllGatherContext, all_gather, create_allgather_context)
from triton_dist_tpu_torch.ops.common import LaunchCount, aligned16
from triton_dist_tpu_torch.runtime.dist import RankGroup
from triton_dist_tpu_torch.runtime.symm_mem import RingState, rank_span

_NEG = -1e30
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
#: KV positions per tile of the bf16 kernel (``csrc/sp_attention.cu``
#: kWgBN): the width at which its p is rounded, where JAX's is ``t_sub``
#: (128 by default, as here). The f32 kernel's tiles are 64 wide; its p is
#: not rounded.
KV_TILE = 128
#: Positions per piece of the ring kernel's copies, one signal each
#: (``csrc/sp_attention.cu`` kPiece).
RING_PIECE = 64
#: Head dims the kernel takes.
HEAD_DIMS = (64, 128)
IMPLS = ("ring", "xla", "ulysses", "ag_pallas", "pallas")

#: Launches of the flash-prefill kernel, by (dtype, B, S, Hq, Hkv, D,
#: causal).
sp_attention_launches = LaunchCount()
#: Launches of the ring kernel (world W), by (dtype, W, B, S, Hq, Hkv, D,
#: causal).
sp_ring_launches = LaunchCount()


@dataclasses.dataclass
class SpAttentionContext:
    """The JAX context: the mask kind, the sequence axis, its ranks and
    the optional head axis of 2-D tp x sp attention, which only the ring
    and xla impls take (JAX asserts so at ``:569-570``).

    ``group`` (the ranks of the sequence axis) sets ``world_size``; a
    context without one runs the plain versions at ``world_size`` on the
    CPU, and the ring kernel needs one. The context keeps the ring
    kernel's workspaces, signals and call counter (``state``) and the
    all-gather context of ``ag_pallas`` (``ag_ctx``) across calls."""
    causal: bool = True
    axis: str = "sp"
    head_axis: str | None = None
    world_size: int = 1
    group: RankGroup | None = None
    state: RingState | None = dataclasses.field(default=None, init=False,
                                                repr=False)
    ag_ctx: AllGatherContext | None = dataclasses.field(
        default=None, init=False, repr=False)

    def __post_init__(self):
        if self.group is not None:
            if self.world_size not in (1, self.group.world):
                raise ValueError(f"world_size {self.world_size} and a group "
                                 f"of {self.group.world} ranks disagree")
            self.world_size = self.group.world
            self.state = RingState(self.group)
        if self.world_size < 1:
            raise ValueError(f"world_size must be >= 1, got "
                             f"{self.world_size}")
        self.ag_ctx = create_allgather_context(
            self.axis, world_size=self.world_size,
            group=self.group if self.world_size > 1 else None)


def create_sp_attention_context(axis: str = "sp", causal: bool = True,
                                head_axis: str | None = None,
                                world_size: int = 1,
                                group: RankGroup | None = None
                                ) -> SpAttentionContext:
    """The context over ``group`` (JAX ``create_sp_attention_context``
    over a mesh axis)."""
    return SpAttentionContext(causal=causal, axis=axis, head_axis=head_axis,
                              world_size=world_size, group=group)


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
    query's own position ``q_first + i`` get -1e30. ``q_first`` and
    ``k_first`` are ints, or tensors that broadcast over the scores'
    leading dimensions (one per batch element)."""
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


def _flash_fold(qf, q_first: int, chunks, causal: bool, t_sub: int, dt):
    """The online softmax of JAX's fused kernel for one rank's folded
    queries qf (B, K, G, Sq, D) in f32, at global positions q_first +
    [0, Sq), over ``chunks`` [(k, v, k_first)] in order, each in
    ``t_sub``-wide tiles (the last may be shorter), with its rounding
    points (:265-287). Returns out (B, K, G, Sq, D) f32."""
    b, hkv, g, sq, d = qf.shape
    dev = qf.device
    m = torch.full((b, hkv, g, sq), _NEG, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, d), device=dev)
    q_pos = q_first + torch.arange(sq, device=dev)[:, None]
    for kc, vc, k_first in chunks:
        for j0 in range(0, kc.shape[1], t_sub):
            kt = kc[:, j0:j0 + t_sub].to(dt).float()
            vt = vc[:, j0:j0 + t_sub].to(dt)
            scores = torch.einsum("bkgsd,btkd->bkgst", qf, kt) * (d ** -0.5)
            if causal:
                k_pos = (k_first + j0
                         + torch.arange(kt.shape[1], device=dev)[None, :])
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
    return acc / torch.clamp(l, min=1e-20)[..., None]


def ring_chunks(me: int, world: int, causal: bool) -> list:
    """The chunks rank ``me`` of the fused kernel consumes, in order: its
    ring steps s = 0..W-1 carry chunk (me - s) mod W, and under a causal
    mask only chunks at or before its own (``cur <= me``, :328) are
    consumed: me, me - 1, ..., 0."""
    cur = [(me - s) % world for s in range(world)]
    return [c for c in cur if c <= me] if causal else cur


def sp_attention_fused_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, causal: bool = True,
                                 t_sub: int = 128,
                                 world: int = 1) -> torch.Tensor:
    """Plain version of the fused kernel (``_sp_fused_kernel``): q
    (B, S, Hq, D), k/v (B, S, Hkv, D), S split over ``world`` ranks ->
    (B, S, Hq, D) in q's dtype.

    Rank r's queries fold the K/V chunks of :func:`ring_chunks` in order,
    each in ``t_sub``-wide tiles, with JAX's rounding points: scores in
    k's dtype when q has it, else f32, summed in f32 and scaled; masked
    entries -1e30; p rounded to that dtype for the PV product while l
    sums the f32 p; out = acc / max(l, 1e-20) (:363). Only one
    (S / W x t_sub) score tile per (batch, head) exists at a time. JAX's
    q-tile height changes no row's result, so every row of a rank is
    processed at once."""
    if t_sub < 1:
        raise ValueError(f"t_sub must be positive, got {t_sub}")
    b, s, hq, d = q.shape
    if s % world:
        raise ValueError(f"{s} positions do not split over {world} ranks")
    s_loc = s // world
    dt = k.dtype if q.dtype == k.dtype else torch.float32
    outs = []
    for me in range(world):
        qf = _fold_q(q[:, me * s_loc:(me + 1) * s_loc],
                     k.shape[2]).to(dt).float()
        chunks = [(k[:, c * s_loc:(c + 1) * s_loc],
                   v[:, c * s_loc:(c + 1) * s_loc], c * s_loc)
                  for c in ring_chunks(me, world, causal)]
        outs.append(_unfold_out(_flash_fold(qf, me * s_loc, chunks, causal,
                                            t_sub, dt), q.dtype))
    return outs[0] if world == 1 else torch.cat(outs, dim=1)


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


def _check_kernel_operands(what: str, q, k, v) -> None:
    _check_operands(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA, not {q.device}")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"the {what} kernel takes q, k and v all bf16 or "
                         f"all f32, not {q.dtype} / {k.dtype} / {v.dtype}")
    d = q.shape[3]
    if d not in HEAD_DIMS or k.shape[1] != q.shape[1]:
        raise ValueError(f"the {what} kernel takes head dim in {HEAD_DIMS} "
                         f"and as many keys as queries, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"the {what} kernel needs contiguous operands")


def _kernel_error(lib, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel call failed: "
                           f"{lib.tdt_error_string(err).decode()} ({err})")


def launch_sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    """One launch of the flash-prefill kernel on CUDA tensors: q
    (B, S, Hq, D), k/v (B, S, Hkv, D), one dtype (bf16 or f32), D in
    :data:`HEAD_DIMS`. Returns (B, S, Hq, D) in q's dtype."""
    _check_kernel_operands("sp attention", q, k, v)
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    lib = _lib()
    out = torch.empty_like(q)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _kernel_error(lib, "sp attention", lib.tdt_sp_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hq,
        hkv, d, int(causal), _DTYPE_CODES[q.dtype], d ** -0.5, stream))
    sp_attention_launches.add((str(q.dtype).removeprefix("torch."), b, s,
                               hq, hkv, d, bool(causal)))
    return out


def launch_sp_ring_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, ctx: SpAttentionContext,
                             fault: bool = False) -> torch.Tensor:
    """One launch of the ring kernel (``csrc/sp_attention.cu``,
    ``tdt_sp_ring_attention``) over every rank of ``ctx.group``: q
    (B, S, Hq, D), k/v (B, S, Hkv, D), S split over the W ranks, as for
    :func:`launch_sp_attention`. Each rank's K/V chunk goes round the
    ring through the ranks' workspaces (``ctx.state``, NaN-filled when
    made) while the ranks consume what has arrived. ``fault`` plants the
    test fault (rank 0's first forward of row 0's first 64 positions
    skipped, its signal still set): a fresh context's NaN-filled
    workspace then shows it. Returns (B, S, Hq, D) in q's dtype."""
    _check_kernel_operands("sp ring attention", q, k, v)
    if ctx.group is None or ctx.world_size < 2:
        raise ValueError("the ring kernel needs a context over a group of "
                         "at least 2 ranks")
    world = ctx.world_size
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if s % world:
        raise ValueError(f"{s} positions do not split over {world} ranks")
    s_loc = s // world
    lib = _lib()
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    state = ctx.state
    ws = state.workspace(2 * world * b * s_loc * hkv * d, q.dtype)
    sig = state.signals("sp", world * b * -(-s_loc // RING_PIECE))
    out = torch.empty_like(q)
    # Every rank's workspace and signals as (rank 0's address, step): host
    # arithmetic, so the call queues the one kernel.
    ws_base, ws_step = rank_span(ws, world)
    sig_base, sig_step = rank_span(sig, world)
    epoch = state.next_epoch()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _kernel_error(lib, "sp ring attention", lib.tdt_sp_ring_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws_base,
        ws_step // ws.element_size(), sig_base,
        sig_step // sig.element_size(), world, b, s, hq, hkv, d,
        int(ctx.causal), _DTYPE_CODES[q.dtype], d ** -0.5, epoch,
        int(fault), stream))
    sp_ring_launches.add((str(q.dtype).removeprefix("torch."), world, b, s,
                          hq, hkv, d, bool(ctx.causal)))
    return out


def _check_split(ctx: SpAttentionContext, s: int, t: int) -> None:
    """JAX's asserts (:489-493): queries and keys split over the ranks."""
    if s % ctx.world_size or t % ctx.world_size:
        raise ValueError(f"{s} queries and {t} keys must split over "
                         f"{ctx.world_size} ranks")


def sp_ag_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          ctx: SpAttentionContext | None = None,
                          sq_blk: int = 128, t_sub: int = 128
                          ) -> torch.Tensor:
    """The fused prefill (JAX ``sp_ag_attention_fused`` :373), with JAX's
    signature. ``sq_blk`` (JAX's q-tile height) changes no result and is
    only checked. CPU tensors run :func:`sp_attention_fused_reference`
    with ``t_sub`` clamped to each rank's S / W positions as JAX clamps
    it (:386-391), so p is rounded at JAX's points. CUDA tensors launch
    the kernel (world 1) or the ring kernel (world W), whose KV tiles are
    :data:`KV_TILE` wide: there ``t_sub`` is ignored."""
    ctx = ctx or create_sp_attention_context()
    _check_operands(q, k, v)
    _check_split(ctx, q.shape[1], k.shape[1])
    if sq_blk < 1 or t_sub < 1:
        raise ValueError(f"tile sizes must be positive, got sq_blk "
                         f"{sq_blk}, t_sub {t_sub}")
    world = ctx.world_size
    if q.device.type == "cpu":
        return sp_attention_fused_reference(
            q, k, v, ctx.causal, _clamp_tile(t_sub, q.shape[1] // world),
            world)
    if world > 1:
        return launch_sp_ring_attention(q, k, v, ctx)
    return launch_sp_attention(q, k, v, ctx.causal)


def _online_update(state, scores, v):
    """JAX's ``_online_update`` (:131): fold one KV chunk's masked scores
    into (m, l, acc); p is rounded to v's dtype for the PV product."""
    m, l, acc = state
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bkgst,btkd->bkgsd", p.to(v.dtype).float(), v.float())
    return m_new, l, acc


def _ring_pass(q, k, v, causal: bool, q_offset, kv_len, world: int):
    """JAX's ``ring_body`` (:532-557) for every rank at once: rank r's
    queries at global positions q_offset + r S / W + [0, S / W) fold the
    K/V chunks src = r, r - 1, ..., r - W + 1 (mod W, T / W positions
    each) in that order. The ranks ride on the batch dimension (element
    r B + b is rank r's share of row b), so each ring step is one pass
    for all of them, with per-rank query and key positions."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    s_loc, t_loc = s // world, t // world
    qf = _fold_q(q, hkv)
    g = qf.shape[2]
    qr = qf.reshape(b, hkv, g, world, s_loc, d).permute(
        3, 0, 1, 2, 4, 5).reshape(world * b, hkv, g, s_loc, d)
    kr = k.reshape(b, world, t_loc, hkv, d).transpose(0, 1)
    vr = v.reshape(b, world, t_loc, hkv, d).transpose(0, 1)
    ranks = torch.arange(world, device=q.device)

    def per_row(first):
        """Each rank's first position, for each of its B rows, shaped to
        broadcast over (W B, K, G, S, T) scores."""
        return first.repeat_interleave(b).view(-1, 1, 1, 1, 1)
    q_first = per_row(q_offset + ranks * s_loc)
    state = (torch.full((world * b, hkv, g, s_loc), _NEG, device=q.device),
             torch.zeros((world * b, hkv, g, s_loc), device=q.device),
             torch.zeros((world * b, hkv, g, s_loc, d), device=q.device))
    for i in range(world):
        src = (ranks - i) % world
        kc = kr[src].reshape(world * b, t_loc, hkv, d)
        vc = vr[src].reshape(world * b, t_loc, hkv, d)
        scores = _chunk_scores(qr, kc, q_first, per_row(src * t_loc),
                               causal, kv_len)
        state = _online_update(state, scores, vc)
    m, l, acc = state
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(world, b, hkv, g, s_loc, d).permute(
        1, 0, 4, 2, 3, 5).reshape(b, s, hq, d).to(q.dtype)


def _ulysses_pass(q, k, v, causal: bool, world: int):
    """JAX's ``ulysses_body`` (:572-615): after the all-to-alls rank r
    holds the whole sequence of query heads [r Hq / W, (r + 1) Hq / W)
    and KV heads [r Hkv / W, ...), attends them in one pass, and the
    all-to-all back joins the heads."""
    hq, hkv = q.shape[2], k.shape[2]
    if hkv % world or hq % world:
        raise ValueError(f"ulysses needs heads divisible by world: "
                         f"hq={hq}, hkv={hkv}, world={world}")
    if world == 1:
        return _masked_pass(q, k, v, causal)
    hq_l, hkv_l = hq // world, hkv // world
    return torch.cat([_masked_pass(q[:, :, r * hq_l:(r + 1) * hq_l],
                                   k[:, :, r * hkv_l:(r + 1) * hkv_l],
                                   v[:, :, r * hkv_l:(r + 1) * hkv_l],
                                   causal)
                      for r in range(world)], dim=2)


def sp_ag_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ctx: SpAttentionContext | None = None,
                    impl: str = "ring", q_offset=0,
                    kv_len=None) -> torch.Tensor:
    """Prefill attention (JAX ``sp_ag_attention`` :464).

    q: (B, S, Hq, D); k/v: (B, T, Hkv, D), T >= S for a chunk over a
    cache, S and T split over the context's W ranks. ``q_offset``:
    position of q's first row; ``kv_len``: live KV positions (default
    T); both only with impl "ring" or "xla", as in JAX. Returns
    (B, S, Hq, D) in q's dtype. A query row with no live key gets finite
    garbage, as in JAX."""
    if impl not in IMPLS:
        raise ValueError(f"unknown sp attention impl {impl!r}")
    ctx = ctx or create_sp_attention_context()
    world = ctx.world_size
    _check_split(ctx, q.shape[1], k.shape[1])
    if ctx.head_axis is not None and world > 1:
        raise NotImplementedError(
            "2-D tp x sp attention (head_axis at sequence world "
            f"{world}) is not ported yet (ROADMAP.md, Queue A item 13)")
    chunked = (kv_len is not None or k.shape[1] != q.shape[1]
               or not (isinstance(q_offset, int) and q_offset == 0))
    kv_live = k.shape[1] if kv_len is None else kv_len
    if impl == "ring" and world > 1:
        return _ring_pass(q, k, v, ctx.causal, q_offset, kv_live, world)
    if impl in ("ring", "xla"):
        # ag_body: each rank's rows at their global positions over the
        # gathered K/V; rows are independent, so one pass does them all.
        return _masked_pass(q, k, v, ctx.causal, q_offset, kv_live)
    if chunked:
        raise ValueError(f"q_offset/kv_len (chunked prefill) support impl "
                         f"'ring' and 'xla', not {impl!r}")
    if ctx.head_axis is not None:
        raise ValueError(f"impl={impl!r} does not support head_axis (use "
                         f"'ring' or 'xla')")
    if impl == "ulysses":
        return _ulysses_pass(q, k, v, ctx.causal, world)
    if impl == "pallas":
        return sp_ag_attention_fused(q, k, v, ctx)
    # ag_pallas: the all-gather kernel on K/V flattened to (S, B*Hkv*D),
    # every rank's copy (W, S, B*Hkv*D); rank r's queries over its own.
    b, s, hkv, d = k.shape
    kg, vg = (all_gather(t.transpose(0, 1).reshape(s, b * hkv * d),
                         ctx.ag_ctx, impl="pallas", stacked=True).reshape(
                             world, s, b, hkv, d).transpose(1, 2)
              for t in (k, v))
    s_loc = q.shape[1] // world
    return torch.cat([_masked_pass(q[:, r * s_loc:(r + 1) * s_loc], kg[r],
                                   vg[r], ctx.causal, r * s_loc)
                      for r in range(world)], dim=1)


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
        ll = ctypes.c_longlong
        lib.tdt_sp_ring_attention.argtypes = (
            [p] * 4 + [p, ll, p, ll] + [i] * 8
            + [ctypes.c_float, ctypes.c_ulonglong, i, p])
        lib.tdt_sp_ring_attention.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
