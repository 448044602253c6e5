"""Grouped (per-expert) GEMM for MoE at world = 1 (the port of
``triton_dist_tpu.ops.group_gemm``).

``grouped_matmul`` computes ``out[i] = tokens[i] @ w[expert_ids[i]]`` with
f32 accumulation and one rounding (JAX's sort + ``lax.ragged_dot`` +
unsort, :44-64), ``grouped_expert_ffn`` the per-expert SwiGLU FFN (:67-87:
gate and up stay f32 and round once after the SwiGLU). At world = 1
``ag_group_gemm`` is ``grouped_matmul`` in every impl: its all-gather is
the identity, and its Pallas kernel ``_ag_group_gemm_kernel`` (:139)
reduces to the grouped GEMM over the tile-aligned schedule of
:func:`align_tokens_for_tiles`.

On CUDA every grouped product launches the hand-written kernel of
``csrc/group_gemm.cu`` (the note in ``csrc/group_gemm.cuh`` says what
bounds it and what its design does about that), in every mode, as JAX
runs ``ragged_dot`` in every mode. A CPU tensor takes the plain versions
:func:`grouped_matmul_reference` and :func:`grouped_swiglu_reference`.

Rows whose id is the sentinel ``num_experts`` run through the last
expert (``num_experts - 1``), as JAX's ``grouped_matmul`` folds them into
its last group; callers mask them. JAX's fused kernel leaves them
unspecified instead (they collide in a trash tile), which no caller
reads.

``topk`` (a port argument; 1 gives JAX's signature): ``tokens`` holds one
row per ``topk`` consecutive pairs, pair ``i`` reading ``tokens[i //
topk]``. The MoE layers pass their token rows this way, so the (P, K)
expansion ``jnp.repeat`` makes is never written.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import LaunchCount, aligned16
from triton_dist_tpu_torch.ops.moe_utils import bincount

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_EPI_PLAIN, _EPI_SWIGLU = 0, 1
#: The kernel's paths, by the code of ``tdt_group_gemm_plan``.
PATHS = ("fma", "mma")

#: Launches of the grouped-GEMM kernel, by (path, rows per tile,
#: "plain" | "swiglu", pairs, K, widths of the products).
group_gemm_launches = LaunchCount()


# -- plain versions ------------------------------------------------------------
def _expert_runs(expert_ids: torch.Tensor, num_experts: int):
    """(stable expert order of the pairs, pairs per expert as a list):
    sentinel and out-of-range ids count as the nearest expert. The list
    is read back to the host: plain versions only."""
    eids = expert_ids.reshape(-1).long().clamp(0, num_experts - 1)
    order = torch.argsort(eids, stable=True)
    return order, bincount(eids, num_experts).tolist()


def grouped_matmul_reference(tokens: torch.Tensor, w: torch.Tensor,
                             expert_ids: torch.Tensor, num_experts: int,
                             topk: int = 1, out_dtype=None) -> torch.Tensor:
    """Plain version: one f32 product per live expert over its pairs,
    cast to ``out_dtype`` (default ``tokens.dtype``)."""
    p, n = expert_ids.numel(), w.shape[-1]
    out = torch.empty((p, n), dtype=out_dtype or tokens.dtype,
                      device=tokens.device)
    order, counts = _expert_runs(expert_ids, num_experts)
    rows = tokens[order // topk].float()
    start = 0
    for e, c in enumerate(counts):
        if c:
            sl = slice(start, start + c)
            out[order[sl]] = (rows[sl] @ w[e].float()).to(out.dtype)
        start += c
    return out


def grouped_swiglu_reference(tokens: torch.Tensor, w_gate: torch.Tensor,
                             w_up: torch.Tensor, expert_ids: torch.Tensor,
                             num_experts: int,
                             topk: int = 1) -> torch.Tensor:
    """Plain version of the SwiGLU epilogue: gate and up in f32,
    ``silu(gate) * up`` in f32, one rounding to ``tokens.dtype``."""
    gate = grouped_matmul_reference(tokens, w_gate, expert_ids, num_experts,
                                    topk, torch.float32)
    up = grouped_matmul_reference(tokens, w_up, expert_ids, num_experts,
                                  topk, torch.float32)
    return (F.silu(gate) * up).to(tokens.dtype)


# -- entry points ----------------------------------------------------------------
def grouped_matmul(tokens: torch.Tensor, w: torch.Tensor,
                   expert_ids: torch.Tensor, num_experts: int,
                   topk: int = 1) -> torch.Tensor:
    """``out[i] = tokens[i // topk] @ w[expert_ids[i]]``, f32
    accumulation, cast to ``tokens.dtype``. w: (E, K, N); expert_ids: (P,)
    with ``num_experts`` as the sentinel. Returns (P, N)."""
    return grouped_matmul_multi(tokens, [w], expert_ids, num_experts,
                                topk)[0]


def grouped_matmul_multi(tokens: torch.Tensor, ws, expert_ids: torch.Tensor,
                         num_experts: int, topk: int = 1) -> list:
    """:func:`grouped_matmul` of one or two weights sharing the tokens
    and the routing (gate and up), each product rounded on its own; on
    CUDA one launch."""
    ws = list(ws)
    _check_operands("grouped_matmul", tokens, ws, expert_ids, topk)
    if tokens.device.type == "cpu":
        return [grouped_matmul_reference(tokens, w, expert_ids, num_experts,
                                         topk) for w in ws]
    return launch_group_gemm(tokens, ws, expert_ids, num_experts, topk,
                             "plain")


def grouped_swiglu(tokens: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, expert_ids: torch.Tensor,
                   num_experts: int, topk: int = 1) -> torch.Tensor:
    """``silu(tokens @ w_gate[e]) * (tokens @ w_up[e])`` per pair, gate
    and up in f32, one rounding: the first half of
    :func:`grouped_expert_ffn`. Returns (P, I)."""
    _check_operands("grouped_swiglu", tokens, [w_gate, w_up], expert_ids,
                    topk)
    if tokens.device.type == "cpu":
        return grouped_swiglu_reference(tokens, w_gate, w_up, expert_ids,
                                        num_experts, topk)
    return launch_group_gemm(tokens, [w_gate, w_up], expert_ids,
                             num_experts, topk, "swiglu")[0]


def grouped_expert_ffn(tokens: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, w_down: torch.Tensor,
                       expert_ids: torch.Tensor, num_experts: int,
                       topk: int = 1) -> torch.Tensor:
    """Per-expert SwiGLU FFN over a flat pair list (JAX
    ``grouped_expert_ffn``): gate and up in f32, the SwiGLU rounded once,
    then the down product rounded. w_gate/w_up: (E, H, I), w_down: (E, I,
    H). Returns (P, H); on CUDA two launches."""
    act = grouped_swiglu(tokens, w_gate, w_up, expert_ids, num_experts,
                         topk)
    return grouped_matmul(act, w_down, expert_ids, num_experts)


def align_tokens_for_tiles(tokens: torch.Tensor, ids: torch.Tensor,
                           num_experts: int, m_blk: int):
    """Tile-align tokens by expert (JAX ``align_tokens_for_tiles``,
    group_gemm.py:90-136, static shapes): rows expert-sorted, each expert
    group padded to an ``m_blk`` boundary. Returns (padded (M_pad, K),
    tile_experts (M_pad // m_blk,) int32, dest (M,) int32 padded row of
    each row); invalid rows (``ids == num_experts``) go to the trailing
    trash row. The CUDA kernel builds the same schedule on the card
    (``csrc/group_gemm.cuh``) with tiles of its own height; this function
    is its plain statement."""
    m, k = tokens.shape
    e = num_experts
    dev = tokens.device
    m_pad = -(-(m + e * (m_blk - 1)) // m_blk) * m_blk + m_blk
    ids = ids.reshape(-1).long()
    valid = ids < e
    eids = ids.clamp(0, e - 1)
    keyed = torch.where(valid, eids, e)
    sizes = bincount(keyed, e + 1)[:e].long()
    gs_pad = (sizes + m_blk - 1) // m_blk * m_blk
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    offs = torch.cat([zero, torch.cumsum(sizes, 0)[:-1]])
    offs_pad = torch.cat([zero, torch.cumsum(gs_pad, 0)[:-1]])
    order = torch.argsort(keyed, stable=True)
    e_sorted = eids[order]
    rank = torch.arange(m, device=dev) - offs[e_sorted]
    dest_sorted = torch.where(valid[order], offs_pad[e_sorted] + rank,
                              m_pad - 1)
    padded = tokens.new_zeros((m_pad, k))
    padded[dest_sorted] = tokens[order]
    dest = torch.zeros(m, dtype=torch.long, device=dev)
    dest[order] = dest_sorted
    tile_starts = torch.arange(m_pad // m_blk, device=dev) * m_blk
    tile_experts = torch.searchsorted(torch.cumsum(gs_pad, 0), tile_starts,
                                      right=True).clamp(0, e - 1)
    return padded, tile_experts.to(torch.int32), dest.to(torch.int32)


@dataclasses.dataclass
class AGGroupGEMMContext:
    """The JAX context at world = 1: axis name and schedule choice (JAX's
    Pallas tile sizes belong to its TPU kernel; the Hopper kernel tiles
    its own way)."""
    world_size: int = 1
    axis: str = "tp"
    ring: bool = True


def create_ag_group_gemm_context(axis: str = "tp", ring: bool = True,
                                 world_size: int = 1) -> AGGroupGEMMContext:
    return AGGroupGEMMContext(world_size=world_size, axis=axis, ring=ring)


def ag_group_gemm(x: torch.Tensor, w: torch.Tensor, expert_ids: torch.Tensor,
                  num_experts: int, ctx: AGGroupGEMMContext | None = None,
                  impl: str = "ring") -> torch.Tensor:
    """``group_gemm(allgather(x), w)`` (JAX ``ag_group_gemm``) at world =
    1: :func:`grouped_matmul` for impl "xla", "ring" and "fused". x: (M,
    K) with one expert id per row; w: (E, K, N). Returns (M, N)."""
    ctx = ctx or create_ag_group_gemm_context()
    if impl == "auto":
        raise NotImplementedError(
            "ag_group_gemm impl='auto' measures ring against fused through "
            "the autotuner, which is not ported yet (ROADMAP.md, Queue A "
            "item 19)")
    if impl not in ("xla", "ring", "fused"):
        raise ValueError(f"unknown ag_group_gemm impl {impl!r}")
    if ctx.world_size != 1:
        raise NotImplementedError(
            f"ag_group_gemm at world {ctx.world_size} (its ring all-gather) "
            f"is not ported yet (ROADMAP.md, Queue B item 10)")
    return grouped_matmul(x, w, expert_ids, num_experts)


# -- the kernel ------------------------------------------------------------------
class Plan(NamedTuple):
    """How the kernel runs one call, as ``csrc/group_gemm.cuh`` plans it:
    ``path`` (one of :data:`PATHS`), ``m_blk`` (pairs per row tile) and
    ``max_tiles`` (row tiles of the grid, the worst case of live ones)."""
    path: str
    m_blk: int
    max_tiles: int


@functools.cache
def plan(pairs: int, num_experts: int, k: int, n: int,
         dtype: torch.dtype) -> Plan:
    """The kernel's plan of ``pairs`` (k -> n) products over
    ``num_experts`` experts in ``dtype``: a function of the shape only."""
    lib = _lib()
    path, m_blk, tiles = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.tdt_group_gemm_plan(pairs, num_experts, k, n,
                                        _DTYPE_CODES[dtype],
                                        ctypes.byref(path),
                                        ctypes.byref(m_blk),
                                        ctypes.byref(tiles)))
    return Plan(PATHS[path.value], m_blk.value, tiles.value)


def schedule_buffer(pairs: int, p: Plan, device) -> torch.Tensor:
    """The int32 schedule the kernel writes before its product: live
    tiles, the expert-sorted pairs, each tile's expert, first row and
    row count."""
    return torch.empty(1 + pairs + 3 * p.max_tiles, dtype=torch.int32,
                       device=device)


def launch_group_gemm(tokens: torch.Tensor, ws: list,
                      expert_ids: torch.Tensor, num_experts: int, topk: int,
                      epilogue: str) -> list:
    """One call of the grouped-GEMM kernel on CUDA tensors (checked by
    the caller): the products of ``ws`` ("plain", one output each) or the
    SwiGLU of gate ``ws[0]`` and up ``ws[1]`` ("swiglu", one output),
    counted in :data:`group_gemm_launches`."""
    _check_cuda("grouped_matmul", tokens, ws)
    lib = _lib()
    pairs = expert_ids.numel()
    k, n = ws[0].shape[1], ws[0].shape[2]
    swiglu = epilogue == "swiglu"
    outs = [torch.empty((pairs, n), dtype=tokens.dtype, device=tokens.device)
            for _ in range(1 if swiglu else len(ws))]
    if pairs == 0:
        return outs
    p = plan(pairs, num_experts, k, n, tokens.dtype)
    ids = expert_ids.reshape(-1).to(torch.int32).contiguous()
    sched = schedule_buffer(pairs, p, tokens.device)
    tokens = aligned16(tokens)
    ws = [aligned16(w) for w in ws]
    b1 = ws[1].data_ptr() if len(ws) > 1 else None
    c1 = outs[1].data_ptr() if len(outs) > 1 else None
    stream = torch.cuda.current_stream(tokens.device).cuda_stream
    _check(lib, lib.tdt_group_gemm(
        tokens.data_ptr(), topk, ids.data_ptr(), pairs, num_experts,
        ws[0].data_ptr(), b1, outs[0].data_ptr(), c1, len(ws),
        _EPI_SWIGLU if swiglu else _EPI_PLAIN, k, n, sched.data_ptr(),
        _DTYPE_CODES[tokens.dtype], stream))
    group_gemm_launches.add((p.path, p.m_blk, epilogue, pairs, k,
                             tuple(w.shape[2] for w in ws)))
    return outs


def _check_operands(op: str, tokens: torch.Tensor, ws: list,
                    expert_ids: torch.Tensor, topk: int) -> None:
    if not 1 <= len(ws) <= 2:
        raise ValueError(f"{op} takes one or two weights, got {len(ws)}")
    if tokens.dim() != 2 or any(w.dim() != 3 for w in ws):
        raise ValueError(f"{op} needs tokens (T, K) and weights (E, K, N), "
                         f"got {tuple(tokens.shape)} and "
                         f"{[tuple(w.shape) for w in ws]}")
    if any(w.shape != ws[0].shape for w in ws) or \
            ws[0].shape[1] != tokens.shape[1]:
        raise ValueError(f"{op}: weights {[tuple(w.shape) for w in ws]} do "
                         f"not fit tokens {tuple(tokens.shape)}")
    if topk < 1 or expert_ids.numel() != tokens.shape[0] * topk:
        raise ValueError(f"{op}: {expert_ids.numel()} expert ids for "
                         f"{tokens.shape[0]} token rows x topk {topk}")
    if any(w.dtype != tokens.dtype for w in ws):
        raise ValueError(f"{op} needs one dtype, got {tokens.dtype} and "
                         f"{[w.dtype for w in ws]}")
    if any(t.device != tokens.device for t in ws + [expert_ids]):
        raise ValueError(f"{op} operands on more than one device")


def _check_cuda(op: str, tokens: torch.Tensor, ws: list) -> None:
    """What the kernel takes: CUDA, bf16 or f32, contiguous."""
    if tokens.device.type != "cuda":
        raise ValueError(f"{op} runs on CUDA or the CPU, not {tokens.device}")
    if tokens.dtype not in _DTYPE_CODES:
        raise ValueError(f"{op} kernel takes bf16 or f32, not {tokens.dtype}")
    if not all(t.is_contiguous() for t in [tokens] + ws):
        raise ValueError(f"{op} kernel needs contiguous operands")


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.tdt_error_string(err).decode()
        raise RuntimeError(f"group_gemm kernel call failed: {msg} ({err})")


def _lib() -> ctypes.CDLL:
    lib = _build.load("group_gemm")
    if lib.tdt_group_gemm.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        lib.tdt_group_gemm_plan.argtypes = [i] * 5 + [ip, ip, ip]
        lib.tdt_group_gemm_plan.restype = i
        lib.tdt_group_gemm.argtypes = ([p, i, p, i, i, p, p, p, p, i, i, i,
                                        i, p, i, p])
        lib.tdt_group_gemm.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
