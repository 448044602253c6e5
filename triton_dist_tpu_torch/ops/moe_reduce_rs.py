"""MoE down projection + top-k reduce + reduce-scatter at world = 1 (the
port of ``triton_dist_tpu.ops.moe_reduce_rs``).

``out[t] = sum_j weights[t, j] * (act[t k + j] @ w_down[expert_ids[t k +
j]])``. At world = 1 the reduce-scatter is the identity and the impls
differ only in where bf16 rounds:

* ``"ring"`` and ``"xla"``: JAX's one-shot body (:388): ``grouped_matmul``
  rounds each pair's down product to the activation dtype, then
  ``topk_reduce`` sums in f32 and rounds once;
* ``"fused"``: the numerics of the Pallas kernel ``_moe_rs_fused_kernel``
  (:72; world = 1 branch :203-205): f32 through the weighted sum, one
  rounding.

On CUDA all three launch the hand-written kernel of ``csrc/moe_rs.cu``
with the pair rounding on or off; a CPU tensor takes the plain version
:func:`moe_reduce_rs_reference`. ``impl="auto"`` (the autotuner, ROADMAP
Queue A item 19) and world > 1 (the ring reduce-scatter, Queue B item 11)
raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import LaunchCount, aligned16
from triton_dist_tpu_torch.ops.group_gemm import (
    grouped_matmul_reference, plan, schedule_buffer)

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
#: The impls whose pair products round to the activation dtype.
ROUNDED_IMPLS = ("ring", "xla")

#: Launches of the MoE-reduce kernel, by (path, rows per tile, "rounded" |
#: "f32" pairs, pairs, I, H).
moe_rs_launches = LaunchCount()


@dataclasses.dataclass
class MoEReduceRSContext:
    """The JAX context at world = 1: axis, expert count and top-k."""
    world_size: int = 1
    axis: str = "tp"
    num_experts: int = 8
    topk: int = 2


def create_moe_rs_context(axis: str = "tp", num_experts: int = 8,
                          topk: int = 2,
                          world_size: int = 1) -> MoEReduceRSContext:
    return MoEReduceRSContext(world_size=world_size, axis=axis,
                              num_experts=num_experts, topk=topk)


def moe_reduce_rs_reference(act: torch.Tensor, w_down: torch.Tensor,
                            expert_ids: torch.Tensor, weights: torch.Tensor,
                            num_experts: int,
                            round_pairs: bool = True) -> torch.Tensor:
    """Plain version: the grouped down product of every pair (rounded to
    ``act.dtype`` when ``round_pairs``, else kept f32), times its f32
    routing weight, summed over each token's k pairs in f32, rounded
    once."""
    t, k = weights.shape
    pair = grouped_matmul_reference(
        act, w_down, expert_ids, num_experts,
        out_dtype=act.dtype if round_pairs else torch.float32)
    red = (pair.float().reshape(t, k, -1) * weights.float()[..., None])
    return red.sum(dim=1).to(act.dtype)


def moe_reduce_rs(act: torch.Tensor, w_down: torch.Tensor,
                  expert_ids: torch.Tensor, weights: torch.Tensor,
                  ctx: MoEReduceRSContext, impl: str = "ring") -> torch.Tensor:
    """``reduce_scatter(topk_reduce(grouped_gemm(act, w_down)))`` at world
    = 1. act: (T * topk, I); w_down: (E, I, H); expert_ids: (T * topk,)
    with ``num_experts`` as the sentinel; weights: (T, topk). Returns (T,
    H) in ``act.dtype``."""
    if impl == "auto":
        raise NotImplementedError(
            "moe_reduce_rs impl='auto' measures ring against fused through "
            "the autotuner, which is not ported yet (ROADMAP.md, Queue A "
            "item 19)")
    if impl not in ("ring", "xla", "fused"):
        raise ValueError(f"unknown moe_reduce_rs impl {impl!r}")
    if ctx.world_size != 1:
        raise NotImplementedError(
            f"moe_reduce_rs at world {ctx.world_size} (its ring "
            f"reduce-scatter) is not ported yet (ROADMAP.md, Queue B "
            f"item 11)")
    _check_operands(act, w_down, expert_ids, weights)
    round_pairs = impl in ROUNDED_IMPLS
    if act.device.type == "cpu":
        return moe_reduce_rs_reference(act, w_down, expert_ids, weights,
                                       ctx.num_experts, round_pairs)
    return launch_moe_rs(act, w_down, expert_ids, weights, ctx.num_experts,
                         round_pairs)


def launch_moe_rs(act: torch.Tensor, w_down: torch.Tensor,
                  expert_ids: torch.Tensor, weights: torch.Tensor,
                  num_experts: int, round_pairs: bool) -> torch.Tensor:
    """One call of the MoE-reduce kernel on CUDA tensors (checked by the
    caller), counted in :data:`moe_rs_launches`."""
    if act.device.type != "cuda":
        raise ValueError(f"moe_reduce_rs runs on CUDA or the CPU, not "
                         f"{act.device}")
    if act.dtype not in _DTYPE_CODES:
        raise ValueError(f"moe_reduce_rs kernel takes bf16 or f32, not "
                         f"{act.dtype}")
    if not (act.is_contiguous() and w_down.is_contiguous()):
        raise ValueError("moe_reduce_rs kernel needs contiguous operands")
    lib = _lib()
    t, k = weights.shape
    i, h = w_down.shape[1], w_down.shape[2]
    out = torch.empty((t, h), dtype=act.dtype, device=act.device)
    if t == 0:
        return out
    # The plan of the grouped down product: the same header plans both.
    p = plan(t * k, num_experts, i, h, act.dtype)
    ws = torch.empty((t * k, h), device=act.device,
                     dtype=act.dtype if round_pairs else torch.float32)
    ids = expert_ids.reshape(-1).to(torch.int32).contiguous()
    wts = weights.to(torch.float32).contiguous()
    sched = schedule_buffer(t * k, p, act.device)
    act, w_down = aligned16(act), aligned16(w_down)
    stream = torch.cuda.current_stream(act.device).cuda_stream
    _check(lib, lib.tdt_moe_rs(act.data_ptr(), ids.data_ptr(), wts.data_ptr(),
                               w_down.data_ptr(), ws.data_ptr(),
                               out.data_ptr(), sched.data_ptr(), t, k,
                               num_experts, i, h, int(round_pairs),
                               _DTYPE_CODES[act.dtype], stream))
    moe_rs_launches.add((p.path, p.m_blk,
                         "rounded" if round_pairs else "f32", t * k, i, h))
    return out


def _check_operands(act, w_down, expert_ids, weights) -> None:
    if act.dim() != 2 or w_down.dim() != 3 or weights.dim() != 2:
        raise ValueError(f"moe_reduce_rs needs act (T*k, I), w_down (E, I, "
                         f"H) and weights (T, k), got {tuple(act.shape)}, "
                         f"{tuple(w_down.shape)} and {tuple(weights.shape)}")
    t, k = weights.shape
    if act.shape[0] != t * k or expert_ids.numel() != t * k or \
            w_down.shape[1] != act.shape[1]:
        raise ValueError(f"moe_reduce_rs: act {tuple(act.shape)}, ids "
                         f"{expert_ids.numel()}, w_down "
                         f"{tuple(w_down.shape)} do not fit weights "
                         f"{tuple(weights.shape)}")
    if w_down.dtype != act.dtype:
        raise ValueError(f"moe_reduce_rs needs one dtype, got {act.dtype} "
                         f"and {w_down.dtype}")
    if any(x.device != act.device for x in (w_down, expert_ids, weights)):
        raise ValueError("moe_reduce_rs operands on more than one device")


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.tdt_error_string(err).decode()
        raise RuntimeError(f"moe_rs kernel call failed: {msg} ({err})")


def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_rs")
    if lib.tdt_moe_rs.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tdt_moe_rs.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.tdt_moe_rs.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
