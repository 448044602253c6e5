"""AllGather-GEMM and the fused AG-SwiGLU at world = 1.

The port of ``triton_dist_tpu.ops.allgather_gemm``: ``ag_gemm_multi``
(:643), ``ag_gemm`` (:854) and ``ag_swiglu`` (:1088). With one ring
member the all-gather is the identity, and the Pallas kernels
``_ag_gemm_hbm_nb_kernel`` (:265) and ``_ag_swiglu_hbm_kernel`` (:954)
reduce to ``C_i = a @ b_i`` with f32 accumulation and one rounding, and
to ``silu(a @ w_gate + b_gate) * (a @ w_up + b_up)`` in f32 with one
rounding. The kernels are hand-written CUDA for Hopper in
``csrc/ag_gemm.cu``; the note at its top says what bounds them and what
their design does about that.

Weights keep the JAX (in, out) layout and are passed one by one: the
kernel writes each product to its own output, so nothing concatenates
QKV or gate|up per call. ``ag_swiglu`` keeps JAX's rule for when the
fused kernel runs (:func:`swiglu_fuses`), because it decides where bf16
rounds: otherwise it composes ``ag_gemm_multi`` with a plain SwiGLU, as
JAX does (:1193-1205). The VMEM-driven variant choice of
``ag_gemm_multi`` does not change the result at world = 1 and is not
copied.

On a CUDA tensor each entry point launches its kernel or raises; only
tensors that lie on the CPU take the plain versions
:func:`ag_gemm_multi_reference` and :func:`ag_swiglu_reference`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import LaunchCount, aligned16, num_sms

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_OP_GEMM, _OP_SWIGLU = 0, 1
#: The kernel's plans, by the path code of ``tdt_ag_gemm_plan``: the f32 /
#: odd-shape FMA kernel, the B-streaming decode kernel (M <= 64), the
#: tiled tensor-core prefill kernel.
PATHS = ("fma", "decode", "prefill")
#: Products one ``ag_gemm_multi`` launch takes.
MAX_PRODUCTS = 3

#: JAX's soft VMEM budget of the default path
#: (``triton_dist_tpu/ops/common.py`` DEFAULT_VMEM_BUDGET).
DEFAULT_VMEM_BUDGET = 12 * 1024 * 1024

#: Launches of the AG-GEMM kernel, by (plan, K, widths of the products).
ag_gemm_launches = LaunchCount()
#: Launches of the fused AG-SwiGLU kernel, by (plan, K, (width,)).
ag_swiglu_launches = LaunchCount()


# -- JAX's fusion rule ---------------------------------------------------------
def _pick_block_k(k: int, want: int) -> int:
    for cand in (want, 512, 256, 128):
        if cand <= k and k % cand == 0:
            return cand
    return k


def _swiglu_footprint(bm: int, bn: int, k: int, itemsize: int) -> int:
    return itemsize * (2 * bm * k + 4 * k * bn + 2 * bm * bn)


def swiglu_fuses(rows: int, k: int, n_loc: int, itemsize: int) -> bool:
    """Whether JAX's ``ag_swiglu`` runs its fused kernel for an (rows, k)
    activation against (k, n_loc) gate/up weights of ``itemsize`` bytes
    (``allgather_gemm.py:1170-1193`` with the default context: block hints
    256 x 512, the 12 MB budget, no trusted blocks).

    Kept for numerics, not for tiling: the fused kernel rounds once after
    the SwiGLU, the composed path rounds gate and up first, so the rule
    decides where bf16 rounds. The CUDA kernel tiles its own way."""
    if rows <= 0 or n_loc <= 0:
        return False
    choice = None
    for bn in (_pick_block_k(n_loc, 512), 512, 256, 128):
        if bn > n_loc or n_loc % bn:
            continue
        for bm in (_pick_block_k(rows, 256), 256, 128):
            if bm > rows or rows % bm:
                continue
            if _swiglu_footprint(bm, bn, k, itemsize) <= DEFAULT_VMEM_BUDGET:
                choice = (bm, bn)
                break
        if choice:
            break
    return choice is not None and rows % 128 == 0 and n_loc % 128 == 0


# -- plain versions ------------------------------------------------------------
def ag_gemm_multi_reference(a: torch.Tensor, bs) -> list:
    """Plain version: ``[(a.f32 @ b.f32) cast to a.dtype for b in bs]``."""
    af = a.float()
    return [(af @ b.float()).to(a.dtype) for b in bs]


def ag_swiglu_reference(a: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor, b_gate=None,
                        b_up=None) -> torch.Tensor:
    """Plain version of the fused kernel: gate and up in f32 (f32 biases
    added first when given), ``gate * sigmoid(gate) * up`` in f32, one
    rounding to ``a.dtype``."""
    af = a.float()
    gate = af @ w_gate.float()
    up = af @ w_up.float()
    if b_gate is not None:
        gate = gate + b_gate.float()
        up = up + b_up.float()
    return (gate * torch.sigmoid(gate) * up).to(a.dtype)


# -- entry points ----------------------------------------------------------------
def ag_gemm_multi(a: torch.Tensor, bs) -> list:
    """``[allgather(a) @ b for b in bs]`` at world = 1: each product with
    f32 accumulation, cast to ``a.dtype``. a: (M, K); bs: one to three
    (K, N_i) weights in the JAX (in, out) layout. Returns the list of
    (M, N_i) outputs.

    CUDA tensors run the hand-written kernel, all products in one launch
    (bf16 or f32, contiguous); CPU tensors run
    :func:`ag_gemm_multi_reference`."""
    bs = list(bs)
    _check_operands("ag_gemm_multi", a, bs)
    if a.device.type == "cpu":
        return ag_gemm_multi_reference(a, bs)
    return launch_gemm(a, bs, ag_gemm_launches)


def ag_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``allgather(a) @ b`` at world = 1 (one product of
    :func:`ag_gemm_multi`)."""
    return ag_gemm_multi(a, [b])[0]


def ag_swiglu(a: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              b_gate=None, b_up=None) -> torch.Tensor:
    """``silu(allgather(a) @ w_gate + b_gate) * (allgather(a) @ w_up +
    b_up)`` at world = 1. a: (M, K); w_gate/w_up: (K, N); b_gate/b_up:
    optional (N,) biases, both or neither. Returns (M, N) in
    ``a.dtype``.

    Where :func:`swiglu_fuses` says JAX fuses, one kernel computes the
    whole epilogue in f32 and rounds once (CPU tensors:
    :func:`ag_swiglu_reference`). Elsewhere gate and up come from
    :func:`ag_gemm_multi`, round to ``a.dtype`` (biases added in f32,
    rounded again), and the SwiGLU follows in plain PyTorch, as JAX
    composes it."""
    _check_swiglu_operands(a, w_gate, w_up, b_gate, b_up)
    m, k = a.shape
    n = w_gate.shape[1]
    if not swiglu_fuses(m, k, n, a.element_size()):
        gate, up = ag_gemm_multi(a, [w_gate, w_up])
        if b_gate is not None:
            gate = (gate.float() + b_gate.float()).to(a.dtype)
            up = (up.float() + b_up.float()).to(a.dtype)
        return F.silu(gate.float()).to(a.dtype) * up
    if a.device.type == "cpu":
        return ag_swiglu_reference(a, w_gate, w_up, b_gate, b_up)
    return launch_swiglu(a, w_gate, w_up, b_gate, b_up)


# -- the kernel ------------------------------------------------------------------
class Plan(NamedTuple):
    """How the kernel runs one call, as ``csrc/ag_gemm.cu`` plans it:
    ``path`` (one of :data:`PATHS`), ``tiles`` (output tiles, the blocks
    of one K split) and ``splits`` (K splits of the decode plan; with more
    than one the call needs a workspace of ``splits * M * sum(widths)``
    floats)."""
    path: str
    tiles: int
    splits: int


@functools.cache
def plan(op: str, m: int, widths: tuple, k: int, dtype: torch.dtype,
         num_sms: int) -> Plan:
    """The kernel's launch plan of ``op`` ("gemm": one product per width;
    "swiglu": the fused SwiGLU of one width) for an (m, k) activation of
    ``dtype`` on a card with ``num_sms`` SMs. It depends on the op, the
    dtype and the shape only, so equal inputs always sum in the same
    order."""
    lib = _lib()
    op_code = {"gemm": _OP_GEMM, "swiglu": _OP_SWIGLU}[op]
    w = list(widths) + [0] * (MAX_PRODUCTS - len(widths))
    path, tiles, splits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.tdt_ag_gemm_plan(op_code, m, len(widths), *w, k,
                                     num_sms, _DTYPE_CODES[dtype],
                                     ctypes.byref(path), ctypes.byref(tiles),
                                     ctypes.byref(splits)))
    return Plan(PATHS[path.value], tiles.value, splits.value)


def launch_gemm(a: torch.Tensor, bs: list, count: LaunchCount) -> list:
    """The products ``a @ b`` for ``b`` in ``bs`` (checked by the caller)
    in one launch of the AG-GEMM kernel on CUDA tensors, counted in
    ``count`` under (plan, K, widths). Shared with ``gemm_rs``."""
    _check_cuda("ag_gemm_multi", a, bs)
    lib = _lib()
    m, k = a.shape
    widths = tuple(b.shape[1] for b in bs)
    outs = [torch.empty((m, n), dtype=a.dtype, device=a.device)
            for n in widths]
    if m == 0:
        return outs
    sms = num_sms(a.device.index)
    p = plan("gemm", m, widths, k, a.dtype, sms)
    a = aligned16(a)
    bs = [aligned16(b) for b in bs]
    ws = (torch.empty((p.splits, m, sum(widths)), dtype=torch.float32,
                      device=a.device) if p.splits > 1 else None)
    pad = MAX_PRODUCTS - len(bs)
    b_ptrs = [b.data_ptr() for b in bs] + [None] * pad
    c_ptrs = [o.data_ptr() for o in outs] + [None] * pad
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _check(lib, lib.tdt_ag_gemm(a.data_ptr(), len(bs), *b_ptrs, *c_ptrs,
                                *(list(widths) + [0] * pad),
                                ws.data_ptr() if ws is not None else None,
                                m, k, sms, _DTYPE_CODES[a.dtype], stream))
    count.add((p.path, k, widths))
    return outs


def launch_swiglu(a, w_gate, w_up, b_gate, b_up) -> torch.Tensor:
    """One launch of the fused AG-SwiGLU kernel on CUDA tensors (checked
    by the caller), counted in :data:`ag_swiglu_launches`."""
    biases = [] if b_gate is None else [b_gate, b_up]
    _check_cuda("ag_swiglu", a, [w_gate, w_up] + biases)
    lib = _lib()
    m, k = a.shape
    n = w_gate.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0:
        return out
    sms = num_sms(a.device.index)
    p = plan("swiglu", m, (n,), k, a.dtype, sms)
    a, w_gate, w_up = (aligned16(t) for t in (a, w_gate, w_up))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _check(lib, lib.tdt_ag_swiglu(
        a.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        b_gate.data_ptr() if b_gate is not None else None,
        b_up.data_ptr() if b_up is not None else None,
        out.data_ptr(), m, n, k, sms, _DTYPE_CODES[a.dtype], stream))
    ag_swiglu_launches.add((p.path, k, (n,)))
    return out


def _check_operands(op: str, a: torch.Tensor, bs: list) -> None:
    if not 1 <= len(bs) <= MAX_PRODUCTS:
        raise ValueError(f"{op} takes 1 to {MAX_PRODUCTS} weights, got "
                         f"{len(bs)}")
    if a.dim() != 2 or any(b.dim() != 2 or b.shape[0] != a.shape[1]
                           for b in bs):
        raise ValueError(f"{op} needs a (M, K) and weights (K, N_i), got "
                         f"{tuple(a.shape)} and "
                         f"{[tuple(b.shape) for b in bs]}")
    if any(b.shape[1] == 0 for b in bs):
        raise ValueError(f"{op} needs weights of nonzero width")
    if any(b.dtype != a.dtype for b in bs):
        raise ValueError(f"{op} needs one dtype, got {a.dtype} and "
                         f"{[b.dtype for b in bs]}")
    if any(b.device != a.device for b in bs):
        raise ValueError(f"{op} operands on {a.device} and "
                         f"{[str(b.device) for b in bs]}")


def _check_swiglu_operands(a, w_gate, w_up, b_gate, b_up) -> None:
    _check_operands("ag_swiglu", a, [w_gate, w_up])
    if w_gate.shape != w_up.shape:
        raise ValueError(f"ag_swiglu needs gate and up of one shape, got "
                         f"{tuple(w_gate.shape)} and {tuple(w_up.shape)}")
    if (b_gate is None) != (b_up is None):
        raise ValueError("pass both biases or neither")
    n = w_gate.shape[1]
    for bias in ((b_gate, b_up) if b_gate is not None else ()):
        if tuple(bias.shape) != (n,):
            raise ValueError(f"ag_swiglu biases must be ({n},), got "
                             f"{tuple(bias.shape)}")
        if bias.device != a.device:
            raise ValueError(f"ag_swiglu bias on {bias.device}, operands on "
                             f"{a.device}")


def _check_cuda(op: str, a: torch.Tensor, others: list) -> None:
    """What the kernel takes: CUDA, bf16 or f32 throughout, contiguous."""
    if a.device.type != "cuda":
        raise ValueError(f"{op} runs on CUDA or the CPU, not {a.device}")
    if a.dtype not in _DTYPE_CODES:
        raise ValueError(f"{op} kernel takes bf16 or f32, not {a.dtype}")
    if any(t.dtype != a.dtype for t in others):
        raise ValueError(f"{op} kernel needs every operand in {a.dtype}")
    if not all(t.is_contiguous() for t in [a] + others):
        raise ValueError(f"{op} kernel needs contiguous operands")


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.tdt_error_string(err).decode()
        raise RuntimeError(f"ag_gemm kernel call failed: {msg} ({err})")


def _lib() -> ctypes.CDLL:
    lib = _build.load("ag_gemm")
    if lib.tdt_ag_gemm.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        lib.tdt_ag_gemm_plan.argtypes = [i] * 9 + [ip, ip, ip]
        lib.tdt_ag_gemm_plan.restype = i
        lib.tdt_ag_gemm.argtypes = ([p, i] + [p] * 6 + [i] * 3
                                    + [p, i, i, i, i, p])
        lib.tdt_ag_gemm.restype = i
        lib.tdt_ag_swiglu.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.tdt_ag_swiglu.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
