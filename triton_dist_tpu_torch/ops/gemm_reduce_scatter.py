"""GEMM + AllReduce (``gemm_ar``) at world = 1.

The port of ``triton_dist_tpu.ops.gemm_reduce_scatter.gemm_ar`` (:898),
whose Pallas kernels ``_gemm_rs_kernel`` (:249) and
``_gemm_rs_hbm_nb_kernel`` (:353) reduce to ``o = x @ w`` with f32
accumulation when the ring has one member. The kernel is hand-written
CUDA for Hopper in ``csrc/gemm_ar.cu``; the note at its top says what
bounds it and what its design does about that.

``gemm_ar`` on a CUDA tensor launches that kernel or raises; it never
falls back to a library product. Only a tensor that lies on the CPU
takes the plain version :func:`gemm_ar_reference`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import LaunchCount, num_sms

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

#: Launches of the gemm_ar kernel, by the (K, N) of ``b`` (CPU calls do
#: not count).
launches = LaunchCount()


def gemm_ar_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(a.f32 @ b.f32)`` cast to ``a.dtype``."""
    return (a.float() @ b.float()).to(a.dtype)


class Plan(NamedTuple):
    """How the kernel runs one call, as ``csrc/gemm_ar.cu`` plans it:
    ``tensor_cores`` (else the FMA kernel), ``tiles`` (output tiles, the
    blocks of one K split) and ``splits`` (K splits; with more than one,
    the call needs a workspace of ``splits * M * N`` floats)."""
    tensor_cores: bool
    tiles: int
    splits: int


@functools.cache
def plan(m: int, n: int, k: int, dtype: torch.dtype, num_sms: int) -> Plan:
    """The kernel's launch plan for a (m, k) x (k, n) product of
    ``dtype`` on a card with ``num_sms`` SMs. It depends on the dtype and
    the shape only, so equal inputs always sum in the same order (and a
    shape's plan is asked of the library once)."""
    lib = _gemm_ar_lib()
    path, tiles, splits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.tdt_gemm_ar_plan(m, n, k, num_sms, _DTYPE_CODES[dtype],
                                     ctypes.byref(path), ctypes.byref(tiles),
                                     ctypes.byref(splits)))
    return Plan(bool(path.value), tiles.value, splits.value)


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_ar needs a (M, K) and b (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"gemm_ar needs one dtype, got {a.dtype} and "
                         f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"gemm_ar operands on {a.device} and {b.device}")


def gemm_ar(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``allreduce(a @ b)`` at world = 1: ``(a @ b)`` with f32
    accumulation, cast to ``a.dtype``. a: (M, K), b: (K, N) in the JAX
    (in, out) layout. Returns (M, N).

    CUDA tensors run the hand-written kernel (bf16 or f32, contiguous);
    CPU tensors run :func:`gemm_ar_reference`."""
    _check_operands(a, b)
    if a.device.type == "cpu":
        return gemm_ar_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_ar runs on CUDA or the CPU, not {a.device}")
    if a.dtype not in _DTYPE_CODES:
        raise ValueError(f"gemm_ar kernel takes bf16 or f32, not {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm_ar kernel needs contiguous operands")
    lib = _gemm_ar_lib()
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    sms = num_sms(a.device.index)
    p = plan(m, n, k, a.dtype, sms)
    a, b = _aligned16(a), _aligned16(b)
    ws = (torch.empty((p.splits, m, n), dtype=torch.float32,
                      device=a.device) if p.splits > 1 else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _check(lib, lib.tdt_gemm_ar(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                ws.data_ptr() if ws is not None else None,
                                m, n, k, sms, _DTYPE_CODES[a.dtype], stream))
    launches.add((k, n))
    return out


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it does not start on 16 bytes (an
    offset view): the kernel reads 16-byte chunks."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.tdt_error_string(err).decode()
        raise RuntimeError(f"gemm_ar kernel call failed: {msg} ({err})")


def _gemm_ar_lib() -> ctypes.CDLL:
    lib = _build.load("gemm_ar")
    if lib.tdt_gemm_ar.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        lib.tdt_gemm_ar_plan.argtypes = [i, i, i, i, i, ip, ip, ip]
        lib.tdt_gemm_ar_plan.restype = i
        lib.tdt_gemm_ar.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.tdt_gemm_ar.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
