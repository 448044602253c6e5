"""GEMM + AllReduce (``gemm_ar``) and GEMM + ReduceScatter (``gemm_rs``)
at world = 1.

The port of ``triton_dist_tpu.ops.gemm_reduce_scatter.gemm_ar`` (:898)
and ``gemm_rs`` (:884). With one ring member their Pallas kernels
(``_gemm_rs_kernel`` :249, ``_gemm_rs_hbm_nb_kernel`` :353,
``_gemm_rs_hbm_kernel`` :533) all reduce to ``o = x @ w`` with f32
accumulation and one rounding, so the two entry points compute one
function. The kernels are hand-written CUDA for Hopper: ``gemm_ar`` runs
``csrc/gemm_ar.cu`` (B-streaming, for decode batches); ``gemm_rs`` runs
that kernel for M <= 64 and the tiled prefill GEMM of ``csrc/ag_gemm.cu``
(one product) above. The notes at the top of the sources say what bounds
them and what their design does about that.

On a CUDA tensor both launch a kernel or raise; they never fall back to
a library product. Only tensors that lie on the CPU take the plain
versions :func:`gemm_ar_reference` and :func:`gemm_rs_reference`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops import allgather_gemm
from triton_dist_tpu_torch.ops.common import LaunchCount, aligned16, num_sms

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
#: Largest M that ``gemm_rs`` sends to the B-streaming gemm_ar kernel.
DECODE_MAX_M = 64

#: Launches of the gemm_ar kernel by ``gemm_ar``, by the (K, N) of ``b``
#: (CPU calls do not count).
launches = LaunchCount()
#: Launches by ``gemm_rs``, by (plan, K, N): plan "decode" is the gemm_ar
#: kernel (M <= 64), "prefill" / "fma" the AG-GEMM kernel's plans.
gemm_rs_launches = LaunchCount()


def gemm_ar_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(a.f32 @ b.f32)`` cast to ``a.dtype``."""
    return (a.float() @ b.float()).to(a.dtype)


def gemm_rs_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gemm_rs``: at world = 1 the function of
    :func:`gemm_ar_reference`."""
    return gemm_ar_reference(a, b)


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


def _check_operands(op: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{op} needs a (M, K) and b (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"{op} needs one dtype, got {a.dtype} and "
                         f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{op} operands on {a.device} and {b.device}")


def gemm_ar(a: torch.Tensor, b: torch.Tensor, group=None,
            impl: str = "pallas") -> torch.Tensor:
    """``allreduce(a @ b)`` at world = 1: ``(a @ b)`` with f32
    accumulation, cast to ``a.dtype``. a: (M, K), b: (K, N) in the JAX
    (in, out) layout. Returns (M, N).

    CUDA tensors run the hand-written kernel (bf16 or f32, contiguous);
    CPU tensors run :func:`gemm_ar_reference`. Over a rank group of
    W > 1, see :func:`gemm_rs` (the result is replicated, JAX pads M to
    the ranks)."""
    _check_operands("gemm_ar", a, b)
    if group is not None and group.world > 1:
        return _psum_of_products("gemm_ar", a, b, group, impl, pad=True)
    if a.device.type == "cpu":
        return gemm_ar_reference(a, b)
    return _launch_gemm_ar("gemm_ar", a, b, launches,
                           (a.shape[1], b.shape[1]))


def gemm_rs(a: torch.Tensor, b: torch.Tensor, group=None,
            impl: str = "pallas") -> torch.Tensor:
    """``reduce_scatter(a @ b)`` at world = 1: ``(a @ b)`` with f32
    accumulation, cast to ``a.dtype``, the function of :func:`gemm_ar`.
    a: (M, K), b: (K, N) in the JAX (in, out) layout. Returns (M, N).

    CUDA tensors (bf16 or f32, contiguous) run the gemm_ar kernel for
    M <= :data:`DECODE_MAX_M`, which streams B once for all rows, and the
    AG-GEMM kernel's tiled plan above; both count in
    :data:`gemm_rs_launches`. CPU tensors run :func:`gemm_rs_reference`.

    Over a rank group (``runtime.dist.RankGroup``) of W > 1: a is
    column-sharded, b row-sharded, the result row-sharded. ``impl="xla"``
    is JAX's XLA body, plain: each rank's partial product rounded
    (:func:`gemm_rs_reference` on its shards), summed over the ranks
    (``RankGroup.psum``). ``impl="pallas"`` (the ring reduce-scatter) is
    not ported yet and raises."""
    _check_operands("gemm_rs", a, b)
    if group is not None and group.world > 1:
        return _psum_of_products("gemm_rs", a, b, group, impl)
    if a.device.type == "cpu":
        return gemm_rs_reference(a, b)
    m, k = a.shape
    n = b.shape[1]
    if m > DECODE_MAX_M and n > 0:
        return allgather_gemm.launch_gemm(a, [b], gemm_rs_launches)[0]
    return _launch_gemm_ar("gemm_rs", a, b, gemm_rs_launches,
                           ("decode", k, (n,)))


def _psum_of_products(op: str, a: torch.Tensor, b: torch.Tensor, group,
                      impl: str, pad: bool = False) -> torch.Tensor:
    """The world > 1 XLA body of gemm_rs / gemm_ar: the sum over ranks of
    each rank's rounded partial product. ``pad``: rows that do not split
    over the ranks are allowed (gemm_ar pads and slices them in JAX,
    which leaves the sum of the real rows as it is)."""
    if impl != "xla":
        raise NotImplementedError(
            f"{op}(impl={impl!r}) at world {group.world} runs the ring "
            f"reduce-scatter of GEMM-RS/AR, which is not ported yet "
            f"(ROADMAP.md, Queue B items 3-5)")
    if not pad and a.shape[0] % group.world:
        raise ValueError(f"{op}: {a.shape[0]} rows do not split over "
                         f"{group.world} ranks")
    return group.psum(gemm_rs_reference(xs, ws) for xs, ws in
                      zip(group.shard(a, 1), group.shard(b, 0)))


def _launch_gemm_ar(op: str, a: torch.Tensor, b: torch.Tensor,
                    count: LaunchCount, key) -> torch.Tensor:
    """The gemm_ar kernel on checked operands, one launch counted in
    ``count`` under ``key`` (none for an empty product)."""
    if a.device.type != "cuda":
        raise ValueError(f"{op} runs on CUDA or the CPU, not {a.device}")
    if a.dtype not in _DTYPE_CODES:
        raise ValueError(f"{op} kernel takes bf16 or f32, not {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{op} kernel needs contiguous operands")
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
    a, b = aligned16(a), aligned16(b)
    ws = (torch.empty((p.splits, m, n), dtype=torch.float32,
                      device=a.device) if p.splits > 1 else None)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _check(lib, lib.tdt_gemm_ar(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                ws.data_ptr() if ws is not None else None,
                                m, n, k, sms, _DTYPE_CODES[a.dtype], stream))
    count.add(key)
    return out


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
