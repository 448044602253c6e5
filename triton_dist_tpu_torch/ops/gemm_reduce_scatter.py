"""GEMM + AllReduce (``gemm_ar``) and GEMM + ReduceScatter (``gemm_rs``).

The port of ``triton_dist_tpu.ops.gemm_reduce_scatter.gemm_ar`` (:898)
and ``gemm_rs`` (:884). With one ring member their Pallas kernels
(``_gemm_rs_kernel`` :249, ``_gemm_rs_hbm_nb_kernel`` :353,
``_gemm_rs_hbm_kernel`` :533) all reduce to ``o = x @ w`` with f32
accumulation and one rounding, so the two entry points compute one
function. The kernels are hand-written CUDA for Hopper: ``gemm_ar`` runs
``csrc/gemm_ar.cu`` (B-streaming, for decode batches: bf16 on
``csrc/stream.cuh``'s wgmma body fed by TMA, one launch a call);
``gemm_rs`` runs that kernel for M <= 64 and the tiled prefill GEMM of
``csrc/ag_gemm.cu`` (one product) above. The notes at the top of the sources say what bounds
them and what their design does about that.

At world W > 1 (a ``runtime.dist.RankGroup`` of W ranks on one card)
``impl="pallas"`` runs the ring: ``csrc/gemm_rs_ring.cu``, one
cooperative launch over every rank, the counterpart of the three Pallas
kernels' ring reduce-scatter and (``gemm_ar``) its ring all-gather
epilogue. It has two bodies (:func:`ring_path`): calls of at most
:data:`DECODE_MAX_M` padded rows (decode) stream each rank's shard of
``b`` once through the world-1 kernel's split-K bodies, then run the
ring on the rounded partials; larger calls run the tiles chunk by chunk
in the ring's order. The ring's sum order and roundings are JAX's, not a
psum's:
:func:`gemm_rs_ring_reference` repeats them, and :func:`ring_plan`, a
copy of JAX's variant and block choice, says where the two ring
directions split the columns. Where JAX's ``gemm_ar`` falls back to its
XLA psum (the k-tiled variant, which has no all-gather epilogue), the
port gives the psum's result too (:func:`_psum_of_products`).

On a CUDA tensor every entry point launches a kernel or raises; none
falls back to a library product. Only tensors that lie on the CPU take
the plain versions (:func:`gemm_ar_reference`, :func:`gemm_rs_reference`
and, at world W, the ring references).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops import allgather_gemm
from triton_dist_tpu_torch.ops.allgather_gemm import (
    DECODE_MAX_M, DEFAULT_VMEM_BUDGET, RING_PATHS)
from triton_dist_tpu_torch.ops.common import (
    LaunchCount, aligned16, check_ring_dirs, num_sms)
from triton_dist_tpu_torch.runtime.dist import RankGroup
from triton_dist_tpu_torch.runtime.symm_mem import RingState

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

#: Launches of the gemm_ar kernel by ``gemm_ar``, by the (K, N) of ``b``
#: (CPU calls do not count).
launches = LaunchCount()
#: Launches by ``gemm_rs``, by (plan, K, N): plan "decode" is the gemm_ar
#: kernel (M <= 64), "prefill" / "fma" the AG-GEMM kernel's plans.
gemm_rs_launches = LaunchCount()
#: Launches of the ring kernel by ``gemm_rs`` at world W > 1, by (path,
#: world, rows, K per rank, N); path (:func:`ring_path`) "stream" (the
#: decode body, padded M <= 64), else the tile, "mma" (tensor cores) or
#: "fma".
rs_ring_launches = LaunchCount()
#: Launches of the ring kernel with its all-gather epilogue by ``gemm_ar``
#: at world W > 1, keyed as :data:`rs_ring_launches`.
ar_ring_launches = LaunchCount()


def gemm_ar_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(a.f32 @ b.f32)`` cast to ``a.dtype``."""
    return (a.float() @ b.float()).to(a.dtype)


def gemm_rs_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gemm_rs``: at world = 1 the function of
    :func:`gemm_ar_reference`."""
    return gemm_ar_reference(a, b)


class Plan(NamedTuple):
    """How the kernel runs one call, as ``csrc/gemm_ar.cu`` plans it
    (``csrc/gemm_common.cuh``'s ``stream_plan``; mirrored by
    ``allgather_gemm.stream_plan``): ``tensor_cores`` (else the FMA
    kernel), ``tiles`` (output tiles, the blocks of one K split),
    ``splits`` (K splits: the tensor-core kernel's are one cluster),
    ``k_per_split`` (K rows of a split) and ``workspace`` (the f32
    elements the call needs: the FMA kernel's splits, else 0)."""
    tensor_cores: bool
    tiles: int
    splits: int
    k_per_split: int
    workspace: int


@functools.cache
def plan(m: int, n: int, k: int, dtype: torch.dtype, num_sms: int) -> Plan:
    """The kernel's launch plan for a (m, k) x (k, n) product of
    ``dtype`` on a card with ``num_sms`` SMs. It depends on the dtype and
    the shape only, so equal inputs always sum in the same order (and a
    shape's plan is asked of the library once)."""
    lib = _gemm_ar_lib()
    path, tiles, splits, kps = (ctypes.c_int() for _ in range(4))
    ws = ctypes.c_longlong()
    _check(lib, lib.tdt_gemm_ar_plan(m, n, k, num_sms, _DTYPE_CODES[dtype],
                                     ctypes.byref(path), ctypes.byref(tiles),
                                     ctypes.byref(splits), ctypes.byref(kps),
                                     ctypes.byref(ws)))
    return Plan(bool(path.value), tiles.value, splits.value, kps.value,
                ws.value)


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
            impl: str = "pallas", ctx=None) -> torch.Tensor:
    """``allreduce(a @ b)``: a (M, K), b (K, N) in the JAX (in, out)
    layout. Returns (M, N) in ``a.dtype``.

    At world 1 the reduction is the identity: ``(a @ b)`` with f32
    accumulation, cast to ``a.dtype``; CUDA tensors run the hand-written
    kernel (bf16 or f32, contiguous), CPU tensors
    :func:`gemm_ar_reference`.

    Over a rank group of W > 1: a is column-sharded, b row-sharded, the
    result replicated; M need not split over the ranks (JAX pads it with
    zero rows and slices them off). ``impl="xla"``: each rank's rounded
    partial product, summed (``RankGroup.psum``). ``impl="pallas"``: the
    ring of :func:`gemm_rs` with the all-gather epilogue, one launch of
    ``csrc/gemm_rs_ring.cu`` on CUDA tensors (:func:`launch_ring`),
    :func:`gemm_ar_ring_reference` on CPU ones; where JAX falls back to
    its psum (:func:`ring_plan` variant "xla") the psum's result."""
    _check_operands("gemm_ar", a, b)
    if group is not None and group.world > 1:
        _check_impl("gemm_ar", impl)
        if impl == "xla":
            return _psum_of_products("gemm_ar", a, b, group, pad=True)
        return _ring("gemm_ar", a, b, ctx or GEMMReduceScatterContext(group),
                     True)
    if a.device.type == "cpu":
        return gemm_ar_reference(a, b)
    return _launch_gemm_ar("gemm_ar", a, b, launches,
                           (a.shape[1], b.shape[1]))


def gemm_rs(a: torch.Tensor, b: torch.Tensor, group=None,
            impl: str = "pallas", ctx=None) -> torch.Tensor:
    """``reduce_scatter(a @ b)``: a (M, K), b (K, N) in the JAX (in, out)
    layout. Returns (M, N) in ``a.dtype``.

    At world 1 the function of :func:`gemm_ar`. CUDA tensors (bf16 or
    f32, contiguous) run the gemm_ar kernel for M <= :data:`DECODE_MAX_M`,
    which streams B once for all rows, and the AG-GEMM kernel's tiled plan
    above; both count in :data:`gemm_rs_launches`. CPU tensors run
    :func:`gemm_rs_reference`.

    Over a rank group (``runtime.dist.RankGroup``) of W > 1: a is
    column-sharded, b row-sharded, the result row-sharded (M must split
    over the ranks). ``impl="xla"`` is JAX's XLA body, plain: each rank's
    partial product rounded, summed over the ranks (``RankGroup.psum``).
    ``impl="pallas"`` is the ring reduce-scatter in JAX's sum order: one
    launch of ``csrc/gemm_rs_ring.cu`` on CUDA tensors
    (:func:`launch_ring`), :func:`gemm_rs_ring_reference` on CPU ones.
    ``ctx``: the :class:`GEMMReduceScatterContext` whose kernel state the
    call uses (a layer keeps one across calls; default: a new one)."""
    _check_operands("gemm_rs", a, b)
    if group is not None and group.world > 1:
        _check_impl("gemm_rs", impl)
        if impl == "xla":
            return _psum_of_products("gemm_rs", a, b, group)
        return _ring("gemm_rs", a, b, ctx or GEMMReduceScatterContext(group),
                     False)
    if a.device.type == "cpu":
        return gemm_rs_reference(a, b)
    m, k = a.shape
    n = b.shape[1]
    if m > DECODE_MAX_M and n > 0:
        return allgather_gemm.launch_gemm(a, [b], gemm_rs_launches)[0]
    return _launch_gemm_ar("gemm_rs", a, b, gemm_rs_launches,
                           ("decode", k, (n,)))


def _check_impl(op: str, impl: str) -> None:
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown {op} impl {impl!r}")


def _psum_of_products(op: str, a: torch.Tensor, b: torch.Tensor, group,
                      pad: bool = False) -> torch.Tensor:
    """The world > 1 XLA body of gemm_rs / gemm_ar: the sum over ranks of
    each rank's rounded partial product. ``pad``: rows that do not split
    over the ranks are allowed (gemm_ar pads and slices them in JAX,
    which leaves the sum of the real rows as it is)."""
    if not pad and a.shape[0] % group.world:
        raise ValueError(f"{op}: {a.shape[0]} rows do not split over "
                         f"{group.world} ranks")
    return group.psum(gemm_rs_reference(xs, ws) for xs, ws in
                      zip(group.shard(a, 1), group.shard(b, 0)))


# -- the ring (world > 1) ----------------------------------------------------------
@dataclasses.dataclass
class GEMMReduceScatterContext:
    """JAX's ``GEMMReduceScatterContext`` over a rank group: ``ring_dirs``
    (2: the columns split between the two ring directions; 1: one ring)
    and ``vmem_budget``, which the port reads only to copy JAX's variant
    choice (:func:`ring_plan`). JAX reads ``TDT_RING_DIRS`` when
    ``ring_dirs`` is 0; the port reads no environment variable, and its
    default is JAX's default. ``state`` holds the kernel's slabs and
    signals across calls."""
    group: RankGroup
    ring_dirs: int = 2
    vmem_budget: int = DEFAULT_VMEM_BUDGET
    state: RingState = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        check_ring_dirs(self.ring_dirs)
        self.state = RingState(self.group)

    @property
    def world_size(self) -> int:
        return self.group.world


class RingPlan(NamedTuple):
    """What JAX's ``_entry`` (gemm_reduce_scatter.py:620-820) runs for one
    call: ``variant`` "vmem", "hbm" or "hbm_kt" (the Pallas kernel), or
    "xla" (gemm_ar's psum fallback); ``dirs`` the effective ring
    directions; ``split`` the first column of the mirrored ring (N with
    one direction)."""
    variant: str
    dirs: int
    split: int


def _pick_block(total: int, want: int) -> int:
    for cand in (want, 512, 256, 128):
        if cand <= total and total % cand == 0:
            return cand
    return total


def _hbm_nb_footprint(bm: int, bn: int, k_loc: int, itemsize: int) -> int:
    return itemsize * (2 * bm * k_loc + 2 * k_loc * bn + 4 * bm * bn)


def _hbm_budget_blocks(rows: int, k_loc: int, n: int, itemsize: int,
                       budget: int):
    """The first in-budget N-blocked config of JAX's ``gemm_rs_configs``
    (:69-130, block_n then block_m descending), as (block_m, block_n), or
    None: the re-filter of ``_entry`` (:724-733) takes its first entry."""
    for bn in (2048, 1024, 512, 256, 128):
        if bn > n or n % bn:
            continue
        for bm in (1024, 512, 256, 128):
            if bm > rows or rows % bm:
                continue
            if _hbm_nb_footprint(bm, bn, k_loc, itemsize) <= budget:
                return bm, bn
    return None


@functools.cache
def ring_plan(m: int, k_loc: int, n: int, itemsize: int, world: int,
              ring_dirs: int = 2, all_gather_epilogue: bool = False,
              vmem_budget: int = DEFAULT_VMEM_BUDGET) -> RingPlan:
    """JAX's decision for a ``gemm_rs`` / ``gemm_ar`` call of (already
    padded) ``m`` rows, ``k_loc`` columns of a per rank and ``n`` output
    columns at ``world`` ranks, with the default context's block hints
    (256 x 512) and no autotuning: ``resolve_variant`` (:226-237), the
    hbm block clamp and re-filter (:712-733), gemm_ar's psum fallback
    (:735-741) and the effective directions (:745, :802, :845)."""
    rows = m // world
    fp = itemsize * (m * k_loc + k_loc * n + rows * n
                     + 2 * max(world - 1, 1) * rows * n)
    variant = "vmem" if fp <= vmem_budget else "hbm"
    n_blk = None
    if variant == "hbm":
        m_blk, n_blk = _pick_block(rows, 256), _pick_block(n, 512)
        if _hbm_nb_footprint(m_blk, n_blk, k_loc, itemsize) > vmem_budget:
            cand = _hbm_budget_blocks(rows, k_loc, n, itemsize, vmem_budget)
            if cand is None:
                variant = "hbm_kt"
            else:
                n_blk = cand[1]
    if variant == "hbm_kt":
        if all_gather_epilogue:
            return RingPlan("xla", 1, n)
        return RingPlan("hbm_kt", 1, n)
    if variant == "hbm":
        n_blocks = n // n_blk
        if ring_dirs == 2 and world > 1 and n_blocks >= 2:
            return RingPlan("hbm", 2, (n_blocks // 2) * n_blk)
        return RingPlan("hbm", 1, n)
    if ring_dirs == 2 and world > 1 and n % 256 == 0:
        return RingPlan("vmem", 2, n // 2)
    return RingPlan("vmem", 1, n)


def _ring_partials(a: torch.Tensor, b: torch.Tensor,
                   world: int) -> torch.Tensor:
    """Every rank's partial product, rounded to ``a.dtype``: (W, M, N)."""
    m, k = a.shape
    kl = k // world
    ar = a.reshape(m, world, kl).transpose(0, 1).float()
    br = b.reshape(world, kl, b.shape[1]).float()
    return torch.bmm(ar, br).to(a.dtype)


def gemm_rs_ring_reference(a: torch.Tensor, b: torch.Tensor, world: int,
                           split: int) -> torch.Tensor:
    """Plain version of the ring kernel: the global (M, N) result of the
    ring reduce-scatter, in its sum order and roundings. Each rank's
    partial is rounded to ``a.dtype``; row chunk c's columns [0, split)
    add the partials p_{c+1}, p_{c+2}, ..., p_{c-1} and then p_c, its
    columns [split, N) p_{c-1}, p_{c-2}, ..., p_{c+1} and then p_c (the
    mirrored ring), each running sum rounded to ``a.dtype`` (JAX
    ``send_buf[s] = part + recv_buf[s - 1]``, :296-318)."""
    m, n = a.shape[0], b.shape[1]
    rows = m // world
    parts = _ring_partials(a, b, world).reshape(world, world, rows, n)
    chunks = torch.arange(world, device=a.device)
    out = torch.empty((world, rows, n), dtype=a.dtype, device=a.device)
    for c0, c1, d in ((0, split, 1), (split, n, -1)):
        if c0 == c1:
            continue

        def part(j):     # partial of rank c + j * d for every chunk c
            return parts[(chunks + j * d) % world, chunks][..., c0:c1]
        acc = part(1)
        for j in list(range(2, world)) + [0]:
            acc = (acc.float() + part(j).float()).to(a.dtype)
        out[..., c0:c1] = acc
    return out.reshape(m, n)


def gemm_ar_ring_reference(a: torch.Tensor, b: torch.Tensor, world: int,
                           split: int) -> torch.Tensor:
    """Plain version of the ring kernel with its all-gather epilogue: M
    padded with zero rows to a multiple of ``world``, the ring
    reduce-scatter of :func:`gemm_rs_ring_reference`, the padding sliced
    off. The all-gather copies, so every rank's (M, N) is this one."""
    m = a.shape[0]
    pad = -m % world
    if pad:
        a = torch.cat([a, a.new_zeros((pad, a.shape[1]))])
    return gemm_rs_ring_reference(a, b, world, split)[:m]


def _ring(op: str, a: torch.Tensor, b: torch.Tensor,
          ctx: GEMMReduceScatterContext, ag: bool) -> torch.Tensor:
    """gemm_rs / gemm_ar at world W > 1 through the ring."""
    world = ctx.world_size
    m, k = a.shape
    if k % world:
        raise ValueError(f"{op}: K = {k} does not split over {world} ranks")
    if not ag and m % world:
        raise ValueError(f"{op}: {m} rows do not split over {world} ranks")
    n = b.shape[1]
    pad = -m % world
    p = ring_plan(m + pad, k // world, n, a.element_size(), world,
                  ctx.ring_dirs, ag, ctx.vmem_budget)
    if p.variant == "xla":
        return _psum_of_products(op, a, b, ctx.group, pad=True)
    if a.device.type == "cpu":
        if ag:
            return gemm_ar_ring_reference(a, b, world, p.split)
        return gemm_rs_ring_reference(a, b, world, p.split)
    allgather_gemm._check_cuda(op, a, [b])
    _ring_lib()
    if pad:
        a = torch.cat([a, a.new_zeros((pad, k))])
    out = launch_ring(a, b, ctx, p.split, ag)
    return out[0, :m] if ag else out


def ring_path(dtype: torch.dtype, m: int, k_loc: int, n: int,
              split: int) -> str:
    """The ring kernel's body for a call of (padded) ``m`` rows: "stream"
    (the decode body, every dtype) for m <= :data:`DECODE_MAX_M`, the rule
    of the world-1 plans; above it the tile, "mma" (tensor cores: bf16 with
    K per rank, N and the split multiples of 8) or "fma"."""
    if m <= DECODE_MAX_M:
        return "stream"
    mma = (dtype == torch.bfloat16 and k_loc % 8 == 0 and n % 8 == 0
           and split % 8 == 0)
    return "mma" if mma else "fma"


class RingSizes(NamedTuple):
    """The state one ring launch needs (``csrc/gemm_rs_ring.cu``'s
    ``tdt_rs_ring_tiles``): ``pieces`` signals a ring step, ``prods`` the
    product signals of a rank (decode body), ``ws`` its f32 workspace's
    elements (decode body)."""
    pieces: int
    prods: int
    ws: int


@functools.cache
def _ring_sizes(dtype: torch.dtype, path: str, world: int, rows: int,
                k_loc: int, n: int, split: int, sms: int) -> RingSizes:
    lib = _ring_lib()
    pieces, prods, ws = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    _check(lib, lib.tdt_rs_ring_tiles(
        _DTYPE_CODES[dtype], RING_PATHS[path], world, rows, k_loc, n, split,
        sms, ctypes.byref(pieces), ctypes.byref(prods), ctypes.byref(ws)))
    return RingSizes(pieces.value, prods.value, ws.value)


def launch_ring(a: torch.Tensor, b: torch.Tensor,
                ctx: GEMMReduceScatterContext, split: int,
                all_gather_epilogue: bool, fault: bool = False
                ) -> torch.Tensor:
    """One launch of ``csrc/gemm_rs_ring.cu`` over every rank of
    ``ctx.group``, counted in :data:`rs_ring_launches` (or, with the
    all-gather epilogue, :data:`ar_ring_launches`) under (path, world,
    rows, K per rank, N), the path :func:`ring_path`'s. a (M, K) and b (K,
    N) are the global tensors (contiguous, CUDA, bf16 or f32), M and K
    multiples of W. Returns the row-sharded (M, N) result, or with the
    epilogue every rank's (M, N) buffer as one (W, M, N) tensor (rank 0's
    is the replicated result). ``fault`` plants the test fault of the
    kernel (the step-0 pushes of chunk 0, which holds row 0, skipped,
    their signals still set)."""
    allgather_gemm._check_cuda("gemm_rs ring", a, [b])
    world = ctx.world_size
    m, k = a.shape
    n = b.shape[1]
    rows, kl = m // world, k // world
    path = ring_path(a.dtype, m, kl, n, split)
    sms = num_sms(a.device.index)
    size = _ring_sizes(a.dtype, path, world, rows, kl, n, split, sms)
    state = ctx.state
    # The state's tables are made once (RingState.table): a launch queues
    # no kernel but its own.
    slab_tab = state.table(state.workspace((world - 1) * rows * n, a.dtype))
    sig_tab = state.table(state.signals(
        "rs", size.prods + (world - 1) * size.pieces))
    ws_tab = (state.table(state.workspace(size.ws, torch.float32,
                                          "products")) if size.ws else None)
    ag_tab = (state.table(state.signals("ag", world * size.pieces))
              if all_gather_epilogue and path != "stream" else None)
    a, b = aligned16(a), aligned16(b)
    out = torch.empty((world, m, n) if all_gather_epilogue else (m, n),
                      dtype=a.dtype, device=a.device)
    epoch = state.next_epoch()
    lib = _ring_lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream

    def ptr(t):
        return t.data_ptr() if t is not None else None
    _check(lib, lib.tdt_rs_ring(
        _DTYPE_CODES[a.dtype], RING_PATHS[path], a.data_ptr(), b.data_ptr(),
        out.data_ptr(), slab_tab.data_ptr(), sig_tab.data_ptr(),
        ptr(ws_tab), ptr(ag_tab), int(all_gather_epilogue), world, rows, kl,
        n, split, sms, epoch, int(fault), stream))
    count = ar_ring_launches if all_gather_epilogue else rs_ring_launches
    count.add((path, world, rows, kl, n))
    return out


def _ring_lib() -> ctypes.CDLL:
    lib = _build.load("gemm_rs_ring")
    if lib.tdt_rs_ring.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        lib.tdt_rs_ring_grid.argtypes = [i] * 6 + [ip]
        lib.tdt_rs_ring_grid.restype = i
        lib.tdt_rs_ring_tiles.argtypes = [i] * 8 + [ip, ip,
                                                    ctypes.POINTER(
                                                        ctypes.c_longlong)]
        lib.tdt_rs_ring_tiles.restype = i
        lib.tdt_rs_ring.argtypes = ([i, i] + [p] * 7 + [i] * 7
                                    + [ctypes.c_ulonglong, i, p])
        lib.tdt_rs_ring.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib


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
    ws = (torch.empty(p.workspace, dtype=torch.float32, device=a.device)
          if p.workspace else None)
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
        lib.tdt_gemm_ar_plan.argtypes = [i, i, i, i, i, ip, ip, ip, ip,
                                         ctypes.POINTER(ctypes.c_longlong)]
        lib.tdt_gemm_ar_plan.restype = i
        lib.tdt_gemm_ar.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.tdt_gemm_ar.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
