"""The expert-parallel low-latency all-to-all (the port of
``triton_dist_tpu.ops.all_to_all``).

Data model, as in JAX: every rank holds a rank-major send buffer (W,
capacity, H) whose slab p carries ``send_counts[p]`` rows for rank p; the
exchange transposes slabs, so afterwards recv slab j holds the rows rank
j sent here. The port keeps JAX's global layouts: ``send_buf`` is (W * W,
capacity, H) with rank s's buffer at rows [s * W, (s + 1) * W), and
``send_counts`` is (W * W,).

``fast_all_to_all(impl="pallas")`` launches the hand-written kernel of
``csrc/all_to_all.cu``, the counterpart of ``_a2a_kernel`` (:155), for
every rank of the card at once; only the live chunks of each slab move
(:func:`a2a_live_chunks`). ``impl="xla"``, and every call at world 1 (as
in JAX, :262), is the plain slab transpose :func:`_xla_a2a`, which also
carries the small side bands (counts, fp8 scales, expert ids).

On a CUDA tensor ``impl="pallas"`` launches the kernel or raises; only a
tensor that lies on the CPU takes the plain version
:func:`fast_all_to_all_reference`, which moves the same chunks.

The fp8 wire (:func:`fast_all_to_all_fp8`): rows quantized to e4m3 with
per-row f32 scales, bitcast to ``int8`` for the same kernel, the scales
through the side band. Inference only, as in JAX (no gradient is
defined).

``a2a_footprint`` is the TPU kernel's VMEM budget and has no counterpart
here: the kernel keeps nothing in shared memory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import LaunchCount
from triton_dist_tpu_torch.runtime.dist import RankGroup, create_rank_group
from triton_dist_tpu_torch.runtime.symm_mem import rank_table, symm_tensor

#: Launches of the all-to-all kernel, by (world, capacity, row bytes).
a2a_launches = LaunchCount()

#: float8_e4m3fn's largest finite value.
FP8_MAX = 448.0


def _default_chunk_rows(capacity: int, itemsize: int = 2) -> int:
    """Largest divisor of ``capacity`` of at most 128 rows among the
    TPU tile-aligned sizes of the element width (JAX
    ``_default_chunk_rows``, :54-66: 32-row steps for 1-byte rows), else
    the whole slab. The chunk sets which rows move, so the port keeps
    JAX's choice."""
    aligned = {4: (128, 64, 32, 16, 8), 2: (128, 64, 32, 16),
               1: (128, 64, 32)}.get(itemsize, (128, 64, 32))
    for c in aligned:
        if capacity % c == 0:
            return c
    return capacity


@dataclasses.dataclass
class AllToAllContext:
    """Capacity and chunking of the exchange (JAX ``AllToAllContext``),
    over a rank group. The kernel's persistent state lives here: the
    symmetric signals (one 64-bit word per (src, chunk) on each rank), the
    launch barrier's flags and the call counter that stamps them."""
    group: RankGroup
    capacity: int = 128          # max rows per (src, dst) pair
    chunk_rows: int | None = None
    _signals: dict = dataclasses.field(default_factory=dict, repr=False)
    _barrier: torch.Tensor | None = dataclasses.field(default=None,
                                                      repr=False)
    _epoch: int = dataclasses.field(default=0, repr=False)

    @property
    def world_size(self) -> int:
        return self.group.world

    def resolve_chunk(self, itemsize: int = 2) -> int:
        return self.chunk_rows or _default_chunk_rows(self.capacity,
                                                      itemsize)

    def kernel_state(self, n_chunks: int):
        """(signals, barrier flags, this call's epoch) for one launch.
        The signals of ``n_chunks`` chunks per slab are allocated zeroed
        at first use and kept; every call takes the next epoch."""
        sig = self._signals.get(n_chunks)
        if sig is None:
            sig = self._signals[n_chunks] = symm_tensor(
                (self.world_size, n_chunks), torch.int64, self.group)
        if self._barrier is None:
            self._barrier = torch.zeros(max_blocks(), dtype=torch.int64,
                                        device=self.group.device)
        self._epoch += 1
        return sig, self._barrier, self._epoch


def create_all_to_all_context(group: RankGroup | None = None,
                              capacity: int = 128,
                              chunk_rows: int | None = None
                              ) -> AllToAllContext:
    """The context of ``group`` (default: one rank on the CUDA card)."""
    return AllToAllContext(group=group or create_rank_group(),
                           capacity=capacity, chunk_rows=chunk_rows)


# -- schedule helpers (JAX :114-131), on ints or integer tensors ---------------
def a2a_send_peer(me, i, world: int):
    """Peer of send position ``i`` (1..world-1): rank-rotated right."""
    return (me + i) % world


def a2a_wait_src(me, i, world: int):
    """Source of wait position ``i``: the mirror of :func:`a2a_send_peer`."""
    return (me - i + world) % world


def a2a_live_chunks(count, chunk: int):
    """Chunks that move for a slab of ``count`` live rows (cdiv)."""
    return (count + (chunk - 1)) // chunk


# -- plain versions ----------------------------------------------------------------
def _xla_a2a(arr: torch.Tensor, world: int) -> torch.Tensor:
    """The slab transpose of a global (W * W, ...) array (JAX ``_xla_a2a``,
    an XLA all-to-all on the leading dim): rank d's slab s becomes rank
    s's slab d. The side band of counts, scales and expert ids."""
    if world == 1:
        return arr
    rest = tuple(arr.shape[1:])
    return (arr.reshape(world, world, *rest).transpose(0, 1)
            .reshape(world * world, *rest))


def fast_all_to_all_reference(send_buf: torch.Tensor,
                              send_counts: torch.Tensor, world: int,
                              chunk: int, out: torch.Tensor | None = None):
    """Plain version of the kernel: the live chunks of every (src, dst)
    slab move, rows of other chunks keep ``out``'s values (zeros when no
    ``out`` is given). Returns (recv_buf, recv_counts) in the layouts of
    :func:`fast_all_to_all`."""
    cap = send_buf.shape[1]
    n_chunks = cap // chunk
    counts = send_counts.reshape(world, world).long()          # [s, d]
    rows = a2a_live_chunks(counts.clamp(min=0), chunk).clamp(
        max=n_chunks) * chunk
    live = (torch.arange(cap, device=send_buf.device)[None, None, :]
            < rows.t()[:, :, None])                            # [d, s, row]
    moved = _xla_a2a(send_buf, world).reshape(world, world, cap, -1)
    if out is None:
        out = torch.zeros_like(send_buf)
    out4 = out.view(world, world, cap, -1)
    out4.copy_(torch.where(live[..., None], moved, out4))
    return out, _xla_a2a(send_counts, world)


# -- entry points ----------------------------------------------------------------
def fast_all_to_all(send_buf: torch.Tensor, send_counts: torch.Tensor,
                    ctx: AllToAllContext | None = None, impl: str = "pallas",
                    out: torch.Tensor | None = None):
    """Exchange rank-major slabs (JAX ``fast_all_to_all``, :237).

    send_buf: (W * W, capacity, H), rank s's slab d at row s * W + d;
    send_counts: (W * W,) int32. Returns (recv_buf, recv_counts) in the
    same layouts: recv slab j of rank d came from rank j. Rows past the
    live chunks are undefined, as in JAX (``out``, when given, receives
    the result and keeps its values there)."""
    ctx = ctx or create_all_to_all_context()
    world, cap = ctx.world_size, ctx.capacity
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown fast_all_to_all impl {impl!r}")
    if send_buf.dim() < 2 or send_buf.shape[0] != world * world or \
            send_buf.shape[1] != cap:
        raise ValueError(f"send_buf {tuple(send_buf.shape)} is not "
                         f"({world * world}, {cap}, ...)")
    if send_counts.shape != (world * world,):
        raise ValueError(f"send_counts {tuple(send_counts.shape)} is not "
                         f"({world * world},)")
    chunk = ctx.resolve_chunk(send_buf.element_size())
    if cap % chunk:
        raise ValueError(f"capacity {cap} is no multiple of chunk {chunk}")
    if impl == "xla" or world == 1:
        return _xla_a2a(send_buf, world), _xla_a2a(send_counts, world)
    if send_buf.device.type == "cpu":
        return fast_all_to_all_reference(send_buf, send_counts, world, chunk,
                                         out)
    recv = launch_all_to_all(send_buf, send_counts, ctx, chunk, out)
    return recv, _xla_a2a(send_counts, world)


def quantize_fp8_rows(x: torch.Tensor):
    """Per-row symmetric e4m3 quantization (JAX ``quantize_fp8_rows``):
    ``q = fp8(x / scale)``, ``scale = max|row| / 448`` in f32 (1 for a row
    of zeros). Returns (q, scales of shape ``x.shape[:-1]``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (xf / scale[..., None]).to(torch.float8_e4m3fn), scale


def dequantize_fp8_rows(q: torch.Tensor, scale: torch.Tensor,
                        dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def fast_all_to_all_fp8(send_buf: torch.Tensor, send_counts: torch.Tensor,
                        ctx: AllToAllContext | None = None,
                        impl: str = "pallas"):
    """:func:`fast_all_to_all` at fp8 wire precision (JAX
    ``fast_all_to_all_fp8``): rows quantized to e4m3, moved as ``int8``
    bytes through the same exchange (chunks for 1-byte rows), scales
    through the side band, then dequantized to ``send_buf.dtype``. Rows
    past the live chunks stay undefined."""
    ctx = ctx or create_all_to_all_context()
    q, scale = quantize_fp8_rows(send_buf)
    recv_wire, recv_counts = fast_all_to_all(q.view(torch.int8), send_counts,
                                             ctx, impl=impl)
    recv_scale = _xla_a2a(scale, ctx.world_size)
    return (dequantize_fp8_rows(recv_wire.view(torch.float8_e4m3fn),
                                recv_scale, send_buf.dtype), recv_counts)


# -- the kernel ------------------------------------------------------------------
@functools.cache
def max_blocks() -> int:
    """Blocks of the kernel resident at once on the card: the most one
    launch may have, and the barrier's flag count."""
    return blocks_per_rank(1, 1 << 30)


@functools.cache
def blocks_per_rank(world: int, n_chunks: int) -> int:
    """The kernel's blocks for each rank of a ``world``-rank call with
    ``n_chunks`` chunks per slab (``tdt_all_to_all_grid``)."""
    lib = _lib()
    out = ctypes.c_int()
    _check(lib, lib.tdt_all_to_all_grid(world, n_chunks, ctypes.byref(out)))
    return out.value


def launch_all_to_all(send_buf: torch.Tensor, send_counts: torch.Tensor,
                      ctx: AllToAllContext, chunk: int,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors, counted in
    :data:`a2a_launches`. Returns the receive buffer (``out`` or a new
    one, rows outside the live chunks untouched)."""
    world, cap = ctx.world_size, ctx.capacity
    if send_buf.device.type != "cuda":
        raise ValueError(f"the all-to-all kernel runs on CUDA, not "
                         f"{send_buf.device}")
    if not send_buf.is_contiguous():
        raise ValueError("the all-to-all kernel needs a contiguous send_buf")
    lib = _lib()
    if out is None:
        out = torch.empty_like(send_buf)
    elif (out.shape != send_buf.shape or out.dtype != send_buf.dtype
          or not out.is_contiguous() or out.device != send_buf.device):
        raise ValueError("out must be a contiguous tensor like send_buf")
    counts = send_counts.to(device=send_buf.device, dtype=torch.int32)
    counts = counts.contiguous()
    sig, bar, epoch = ctx.kernel_state(cap // chunk)
    row_bytes = send_buf[0, 0].numel() * send_buf.element_size()
    send_tab = rank_table(send_buf, world)
    recv_tab = rank_table(out, world)
    stream = torch.cuda.current_stream(send_buf.device).cuda_stream
    _check(lib, lib.tdt_all_to_all(
        send_tab.data_ptr(), recv_tab.data_ptr(), sig.table.data_ptr(),
        bar.data_ptr(), bar.numel(), counts.data_ptr(), world, cap, chunk,
        row_bytes, epoch, stream))
    a2a_launches.add((world, cap, row_bytes))
    return out


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.tdt_error_string(err).decode()
        raise RuntimeError(f"all_to_all kernel call failed: {msg} ({err})")


def _lib() -> ctypes.CDLL:
    lib = _build.load("all_to_all")
    if lib.tdt_all_to_all.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tdt_all_to_all_grid.argtypes = [i, i, ctypes.POINTER(i)]
        lib.tdt_all_to_all_grid.restype = i
        lib.tdt_all_to_all.argtypes = [p, p, p, p, i, p, i, i, i,
                                       ctypes.c_longlong, ctypes.c_ulonglong,
                                       p]
        lib.tdt_all_to_all.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
