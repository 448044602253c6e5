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
(:func:`a2a_live_chunks`), and the kernel writes the receive counts too,
so a call queues that one kernel and nothing else. ``impl="xla"``, and
every call at world 1 (as in JAX, :262), is the plain slab transpose
:func:`_xla_a2a`, which also carries the small side bands (counts, fp8
scales, expert ids).

On a CUDA tensor ``impl="pallas"`` launches the kernel or raises; only a
tensor that lies on the CPU takes the plain version
:func:`fast_all_to_all_reference`, which moves the same chunks.

The fp8 wire (:func:`fast_all_to_all_fp8`): rows quantized to e4m3 with
per-row f32 scales, bitcast to ``int8`` for the same kernel, the scales
through the side band. Inference only, as in JAX (no gradient is
defined).

``a2a_footprint`` is the TPU kernel's VMEM budget and has no counterpart
here: the kernel keeps only its scan of the slabs' live pieces in shared
memory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops.common import LaunchCount
from triton_dist_tpu_torch.runtime.dist import RankGroup, create_rank_group
from triton_dist_tpu_torch.runtime.symm_mem import rank_span, symm_tensor

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
    symmetric signals (one 64-bit word per (src, chunk, piece) on each
    rank) and the call counter that stamps them."""
    group: RankGroup
    capacity: int = 128          # max rows per (src, dst) pair
    chunk_rows: int | None = None
    _signals: dict = dataclasses.field(default_factory=dict, repr=False)
    _epoch: int = dataclasses.field(default=0, repr=False)

    @property
    def world_size(self) -> int:
        return self.group.world

    def resolve_chunk(self, itemsize: int = 2) -> int:
        return self.chunk_rows or _default_chunk_rows(self.capacity,
                                                      itemsize)

    def kernel_state(self, n_signals: int):
        """(signals, this call's epoch) for one launch whose rows hold
        ``n_signals`` signals (``tdt_all_to_all_signals``: they depend on
        the row width through the pieces of a chunk). Each size's signals
        are allocated zeroed at first use and kept, so a call never
        reuses a smaller buffer; every call takes the next epoch."""
        sig = self._signals.get(n_signals)
        if sig is None:
            sig = self._signals[n_signals] = symm_tensor(
                (n_signals,), torch.int64, self.group)
        self._epoch += 1
        return sig, self._epoch


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
    return launch_all_to_all(send_buf, send_counts, ctx, chunk, out)


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
def grid(world: int, capacity: int, chunk: int,
         row_bytes: int) -> tuple[int, bool]:
    """(blocks, compact body) of one launch (``tdt_all_to_all_grid``): a
    block an item (a copy item per 16 KiB piece of every (peer, rank,
    chunk), a wait item per (rank, source)) while the card keeps that many
    resident, else the compact body on every block it keeps resident."""
    lib = _lib()
    blocks, compact = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.tdt_all_to_all_grid(world, capacity, chunk, row_bytes,
                                        ctypes.byref(blocks),
                                        ctypes.byref(compact)))
    return blocks.value, bool(compact.value)


def launch_all_to_all(send_buf: torch.Tensor, send_counts: torch.Tensor,
                      ctx: AllToAllContext, chunk: int,
                      out: torch.Tensor | None = None):
    """One launch of the kernel on CUDA tensors, counted in
    :data:`a2a_launches`; nothing else is queued. Returns (the receive
    buffer: ``out`` or a new one, rows outside the live chunks untouched;
    the receive counts, a new int32 tensor the kernel writes)."""
    world, cap = ctx.world_size, ctx.capacity
    if send_buf.device.type != "cuda":
        raise ValueError(f"the all-to-all kernel runs on CUDA, not "
                         f"{send_buf.device}")
    if not send_buf.is_contiguous():
        raise ValueError("the all-to-all kernel needs a contiguous send_buf")
    if send_counts.device != send_buf.device:
        raise ValueError(f"send_counts on {send_counts.device}, send_buf on "
                         f"{send_buf.device}")
    lib = _lib()
    if out is None:
        out = torch.empty_like(send_buf)
    elif (out.shape != send_buf.shape or out.dtype != send_buf.dtype
          or not out.is_contiguous() or out.device != send_buf.device):
        raise ValueError("out must be a contiguous tensor like send_buf")
    # No-ops for the contiguous int32 counts of ``dispatch_layout``.
    counts = send_counts.to(torch.int32).contiguous()
    recv_counts = torch.empty_like(counts)
    row_bytes = math.prod(send_buf.shape[2:]) * send_buf.element_size()
    n_signals = lib.tdt_all_to_all_signals(world, cap, chunk, row_bytes)
    if n_signals < 1:
        raise ValueError(f"the all-to-all kernel refuses world {world}, "
                         f"capacity {cap}, chunk {chunk}, {row_bytes}-byte "
                         f"rows")
    sig, epoch = ctx.kernel_state(n_signals)
    send_base, send_step = rank_span(send_buf, world)
    recv_base, recv_step = rank_span(out, world)
    stream = torch.cuda.current_stream(send_buf.device).cuda_stream
    _check(lib, lib.tdt_all_to_all(
        send_base, send_step, recv_base, recv_step, sig.table.data_ptr(),
        counts.data_ptr(), recv_counts.data_ptr(), world, cap, chunk,
        row_bytes, epoch, stream))
    a2a_launches.add((world, cap, row_bytes))
    return out, recv_counts


def _check(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.tdt_error_string(err).decode()
        raise RuntimeError(f"all_to_all kernel call failed: {msg} ({err})")


def _lib() -> ctypes.CDLL:
    lib = _build.load("all_to_all")
    if lib.tdt_all_to_all.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tdt_all_to_all_signals.argtypes = [i, i, i, ll]
        lib.tdt_all_to_all_signals.restype = ll
        lib.tdt_all_to_all_grid.argtypes = [i, i, i, ll, ctypes.POINTER(i),
                                            ctypes.POINTER(i)]
        lib.tdt_all_to_all_grid.restype = i
        lib.tdt_all_to_all.argtypes = [p, ll, p, ll, p, p, p, i, i, i, ll,
                                       ctypes.c_ulonglong, p]
        lib.tdt_all_to_all.restype = i
        lib.tdt_error_string.argtypes = [i]
        lib.tdt_error_string.restype = ctypes.c_char_p
    return lib
