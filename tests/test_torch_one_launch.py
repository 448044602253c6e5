"""The world-W exchange entries queue one kernel a call and nothing else:
``fast_all_to_all`` (``csrc/all_to_all.cu``), the world-W all-gather in
every method and the broadcast (``csrc/allgather.cu``), ``all_reduce`` in
every method and ``reduce_scatter`` in both (``csrc/reduce_world.cu``),
``pp_shift`` and ``symm_ship`` (``csrc/p2p.cu``), on the CPU.

The calls get CPU tensors that report the CUDA device, so they take the
kernel route, and a stub in place of the built library that records each
launch's arguments and does what the kernel's contract says through the
addresses it is given (the tensors lie in host memory). Under a
``TorchDispatchMode`` that logs every aten op, a call after the first
(which makes the context's signals and their table) runs nothing but
allocations and views: the launch is the only work it queues. The
stub's results, written through the (base, step) addresses, are
bit-equal to the plain versions, the addresses equal ``rank_table``'s and
the receive counts the kernel is told to write equal ``_xla_a2a`` of the
send counts. The kernels themselves run on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py`` phases 16, 22, 26 and
27)."""

import ctypes
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from triton_dist_tpu_torch.ops import all_to_all as a2a
from triton_dist_tpu_torch.ops import allgather as ag
from triton_dist_tpu_torch.ops import allreduce as ar
from triton_dist_tpu_torch.ops import p2p
from triton_dist_tpu_torch.ops import reduce_scatter as rs
from triton_dist_tpu_torch.runtime import symm_mem
from triton_dist_tpu_torch.runtime.dist import create_rank_group
from triton_dist_tpu_torch.serving import kv_stream as ks

WORLDS = (2, 3, 4, 8)
#: aten ops that allocate without writing: no kernel on the card.
ALLOCATIONS = {"empty", "empty_like", "new_empty", "empty_strided"}


class CudaView(torch.Tensor):
    """A CPU tensor that reports the CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def on_cuda(t):
    return t.as_subclass(CudaView)


def host(t):
    return t.as_subclass(torch.Tensor)


def bits(t):
    t = host(t)
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


class OpLog(TorchDispatchMode):
    """Every aten op run while the mode is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))

    def work(self) -> list:
        """The logged ops that are neither an allocation nor a view."""
        return [f.name() for f in self.ops
                if not f.is_view and f.overloadpacket.__name__
                not in ALLOCATIONS]


@pytest.fixture
def no_stream(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))


def _ints(address: int, n: int):
    return (ctypes.c_int32 * n).from_address(address)


class A2AStub:
    """``csrc/all_to_all.cu``'s entries: the live chunks of every slab and
    the transposed counts, moved through the addresses."""

    def __init__(self):
        self.calls = []

    def tdt_all_to_all_signals(self, world, cap, chunk, row_bytes):
        return world * (cap // chunk) * -(-chunk * row_bytes // (16 * 1024))

    def tdt_all_to_all(self, send, send_step, recv, recv_step, sig_tab,
                       counts, recv_counts, world, cap, chunk, row_bytes,
                       epoch, stream):
        self.calls.append(dict(send=send, send_step=send_step, recv=recv,
                               recv_step=recv_step, sig_tab=sig_tab,
                               epoch=epoch))
        sent, got = _ints(counts, world * world), _ints(recv_counts,
                                                        world * world)
        slab = cap * row_bytes
        for s in range(world):
            for d in range(world):
                n = sent[s * world + d]
                live = min(-(-max(n, 0) // chunk), cap // chunk)
                ctypes.memmove(recv + d * recv_step + s * slab,
                               send + s * send_step + d * slab,
                               live * chunk * row_bytes)
                got[d * world + s] = n       # recv_counts[d W + s]
        return 0

    def tdt_error_string(self, err):
        return b"stub"


class GatherStub:
    """``csrc/allgather.cu``'s world-W entries: every rank's output row
    written through (out, out_step)."""

    def __init__(self):
        self.calls = []

    def tdt_gather_signals(self, chunk, world):
        return world * -(-chunk // (16 * 1024))

    def tdt_all_gather_world(self, x, out, out_step, sig_tab, chunk, world,
                             method, epoch, fault, stream):
        self.calls.append(dict(out=out, out_step=out_step, sig_tab=sig_tab))
        for r in range(world):
            for s in range(world):
                ctypes.memmove(out + r * out_step + s * chunk, x + s * chunk,
                               chunk)
        return 0

    def tdt_broadcast_world(self, x, out, out_step, sig_tab, chunk, world,
                            root, epoch, fault, stream):
        self.calls.append(dict(out=out, out_step=out_step, sig_tab=sig_tab))
        for r in range(world):
            ctypes.memmove(out + r * out_step, x + root * chunk, chunk)
        return 0

    def tdt_error_string(self, err):
        return b"stub"


def _addresses(call, name, world):
    return [call[name] + r * call[f"{name}_step"] for r in range(world)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("world", WORLDS)
def test_all_to_all_call_queues_one_kernel(monkeypatch, no_stream, world,
                                           dtype):
    stub = A2AStub()
    monkeypatch.setattr(a2a, "_lib", lambda: stub)
    cap, h, chunk = 16, 24, 8
    rng = np.random.RandomState(world)
    send = torch.from_numpy(rng.randint(-100, 100, (world * world, cap, h))
                            .astype(np.int8)).to(dtype)
    counts = rng.randint(0, cap + 1, world * world).astype(np.int32)
    counts[0], counts[-1] = cap, 0
    counts = torch.from_numpy(counts)
    # The send buffer at an offset inside a larger one: rank 0's address
    # is not the allocation's.
    big = torch.zeros((world * world + 1, cap, h), dtype=dtype)
    big[1:] = send
    send_view = big[1:]
    ctx = a2a.create_all_to_all_context(
        create_rank_group(world, device="cpu"), capacity=cap,
        chunk_rows=chunk)
    a2a.fast_all_to_all(on_cuda(send_view), on_cuda(counts), ctx)
    canary = 127 if dtype == torch.int8 else float("nan")
    out = torch.full_like(send, canary)
    before = a2a.a2a_launches.total
    with OpLog() as log:
        got, got_counts = a2a.fast_all_to_all(on_cuda(send_view),
                                              on_cuda(counts), ctx,
                                              out=on_cuda(out))
    assert log.work() == []
    assert a2a.a2a_launches.total == before + 1
    first, call = stub.calls
    assert call["epoch"] == first["epoch"] + 1
    assert _addresses(call, "send", world) == \
        symm_mem.rank_table(send_view, world).tolist()
    assert _addresses(call, "recv", world) == \
        symm_mem.rank_table(out, world).tolist()
    # The signals' table is the context's, made once.
    (sig,) = ctx._signals.values()
    assert call["sig_tab"] == first["sig_tab"] == sig.table.data_ptr()
    assert host(got).data_ptr() == out.data_ptr()
    assert got_counts.dtype == torch.int32
    assert torch.equal(host(got_counts), a2a._xla_a2a(counts, world))
    want, want_counts = a2a.fast_all_to_all_reference(
        send, counts, world, chunk, out=torch.full_like(send, canary))
    assert torch.equal(bits(got), bits(want))
    assert torch.equal(host(got_counts), want_counts)


def test_all_to_all_refuses_counts_on_another_device(monkeypatch):
    monkeypatch.setattr(a2a, "_lib", lambda: pytest.fail("built"))
    ctx = a2a.create_all_to_all_context(create_rank_group(2, device="cpu"),
                                        capacity=8)
    send = on_cuda(torch.zeros(4, 8, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="send_counts on cpu"):
        a2a.fast_all_to_all(send, torch.full((4,), 3, dtype=torch.int32),
                            ctx)


def test_all_to_all_signals_follow_the_row_width(monkeypatch, no_stream):
    """A chunk's pieces, so a rank's signals, grow with the row width: a
    call with wider rows gets a larger signal buffer of its own, never a
    smaller one made earlier, and a later call with the first width takes
    the first buffer again; every call takes the next epoch."""
    stub = A2AStub()
    monkeypatch.setattr(a2a, "_lib", lambda: stub)
    world, cap, chunk = 4, 16, 8
    ctx = a2a.create_all_to_all_context(
        create_rank_group(world, device="cpu"), capacity=cap,
        chunk_rows=chunk)
    counts = on_cuda(torch.full((world * world,), cap, dtype=torch.int32))
    # bf16 rows of 2 KiB (a chunk is one 16 KiB piece), then of 4 KiB (two).
    for h in (1024, 2048, 1024):
        send = torch.zeros((world * world, cap, h), dtype=torch.bfloat16)
        a2a.fast_all_to_all(on_cuda(send), counts, ctx)
    sizes = {n: sig.table.data_ptr() for n, sig in ctx._signals.items()}
    one, two = world * (cap // chunk), 2 * world * (cap // chunk)
    assert sorted(sizes) == [one, two]
    assert [c["sig_tab"] for c in stub.calls] == [sizes[one], sizes[two],
                                                  sizes[one]]
    assert [c["epoch"] for c in stub.calls] == [1, 2, 3]


@pytest.mark.parametrize("method", ["full_mesh_push", "ring_1d",
                                    "ring_bidir"])
@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_world_call_queues_one_kernel(monkeypatch, no_stream,
                                                 world, method):
    stub = GatherStub()
    monkeypatch.setattr(ag, "_lib", lambda: stub)
    m_ = ag.AllGatherMethod(method)
    ctx = ag.create_allgather_context(
        method=m_, group=create_rank_group(world, device="cpu"))
    x = torch.randn(3 * world, 40).to(torch.bfloat16)
    want = ag.all_gather_reference(x, world, stacked=True)
    ag.all_gather(on_cuda(x), ctx, stacked=True)
    out = torch.full_like(want, float("nan"))
    before = ag.all_gather_launches.total
    with OpLog() as log:
        stacked = ag.all_gather(on_cuda(x), ctx, stacked=True)
        one = ag.all_gather(on_cuda(x), ctx)
        got = ag.launch_all_gather_world(on_cuda(x), ctx, m_,
                                         out=on_cuda(out))
    assert log.work() == []
    assert ag.all_gather_launches.total == before + 3
    sig = ctx.state.signals("ag", stub.tdt_gather_signals(
        x[:3].numel() * x.element_size(), world))
    assert {c["sig_tab"] for c in stub.calls} == \
        {ctx.state.table(sig).data_ptr()}
    assert _addresses(stub.calls[-1], "out", world) == \
        symm_mem.rank_table(out, world).tolist()
    assert host(got).data_ptr() == out.data_ptr()
    for result in (stacked, got):
        assert torch.equal(bits(result), bits(want))
    assert torch.equal(bits(one), bits(x))


@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_world_call_queues_one_kernel(monkeypatch, no_stream,
                                                world):
    stub = GatherStub()
    monkeypatch.setattr(ag, "_lib", lambda: stub)
    ctx = ag.create_allgather_context(
        group=create_rank_group(world, device="cpu"))
    x = torch.randn(2 * world, 40).to(torch.bfloat16)
    ag.broadcast(on_cuda(x), 0, ctx)
    before = ag.broadcast_launches.total
    with OpLog() as log:
        one = ag.broadcast(on_cuda(x), world - 1, ctx)
        every = ag.launch_broadcast_world(on_cuda(x), 1, ctx)
    assert log.work() == []
    assert ag.broadcast_launches.total == before + 2
    assert len({c["sig_tab"] for c in stub.calls}) == 1
    assert _addresses(stub.calls[-1], "out", world) == \
        symm_mem.rank_table(host(every), world).tolist()
    assert torch.equal(bits(one), bits(ag.broadcast_reference(
        x, world - 1, world)))
    want = ag.broadcast_reference(x, 1, world)
    assert all(torch.equal(bits(every[r]), bits(want))
               for r in range(world))


@pytest.mark.parametrize("world", WORLDS)
def test_rank_span_is_rank_table(world):
    """(base, step) gives the addresses of ``rank_table`` on a contiguous
    tensor, one at an offset and a view with a leading-dim stride."""
    big = torch.zeros(4 * world * 3, 5, dtype=torch.bfloat16)
    for x in (big[:world * 3], big[3:3 + world * 3], big[::4],
              big.view(4 * world, 3, 5)[1::2]):
        base, step = symm_mem.rank_span(x, world)
        rows = x.shape[0] // world
        assert [base + r * step for r in range(world)] == \
            symm_mem.rank_table(x, world).tolist() == \
            [x[r * rows].data_ptr() for r in range(world)]
    with pytest.raises(ValueError):
        symm_mem.rank_span(big[:world * 3 + 1], world)


def _host_tensor(address: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    """The ``n`` elements of ``dtype`` at a host ``address``, as a tensor
    over the same memory."""
    size = n * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * size).from_address(address),
                            dtype=dtype)


_CODES = {0: torch.bfloat16, 1: torch.float32}


def _put(**outs) -> int:
    """Writes each value through its ``ctypes.byref`` argument, as a C
    entry writes its outputs; returns 0 (cudaSuccess)."""
    for ref, value in outs.values():
        ref._obj.value = value
    return 0


class ReduceStub:
    """``csrc/reduce_world.cu``'s entries: the plain version's result of
    the kind asked for, written into every rank's output through (out,
    out_step)."""

    def __init__(self):
        self.calls = []

    def tdt_reduce_world_grid(self, kind, world, elems, dtype, grid,
                              resident, piece, pieces, signals):
        return _put(grid=(grid, world), resident=(resident, 1056),
                    piece=(piece, elems), pieces=(pieces, 1),
                    signals=(signals, 2 * world))

    def tdt_reduce_world_workspace(self, kind, world, elems):
        return world * elems

    def _launch(self, op, x, out, out_step, ws, ws_step, sig, sig_step,
                elems, world, method, dtype, straggler, cycles, epoch, fault,
                stream):
        self.calls.append(dict(op=op, out=out, out_step=out_step, ws=ws,
                               ws_step=ws_step, sig=sig, sig_step=sig_step,
                               method=method, epoch=epoch))
        # The kernel's work, which the caller's op log does not see.
        with _disable_current_modes():
            rows = world if elems % world == 0 else 1
            xs = _host_tensor(x, world * elems, _CODES[dtype]).reshape(
                world, rows, -1)
            if op == "reduce_scatter":
                want = rs.reduce_scatter_world_reference(
                    xs, rs.ReduceScatterMethod(("one_shot", "ring")[method]))
                parts = list(want)             # rank r's chunk: row r
            else:
                want = ar.all_reduce_world_reference(xs, ar.AllReduceMethod(
                    ("one_shot", "two_shot", "recursive_doubling")[method]))
                parts = [want.reshape(-1)] * world
            for r, part in enumerate(parts):
                part = part.contiguous()
                ctypes.memmove(out + r * out_step, part.data_ptr(),
                               part.numel() * part.element_size())
        return 0

    def tdt_reduce_scatter_world(self, *args):
        return self._launch("reduce_scatter", *args)

    def tdt_all_reduce_world(self, *args):
        return self._launch("all_reduce", *args)

    def tdt_error_string(self, err):
        return b"stub"


RW_CASES = [("all_reduce", "one_shot"), ("all_reduce", "two_shot"),
            ("all_reduce", "recursive_doubling"),
            ("reduce_scatter", "ring"), ("reduce_scatter", "one_shot")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("op,method", RW_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_world_reduce_call_queues_one_kernel(monkeypatch, no_stream, world,
                                             op, method, dtype):
    """``all_reduce`` / ``reduce_scatter`` at world W and a launch into a
    NaN-filled buffer queue the kernel alone; their output, workspace and
    signal rows go as (base, step) with ``rank_table``'s addresses, the
    state's buffers made by the first call, and the stub's results written
    through them are bit-equal to the plain version (every all-reduce
    copy). At W = 3 recursive doubling runs one-shot, as JAX's rule
    says."""
    stub = ReduceStub()
    monkeypatch.setattr(rs, "_lib", lambda: stub)
    group = create_rank_group(world, device="cpu")
    m, n = 2 * world, 24
    rng = np.random.RandomState(world)
    x = (torch.from_numpy(rng.randn(world, m, n).astype(np.float32))
         * 4.0 ** torch.arange(world)[:, None, None]).to(dtype)
    if op == "all_reduce":
        ctx = ar.create_allreduce_context(
            method=ar.AllReduceMethod(method), group=group)
        ran = ar.resolve_method(ctx, m, m * n * x.element_size())
        want = ar.all_reduce_world_reference(x, ran)

        def call():
            return ar.all_reduce(on_cuda(x), ctx, stacked=True)
        counter, shape = ar.all_reduce_launches, (world, m, n)
    else:
        ctx = rs.create_reduce_scatter_context(
            method=rs.ReduceScatterMethod(method), group=group)
        ran = ctx.resolve_method(m // world * n * x.element_size())
        want = rs.reduce_scatter_world_reference(x, ran)

        def call():
            return rs.reduce_scatter(on_cuda(x), ctx)
        counter, shape = rs.reduce_scatter_launches, (m, n)
    call()
    out = torch.full(shape, float("nan"), dtype=dtype)
    before = counter.total
    with OpLog() as log:
        got = call()
        into = rs.launch_reduce_world(on_cuda(x), ctx, op, ran.value,
                                      out=on_cuda(out))
    assert log.work() == []
    assert counter.total == before + 1
    epochs = [c["epoch"] for c in stub.calls]
    assert epochs == [epochs[0], epochs[0] + 1, epochs[0] + 2]
    kind = rs.KINDS[(op, ran.value)]
    assert {c["method"] for c in stub.calls} == \
        {kind - rs.KINDS[(op, "one_shot")]}
    ws, sig = rs.world_buffers(x, ctx.state, kind)
    for c in stub.calls:
        assert _addresses(c, "ws", world) == \
            symm_mem.rank_table(ws, world).tolist()
        assert _addresses(c, "sig", world) == \
            symm_mem.rank_table(sig, world).tolist()
    assert _addresses(stub.calls[-1], "out", world) == \
        symm_mem.rank_table(out, world).tolist()
    assert host(into).data_ptr() == out.data_ptr()
    copies = [got, into] if op == "reduce_scatter" else [*got, *into]
    assert all(torch.equal(bits(c), bits(want)) for c in copies)


class ShiftStub:
    """``csrc/p2p.cu``'s entries: rank r's block written into rank
    dst(r)'s output block through (out, out_step)."""

    def __init__(self):
        self.calls = []

    def tdt_shift_grid(self, chunk, world, grid, resident, piece, pieces):
        n = -(-chunk // (16 * 1024))
        return _put(grid=(grid, world * (n + 1)), resident=(resident, 1056),
                    piece=(piece, 16 * 1024), pieces=(pieces, n))

    def tdt_shift_world(self, x, out, out_step, sig, sig_step, chunk, world,
                        delta, epoch, fault, stream):
        self.calls.append(dict(out=out, out_step=out_step, sig=sig,
                               sig_step=sig_step, epoch=epoch))
        for r in range(world):
            dst = p2p.shift_partners(r, delta, world)[0]
            ctypes.memmove(out + dst * out_step, x + r * chunk, chunk)
        return 0

    def tdt_error_string(self, err):
        return b"stub"


DELTAS = {"1": lambda w: 1, "-1": lambda w: -1, "W+1": lambda w: w + 1,
          "-(W+2)": lambda w: -(w + 2)}


@pytest.mark.parametrize("delta", list(DELTAS))
@pytest.mark.parametrize("entry,dtype", [
    ("pp_shift", torch.bfloat16), ("pp_shift", torch.float32),
    ("symm_ship", torch.bfloat16), ("symm_ship", torch.float32),
    ("symm_ship", torch.uint8)])
@pytest.mark.parametrize("world", WORLDS)
def test_shift_call_queues_one_kernel(monkeypatch, no_stream, world, entry,
                                      dtype, delta):
    """``pp_shift`` / ``symm_ship`` at world W and a launch into a filled
    buffer queue the kernel alone; the output and signal rows go as (base,
    step) with ``rank_table``'s addresses, the signals made by the first
    call, and the stub's results written through them are bit-equal to
    the plain roll (a uint8 payload of W x 37 bytes: shards off 16-byte
    alignment)."""
    stub = ShiftStub()
    monkeypatch.setattr(p2p, "_lib", lambda: stub)
    d = DELTAS[delta](world)
    rng = np.random.RandomState(world)
    if dtype == torch.uint8:
        x = torch.from_numpy(rng.randint(0, 256, world * 37).astype(np.uint8))
    else:
        x = torch.from_numpy(rng.randn(4 * world, 40).astype(np.float32)
                             ).to(dtype)
    if entry == "pp_shift":
        ctx = p2p.create_p2p_context(create_rank_group(world, "pp",
                                                       device="cpu"))

        def call():
            return p2p.pp_shift(on_cuda(x), ctx, delta=d)
        counter = p2p.pp_shift_launches
    else:
        group = create_rank_group(world, "tp", device="cpu")

        def call():
            return ks.symm_ship(on_cuda(x), group, delta=d)
        counter = ks.symm_ship_launches
    call()
    if entry == "symm_ship":
        ctx = ks._ship_context(group)
    fill = 255 if dtype == torch.uint8 else float("nan")
    out = torch.full_like(x, fill)
    before = counter.total
    with OpLog() as log:
        got = call()
        into = p2p.launch_shift(on_cuda(x), ctx, d, counter,
                                out=on_cuda(out))
    assert log.work() == []
    assert counter.total == before + 2
    epochs = [c["epoch"] for c in stub.calls]
    assert epochs == [epochs[0], epochs[0] + 1, epochs[0] + 2]
    sig = ctx.state.signals("p2p", p2p.shift_grid(x, world).pieces)
    for c in stub.calls:
        assert _addresses(c, "sig", world) == \
            symm_mem.rank_table(sig, world).tolist()
    assert _addresses(stub.calls[-1], "out", world) == \
        symm_mem.rank_table(out, world).tolist()
    assert host(into).data_ptr() == out.data_ptr()
    want = p2p.pp_shift_reference(x, world, d)
    for t in (got, into):
        assert torch.equal(bits(t), bits(want))
