"""What one call queues on the card, read off a CUDA graph captured from it.

:func:`queued_work` captures one ``fn()`` call into a CUDA graph (nothing
runs) and counts the graph's nodes by type through the driver API: every
kernel, copy and memset the call puts on the current stream. Unlike a
profiler session it loses nothing, so it is the proof that an entry
queues exactly its one kernel.
"""

from __future__ import annotations

import collections
import ctypes

import torch

#: ``CUgraphNodeType`` (cuda.h) by value.
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def _ok(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed with CUresult {err}")


def queued_work(fn) -> collections.Counter:
    """The nodes, by type name (:data:`NODE_TYPES`), of a CUDA graph
    captured from one ``fn()`` call on the current device. Let ``fn`` run
    once before, so that what its first call makes (contexts, signal
    buffers, built kernels) is made outside the capture. The graph is
    never launched; it is destroyed before the return."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    try:
        drv = ctypes.CDLL("libcuda.so.1")
        handle = ctypes.c_void_p(graph.raw_cuda_graph())
        count = ctypes.c_size_t(0)
        _ok(drv.cuGraphGetNodes(handle, None, ctypes.byref(count)),
            "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * max(count.value, 1))()
        _ok(drv.cuGraphGetNodes(handle, nodes, ctypes.byref(count)),
            "cuGraphGetNodes")
        kinds = collections.Counter()
        for node in nodes[:count.value]:
            kind = ctypes.c_int(-1)
            _ok(drv.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)),
                "cuGraphNodeGetType")
            kinds[NODE_TYPES.get(kind.value, str(kind.value))] += 1
        return kinds
    finally:
        graph.reset()
