"""The collective cost model that picks the collectives' methods (a copy
of ``triton_dist_tpu/tools/perf_model.py:20-146``, as far as
``ops.allgather.get_auto_all_gather_method``,
``ops.allreduce.get_auto_allreduce_method`` and
``ops.reduce_scatter.ReduceScatterContext.resolve_method`` need it).

``ChipSpec``, ``DMA_STARTUP_US``, ``ICI_HOP_LATENCY_US``,
:func:`estimate_all_gather_time_ms`,
:func:`estimate_full_mesh_push_time_ms`,
:func:`estimate_reduce_scatter_time_ms`,
:func:`estimate_one_shot_reduce_time_ms` and
:func:`estimate_all_reduce_time_ms` are JAX's formulas on plain
numbers. The JAX spec table describes TPU chips and their torus links;
the port runs every rank on one H100, so its one spec,
:data:`H100_ONE_CARD`, describes that card: the ranks exchange through
its HBM, and a "link" is a copy from HBM to HBM.

By these formulas the full-mesh push wins at every world <= 4 whatever
the bandwidth (at W = 4 the bidirectional ring costs 2n/bw + 6 us, the
push 1.5n/bw + 3 us), so the model path runs the push kernel; the ring
wins only at W >= 5 with large payloads.

At W = 4 the ring reduce-scatter (4n / 3.35 TB/s + 6 us for n-byte
chunks) beats the one-shot (7n / 3.35 TB/s + 3 us) only above n = 3.35 MB,
and the two-shot all-reduce beats the one-shot only above about 6.0 MB
of buffer. So at Qwen3-8B's TP-world-4 shapes AUTO picks one-shot for
both: the decode all-reduce of 32 KB, the prefill all-reduce of 4 MB and
the prefill reduce-scatter's 1 MB chunk.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_tflops: float          # tensor-core peak, bf16
    hbm_gbps: float             # device memory bandwidth GB/s
    ici_gbps_per_link: float    # per-direction rate of one rank-to-rank link
    ici_links: int              # links per rank


#: One H100 SXM holding every rank (NVIDIA's data sheet: 989 TFLOP/s
#: dense bf16, 3,350 GB/s HBM3). Ranks on one card exchange by copies
#: within its HBM: each byte a copy moves is read once and written once,
#: so a rank-to-rank "link" moves at most half the HBM rate, 1,675 GB/s,
#: and all links share that one memory. Two links per rank: the two
#: directions of a one-dimensional axis, as JAX's model counts them.
H100_ONE_CARD = ChipSpec("h100-one-card", 989.0, 3350.0, 1675.0, 2)

# Fixed costs per copy and per step, JAX's constants: what makes small
# payloads latency-bound and large ones bandwidth-bound in the method
# choice. Not measured on the H100.
DMA_STARTUP_US = 2.0
ICI_HOP_LATENCY_US = 1.0


def _ring_time_s(nbytes_per_rank: int, world: int, link_gbps: float,
                 n_hops: int) -> float:
    return (nbytes_per_rank * n_hops) / (link_gbps * 1e9)


def estimate_all_gather_time_ms(nbytes_per_rank: int, world: int,
                                spec: ChipSpec | None = None,
                                bidir: bool = True) -> float:
    """Ring all-gather: W - 1 hops of the shard (ceil((W - 1) / 2) when
    bidirectional) plus per-step fixed costs."""
    spec = spec or H100_ONE_CARD
    if world <= 1:
        return 0.0
    hops = (world - 1 + 1) // 2 if bidir else world - 1
    bw = _ring_time_s(nbytes_per_rank, world, spec.ici_gbps_per_link, hops)
    fixed = hops * (DMA_STARTUP_US + ICI_HOP_LATENCY_US) * 1e-6
    return (bw + fixed) * 1e3


def estimate_full_mesh_push_time_ms(nbytes_per_rank: int, world: int,
                                    spec: ChipSpec | None = None) -> float:
    """Full-mesh push all-gather: all W - 1 pushes at once, each over a
    mean distance of max(W / 4, 1) hops on a ring of two links a rank."""
    spec = spec or H100_ONE_CARD
    if world <= 1:
        return 0.0
    avg_hops = max(world / 4.0, 1.0)
    bw = 2.0 * spec.ici_gbps_per_link
    t = nbytes_per_rank * (world - 1) * avg_hops / (bw * 1e9)
    fixed = (DMA_STARTUP_US + avg_hops * ICI_HOP_LATENCY_US) * 1e-6
    return (t + fixed) * 1e3


def estimate_reduce_scatter_time_ms(nbytes_per_rank: int, world: int,
                                    spec: ChipSpec | None = None,
                                    bidir: bool = True) -> float:
    """Ring reduce-scatter: the ring all-gather's mirror."""
    return estimate_all_gather_time_ms(nbytes_per_rank, world, spec, bidir)


def estimate_one_shot_reduce_time_ms(nbytes_per_chunk: int, world: int,
                                     spec: ChipSpec | None = None) -> float:
    """One-shot reduce-scatter or all-reduce: every rank pushes its
    contribution directly (the full-mesh push), then a local W-way sum
    bound by device memory."""
    spec = spec or H100_ONE_CARD
    if world <= 1:
        return 0.0
    push = estimate_full_mesh_push_time_ms(nbytes_per_chunk, world, spec)
    reduce_ms = world * nbytes_per_chunk / (spec.hbm_gbps * 1e9) * 1e3
    return push + reduce_ms


def estimate_all_reduce_time_ms(nbytes: int, world: int,
                                spec: ChipSpec | None = None,
                                method: str = "two_shot") -> float:
    """two_shot: a ring reduce-scatter and a ring all-gather of the
    1 / W chunks; one_shot: the whole buffer pushed, then summed."""
    if world <= 1:
        return 0.0
    if method == "one_shot":
        return estimate_one_shot_reduce_time_ms(nbytes, world, spec)
    per = nbytes // max(world, 1)
    return (estimate_all_gather_time_ms(per, world, spec)
            + estimate_reduce_scatter_time_ms(per, world, spec))
