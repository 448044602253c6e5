"""The collective cost model that picks an all-gather method (a copy of
``triton_dist_tpu/tools/perf_model.py:20-113``, as far as
``ops.allgather.get_auto_all_gather_method`` needs it).

``ChipSpec``, ``DMA_STARTUP_US``, ``ICI_HOP_LATENCY_US``,
:func:`estimate_all_gather_time_ms` and
:func:`estimate_full_mesh_push_time_ms` are JAX's formulas on plain
numbers. The JAX spec table describes TPU chips and their torus links;
the port runs every rank on one H100, so its one spec,
:data:`H100_ONE_CARD`, describes that card: the ranks exchange through
its HBM, and a "link" is a copy from HBM to HBM.

By these formulas the full-mesh push wins at every world <= 4 whatever
the bandwidth (at W = 4 the bidirectional ring costs 2n/bw + 6 us, the
push 1.5n/bw + 3 us), so the model path runs the push kernel; the ring
wins only at W >= 5 with large payloads.
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
