"""KV-block streaming helpers (the port of part of
``triton_dist_tpu.serving.kv_stream``).

A prefill replica ships the finished KV blocks of one admission to a
decode replica, keyed by the prefix cache's block-hash chain, shipping
only the suffix the receiver does not hold, each block with a sequence
number. This module holds the pieces of that transfer that the port has:

* the schedule helpers (JAX :80-105): :func:`needed_blocks`,
  :func:`ship_schedule` (the one spelling of the ship order) and
  :func:`block_span`;
* the payload codec (JAX :108-148): :func:`pack_block` writes one block's
  per-layer (k, v) pages as float32 bytes, layer-major, k before v (the
  same bytes as JAX's for equal values), and :func:`unpack_block` reads
  them back;
* the one-sided hop (JAX :172-211): :func:`symm_ship`, which launches the
  shift kernel of ``ops.p2p`` (``csrc/p2p.cu``, the port of JAX's
  ``_ship_kernel`` :151) on a CUDA tensor.

The wire tier (``KVStreamSender``), the receiver's staging table
(``HandoffStaging``) and their ``TDT_KVSTREAM_*`` knobs come with
disaggregated serving (ROADMAP.md, Queue A item 17); the port reads no
environment variable.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_dist_tpu_torch.ops.common import LaunchCount
from triton_dist_tpu_torch.ops.p2p import (
    P2PContext, create_p2p_context, launch_shift, pp_shift_reference)
from triton_dist_tpu_torch.runtime.dist import RankGroup

__all__ = ["block_span", "needed_blocks", "pack_block", "ship_schedule",
           "symm_ship", "symm_ship_launches", "unpack_block"]

#: Launches of the shift kernel through :func:`symm_ship`, by (W, rows, row
#: bytes).
symm_ship_launches = LaunchCount()


# -- schedule helpers --------------------------------------------------------
def needed_blocks(n_blocks: int, held_prefix: int) -> list:
    """Blocks the receiver still needs: the suffix past its locally-held
    hash-chain prefix, ``held_prefix`` clamped into [0, n_blocks]."""
    held = max(0, min(int(held_prefix), int(n_blocks)))
    return list(range(held, int(n_blocks)))


def ship_schedule(n_blocks: int, held_prefix: int) -> list:
    """``[(block_j, seq_s), ...]`` in ship order: the needed suffix,
    sequence-numbered from 0 with no gaps."""
    return [(j, s) for s, j in enumerate(needed_blocks(n_blocks,
                                                       held_prefix))]


def block_span(prompt_len: int, page_size: int) -> int:
    """Blocks covering one prompt's written positions [0, L):
    ``ceil(L / page)``."""
    return -(-int(prompt_len) // int(page_size))


# -- payload packing ---------------------------------------------------------
def pack_block(layers) -> bytes:
    """One block's per-layer (k, v) pages (tensors of any float dtype, on
    any device) as wire bytes: float32, layer-major, k before v. float32
    is lossless for the f32 and bf16 pool dtypes, so the bytes are a pure
    function of the block's content."""
    parts = []
    for k, v in layers:
        for t in (k, v):
            parts.append(t.detach().to(device="cpu", dtype=torch.float32)
                         .contiguous().numpy().tobytes())
    return b"".join(parts)


def unpack_block(data: bytes, num_layers: int, shape) -> list:
    """Inverse of :func:`pack_block`: ``[(k, v), ...]`` float32 CPU
    tensors of ``shape`` (page, Hkv, D) per layer. Raises ``ValueError``
    on a size mismatch (a torn or mis-framed payload must fail the
    handoff, never admit garbage K/V)."""
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape, dtype=np.int64))
    per = n * 4
    if len(data) != num_layers * 2 * per:
        raise ValueError(
            f"kv block payload is {len(data)} bytes, expected "
            f"{num_layers * 2 * per} ({num_layers} layers x 2 x "
            f"{shape} float32)")
    flat = torch.from_numpy(np.frombuffer(data, np.float32).copy())
    pages = flat.reshape(num_layers, 2, *shape)
    return [(pages[i, 0], pages[i, 1]) for i in range(num_layers)]


# -- the one-sided hop -------------------------------------------------------
_contexts: dict = {}


def _ship_context(group: RankGroup) -> P2PContext:
    """The ship hop's context over ``group``: its signals and call counter
    live as long as the process, as JAX's collective id 9 is one per
    mesh axis."""
    ctx = _contexts.get(group)
    if ctx is None:
        ctx = _contexts[group] = create_p2p_context(group, group.axis)
    return ctx


def symm_ship(x: torch.Tensor, group: RankGroup | None = None,
              delta: int = 1) -> torch.Tensor:
    """One-sided push of a staged block buffer one hop of ``delta`` along
    ``group``'s axis (JAX ``symm_ship`` :172).

    ``x`` is the staged payload, usually a uint8 tensor of the block's
    bytes; its leading dimension splits over the W ranks (``ValueError``
    otherwise), shard r being rank r's. At world 1 (``group`` None or of
    one rank) the hop is the identity and ``x`` itself is returned. At
    world W the result is JAX's: every rank pushes its shard to rank
    r + delta, so the W shards come back rotated by ``delta`` (a 64-byte
    payload at W = 4 returns as bytes [48..63, 0..15, 16..31, 32..47]),
    not the payload as it was. On a CUDA tensor it launches the shift
    kernel (``csrc/p2p.cu``, counted in :data:`symm_ship_launches`); on
    a CPU tensor it takes the plain roll."""
    if group is None or group.world == 1:
        return x
    world = group.world
    if x.dim() == 0 or x.shape[0] % world:
        raise ValueError(f"a payload of {tuple(x.shape)} does not split "
                         f"into {world} shards")
    if x.device.type == "cpu":
        return pp_shift_reference(x, world, delta)
    return launch_shift(x, _ship_context(group), delta, symm_ship_launches)
