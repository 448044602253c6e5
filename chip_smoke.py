#!/usr/bin/env python3
"""Drives the PyTorch port (``triton_dist_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each printed as it runs; any failure raises and exits non-zero
without the final line:

1. setup: the card's name and power limit (``nvidia-smi``), the kernel
   build from ``triton_dist_tpu_torch/csrc`` and its time, and the
   matmul precision settings (TF32 and reduced-precision bf16 reductions
   off, so the plain versions are exact references).
2. kernel: the ``gemm_ar`` kernel against its plain version
   ``gemm_ar_reference`` in bf16 and f32 over M in {1, 3, 8, 64} and
   (K, N) in {(4096, 4096), (12288, 4096), (100, 72)}, with the stated
   tolerance, and its time beside the bound and one ``torch.matmul``.
3. model: Qwen3-8B at full width and depth with random bf16 weights
   drawn on the card from the seed, served through ``Engine.serve``,
   ``serve_ragged`` and ``serve_stream`` (batch 4, max_seq 1024): the
   gemm_ar launch count must grow by 2 x 36 per decode step.
4. server: the port's ``ModelServer`` on 127.0.0.1, driven by the port's
   ``ChatClient``; each reply must equal ``Engine.serve_ragged`` on the
   same prompts.
5. logits: one decode step through the kernel against the same step
   through ``gemm_ar_reference``, within the stated tolerance; then that
   step's wall time beside its device time (the device's idle share).
6. kernels: one JSON line with each kernel's launches on its main path
   (gemm_ar: phases 3-4; flash decode: phase 8), error, time, plain time,
   bound and library time. Times (``ms``, ``plain_ms``, ``library_ms``)
   come from CUDA events around calls queued behind a GPU sleep
   (``queued_ms``; a plain version that reads back to the host includes
   that host time); ``wall_ms`` is the kernel's time per call when called
   back to back, host overhead included. The profiler (CUPTI) serves only
   step device time, idle shares and breakdowns; each of its sessions
   prints the share of the port's launches it recorded, and one that lost
   records is tried again (ROADMAP.md, Queue C item C6). ``--records`` runs only the check
   of those records on phase 5's decode step, in a fresh process.
7. flash-decode kernels: the split-KV ``partial`` (dense rows and pages
   through a block table), the fused ``tiled`` launch (the partial with
   its merge tail), ``combine`` and ``single`` against their plain
   versions at Qwen3-8B's decode shapes, kv_len 1, 17, 160, 1024 and
   ragged, bf16 and f32, with the stated tolerance (bf16: 2^-7 |out| +
   2^-8 sum_j (p_j / l)|v_j|, the weight rule of phases 14-15); repeats
   must give the same bits, paged and dense addressing of the same rows
   too, and the fused launch the bits of the standalone combine of the
   partials; a planted fault (one split left out of the merge, by the
   standalone combine and by the fused launch, at kv_len 160 and 1024)
   must fail that limit.
8. sp main path (flash decode's): Qwen3-8B served in mode "sp" by three
   engines, (a) paged (page 16), (b) contiguous with max_seq 1024 (the
   split kernel with its merge) and (c) contiguous with max_seq 512 (the
   single-pass kernel), 4 x 128-token prompts for 32 tokens each:
   flash-decode launches per decode step must be 36 (one a layer, the
   standalone combine never), gemm_ar launches 0,
   and (a) and (b) the same tokens; then 6 prompts sharing a 64-token
   prefix streamed through a 24-page pool (a'), with prefix hits and a
   clean block audit, and the server over (a) (uniform prompts -> serve,
   more prompts than rows -> serve_stream, ragged -> error reply).
9. sp checks: one paged decode step's logits through the kernels against
   the same step through the plain version; each engine's decode step wall
   vs device time (idle share); a prefix-hit admission's first-token
   logits against a cold admission of the same prompt.

10. AG-GEMM / AG-SwiGLU / GEMM-RS kernels (``csrc/ag_gemm.cu``) against
    their plain versions in bf16 at Qwen3-8B's shapes on the model's own
    weights: prefill M = 512 (QKV, n_b = 3; the fused SwiGLU 4096 ->
    12288; gemm_rs at the o_proj and down shapes) and decode M = 4 (QKV,
    gate|up with n_b = 2, down): error, bit-identical repeat, device ms,
    plain ms, one ``torch.matmul`` of the same product (for the SwiGLU, of
    the gate|up products without their epilogue) and the bound; at prefill
    the TFLOP/s, their share of the bf16 peak and the waves of the
    persistent grid (``tile_waves``: tiles over blocks, the last wave's
    idle share).
11. ag_rs main path: Qwen3-8B (default model mode "ag_rs") served by the
    reference engine (prefill "ag_rs", decode "gemm_ar") and the fused one
    (both "ag_rs") through serve, serve_stream (6 prompts of 65-128
    tokens, every admission bucket 128) and the server: per prefill 36
    ag_gemm, 36 ag_swiglu and 72 gemm_rs launches; per decode step 72
    ag_gemm + 72 gemm_rs (fused) or 72 gemm_ar (reference); the share of
    greedy tokens equal to phase 3's engine; then the prefill's
    last-position logits through the kernels against the plain versions
    (within 0.25), each engine's decode step wall vs device time and the
    ag_rs prefill's per-kernel breakdown (``device_breakdown``: lower
    bounds, shares not measured, when no profiler session recorded every
    port launch).

12. MoE kernels: Qwen3-30B-A3B (``presets.qwen3_30b_a3b()``, full width
    and depth, random bf16 weights drawn on the card from the seed) after
    every Qwen3-8B object is released (device memory printed); then the
    grouped-GEMM kernel (``csrc/group_gemm.cu``: gate|up with the plain
    epilogue, the SwiGLU epilogue, the down product), the MoE-reduce
    kernel (``csrc/moe_rs.cu``, rounded and f32 pairs) and the all-gather
    copy (``csrc/allgather.cu``) against their plain versions at decode (4
    tokens, 32 pairs) and prefill (512 tokens, 4096 pairs) shapes routed
    by layer 0's router: error, bit-identical repeat, device ms, plain
    ms, the bound and one ``torch._grouped_mm`` (``Tensor.copy_`` for the
    all-gather; for the MoE-reduce, the grouped product only); each
    grouped row carries its plan (path, rows a tile, columns an item).
13. MoE main path: the default (prefill xla_ar, decode gemm_ar), all-ag_rs
    and paged sp engines through serve, serve_ragged (not sp),
    serve_stream and the server, with launch counts per prefill and per
    decode step; the prefill and one decode step through the kernels
    against the plain versions with the routing held fixed (within
    ``MOE_LOGITS_ATOL``); free-running greedy agreement and flipped
    routing decisions (not gated); one MoE layer under
    ``torch.cuda.set_sync_debug_mode("error")``; each engine's decode step
    wall vs device time.

14. flash-prefill kernel (``csrc/sp_attention.cu``) against its plain
    version ``sp_attention_fused_reference`` (``KV_TILE``-wide KV tiles,
    128, as the bf16 kernel's) after every Qwen3-8B object is released,
    at Qwen3-8B's attention width (32 query heads, D = 128): bf16 and f32,
    causal and full, G = 4 and 8, S = 1000 (no multiple of the tiles), B =
    4 at S = 4096 and the full case B = 1, S = 32768; each within the port's
    tolerance (``sp_attention_tolerance``: bf16 2^-7 |out| + 2^-8 sum_j
    (p_j / l) |v_j| elementwise), a planted fault (the KV tile at S / 2
    zeroed for the kernel only) refused by that same limit, bit-identical
    on repeat, with its time, TFLOP/s and share of the peak beside the
    bound; the full case also with the plain version's time and one
    ``scaled_dot_product_attention(is_causal, enable_gqa)`` (and its
    TFLOP/s). These times come from CUDA events around back-to-back
    calls, not the profiler.
15. sp main path (this slice's), every count set to 0 just before it:
    ``SpAttentionLayer(impl="pallas")`` prefill of the 32k prompt (one
    kernel launch, equal to phase 14's output), ``SpFlashDecodeLayer``
    over a cache of 32768 + 32 positions filled by ``append``, then 32
    append-then-decode steps (one fused launch per step) each against
    ``flash_decode_reference`` (2^-7 |out| + 2^-8 sum_j (p_j / l) |v_j|); ``sp_ag_attention`` in xla, ulysses and
    ag_pallas (the all-gather kernel) equal to ring, and pallas within
    tolerance, at S = 4096; every all_reduce and reduce_scatter method
    and broadcast at (1, 4, 4096) and (1, 512, 4096) bf16 equal to their
    plain versions; then the flash-decode kernels at kv_len 32800 (the
    fused launch bit-equal to partial + standalone combine, its planted
    fault, one split left out, refused by the same limit) and the
    copy kernel under each collective are timed for the JSON line.

16. expert parallelism (this slice's main path), on phase 12's
    Qwen3-30B-A3B weights once phase 13's engines are released: the
    all-to-all kernel (``csrc/all_to_all.cu``) against
    ``fast_all_to_all_reference`` at W = 4 and 2 (and W = 8, which the
    model's 4 KV heads do not allow, at its hidden 2048), decode (batch 4)
    and prefill (4 x 128) slabs routed by layer 0's router, bf16 and the
    fp8 path's int8 wire: live rows bit-equal, dead-chunk NaN canaries
    intact, bit-identical on repeat, a planted fault (one slab's count
    lowered by a chunk for the kernel only) refused, with its time
    (queued CUDA events) beside the bound, the
    plain version and one ``Tensor.copy_`` of the transposed slabs. Then
    ``Qwen3MoE(moe_parallel="ep", world=4)`` over the same params (per-rank
    views, device memory printed before and after) served by
    ``Engine(prefill_mode="xla", decode_mode="xla")``, 4 x 128 prompts
    and 16 new tokens, every count set to 0 just before: 96 all-to-all
    launches (dispatch and combine, 48 layers) and 384 grouped-GEMM
    launches per prefill and per decode step; the prefill's last-position
    logits and one decode step's logits through the kernel bit-equal to
    the same forward with the plain exchange; one EP MoE layer under
    ``torch.cuda.set_sync_debug_mode("error")``; greedy agreement with
    phase 13's default engine (not gated); the decode step's and the
    prefill's wall and device time, the grouped GEMM's share and the
    dead-slot share of the slots it runs. Then mode "ep" (attention
    through the ring kernels of phase 17, the MoE through the all-to-all):
    one prefill and four decode steps, every count set to 0 just before,
    48 AG-GEMM ring, 48 GEMM-RS ring and 96 all-to-all launches each, the
    logits within 0.25 of mode "xla" with the routing held fixed (the ep
    run's routing replayed, as phase 13 holds it).

17. ring kernels (``csrc/ag_gemm_ring.cu``, ``csrc/gemm_rs_ring.cu``)
    against their plain ring versions, on Qwen3-8B's layer-0 weights:
    AG-GEMM (QKV, gate|up), AG-SwiGLU, GEMM-RS (o_proj, down) and GEMM-AR
    at prefill (M = 512) and decode (M = 4, gemm_ar padding where W does
    not divide it) shapes, W = 2, 3, 4, 8, ring_dirs 1 and 2, bf16 and
    f32 (smaller shapes), the o_proj at M = 1, 64 and 65 (W = 4), the AG
    decode QKV at W = 2, 8 and one direction, gate|up at W = 3 (M = 6),
    QKV at M = 68 and Qwen3-30B-A3B's QKV at decode: RS / AR of at most
    64 padded rows and bf16 AG-GEMM of at most 64 rows through the decode
    bodies ("stream"), the others through the tile (the body printed and
    checked), the products' NaN canaries too; AG within the GEMM limits
    (``gemm_error``, ``swiglu_error``), RS / AR within the ring's own
    rounding (W ulps of the sum of the partials' magnitudes, share
    printed), bit-identical on repeat, GEMM-AR's W per-rank buffers
    bit-equal, the workspaces' NaN canaries intact, a planted fault (AG:
    rank 0's first push skipped; RS / AR: the step-0 pushes of chunk 0;
    their signals still set) refused; the bf16 AG output checked
    bit-equal to the world-1 kernel on each rank's column shard (the
    decode body and the tensor-core tile); the W = 4 cases timed
    (queued CUDA events) beside the plain version, one ``torch.matmul`` of the
    global product, the world-1 kernel at the same global shape and the
    bound (the ring's copies counted as HBM traffic), at prefill the
    TFLOP/s, their share of the peak and a rank's waves; a decode body's
    ``exchange_ms`` is its time less the world-1 kernel's, which streams
    the same bytes of B once (printed,
    without a record, for the bf16 decode cases at the other worlds and
    shapes too, AG's with its bound and library time). Each record names
    the JAX
    variant that
    ``ring_plan`` picks for its shape.
18. TP main path: Qwen3-8B at W = 4, full width and depth, over the same
    params (per-rank views), served by three engines -- (xla_ar, gemm_ar)
    (JAX ``tdt-serve``'s default at world W), (ag_rs, gemm_ar) and (ag_rs,
    ag_rs) -- through serve (4 x 128, 16 new tokens), serve_stream and the
    server, every count set to 0 just before: per ag_rs prefill 36
    AG-GEMM, 36 AG-SwiGLU and 72 GEMM-RS ring launches, per decode step 72
    GEMM-AR (gemm_ar) or 72 AG-GEMM (each keyed "stream", the decode
    body) + 72 GEMM-RS (ag_rs) ring launches, no world-1 kernel; prefill and decode-step logits through the rings
    within 0.25 of the same world-4 model's plain modes (xla / xla_ar);
    one layer in each fused mode under sync debug "error"; greedy
    agreement with phase 3 (not gated); wall and device time, idle share
    and the device time by kernel of a decode step and a prefill.

19. sequence-world kernels: the world-W flash-decode exchange
    (``tdt_flash_decode_world``) at W = 2, 3, 4, 8, single / tiled dense /
    tiled paged, bf16 and f32, kv_len 1 (ranks past the first empty),
    ragged and full, within the weight rule of the plain world-W decode,
    the W rank outputs bit-equal, repeats bit-identical, a skipped push
    (its signal set) refused; the ring-KV prefill
    (``tdt_sp_ring_attention``) at W = 2, 4, 8 causal and W = 4 full and
    f32 at Qwen3-8B's attention width, within ``sp_attention_tolerance``
    of the plain world-W version, a skipped forward refused, its time and
    TFLOP/s beside the world-1 kernel's at the same global shape.
20. SP main path: Qwen3-8B (phase 3's params, full width and depth) as
    ``AutoLLM.build(cfg, sp_axis="sp", sp_world=4)``, served by a paged
    engine, a contiguous engine of 4096 positions (the tiled variant) and
    one of 1024 prefilled in chunks of 64 (the single-pass variant), a
    prefix-cache stream and the server, every count set to 0 just before:
    36 world-W launches per decode step, none of the world-1 decode
    kernels or of a prefill kernel; decode-step logits within 0.25 of the
    plain world-4 decode, argmax agreement, wall / device time and idle
    share; greedy agreement with phase 8 (not gated).
21. SP long context at W = 4: ``SpAttentionLayer(impl="pallas")`` over a
    group of 4 on phase 14's 32k inputs (one ring launch) and 32 append +
    decode steps through ``SpFlashDecodeLayer`` over the sequence-split
    cache (one world-W launch each), each against its plain world-4
    version; times beside the world-1 kernels' on the same inputs (the
    ring prefill's TFLOP/s and its time over the world-1 kernel's).

22. world-W all-gather kernels (``csrc/allgather.cu``:
    ``tdt_all_gather_world``, ``tdt_broadcast_world``), once phase 16's
    EP model is released: the full-mesh
    push, the ring and the bidirectional ring, and the broadcast from
    the first and the last rank, at W = 2, 3, 4, 8, bf16 and f32, at
    TPMoE's decode (4 x 2048) and prefill (512 x 2048) all-gathers
    (padded to a multiple of W as TPMoE pads them) and at 8192 x 4096:
    every rank's copy, written into NaN-filled buffers, bit-equal to the
    plain version, a repeat bit-identical, a push (or forward) skipped
    with its signal still set refused; the W = 4 bf16 cases timed
    (queued CUDA events) beside the plain version, one
    ``Tensor.copy_`` of the same bytes and the bound.
23. TP MoE main path: ``Qwen3MoE(moe_parallel="tp", world=4)``
    (``AutoLLM.build(cfg, world=4)``) over phase 12's params (per-rank
    views), served by the default engine (prefill xla_ar, decode gemm_ar)
    and the fused one (ag_rs both) through serve (4 x 128 prompts, 16 new
    tokens) and the server, every count set to 0 just before: per
    prefill and decode step 48 all-gather launches in MoE mode ag_rs
    (none in the default prefill), 192 grouped-GEMM and 192 MoE-reduce
    launches (one a rank a layer) and attention's rings, no world-1
    kernel; the server's replies equal to ``Engine.serve``; prefill and
    decode-step logits through the kernels within MOE_LOGITS_ATOL of the
    plain world-4 path with the routing held fixed; greedy agreement with
    phase 13 (not gated); one TPMoE layer under sync debug "error"; wall
    and device time, idle share and the all-gather's share of a decode
    step in each mode and of a prefill.
24. world-W ring AG + grouped GEMM (``csrc/ag_group_gemm.cu``,
    ``ag_group_gemm(impl="fused")``) on phase 12's weights, with layer
    0's routing of phase 23's served batch (decode: 4 tokens x top-8 =
    32 rows; prefill: 4 x 128 x 8 = 4096 rows): (a) at W = 2, 3, 4, 8,
    bf16 and f32, on layer 0's w_gate (96-wide shards at W = 8),
    bit-equal to impls "xla" and "ring", within the grouped GEMM's limit
    of the plain version, repeats bit-identical, workspace canaries
    intact, a skipped push refused, and with a quarter of the ids set to
    the sentinel the valid rows within the limit; (c) the W = 4 bf16
    cases timed by CUDA events around calls queued behind a GPU sleep
    beside the bound, the
    plain version, impl "xla", the world-1 kernel at the same global
    shape and one ``torch._grouped_mm`` of the gathered, expert-sorted
    rows against the full weights, with the workspace bytes; (b) the main path, every count set to 0 just before:
    ``ag_group_gemm(impl="fused")`` at TP world 4 on layer 0's gate and
    up weights at both shapes, one ring call (a schedule and a
    cooperative launch) each and no other kernel's launch, each output
    bit-equal to impls "xla" and "ring".
25. world-W fused MoE down projection + top-k reduce + ring reduce-scatter
    (``csrc/moe_rs_ring.cu``, ``moe_reduce_rs(impl="fused")``) on phase
    12's layer-0 w_down with layer 0's routing of phase 23's served batch
    (decode: 4 tokens x top-8 = 32 pairs; prefill: 512 x 8 = 4096):
    (a) at W = 2, 3, 4, 8 (W = 3: tokens padded with sentinel ids), bf16
    and f32, within the MoE-reduce rule with W roundings
    (``mrr_error``) of ``moe_reduce_rs_fused_world_reference``, repeats
    bit-identical, canaries intact, a skipped push refused by that limit;
    the W = 4 bf16 cases timed beside the bound, impl "ring", the world-1
    kernel at the same global shape, one ``torch._grouped_mm`` of the
    sorted pairs (the grouped product only) and the plain version;
    (b) the main path, every count set to 0 just before: the expert half
    of one TPMoE layer at W = 4 on layer 0's served MoE inputs, gate and
    up through ``ag_group_gemm(impl="fused")``, the SwiGLU, the down
    projection through ``moe_reduce_rs(impl="fused")``: 2 + 2 ring AG +
    grouped GEMM calls and 1 + 1 MoE-reduce ring calls, no world-1
    grouped-GEMM or MoE-reduce and no all-gather launch, each output
    within the stated limit of ``TPMoE(world=4)``'s own forward.
26. world-W reduce-scatter and all-reduce (``csrc/reduce_world.cu``),
    while Qwen3-8B's weights are loaded: (a) ``all_reduce`` (one_shot,
    two_shot, recursive_doubling) and ``reduce_scatter`` (ring, one_shot)
    at W = 2, 3, 4, 8, bf16 and f32, hidden 4096, decode (4 rows; 6 at
    W = 3, 8 at W = 8) and prefill (512 rows; 513 at W = 3) partials,
    bit-equal to the plain versions (which round after every add, in
    each method's order, as JAX's kernels do), every all-reduce copy
    bit-equal, repeats and a straggling rank bit-identical, workspace
    canaries intact, a skipped push refused; the W = 4 bf16 cases timed
    beside the bound, one ``torch.sum(x, 0)``, impl "xla", the plain
    version and the world-1 copy. (b) the main path, every count set to
    0 just before: layer 0's MLP down-projection partials of the served
    prompts at TP world 4 (decode and prefill) through ``all_reduce`` in
    each method and ``reduce_scatter`` in both, one world-W launch a call,
    no copy-kernel launch, each output within W bf16 ulps of the
    partials' magnitudes of ``group.psum``.
27. the pipeline shift and the KV ship hop (``csrc/p2p.cu``), while
    Qwen3-8B's weights are loaded: (a) ``pp_shift(impl="pallas")`` and
    ``symm_ship`` at W = 2, 3, 4, 8 and delta in {1, -1, W + 1,
    -(W + 2)}, on the decode hop (W x 4, 4096) and the prefill hop
    (W x 512, 4096) in bf16 and f32, one Qwen3-8B KV block as bytes
    (4,718,592) and a W x 37-byte payload: both entries, a launch into a
    NaN- (0xFF-) filled buffer and a repeat bit-equal to the plain roll, a
    skipped piece (its signal still set) refused; the W = 4 cases timed
    beside the bound (2 W C bytes), one ``torch.roll(x.view(W, -1), 1,
    0)`` and the plain version. (b) the main path, every count set to 0
    just before: Qwen3-8B as a 4-stage pipeline,
    ``pipeline_forward(impl="pallas")`` over ``RankGroup(4, "pp")``,
    stage s running layers 9s..9s+8 through ``DenseLLM.decoder_layer``
    in mode ag_rs with fresh caches, on phase 3's 4 x 128 prompts: 4
    shift launches, logits bit-equal to ``DenseLLM.forward``'s prefill,
    wall time beside the sequential prefill's (not gated); ``CommOp``
    sends the decode rows once (one launch, bit-equal). (c) a paged sp
    engine serves one prompt (8 blocks of 16); each block packed from its
    pools (``pack_block``), shipped by +1 (JAX's rotation of the W
    shards) and back by -1 through ``symm_ship`` over ``RankGroup(4,
    "tp")``: 16 launches, the bytes and ``unpack_block``'s pages equal to
    the pool's.

Phases 7-15 run between phases 5 and 6 (14-15 after the Qwen3-8B
release, before the Qwen3-30B-A3B load), phases 17-20, 26 and 27 after
phase 11 (before that release; 26 right after 18, 27 right after 26),
phase 21 after phase 15, phase 16 after phase 13, phases 22-25 after
phase 16; the JSON line covers all thirteen slices.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card
the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12,      # dense tensor-core bf16
              "f32": 67e12}        # f32 outside the tensor cores
#: |kernel - plain| limits. bf16: one bf16 ulp of the larger of the two
#: (both sum in f32 in different orders, then round once). f32: outputs
#: of unit scale summed over K <= 12288 terms in another order.
BF16_ULP_REL = 2.0 ** -7
F32_ATOL = 3e-5
#: One decode step's logits, kernel path vs plain path, after 36 bf16
#: layers: a one-ulp difference in a few gemm_ar outputs moves every
#: later bf16 rounding; logits have std ~1.3 at these init scales.
LOGITS_ATOL = 0.25
GEN = 32
#: Kernels a port wrapper launches beside its one main kernel (the expert
#: schedule, the top-k reduce, the split-K reduce); every call that a
#: wrapper counts in its ``LaunchCount`` launches exactly one main kernel.
PORT_HELPER_KERNELS = ("group_schedule", "topk_reduce_rows", "splitk_reduce")
#: Profiler sessions a step reading tries: CUPTI drops kernel records now
#: and then, more often the more records a session holds (ROADMAP.md,
#: Queue C item C6), so a session that recorded fewer of the port's
#: launches than its wrappers counted is printed and tried again.
PROFILER_SESSIONS = 8


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def port_kernel_names() -> tuple:
    """The port's main kernels: every ``__global__`` function of
    ``triton_dist_tpu_torch/csrc`` but :data:`PORT_HELPER_KERNELS`."""
    import pathlib
    import re
    csrc = pathlib.Path(__file__).resolve().parent / \
        "triton_dist_tpu_torch" / "csrc"
    names = set()
    for src in csrc.glob("*.cu*"):
        text = src.read_text()
        for m in re.finditer(r"__global__", text):
            for w in re.finditer(r"(\w+)\s*\(", text[m.end():m.end() + 300]):
                if w.group(1) not in ("__launch_bounds__", "sizeof"):
                    names.add(w.group(1))
                    break
    return tuple(sorted(names - set(PORT_HELPER_KERNELS)))


def port_launches() -> int:
    """Calls counted so far by every ``LaunchCount`` of the port's ops."""
    import importlib
    import pkgutil
    from triton_dist_tpu_torch import ops
    from triton_dist_tpu_torch.ops.common import LaunchCount
    total = 0
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for value in vars(mod).values():
            counts = value.values() if isinstance(value, dict) else [value]
            total += sum(c.total for c in counts
                         if isinstance(c, LaunchCount))
    return total


def port_pattern():
    """A regular expression that finds a kernel record of one of the
    port's main kernels (:func:`port_kernel_names`)."""
    import re
    return re.compile(r"\b(" + "|".join(port_kernel_names()) + r")\b")


def port_session(torch, fn, n: int, tail=None):
    """One profiler (CUPTI) session over ``n`` ``fn()`` calls after a
    warm-up, then ``tail()`` once if given: (the kernel rows of
    ``key_averages()``, records of the port's main kernels, calls its
    wrappers counted meanwhile)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    pattern = port_pattern()
    before = port_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        if tail is not None:
            tail()
        torch.cuda.synchronize()
    counted = port_launches() - before
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    recorded = sum(e.count for e in events if pattern.search(e.key))
    return events, recorded, counted


def profiled_rows(torch, fn, n: int = 3, what: str = "") -> tuple:
    """([(kernel name, ms per call)] of one ``fn()`` call from a profiler
    session (:func:`port_session`), whether that session recorded every
    port launch), for step device time, idle share and breakdowns (single
    kernels time by :func:`queued_ms`). Each session prints the share of
    the port's launches it recorded: records of its main kernels
    (:func:`port_kernel_names`) over the calls its wrappers counted. A
    session below 1.0 lost records, and another is tried, up to
    :data:`PROFILER_SESSIONS`; if none records them all, the last one's
    rows are returned and its figures are lower bounds (printed so)."""
    label = f" ({what})" if what else ""
    for attempt in range(1, PROFILER_SESSIONS + 1):
        events, recorded, counted = port_session(torch, fn, n)
        share = recorded / counted if counted else 1.0
        complete = share >= 1.0
        print(f"profiler session{label} {attempt}: {recorded} of {counted} "
              f"port launches recorded (share {share:.4f}), "
              f"{sum(e.count for e in events)} kernel records in all"
              + ("" if complete or attempt < PROFILER_SESSIONS else
                 "; no session recorded them all: its figures are lower "
                 "bounds"), flush=True)
        if complete:
            break
    return ([(e.key, e.self_device_time_total / n / 1e3) for e in events],
            complete)


def device_ms(torch, fn, n: int = 3, what: str = "") -> tuple:
    """(device ms of one ``fn()`` call (a decode step, a prefill): the GPU
    time of every kernel it launches, summed by :func:`profiled_rows`;
    the prefixes of that time and of an idle share taken from it:
    ``bound_marks``). Host overhead between launches is not in it."""
    rows, whole = profiled_rows(torch, fn, n, what)
    return (sum(ms for _, ms in rows), *bound_marks(whole))


def bound_marks(whole: bool) -> tuple:
    """("", "") when the profiler session recorded every port launch, else
    (">= ", "<= "): the device time it gives is then a lower bound and an
    idle share from it an upper bound (ROADMAP.md, Queue C item C6)."""
    return ("", "") if whole else (">= ", "<= ")


def device_breakdown(torch, fn, label: str, n: int = 3,
                     top: int = 8) -> list:
    """Lines of the ``top`` kernels of one ``fn()`` call by device time
    (kernel name cut to 70 characters, ms per call, share of the call's
    device time), from :func:`profiled_rows`. When no session recorded
    every port launch the times are lower bounds (``bound_marks``) and the
    shares not measured (ROADMAP.md, Queue C item C6)."""
    rows, whole = profiled_rows(torch, fn, n, f"{label} breakdown")
    total = sum(ms for _, ms in rows)
    ge = bound_marks(whole)[0]
    rows.sort(key=lambda r: -r[1])
    return [f"  {label} device time: {ge}{ms:.3f} ms ("
            + (f"{ms / total:.2f}" if whole and total else "share not measured")
            + f") {k[:70]}" for k, ms in rows[:top]]


def kernels_a_call(torch, fn, what: str, n: int = 20,
                   pad: int = 64) -> tuple:
    """(what one ``fn()`` call queues: the node types of a CUDA graph
    captured from it, e.g. ``{"kernel": 1}``
    (``triton_dist_tpu_torch.tools.queued.queued_work``, which loses
    nothing); kernel records a call and the names recorded, from a
    profiler session (:func:`port_session`) of ``n`` calls, ``fn``
    launching one port kernel a call, or (None, []) when no session
    recorded every port launch; device ms of one port kernel launch from
    that session, the kernel alone without the launch gaps of
    :func:`queued_ms`, or None likewise). ``pad`` short GPU sleeps
    (``torch.cuda._sleep``, whose ``spin_kernel`` no port entry queues)
    follow the calls: sessions drop their last records (on the card, 24 of
    84 in every one of eight tries), and the pad takes that loss. A
    session that recorded fewer port kernel records than the calls counted
    is printed and tried again, up to :data:`PROFILER_SESSIONS` times;
    late in a long process every session may record nothing (ROADMAP.md,
    C6), and then the profiler's figures are not measured, and later
    calls try two sessions only."""
    from triton_dist_tpu_torch.tools.queued import queued_work

    def tail():
        for _ in range(pad):
            torch.cuda._sleep(1000)

    fn()
    nodes = dict(queued_work(fn))
    tries = 2 if kernels_a_call.lost else PROFILER_SESSIONS
    for attempt in range(1, tries + 1):
        events, recorded, counted = port_session(torch, fn, n, tail)
        if counted and recorded >= counted:
            break
        print(f"profiler session ({what}, {n} calls) {attempt}: {recorded} "
              f"of {counted} port launches recorded", flush=True)
    else:
        print(f"profiler ({what}): no session recorded every port launch; "
              f"kernel records a call and the kernel alone not measured "
              f"(C6)", flush=True)
        kernels_a_call.lost = True
        return nodes, None, [], None
    seen = [e for e in events if "spin_kernel" not in e.key]
    pattern = port_pattern()
    ours = [e for e in seen if pattern.search(e.key)]
    return (nodes, sum(e.count for e in seen) / counted,
            sorted({e.key[:60] for e in seen}),
            sum(e.self_device_time_total for e in ours) / recorded / 1e3)


kernels_a_call.lost = False


def one_kernel(nodes: dict, seen) -> bool:
    """Whether :func:`kernels_a_call` shows one kernel queued and nothing
    else: the captured graph holds one kernel node and no other, and the
    profiler, where it recorded the calls, saw one kernel a call."""
    return nodes == {"kernel": 1} and seen in (None, 1.0)


def queued_kernels(torch, fn, what: str, strict: bool) -> dict:
    """The node types one ``fn()`` call queues (a CUDA graph captured from
    it, ``tools/queued.py``'s ``queued_work``, after one warm-up call).
    ``strict``: fail unless that is one kernel and nothing else (the
    decode products since the cluster body: no split reduce, no memset)."""
    from triton_dist_tpu_torch.tools.queued import queued_work
    fn()
    nodes = dict(queued_work(fn))
    if strict:
        check(nodes == {"kernel": 1},
              f"{what}: a call queues {nodes}, not one kernel")
    return nodes


def decode_plan_text(ag, m: int, widths, k: int, dtype, sms: int) -> str:
    """The decode plan of (m, k) x widths (``allgather_gemm.stream_plan``,
    the mirror of the C plans): body, items, K splits (one cluster on the
    tensor cores), K rows a split, blocks over the SMs, workspace."""
    p = ag.stream_plan(m, widths, k, dtype, sms)
    return (f"{'stream_tc' if p.tensor_cores else 'fma'} {p.tiles} tiles x "
            f"{p.splits} splits of {p.k_per_split} K = "
            f"{p.tiles * p.splits} blocks on {sms} SMs, workspace "
            f"{p.workspace} f32")


def fmt_ms(ms) -> str:
    """``ms`` to five places, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.5f}"


def queued_ms(torch, fn, n: int = 20, may_wait: bool = False) -> float:
    """Device ms of one ``fn()`` call, by CUDA events around ``n`` calls
    queued behind a GPU sleep, after a warm-up: the host enqueues the
    calls while the card sleeps, so the events time their kernels back to
    back on the card (launch gaps on the card included, host time not).
    Every single kernel, op, library call and plain version is timed here
    (the profiler drops kernel records now and then: ROADMAP.md, Queue C
    item C6). The sleep doubles, up to six tries, until it outlasts the
    enqueue. A
    call that waits on the card (a plain version that reads counts back
    to the host, or ``n`` calls whose launches overflow the card's launch
    queue) never fits: it fails, or with ``may_wait`` the same
    events time the calls back to back, the host's time between the
    waits included."""
    fn()
    torch.cuda.synchronize()
    cycles = 40_000_000                          # ~20 ms at ~2 GHz
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        ev[1].record()
        for _ in range(n):
            fn()
        ev[2].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if may_wait or host_ms < 0.8 * ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / n
        cycles *= 2
    raise SmokeFailure(f"{n} calls took longer to enqueue ({host_ms:.1f} ms)"
                       f" than the GPU sleep ahead of them")


def wall_ms(torch, fn, n: int = 20) -> float:
    """Mean ms per call of ``n`` back-to-back calls, by CUDA events, after
    one warm-up: device time plus whatever host overhead the calls do not
    hide."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(m: int, k: int, n: int, itemsize: int, kind: str):
    """(least ms, what bounds it): each operand read once, the output
    written once, over HBM; 2*M*N*K operations over the type's peak."""
    by_bytes = (m * k + k * n + m * n) * itemsize / HBM_BYTES_PER_S * 1e3
    by_ops = 2.0 * m * n * k / PEAK_FLOPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def kernel_error(torch, got, ref) -> tuple[float, bool]:
    """(max |got - ref|, within tolerance)."""
    diff = (got.float() - ref.float()).abs()
    if got.dtype == torch.bfloat16:
        lim = BF16_ULP_REL * torch.maximum(got.float().abs(),
                                           ref.float().abs()) + 1e-6
    else:
        lim = torch.full_like(diff, F32_ATOL)
    return diff.max().item(), bool((diff <= lim).all())


def rotating(bs: list):
    """Cycle through distinct weight tensors so repeated launches find B
    cold in L2, as a decode step does (other layers' weights pass in
    between)."""
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(bs)
        return bs[state["i"]]
    return nxt


def phase_kernel(torch, ops, card: str) -> None:
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    print("== phase 2: gemm_ar kernel vs gemm_ar_reference", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for k, n in ((4096, 4096), (12288, 4096), (100, 72)):
            size = k * n * dtype.itemsize
            copies = max(2, -(-256 * 2 ** 20 // size))
            bs = [(torch.randn((k, n), generator=gen, device="cuda")
                   * k ** -0.5).to(dtype) for _ in range(copies)]
            for m in (1, 3, 8, 64):
                a = torch.randn((m, k), generator=gen,
                                device="cuda").to(dtype)
                got = ops.gemm_ar(a, bs[0])
                again = ops.gemm_ar(a, bs[0])
                torch.cuda.synchronize()
                ref = ops.gemm_ar_reference(a, bs[0])
                err, ok = kernel_error(torch, got, ref)
                check(ok, f"gemm_ar {kind} M={m} K={k} N={n}: max abs err "
                          f"{err} outside tolerance")
                check(torch.equal(got, again),
                      f"gemm_ar {kind} M={m} K={k} N={n}: not deterministic")
                nb = rotating(bs)
                k_ms = queued_ms(torch, lambda: ops.gemm_ar(a, nb()))
                k_wall = wall_ms(torch, lambda: ops.gemm_ar(a, nb()))
                bf = [b.to(torch.bfloat16) for b in bs] \
                    if dtype != torch.bfloat16 else bs
                ab = a.to(torch.bfloat16)
                nl = rotating(bf)
                lib_ms = queued_ms(torch, lambda: torch.matmul(ab, nl()))
                tc = ops.plan(m, n, k, dtype, sms).tensor_cores
                nodes = queued_kernels(
                    torch, lambda: ops.gemm_ar(a, bs[0]),
                    f"gemm_ar {kind} M={m} K={k} N={n}", tc)
                bnd, by = bound_ms(m, k, n, dtype.itemsize, kind)
                tol = ("1 bf16 ulp" if dtype == torch.bfloat16
                       else f"{F32_ATOL:g} abs")
                print(f"kernel gemm_ar {kind} M={m} K={k} N={n} "
                      f"({decode_plan_text(ag, m, (n,), k, dtype, sms)}; "
                      f"a call queues {nodes}): "
                      f"max_abs_err={err:.3g} (tol {tol}) ok "
                      f"kernel_ms={k_ms:.4f} (wall {k_wall:.4f}) "
                      f"library_ms={lib_ms:.4f} "
                      f"bound_ms={bnd:.4f} ({by}) [{card}]", flush=True)
            del bs


def sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_model(torch, models, ops, card: str, seed: int):
    print("== phase 3: Qwen3-8B served through the port", flush=True)
    cfg = models.presets.qwen3_8b()
    model = models.DenseLLM(cfg)
    (params, init_ms) = sync_time(torch, lambda: model.init(seed))
    n_params = models.presets.param_count(cfg)
    print(f"model qwen3_8b: {cfg.num_hidden_layers} layers hidden "
          f"{cfg.hidden_size} heads {cfg.num_attention_heads}/"
          f"{cfg.num_key_value_heads} head_dim {cfg.head_dim} inter "
          f"{cfg.intermediate_size} vocab {cfg.vocab_size}; ~{n_params/1e9:.2f}B"
          f" params drawn in {init_ms:.0f} ms; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
    eng = models.Engine(model, batch=4, max_seq=1024)
    host = torch.Generator().manual_seed(seed)

    def prompts(lengths):
        return [torch.randint(0, cfg.vocab_size, (n,),
                              generator=host).tolist() for n in lengths]

    square = prompts([128] * 4)
    eng.serve(params, square, 2)      # warm-up: cuBLAS handles, allocator
    per_step = 2 * cfg.num_hidden_layers

    ops.launches.reset()              # ---- the main path starts here
    _, prefill_ms = sync_time(torch, lambda: eng.serve(params, square, 1))
    check(ops.launches.total == 0, "prefill launched gemm_ar")
    out, serve_ms = sync_time(torch, lambda: eng.serve(params, square, GEN))
    check(tuple(out.shape) == (4, 128 + GEN), f"serve shape {out.shape}")
    steps = GEN - 1
    check(ops.launches.total == per_step * steps,
          f"serve: {ops.launches.total} gemm_ar launches, expected "
          f"{per_step} x {steps}")
    decode_ms = serve_ms - prefill_ms
    print(f"model serve: batch 4 x 128 prompt, {GEN} new tokens: "
          f"prefill_ms={prefill_ms:.1f} decode_ms={decode_ms:.1f} "
          f"per_step_ms={decode_ms / steps:.2f} "
          f"decode_tokens_per_s={4 * steps / decode_ms * 1e3:.1f} "
          f"gemm_ar launches {ops.launches.total} = {per_step} x {steps} "
          f"[{card}]", flush=True)

    mixed = prompts([128, 77, 33, 101])
    before = ops.launches.total
    rows, ragged_ms = sync_time(
        torch, lambda: eng.serve_ragged(params, mixed, 16))
    check([len(r) for r in rows] == [len(p) + 16 for p in mixed],
          "serve_ragged row lengths")
    check(all(r[:len(p)].tolist() == p for r, p in zip(rows, mixed)),
          "serve_ragged lost the prompts")
    check(ops.launches.total - before == per_step * 15,
          "serve_ragged gemm_ar launches")
    print(f"model serve_ragged: lengths {[len(p) for p in mixed]}, 16 new "
          f"tokens in {ragged_ms:.1f} ms; gemm_ar launches "
          f"{ops.launches.total - before} [{card}]", flush=True)

    stream = prompts([20, 128, 64, 9, 100, 45])
    before = ops.launches.total
    res, stream_ms = sync_time(
        torch, lambda: eng.serve_stream(params, stream, 16))
    check([len(r) for r in res] == [len(p) + 16 for p in stream],
          "serve_stream row lengths")
    launched = ops.launches.total - before
    check(launched > 0 and launched % per_step == 0,
          f"serve_stream gemm_ar launches {launched}")
    print(f"model serve_stream: 6 prompts through 4 rows, 16 new tokens "
          f"in {stream_ms:.1f} ms; decode steps {launched // per_step}, "
          f"gemm_ar launches {launched} [{card}]", flush=True)
    for t in [out] + rows + [torch.tensor(r) for r in res]:
        check(bool(((t >= 0) & (t < cfg.vocab_size)).all()),
              "token out of vocabulary")
    return cfg, model, params, eng, prompts, (square, out)


def phase_server(torch, eng, params, prompts, card: str) -> None:
    print("== phase 4: ModelServer + ChatClient", flush=True)
    from triton_dist_tpu_torch.serving.client import ChatClient
    from triton_dist_tpu_torch.serving.server import ModelServer
    srv = ModelServer(eng, params, host="127.0.0.1", port=0).start()
    try:
        with ChatClient(srv.host, srv.port, timeout=600) as client:
            for batch, gen in ((prompts([64, 64]), 8),
                               (prompts([50, 90, 17]), 8),
                               (prompts([128]), 16)):
                t0 = time.perf_counter()
                reply = client.generate_ids(batch, gen)
                ms = (time.perf_counter() - t0) * 1e3
                check("tokens" in reply, f"server error: {reply}")
                want = [r[len(p):].tolist() for r, p in
                        zip(eng.serve_ragged(params, batch, gen), batch)]
                check(reply["tokens"] == want,
                      f"server reply differs from serve_ragged: "
                      f"{reply['tokens']} vs {want}")
                print(f"server: {len(batch)} prompts of lengths "
                      f"{[len(p) for p in batch]} -> {gen} tokens each, "
                      f"equal to serve_ragged; {ms:.1f} ms round trip "
                      f"[{card}]", flush=True)
    finally:
        srv.stop()


def phase_logits(torch, ops, model, params, prompts, cfg,
                 card: str) -> None:
    print("== phase 5: decode logits, kernel vs plain", flush=True)
    from triton_dist_tpu_torch.layers import tp_attn
    from triton_dist_tpu_torch.models import KVCacheManager
    ids = torch.tensor(prompts([128] * 4), device="cuda")
    kv = KVCacheManager(cfg.num_hidden_layers, 4, 1024,
                        cfg.num_key_value_heads, cfg.head_dim,
                        dtype=cfg.dtype, device="cuda")
    caches = kv.init()
    with torch.no_grad():
        logits, caches = model.forward(params, ids, caches, 0,
                                       mode="xla_ar")
        tok = logits[:, -1].argmax(-1)[:, None]
        # Each run writes position 128 before reading it, so the two runs
        # see the same cache.
        got, _ = model.forward(params, tok, caches, 128, mode="gemm_ar")
        # The same step with the plain version patched in at the one call
        # site that attention and the MLP share.
        tp_attn.gemm_ar = ops.gemm_ar_reference
        try:
            ref, _ = model.forward(params, tok, caches, 128, mode="gemm_ar")
        finally:
            tp_attn.gemm_ar = ops.gemm_ar
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    same = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    check(err <= LOGITS_ATOL, f"decode logits differ by {err} "
                              f"(tol {LOGITS_ATOL})")
    print(f"logits: decode step kernel vs gemm_ar_reference max abs diff "
          f"{err:.4g} (tol {LOGITS_ATOL}), max |logit| {scale:.3g}, argmax "
          f"agreement {same:.2f}", flush=True)

    def step():
        with torch.no_grad():
            model.forward(params, tok, caches, 128, mode="gemm_ar")
    walls = [sync_time(torch, step)[1] for _ in range(5)]
    wall = sorted(walls)[2]
    dev, ge, le = device_ms(torch, step, n=3)
    print(f"decode step (batch 4, max_seq 1024, forward only): wall "
          f"{wall:.2f} ms (median of 5), device {ge}{dev:.2f} ms, device "
          f"idle share {le}{1 - dev / wall:.2f} [{card}]", flush=True)


def phase_kernels_line(torch, ops, params, cfg, main_launches) -> list:
    """The JSON kernel records at the main path's shapes: M = 4 rows of
    activations against the model's own o_proj and down weights (all 36
    layers in turn, so B is cold in L2)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = []
    for name, key, line in (("gemm_ar[o_proj]", ("attn", "w_o"), 249),
                            ("gemm_ar[down]", ("mlp", "w_down"), 353)):
        ws = [lp[key[0]][key[1]] for lp in params["layers"]]
        k, n = ws[0].shape
        a = torch.randn((4, k), generator=gen, device="cuda",
                        dtype=cfg.dtype)
        err, ok = kernel_error(torch, ops.gemm_ar(a, ws[0]),
                               ops.gemm_ar_reference(a, ws[0]))
        check(ok, f"{name}: max abs err {err} outside tolerance")
        nk, np_, nl = rotating(ws), rotating(ws), rotating(ws)
        ms = queued_ms(torch, lambda: ops.gemm_ar(a, nk()))
        wall = wall_ms(torch, lambda: ops.gemm_ar(a, nk()))
        plain = queued_ms(torch, lambda: ops.gemm_ar_reference(a, np_()),
                          may_wait=True)
        lib = queued_ms(torch, lambda: torch.matmul(a, nl()))
        bnd, by = bound_ms(4, k, n, 2, "bf16")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        nodes, seen, names, alone = kernels_a_call(
            torch, lambda: ops.gemm_ar(a, nk()), name)
        check(one_kernel(nodes, seen),
              f"{name}: a call queues {nodes} ({seen} kernel records a call"
              f" in the profiler: {names}), not one kernel")
        from triton_dist_tpu_torch.ops import allgather_gemm as ag
        print(f"kernel {name} bf16 M=4 K={k} N={n} "
              f"({decode_plan_text(ag, 4, (n,), k, cfg.dtype, sms)}): a call "
              f"queues {nodes}, {fmt_ms(alone)} ms the kernel alone; "
              f"kernel_ms={ms:.5f} library_ms={lib:.5f} bound_ms={bnd:.5f}"
              f" [{card_line()}]", flush=True)
        out.append({
            "name": name, "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/gemm_ar.cu",
            "replaces": f"triton_dist_tpu/ops/gemm_reduce_scatter.py:{line}",
            "launches": main_launches.get((k, n), 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib,
            "wall_ms": wall, "alone_ms": alone, "kernels_a_call": nodes,
            "shape": [4, k, n], "ok": ok})
        check(out[-1]["launches"] > 0, f"{name} never launched on the path")
    return out


# -- slice 2: mode "sp" serving through the flash-decode kernels --------------
#: Qwen3-8B's decode attention: batch 4, 32 query / 8 KV heads of dim 128.
FD_B, FD_HQ, FD_HKV, FD_D, FD_PAGE = 4, 32, 8, 128, 16
#: kv_len cases of phase 7; the last is ragged, one length per row.
FD_LENS = (1, 17, 160, 1024, (1, 17, 160, 1024))
#: The three sp engines: (a) paged, (b) contiguous with a shard of 8 MiB
#: (the split kernel, dense rows), (c) contiguous with a shard of 4 MiB
#: (the single-pass kernel): name -> (max_seq, Engine options, flash-decode
#: launches per layer of a decode step: the fused tiled launch or the
#: single-pass one).
SP_ENGINES = {"a": (1024, {"paged": True, "page_size": FD_PAGE}, 1),
              "b": (1024, {}, 1),
              "c": (512, {}, 1)}
#: Block pool of the stream phase: 24 pages hold two of its requests at a
#: time (each needs 7-13), so admission waits for retirements.
STREAM_SLOTS = 24
PREFIX_LEN = 64


def fd_error(torch, got, ref, weight) -> tuple[float, bool]:
    """(max |got - ref|, within tolerance) of attention outputs. f32: 1e-5
    (f32 sums in another order). bf16: the kernel rounds each probability
    to bf16 against its 64-position chunk's running max, the plain
    version against the row's final max, so a probability p_j moves by
    up to 2^-8 of itself on each side; both outputs then round to bf16
    once. The limit is the SP phases' weight rule,
    ``bf16_attention_limit`` (ops/sp_attention.py): 2^-7 |out| + 2^-8
    sum_j (p_j / l)|v_j|, ``weight`` being that sum from the plain decode
    over |v| (:func:`fd_weight`)."""
    from triton_dist_tpu_torch.ops.sp_attention import bf16_attention_limit
    diff = (got.float() - ref.float()).abs()
    if got.dtype == torch.float32:
        lim = torch.full_like(diff, F32_ATOL / 3)
    else:
        lim = bf16_attention_limit(got, ref, weight)
    return diff.max().item(), bool((diff <= lim).all())


def drop_split(parts, lens, split_len: int):
    """A planted fault: the partials (acc, l, m) with the split that holds
    the last position of the shortest row dropped before the combine."""
    a, l, m = (x.clone() for x in parts)
    first = min(lens) if isinstance(lens, list) else lens
    drop = min((first - 1) // split_len, a.shape[2] - 1)
    a[:, :, drop], l[:, :, drop], m[:, :, drop] = 0.0, 0.0, -1e30
    return (a, l, m), drop


def fd_operands(torch, dtype, t: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (randn(FD_B, FD_HQ, FD_D), randn(FD_B, t, FD_HKV, FD_D),
            randn(FD_B, t, FD_HKV, FD_D))


def fd_paged(torch, k, v):
    """The rows of k/v scattered page by page over a pool of one row's
    pages more than they fill (the sentinel's place), in a seeded random
    order: (pool_k, pool_v, table (1, B, n_pages))."""
    b, t = k.shape[:2]
    n_pages = t // FD_PAGE
    slots = torch.randperm(b * n_pages + 1,
                           generator=torch.Generator().manual_seed(5))
    table = slots[:b * n_pages].reshape(1, b, n_pages).to(torch.int32)
    table = table.to("cuda")
    idx = table[0].reshape(-1).long()
    pools = []
    for x in (k, v):
        pool = torch.zeros((b * n_pages + 1, FD_PAGE) + tuple(x.shape[2:]),
                           dtype=x.dtype, device="cuda")
        pool[idx] = x.reshape(b * n_pages, FD_PAGE, *x.shape[2:])
        pools.append(pool)
    return pools[0], pools[1], table


def phase_flash_kernels(torch, fd, card: str) -> None:
    print("== phase 7: flash-decode kernels vs their plain versions",
          flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = fd_operands(torch, dtype, 1024, seed=7)
        pool_k, pool_v, table = fd_paged(torch, k, v)
        k5, v5 = k[:, :512].contiguous(), v[:, :512].contiguous()
        p = fd.plan(FD_B, FD_HKV, 1024, sms)
        errs = {"partial": 0.0, "combine": 0.0, "single": 0.0, "tiled": 0.0}
        faults = []
        for lens in FD_LENS:
            lens = list(lens) if isinstance(lens, tuple) else lens
            w = fd_weight(fd, q, k, v, lens)
            w5 = fd_weight(fd, q, k5, v5, lens)
            runs = []
            for _ in range(2):               # the repeat must match bits
                dense = fd.flash_decode_partial(q, k, v, lens, p.split_len,
                                                p.splits)
                paged = fd.flash_decode_partial(q, pool_k, pool_v, lens,
                                                p.split_len, p.splits,
                                                table=table[0])
                runs.append((dense, paged,
                             fd.flash_decode_combine(*dense, dtype),
                             fd.flash_decode_single(q, k5, v5, lens),
                             fd.flash_decode_tiled(q, k, v, lens,
                                                   p.split_len, p.splits),
                             fd.flash_decode_tiled(q, pool_k, pool_v, lens,
                                                   p.split_len, p.splits,
                                                   table[0])))
            torch.cuda.synchronize()
            (dense, paged, merged, single, fused, fused_paged), again = runs
            flat = [t for r in runs for t in (*r[0], *r[1], *r[2:])]
            half = len(flat) // 2
            check(all(torch.equal(a, b)
                      for a, b in zip(flat[:half], flat[half:])),
                  f"flash decode {kind} kv_len {lens}: repeat differs")
            check(all(torch.equal(a, b) for a, b in zip(dense, paged)),
                  f"flash decode {kind} kv_len {lens}: paged and dense "
                  f"partials differ")
            # The fused launch merges with the standalone combine's code:
            # the same bits, dense and paged.
            check(torch.equal(fused, merged)
                  and torch.equal(fused_paged, merged),
                  f"flash decode {kind} kv_len {lens}: the fused launch "
                  f"differs from partial + combine")
            # partial: both partials merged by the plain combine.
            plain = fd.flash_decode_partials_reference(q, k, v, lens,
                                                       p.split_len, p.splits)
            err, ok = fd_error(torch,
                               fd.flash_decode_combine_reference(*dense,
                                                                 dtype),
                               fd.flash_decode_combine_reference(*plain,
                                                                 dtype), w)
            check(ok, f"partial {kind} kv_len {lens}: err {err}")
            errs["partial"] = max(errs["partial"], err)
            err, ok = fd_error(torch, merged,
                               fd.flash_decode_combine_reference(*dense,
                                                                 dtype), w)
            check(ok, f"combine {kind} kv_len {lens}: err {err}")
            errs["combine"] = max(errs["combine"], err)
            err, ok = fd_error(torch, single,
                               fd.flash_decode_reference(q, k5, v5, lens), w5)
            check(ok, f"single {kind} kv_len {lens}: err {err}")
            errs["single"] = max(errs["single"], err)
            want = fd.flash_decode_reference(q, k, v, lens)
            err, ok = fd_error(torch, fused, want, w)
            check(ok, f"tiled {kind} kv_len {lens}: err {err}")
            errs["tiled"] = max(errs["tiled"], err)
            if lens in (160, 1024):
                # Phase 8's kv_len (160) and the full cache: the same
                # limit must refuse a merge that lost one split, in the
                # standalone combine and in the fused launch.
                bad, drop = drop_split(dense, lens, p.split_len)
                bad_err, bad_ok = fd_error(
                    torch, fd.flash_decode_combine(*bad, dtype), want, w)
                f_err, f_ok = fd_error(torch, fd.flash_decode_tiled(
                    q, pool_k, pool_v, lens, p.split_len, p.splits,
                    table[0], fault=drop), want, w)
                check(not bad_ok and not f_ok,
                      f"flash decode {kind} kv_len {lens}: a dropped split "
                      f"passed (combine {bad_err}, fused {f_err})")
                faults.append(f"kv_len {lens}: split {drop} dropped, err "
                              f"{bad_err:.3g} (fused launch {f_err:.3g})")
        tol = ("1e-5" if dtype == torch.float32 else
               "2^-7 |out| + 2^-8 sum_j (p_j/l)|v_j|")
        print(f"kernel flash_decode {kind} B={FD_B} Hq={FD_HQ} Hkv={FD_HKV} "
              f"D={FD_D}, kv_len {list(FD_LENS)}: "
              f"partial (T=1024 dense and paged, {p.splits} splits of "
              f"{p.split_len}) max_abs_err={errs['partial']:.3g}, combine "
              f"{errs['combine']:.3g}, fused tiled {errs['tiled']:.3g}, "
              f"single (T=512) {errs['single']:.3g} (tol {tol}); repeats "
              f"bit-identical, paged == dense bits, fused launch == "
              f"partial + combine bits; planted faults refused: "
              f"{'; '.join(faults)} [{card}]", flush=True)


def sp_prompts(torch, cfg, seed: int):
    host = torch.Generator().manual_seed(seed + 1)

    def rand(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=host).tolist()
    square = [rand(128) for _ in range(4)]
    prefix = rand(PREFIX_LEN)
    stream = [prefix + rand(n) for n in (64, 20, 48, 7, 100, 33)]
    return square, stream


def phase_sp_main(torch, models, ops, fd, cfg, params, card: str,
                  seed: int):
    """The sp main path: serve on (a), (b), (c), the stream on (a') and the
    server over (a). Returns (engines, the prompts, the stream, launches,
    engine (a)'s tokens)."""
    print("== phase 8: Qwen3-8B served in mode 'sp' through the "
          "flash-decode kernels", flush=True)
    model = models.DenseLLM(cfg, sp_axis="sp")
    engines = {name: models.Engine(model, batch=4, max_seq=max_seq,
                                   prefill_mode="sp", decode_mode="sp", **kw)
               for name, (max_seq, kw, _) in SP_ENGINES.items()}
    engines["a'"] = models.Engine(model, batch=4, max_seq=1024,
                                  prefill_mode="sp", decode_mode="sp",
                                  paged=True, page_size=FD_PAGE,
                                  kv_slots_per_dev=STREAM_SLOTS)
    square, stream = sp_prompts(torch, cfg, seed)
    for name in SP_ENGINES:                       # warm-up
        engines[name].serve(params, square, 2)
    engines["a'"].serve_stream(params, stream[:2], 2)

    def fd_total():
        return sum(c.total for c in fd.launches.values())

    ops.launches.reset()                          # ---- the main path starts
    for c in fd.launches.values():
        c.reset()
    layers = cfg.num_hidden_layers
    steps = GEN - 1
    tokens = {}
    for name, (max_seq, _, per_layer) in SP_ENGINES.items():
        eng = engines[name]
        before = fd_total()
        _, prefill_ms = sync_time(torch, lambda: eng.serve(params, square, 1))
        check(fd_total() == before, f"({name}) prefill launched flash decode")
        out, serve_ms = sync_time(torch,
                                  lambda: eng.serve(params, square, GEN))
        check(tuple(out.shape) == (4, 128 + GEN), f"({name}) serve shape")
        launched = fd_total() - before
        check(launched == per_layer * layers * steps,
              f"({name}) {launched} flash-decode launches, expected "
              f"{per_layer} x {layers} x {steps}")
        tokens[name] = out
        decode_ms = serve_ms - prefill_ms
        print(f"sp serve ({name}: {'paged' if eng.paged else 'contiguous'}, "
              f"max_seq {max_seq}): batch 4 x 128 prompt, {GEN} new tokens: "
              f"prefill_ms={prefill_ms:.1f} decode_ms={decode_ms:.1f} "
              f"per_step_ms={decode_ms / steps:.2f} decode_tokens_per_s="
              f"{4 * steps / decode_ms * 1e3:.1f} flash-decode launches "
              f"{launched} = {per_layer} x {layers} x {steps} [{card}]",
              flush=True)
    check(torch.equal(tokens["a"], tokens["b"]),
          "paged and contiguous split-kernel engines disagree")
    same = (tokens["c"] == tokens["a"]).float().mean().item()
    print(f"sp tokens: (a) paged == (b) contiguous bit for bit; (c) "
          f"single-pass kernel agrees on {same:.3f} of the tokens",
          flush=True)

    eng = engines["a'"]
    before = fd_total()
    res, stream_ms = sync_time(
        torch, lambda: eng.serve_stream(params, stream, GEN))
    check([len(r) for r in res] == [len(p) + GEN for p in stream],
          "sp serve_stream row lengths")
    stats = eng.kv.prefix.stats()
    audit = eng.kv.block_audit()
    check(stats["hit_blocks"] > 0, f"no prefix hits: {stats}")
    check(audit["active"] == 0 and audit["committed"] == 0
          and audit["free"] + audit["evictable"] == audit["total"],
          f"block audit not clean: {audit}")
    launched = fd_total() - before
    check(launched > 0 and launched % layers == 0,
          f"stream flash-decode launches {launched}")
    print(f"sp serve_stream (a': paged, {STREAM_SLOTS}-block pool): 6 "
          f"prompts sharing a {PREFIX_LEN}-token prefix through 4 rows, "
          f"{GEN} new tokens in {stream_ms:.1f} ms; decode steps "
          f"{launched // layers}; prefix {stats}; audit {audit} "
          f"[{card}]", flush=True)

    phase_sp_server(torch, engines["a"], params, square, stream, card)
    fd_launches = {n: dict(c.by_shape) for n, c in fd.launches.items()}
    check(ops.launches.total == 0, "gemm_ar launched on the sp path")
    # The merge runs in the partial's own launch: the standalone combine
    # never does on the path (phase 7 and the records hold the fused
    # launch bit-equal to partial + combine).
    check(not fd_launches["combine"], f"the standalone combine launched on "
                                      f"the sp path: {fd_launches}")
    print(f"sp main path: gemm_ar launches 0; flash-decode launches "
          f"{fd_launches}", flush=True)               # ---- main path ends
    for t in list(tokens.values()) + [torch.tensor(r) for r in res]:
        check(bool(((t >= 0) & (t < cfg.vocab_size)).all()),
              "token out of vocabulary")
    return engines, square, stream, fd_launches, tokens["a"]


def phase_sp_server(torch, eng, params, square, stream, card: str) -> None:
    from triton_dist_tpu_torch.serving.client import ChatClient
    from triton_dist_tpu_torch.serving.server import ModelServer
    srv = ModelServer(eng, params, host="127.0.0.1", port=0).start()
    try:
        with ChatClient(srv.host, srv.port, timeout=600) as client:
            for batch in (square, stream):
                t0 = time.perf_counter()
                reply = client.generate_ids(batch, 8)
                ms = (time.perf_counter() - t0) * 1e3
                check("tokens" in reply, f"server error: {reply}")
                if len(batch) > 4:
                    rows = eng.serve_stream(params, batch, 8)
                    route = "serve_stream"
                else:
                    rows = eng.serve(params, batch, 8).tolist()
                    route = "serve"
                want = [r[len(p):] for r, p in zip(rows, batch)]
                check(reply["tokens"] == want,
                      f"server reply differs from {route}")
                print(f"sp server (a): {len(batch)} prompts -> 8 tokens "
                      f"each, equal to Engine.{route}; {ms:.1f} ms round "
                      f"trip [{card}]", flush=True)
            reply = client.generate_ids([[1, 2, 3], [4, 5]], 4)
            check("non-ragged" in reply.get("error", ""),
                  f"ragged prompts were not refused: {reply}")
            print("sp server (a): ragged prompts get the error reply",
                  flush=True)
    finally:
        srv.stop()


def sp_step(torch, eng, params, square):
    """One decode step (forward only) of engine ``eng`` after a prefill of
    ``square``, as a function of no arguments returning the logits."""
    kv = eng.kv
    table = None
    if eng.paged:
        kv.reset_pool()
        kv.alloc_many(range(4))
        table = kv.block_table()
    caches = kv.init()
    ids = torch.tensor(square, device="cuda")
    with torch.no_grad():
        logits, _ = eng.model.forward(params, ids, caches, 0, mode="sp",
                                      block_table=table)
    tok = logits[:, -1].argmax(-1)[:, None]

    def step():
        # Each call writes position 128 before reading it: every call
        # sees the same cache.
        with torch.no_grad():
            return eng.model.forward(params, tok, caches, 128, mode="sp",
                                     block_table=table)[0]
    return step


def phase_sp_checks(torch, fd, engines, params, square, stream,
                    card: str) -> None:
    print("== phase 9: sp decode logits, idle share, prefix-hit logits",
          flush=True)
    from triton_dist_tpu_torch.models import dense
    step = sp_step(torch, engines["a"], params, square)
    got = step()
    dense.gqa_fwd_batch_decode_paged = (
        lambda q, pk, pv, table, lens, ctx=None:
        fd.flash_decode_paged_reference(q, pk, pv, table, lens))
    try:
        ref = step()
    finally:
        dense.gqa_fwd_batch_decode_paged = fd.gqa_fwd_batch_decode_paged
    check(bool(torch.isfinite(got).all()), "non-finite sp logits")
    err = (got - ref).abs().max().item()
    same = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    check(err <= LOGITS_ATOL, f"sp decode logits differ by {err}")
    print(f"sp logits (a): decode step through the kernels vs "
          f"flash_decode_paged_reference max abs diff {err:.4g} (tol "
          f"{LOGITS_ATOL}), argmax agreement {same:.2f}", flush=True)

    for name in SP_ENGINES:
        fn = sp_step(torch, engines[name], params, square)
        walls = [sync_time(torch, fn)[1] for _ in range(5)]
        wall = sorted(walls)[2]
        dev, ge, le = device_ms(torch, fn, n=3)
        print(f"sp decode step ({name}, forward only): wall {wall:.2f} ms "
              f"(median of 5), device {ge}{dev:.2f} ms, device idle share "
              f"{le}{1 - dev / wall:.2f} [{card}]", flush=True)

    # A prefix-hit admission against a cold one of the same prompt: the
    # hit prefills only the suffix over the cached prefix pages.
    eng = engines["a'"]
    seen = []
    sample = eng._sample
    eng._sample = lambda logits: (seen.append(logits.float()),
                                  sample(logits))[1]
    try:
        sess = eng.stream_session(params)
        sess.prefill_into_row(0, stream[0], gen_budget=GEN)
        sess.prefill_into_row(1, stream[1], gen_budget=GEN)
        cached = sess.admit_info["cached"]
        sess.close()
        eng.prefix_cache = False
        cold = eng.stream_session(params)
        cold.prefill_into_row(0, stream[1], gen_budget=GEN)
        cold.close()
    finally:
        eng.prefix_cache = True
        eng._sample = sample
    check(cached == PREFIX_LEN, f"hit admission cached {cached} tokens")
    err = (seen[1] - seen[2]).abs().max().item()
    check(err <= LOGITS_ATOL, f"hit vs cold first-token logits differ by "
                              f"{err}")
    print(f"sp prefix hit (a'): first-token logits of a {cached}-token hit "
          f"vs a cold admission of the same prompt max abs diff {err:.4g} "
          f"(tol {LOGITS_ATOL}), argmax "
          f"{'equal' if seen[1].argmax() == seen[2].argmax() else 'differs'}"
          f" [{card}]", flush=True)


def attn_bound_ms(lens, t: int, itemsize: int, kind: str, out_bytes: int):
    """(least ms, what bounds it) of one decode attention over the first
    ``lens[b]`` of ``t`` positions: the live K and V rows and q read once
    and ``out_bytes`` written once over HBM; 2 * 2 operations per (query
    head, live position, head-dim element)."""
    live = sum(min(n, t) for n in lens)
    kv_bytes = 2 * live * FD_HKV * FD_D * itemsize
    q_bytes = FD_B * FD_HQ * FD_D * itemsize
    by_bytes = (kv_bytes + q_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    by_ops = 4.0 * FD_HQ * FD_D * live / PEAK_FLOPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase_fd_kernels_line(torch, fd, fd_launches) -> list:
    """The JSON records of the flash-decode kernels at the main path's
    shapes: bf16, batch 4, kv_len 160 (the last decode step of a 128-token
    prompt and 32 new tokens), engine (a)'s pool, (b)'s and (c)'s caches.
    The partial rows time the path's call, the partial kernel with its
    merge tail in one launch (``flash_decode_tiled``), first held bit-equal
    to the partial alone plus the standalone combine; the combine row is
    that standalone kernel, off the path (0 launches). ``library_ms``: one
    ``scaled_dot_product_attention`` with the kv_len mask over the
    contiguous (B, T) view, a yardstick the port never calls (the combine
    has none)."""
    import torch.nn.functional as F
    from triton_dist_tpu_torch.models.kv_cache import PagedKVCacheManager
    view = PagedKVCacheManager.gathered_view
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dtype, kind = torch.bfloat16, "bf16"
    lens = [160] * FD_B
    q, k, v = fd_operands(torch, dtype, 1024, seed=9)
    pool_k, pool_v, table = fd_paged(torch, k, v)
    k5, v5 = k[:, :512].contiguous(), v[:, :512].contiguous()
    p = fd.plan(FD_B, FD_HKV, 1024, sms)
    out_bytes = FD_B * FD_HQ * FD_D * 2

    def library(kk, vv):
        t = kk.shape[1]
        mask = (torch.arange(t, device="cuda")[None, :]
                < torch.tensor(lens, device="cuda")[:, None])[:, None, None]
        q4, k4, v4 = q[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True)

    # The kernels take the lengths as a device tensor: a Python list is
    # copied to the card on every call, which waits for the card.
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ctx = fd.FlashDecodeContext()      # its tickets serve every call

    def paged_tiled():
        return fd.flash_decode_tiled(q, pool_k, pool_v, lens_t, p.split_len,
                                     p.splits, table[0], ctx=ctx)

    def dense_tiled():
        return fd.flash_decode_tiled(q, k, v, lens_t, p.split_len, p.splits,
                                     ctx=ctx)

    parts = fd.flash_decode_partial(q, k, v, lens_t, p.split_len, p.splits)
    part_bytes = sum(x.numel() * 4 for x in parts)
    merged = fd.flash_decode_combine(*parts, dtype)
    check(torch.equal(paged_tiled(), merged)
          and torch.equal(dense_tiled(), merged),
          "the fused tiled launch differs from partial + combine at kv_len "
          "160")
    ref = fd.flash_decode_reference(q, k, v, lens)
    w, w5 = fd_weight(fd, q, k, v, lens), fd_weight(fd, q, k5, v5, lens)
    merge = fd.flash_decode_combine_reference
    # name, counter, launch key, replaced line, kernel, plain version,
    # (kernel result, plain result, weight of the tolerance), library, bound
    cases = [
        ("flash_decode_partial[paged]", "partial", ("paged", FD_B, 1024),
         280, paged_tiled,
         lambda: fd.flash_decode_paged_reference(q, pool_k, pool_v, table,
                                                 lens),
         (paged_tiled(), ref, w),
         library(view(pool_k, table), view(pool_v, table)),
         attn_bound_ms(lens, 1024, 2, kind, out_bytes)),
        ("flash_decode_partial[dense]", "partial", ("dense", FD_B, 1024),
         280, dense_tiled,
         lambda: fd.flash_decode_reference(q, k, v, lens),
         (dense_tiled(), ref, w), library(k, v),
         attn_bound_ms(lens, 1024, 2, kind, out_bytes)),
        ("flash_decode_combine", "combine", None, 218,
         lambda: fd.flash_decode_combine(*parts, dtype),
         lambda: merge(*parts, dtype),
         (merged, merge(*parts, dtype), w),
         None,
         ((part_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3, "bytes")),
        ("flash_decode_single", "single", ("dense", FD_B, 512), 262,
         lambda: fd.flash_decode_single(q, k5, v5, lens_t),
         lambda: fd.flash_decode_reference(q, k5, v5, lens),
         (fd.flash_decode_single(q, k5, v5, lens_t),
          fd.flash_decode_reference(q, k5, v5, lens), w5),
         library(k5, v5), attn_bound_ms(lens, 512, 2, kind, out_bytes)),
    ]
    out = []
    for (name, counter, key, line, kernel, plain, (got, want, wt), lib,
         (bnd, by)) in cases:
        err, ok = fd_error(torch, got, want, wt)
        check(ok, f"{name}: max abs err {err} outside tolerance")
        launches = (fd_launches[counter].get(key, 0) if key is not None
                    else sum(fd_launches[counter].values()))
        rec = {
            "name": name, "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/flash_decode.cu",
            "replaces": f"triton_dist_tpu/ops/flash_decode.py:{line}",
            "launches": launches, "max_abs_err": err,
            "ms": queued_ms(torch, kernel),
            "plain_ms": queued_ms(torch, plain, may_wait=True),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": queued_ms(torch, lib) if lib else None,
            "wall_ms": wall_ms(torch, kernel),
            "shape": [FD_B, FD_HQ, FD_HKV, FD_D, 160], "ok": ok}
        if counter == "combine":
            rec["path"] = ("off the path: its merge runs in the partial's "
                           "launch, bit-equal")
            check(launches == 0, f"{name} launched on the path")
        else:
            check(launches > 0, f"{name} never launched on the path")
        out.append(rec)
        print(f"kernel {name} bf16 kv_len 160: kernel_ms={rec['ms']:.5f} "
              f"plain_ms={rec['plain_ms']:.4f} library_ms="
              f"{rec['library_ms'] and round(rec['library_ms'], 5)} "
              f"bound_ms={bnd:.5f} ({by}) launches={launches} "
              f"max_abs_err={err:.3e}", flush=True)
    return out


# -- slice 3: mode "ag_rs" through the AG-GEMM / AG-SwiGLU / GEMM-RS kernels --
#: Qwen3-8B prefill rows (batch 4 x 128-token prompts) and decode rows.
AG_PREFILL_M, AG_DECODE_M = 512, 4
#: The two ag_rs engines: name -> (prefill mode, decode mode).
AG_ENGINES = {"reference": ("ag_rs", "gemm_ar"), "fused": ("ag_rs", "ag_rs")}


def f32_sum_atol(k: int) -> float:
    """Absolute limit for bf16 products near zero: each side sums k
    unit-scale f32 terms in its own order, and the rounding error of such
    a blocked sum grows like sqrt(k), about 1e-6 * sqrt(k / 1024); 4x
    that for the gap between two such sums."""
    return 4e-6 * max(1.0, (k / 1024) ** 0.5)


def gemm_error(torch, got, ref, k: int) -> tuple[float, bool]:
    """(max |got - ref|, within one bf16 ulp + f32_sum_atol(k))."""
    diff = (got.float() - ref.float()).abs()
    lim = (BF16_ULP_REL * torch.maximum(got.float().abs(), ref.float().abs())
           + f32_sum_atol(k))
    return diff.max().item(), bool((diff <= lim).all())


def swiglu_error(torch, got, ref, a, wg, wu) -> tuple[float, bool]:
    """(max |got - ref|, within tolerance) of the fused SwiGLU: one bf16
    ulp of the value, plus 2^-16 (|silu(g)| + 1.1 |u|) + 1e-6 for the f32
    gate g and up u of two summation orders, whose ~1e-6 gap moves an
    activation near zero by more than its ulp (|silu'| < 1.1)."""
    g = a.float() @ wg.float()
    u = a.float() @ wu.float()
    diff = (got.float() - ref.float()).abs()
    lim = (BF16_ULP_REL * torch.maximum(got.float().abs(), ref.float().abs())
           + 2.0 ** -16 * (torch.nn.functional.silu(g).abs() + 1.1 * u.abs())
           + 1e-6)
    return diff.max().item(), bool((diff <= lim).all())


def gemm_bound_ms(m: int, k: int, widths, n_b_operands: int = 1):
    """(least ms, what bounds it) of products sharing A (M, K): A, every
    weight and every output moved once over HBM; 2*M*K*N operations per
    product over the bf16 peak. ``n_b_operands`` weights per output width
    (2 for the SwiGLU, whose gate and up give one output)."""
    n = sum(widths)
    by_bytes = (m * k + n_b_operands * k * n + m * n) * 2 / HBM_BYTES_PER_S
    by_ops = 2.0 * m * k * n * n_b_operands / PEAK_FLOPS["bf16"]
    return ((by_bytes * 1e3, "bytes") if by_bytes >= by_ops
            else (by_ops * 1e3, "operations"))


def prefill_rate(ag, m: int, k: int, widths, swiglu: bool, ms: float,
                 tiles: int, blocks: int) -> str:
    """What a prefill tile kernel's time gives: its TFLOP/s, their share
    of the bf16 peak, and the waves of ``tiles`` tiles over ``blocks``
    persistent blocks with the idle share of the last one."""
    flops = 2.0 * m * k * sum(widths) * (2 if swiglu else 1)
    tflops = flops / ms / 1e9
    waves, idle = ag.tile_waves(tiles, blocks)
    return (f" {tflops:.0f} TFLOP/s ({tflops * 1e12 / PEAK_FLOPS['bf16']:.3f}"
            f" of the peak), {tiles} tiles in {waves:.2f} waves on {blocks} "
            f"blocks (last wave idle {idle:.2f})")


def phase_ag_kernels(torch, ag, rs, params, cfg, card: str) -> list:
    """Phase 10: the new kernels against their plain versions at the main
    path's shapes, bf16, on the model's own weights (cycled over the 36
    layers so B is cold in L2, as in a forward). Returns the kernel
    records of the JSON line, ``launches`` still to fill from phase 11."""
    print("== phase 10: AG-GEMM, AG-SwiGLU and GEMM-RS kernels vs their "
          "plain versions", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    layers = params["layers"]
    h = cfg.hidden_size
    records = []

    def weights(*keys):
        return [[lp[a][b] for a, b in keys] for lp in layers]

    qkv = weights(("attn", "w_q"), ("attn", "w_k"), ("attn", "w_v"))
    gate_up = weights(("mlp", "w_gate"), ("mlp", "w_up"))
    o_proj = weights(("attn", "w_o"))
    down = weights(("mlp", "w_down"))
    # Each weight set concatenated once, outside the timing, for the one
    # torch.matmul the library time is.
    cat = {id(ws[0][0]): [torch.cat(w, dim=1) for w in ws[:4]]
           for ws in (qkv, gate_up)}
    cases = [
        # name, rows, weight sets, kernel op, plan, counter key name,
        # replaced TPU kernel line
        ("ag_gemm[prefill qkv]", AG_PREFILL_M, qkv, "gemm", "prefill",
         "triton_dist_tpu/ops/allgather_gemm.py:265"),
        ("ag_swiglu[prefill]", AG_PREFILL_M, gate_up, "swiglu", "prefill",
         "triton_dist_tpu/ops/allgather_gemm.py:954"),
        ("gemm_rs[prefill o_proj]", AG_PREFILL_M, o_proj, "rs", "prefill",
         "triton_dist_tpu/ops/gemm_reduce_scatter.py:353"),
        ("gemm_rs[prefill down]", AG_PREFILL_M, down, "rs", "prefill",
         "triton_dist_tpu/ops/gemm_reduce_scatter.py:533"),
        ("ag_gemm[decode qkv]", AG_DECODE_M, qkv, "gemm", "decode",
         "triton_dist_tpu/ops/allgather_gemm.py:265"),
        ("ag_gemm[decode gate|up]", AG_DECODE_M, gate_up, "gemm", "decode",
         "triton_dist_tpu/ops/allgather_gemm.py:265"),
        ("gemm_rs[decode down]", AG_DECODE_M, down, "rs", "decode",
         "triton_dist_tpu/ops/gemm_reduce_scatter.py:533"),
    ]
    for name, m, sets, op, plan, replaces in cases:
        k = sets[0][0].shape[0]
        widths = tuple(w.shape[1] for w in sets[0])
        a = torch.randn((m, k), generator=gen, device="cuda",
                        dtype=cfg.dtype)
        if op == "gemm":
            def kernel(ws):
                return ag.ag_gemm_multi(a, ws)

            def plain(ws):
                return ag.ag_gemm_multi_reference(a, ws)
        elif op == "swiglu":
            def kernel(ws):
                return [ag.launch_swiglu(a, ws[0], ws[1], None, None)]

            def plain(ws):
                return [ag.ag_swiglu_reference(a, ws[0], ws[1])]
        else:
            def kernel(ws):
                return [rs.gemm_rs(a, ws[0])]

            def plain(ws):
                return [rs.gemm_rs_reference(a, ws[0])]
        got, again = kernel(sets[0]), kernel(sets[0])
        torch.cuda.synchronize()
        ref = plain(sets[0])
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{name}: repeat differs")
        if op == "swiglu":
            err, ok = swiglu_error(torch, got[0], ref[0], a, *sets[0])
            tol = "1 bf16 ulp + 2^-16 (|silu(g)| + 1.1|u|) + 1e-6"
        else:
            pairs = [gemm_error(torch, x, y, k) for x, y in zip(got, ref)]
            err, ok = max(e for e, _ in pairs), all(o for _, o in pairs)
            tol = f"1 bf16 ulp + {f32_sum_atol(k):.2g}"
        check(ok, f"{name}: max abs err {err} outside tolerance ({tol})")
        nk, np_ = rotating(sets), rotating(sets)
        ms = queued_ms(torch, lambda: kernel(nk()))
        wall = wall_ms(torch, lambda: kernel(nk()))
        plain_ms = queued_ms(torch, lambda: plain(np_()), may_wait=True)
        if op == "rs":
            nl = rotating([w[0] for w in sets])
            lib_ms = queued_ms(torch, lambda: torch.matmul(a, nl()))
        else:
            nl = rotating(cat[id(sets[0][0])])
            lib_ms = queued_ms(torch, lambda: torch.matmul(a, nl()))
        if op == "swiglu":
            bnd, by = gemm_bound_ms(m, k, widths[:1], 2)
        else:
            bnd, by = gemm_bound_ms(m, k, widths)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rate = ""
        if plan == "decode":
            nodes = queued_kernels(torch, lambda: kernel(sets[0]), name, True)
            rate = (f"; {decode_plan_text(ag, m, widths, k, cfg.dtype, sms)}"
                    f"; a call queues {nodes}")
        if op == "rs" and m <= rs.DECODE_MAX_M:
            key, counter, path = ("decode", k, widths), "gemm_rs", "gemm_ar.cu"
        else:
            p = ag.plan("swiglu" if op == "swiglu" else "gemm", m,
                        widths[:1] if op == "swiglu" else widths, k,
                        cfg.dtype, sms)
            check(p.path == plan, f"{name}: plan {p.path}, expected {plan}")
            counter = {"gemm": "ag_gemm", "swiglu": "ag_swiglu",
                       "rs": "gemm_rs"}[op]
            key = (p.path, k, widths[:1] if op == "swiglu" else widths)
            path = f"{p.path}, {p.tiles} tiles x {p.splits} splits"
        if plan == "prefill":
            # The persistent grid: one block an SM, at most one a tile.
            rate = prefill_rate(ag, m, k, widths[:1] if op == "swiglu"
                                else widths, op == "swiglu", ms, p.tiles,
                                min(p.tiles, sms))
        print(f"kernel {name} bf16 M={m} K={k} N={'|'.join(map(str, widths))}"
              f" ({path}): max_abs_err={err:.3g} (tol {tol}) ok, repeat "
              f"bit-identical; kernel_ms={ms:.4f} (wall {wall:.4f}) "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}"
              f"{' (matmul of the gate|up products, no epilogue)' if op == 'swiglu' else ''}"
              f" bound_ms={bnd:.4f} ({by}){rate} [{card}]", flush=True)
        records.append(({
            "name": name, "route": "cuda",
            "source": ("triton_dist_tpu_torch/csrc/gemm_ar.cu"
                       if path == "gemm_ar.cu"
                       else "triton_dist_tpu_torch/csrc/ag_gemm.cu"),
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms, "wall_ms": wall,
            "shape": [m, k, list(widths)], "ok": ok}, counter, key))
    del cat
    return records


def ag_counts(ag, rs, ops) -> dict:
    return {"ag_gemm": ag.ag_gemm_launches.total,
            "ag_swiglu": ag.ag_swiglu_launches.total,
            "gemm_rs": rs.gemm_rs_launches.total,
            "gemm_ar": ops.launches.total}


def phase_ag_rs_main(torch, models, ag, rs, ops, cfg, params, base, card):
    """Phase 11: Qwen3-8B served in mode "ag_rs" by the reference engine
    (prefill ag_rs, decode gemm_ar) and the fused one (ag_rs both), through
    serve, serve_stream and the server, with the launch counts of every
    prefill and decode step. ``base``: (prompts, tokens) of the
    xla_ar / gemm_ar engine of phase 3. Returns (engines, launches by
    counter and key)."""
    print("== phase 11: Qwen3-8B served in mode 'ag_rs' through the AG-GEMM,"
          " AG-SwiGLU and GEMM-RS kernels", flush=True)
    layers = cfg.num_hidden_layers
    model = models.DenseLLM(cfg)                    # default mode: ag_rs
    check(model.fwd_mode == "ag_rs", "default mode is not ag_rs")
    engines = {name: models.Engine(model, batch=4, max_seq=1024,
                                   prefill_mode=pf, decode_mode=dc)
               for name, (pf, dc) in AG_ENGINES.items()}
    square, base_out = base
    host = torch.Generator().manual_seed(7)
    # Admission buckets of 128: every admission prefill fuses the SwiGLU.
    stream = [torch.randint(0, cfg.vocab_size, (n,), generator=host).tolist()
              for n in (100, 128, 70, 90, 120, 65)]
    for eng in engines.values():                      # warm-up
        eng.serve(params, square, 2)
    counters = (ag.ag_gemm_launches, ag.ag_swiglu_launches,
                rs.gemm_rs_launches, ops.launches)
    for c in counters:                               # ---- the main path
        c.reset()
    steps = GEN - 1
    per_prefill = {"ag_gemm": layers, "ag_swiglu": layers,
                   "gemm_rs": 2 * layers, "gemm_ar": 0}
    for name, (pf, dc) in AG_ENGINES.items():
        eng = engines[name]
        per_step = ({"ag_gemm": 2 * layers, "ag_swiglu": 0,
                     "gemm_rs": 2 * layers, "gemm_ar": 0} if dc == "ag_rs"
                    else {"ag_gemm": 0, "ag_swiglu": 0, "gemm_rs": 0,
                          "gemm_ar": 2 * layers})
        before = ag_counts(ag, rs, ops)
        _, prefill_ms = sync_time(torch, lambda: eng.serve(params, square, 1))
        got = {k: v - before[k] for k, v in ag_counts(ag, rs, ops).items()}
        check(got == per_prefill, f"({name}) prefill launches {got}, "
                                  f"expected {per_prefill}")
        before = ag_counts(ag, rs, ops)
        out, serve_ms = sync_time(torch,
                                  lambda: eng.serve(params, square, GEN))
        check(tuple(out.shape) == (4, 128 + GEN), f"({name}) serve shape")
        got = {k: v - before[k] for k, v in ag_counts(ag, rs, ops).items()}
        want = {k: per_prefill[k] + steps * per_step[k] for k in got}
        check(got == want, f"({name}) serve launches {got}, expected {want}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "token out of vocabulary")
        same = (out[:, 128:] == base_out[:, 128:]).float().mean().item()
        decode_ms = serve_ms - prefill_ms
        print(f"ag_rs serve ({name}: prefill {pf}, decode {dc}): batch 4 x "
              f"128 prompt, {GEN} new tokens: prefill_ms={prefill_ms:.1f} "
              f"decode_ms={decode_ms:.1f} per_step_ms={decode_ms / steps:.2f}"
              f" decode_tokens_per_s={4 * steps / decode_ms * 1e3:.1f}; "
              f"launches per prefill {per_prefill}, per step {per_step}; "
              f"greedy tokens equal to the xla_ar/gemm_ar engine's: "
              f"{same:.3f} [{card}]", flush=True)

        before = ag_counts(ag, rs, ops)
        res, stream_ms = sync_time(
            torch, lambda: eng.serve_stream(params, stream, GEN))
        check([len(r) for r in res] == [len(p) + GEN for p in stream],
              f"({name}) serve_stream row lengths")
        got = {k: v - before[k] for k, v in ag_counts(ag, rs, ops).items()}
        admits = len(stream)
        check(got["ag_swiglu"] == admits * layers,
              f"({name}) stream ag_swiglu launches {got}")
        # A decode step launches 2 x layers of gemm_rs (fused) or gemm_ar
        # (reference); an admission prefill 2 x layers of gemm_rs.
        n_steps = ((got["gemm_rs"] + got["gemm_ar"] - admits * 2 * layers)
                   // (2 * layers))
        want = {k: admits * per_prefill[k] + n_steps * per_step[k]
                for k in got}
        check(n_steps > 0 and got == want,
              f"({name}) stream launches {got}, expected {want}")
        print(f"ag_rs serve_stream ({name}): 6 prompts (65-128 tokens) "
              f"through 4 rows, {GEN} new tokens in {stream_ms:.1f} ms; "
              f"{admits} admission prefills, {n_steps} decode steps; "
              f"launches {got} [{card}]", flush=True)
        phase_ag_server(torch, eng, params, square, stream, name, card)
    launches = {"ag_gemm": dict(ag.ag_gemm_launches.by_shape),
                "ag_swiglu": dict(ag.ag_swiglu_launches.by_shape),
                "gemm_rs": dict(rs.gemm_rs_launches.by_shape)}
    print(f"ag_rs main path launches: {launches}; gemm_ar "
          f"{ops.launches.total}", flush=True)          # ---- main path ends
    return engines, launches


def phase_ag_server(torch, eng, params, square, stream, name, card,
                    ragged: int = 3) -> None:
    """The server over ``eng``: uniform prompts (serve), more prompts than
    rows (serve_stream) and the first ``ragged`` stream prompts
    (serve_ragged), each reply equal to the engine's own call."""
    from triton_dist_tpu_torch.serving.client import ChatClient
    from triton_dist_tpu_torch.serving.server import ModelServer
    srv = ModelServer(eng, params, host="127.0.0.1", port=0).start()
    try:
        with ChatClient(srv.host, srv.port, timeout=600) as client:
            for batch, route in ((square, "serve"), (stream, "serve_stream"),
                                 (stream[:ragged], "serve_ragged")):
                t0 = time.perf_counter()
                reply = client.generate_ids(batch, 8)
                ms = (time.perf_counter() - t0) * 1e3
                check("tokens" in reply, f"server error: {reply}")
                if route == "serve":
                    rows = eng.serve(params, batch, 8).tolist()
                elif route == "serve_stream":
                    rows = eng.serve_stream(params, batch, 8)
                else:
                    rows = [r.tolist() for r in
                            eng.serve_ragged(params, batch, 8)]
                want = [r[len(p):] for r, p in zip(rows, batch)]
                check(reply["tokens"] == want,
                      f"({name}) server reply differs from {route}")
                print(f"ag_rs server ({name}): {len(batch)} prompts -> 8 "
                      f"tokens each, equal to Engine.{route}; {ms:.1f} ms "
                      f"round trip [{card}]", flush=True)
    finally:
        srv.stop()


def phase_ag_checks(torch, ag, engines, params, square, cfg,
                    card: str) -> None:
    """Phase 11, checks: the prefill's last-position logits through the
    kernels against the same prefill with the plain versions patched in
    at the two launch functions; a decode step's wall vs device time."""
    from triton_dist_tpu_torch.models import KVCacheManager
    model = engines["fused"].model
    ids = torch.tensor(square, device="cuda")

    def prefill():
        kv = KVCacheManager(cfg.num_hidden_layers, 4, 1024,
                            cfg.num_key_value_heads, cfg.head_dim,
                            dtype=cfg.dtype, device="cuda")
        caches = kv.init()
        with torch.no_grad():
            logits, caches = model.forward(params, ids, caches, 0,
                                           mode="ag_rs")
        return logits[:, -1], caches

    got, caches = prefill()
    launch_gemm, launch_swiglu = ag.launch_gemm, ag.launch_swiglu
    ag.launch_gemm = lambda a, bs, count: ag.ag_gemm_multi_reference(a, bs)
    ag.launch_swiglu = ag.ag_swiglu_reference
    try:
        ref, _ = prefill()
    finally:
        ag.launch_gemm, ag.launch_swiglu = launch_gemm, launch_swiglu
    check(bool(torch.isfinite(got).all()), "non-finite ag_rs logits")
    err = (got - ref).abs().max().item()
    same = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    check(err <= LOGITS_ATOL, f"ag_rs prefill logits differ by {err}")
    print(f"ag_rs logits: prefill (4 x 128) last-position logits through the"
          f" kernels vs the plain versions max abs diff {err:.4g} (tol "
          f"{LOGITS_ATOL}), argmax agreement {same:.2f}", flush=True)
    tok = got.argmax(-1)[:, None]
    for name, (pf, dc) in AG_ENGINES.items():
        def step():
            with torch.no_grad():
                model.forward(params, tok, caches, 128, mode=dc)
        walls = [sync_time(torch, step)[1] for _ in range(5)]
        wall = sorted(walls)[2]
        dev, ge, le = device_ms(torch, step, n=3)
        _, pre_wall = sync_time(torch, prefill)
        pre_dev, pre_ge, _ = device_ms(torch, prefill, n=3)
        print(f"ag_rs decode step ({name}: mode {dc}, batch 4, forward "
              f"only): wall {wall:.2f} ms (median of 5), device {ge}"
              f"{dev:.2f} ms, device idle share {le}{1 - dev / wall:.2f}; "
              f"prefill forward wall {pre_wall:.2f} ms, device "
              f"{pre_ge}{pre_dev:.2f} ms [{card}]", flush=True)
    # Where the prefill's device time goes (the four products a layer on
    # the tensor-core tile, 144 launches).
    for line in device_breakdown(torch, prefill, "ag_rs prefill (4 x 128)"):
        print(line, flush=True)


def ag_kernels_line(records, launches) -> list:
    out = []
    for rec, counter, key in records:
        rec = dict(rec, launches=launches[counter].get(key, 0))
        check(rec["launches"] > 0, f"{rec['name']} never launched on the "
                                   f"ag_rs path")
        out.append(rec)
    return out

# -- slice 4: Qwen3-30B-A3B through the grouped-GEMM, MoE-reduce and all-gather
# kernels -----------------------------------------------------------------------
#: Qwen3-30B-A3B's decode tokens (batch 4) and prefill tokens (4 x 128).
MOE_DECODE_M, MOE_PREFILL_M = 4, 512
#: The three MoE engines: name -> (prefill mode, decode mode, options).
MOE_ENGINES = {"default": ("xla_ar", "gemm_ar", {}),
               "ag_rs": ("ag_rs", "ag_rs", {}),
               "paged_sp": ("sp", "sp", {"paged": True,
                                         "page_size": FD_PAGE})}
#: Prefill (4 x 128) last-position logits and one decode step's logits,
#: kernel path vs plain path with the routing held fixed, after 48 bf16
#: layers: one-ulp differences in a few kernel outputs move every later
#: bf16 rounding, as in phases 5 and 11 (the same limit).
MOE_LOGITS_ATOL = 0.25


def moe_error(torch, got, ref, k: int, pair_mag=None) -> tuple[float, bool]:
    """(max |got - ref|, within tolerance) of a grouped product or a
    MoE-reduce: one bf16 ulp of the larger value plus f32_sum_atol(k);
    with ``pair_mag`` (the reduce over rounded pairs: sum_j w_j |pair_j|)
    also one bf16 ulp of that, for a pair that rounded the other way."""
    diff = (got.float() - ref.float()).abs()
    lim = (BF16_ULP_REL * torch.maximum(got.float().abs(), ref.float().abs())
           + f32_sum_atol(k))
    if pair_mag is not None:
        lim = lim + BF16_ULP_REL * pair_mag
    return diff.max().item(), bool((diff <= lim).all())


def moe_counts(counters) -> dict:
    return {name: c.total for name, c in counters.items()}


def moe_counters(ag, rs, ops, fd, gg, mrs, agk) -> dict:
    out = {"group_gemm": gg.group_gemm_launches,
           "moe_rs": mrs.moe_rs_launches,
           "all_gather": agk.all_gather_launches,
           "ag_gemm": ag.ag_gemm_launches, "gemm_rs": rs.gemm_rs_launches,
           "gemm_ar": ops.launches}
    out.update({f"flash_decode_{n}": c for n, c in fd.launches.items()})
    return out


def phase_moe_load(torch, models, card: str, seed: int):
    print("== phase 12 (setup): Qwen3-30B-A3B drawn on the card", flush=True)
    cfg = models.presets.qwen3_30b_a3b()
    model = models.AutoLLM.build(cfg, sp_axis="sp")
    check(type(model).__name__ == "Qwen3MoE", f"AutoLLM built {model}")
    params, init_ms = sync_time(torch, lambda: model.init(seed))
    print(f"model qwen3_30b_a3b: {cfg.num_hidden_layers} layers hidden "
          f"{cfg.hidden_size} heads {cfg.num_attention_heads}/"
          f"{cfg.num_key_value_heads} head_dim {cfg.head_dim} experts "
          f"{cfg.num_experts} top-{cfg.num_experts_per_tok} expert width "
          f"{cfg.moe_intermediate_size} vocab {cfg.vocab_size}; "
          f"~{models.presets.param_count(cfg) / 1e9:.2f}B params drawn in "
          f"{init_ms:.0f} ms; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB [{card}]",
          flush=True)
    return cfg, model, params


def grouped_bound_ms(live: int, rows: int, pairs: int, k: int, n: int,
                     n_b: int, out_rows: int, extra_bytes: int = 0):
    """(least ms, what bounds it) of a grouped product: the ``rows`` token
    rows (K wide) and the ``live`` experts' ``n_b`` weights (K x N) read
    once, ``out_rows`` x N x n_b outputs written once (bf16), plus
    ``extra_bytes``; 2 * pairs * K * N * n_b operations over the bf16
    peak."""
    by_bytes = ((rows * k + live * n_b * k * n + out_rows * n * n_b) * 2
                + extra_bytes) / HBM_BYTES_PER_S * 1e3
    by_ops = 2.0 * pairs * k * n * n_b / PEAK_FLOPS["bf16"] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase_moe_kernels(torch, gg, mrs, agk, cfg, params, card: str) -> list:
    """Phase 12: the grouped-GEMM (plain gate|up, SwiGLU, down), MoE-reduce
    (rounded and f32 pairs) and all-gather kernels against their plain
    versions at Qwen3-30B-A3B's decode (4 tokens, P = 32 pairs) and
    prefill (512 tokens, P = 4096) shapes, routed by layer 0's seeded
    router. Times cycle the 48 layers' weights (cold in L2, as in a
    forward). Returns the records of the JSON line, ``launches`` still to
    fill from phase 13."""
    print("== phase 12: grouped-GEMM, MoE-reduce and all-gather kernels vs "
          "their plain versions", flush=True)
    from triton_dist_tpu_torch.ops.moe_utils import topk_routing
    gen = torch.Generator(device="cuda").manual_seed(4)
    e, topk = cfg.num_experts, cfg.num_experts_per_tok
    h, inter = cfg.hidden_size, cfg.moe_intermediate_size
    moe = [lp["moe"] for lp in params["layers"]]
    has_grouped_mm = hasattr(torch, "_grouped_mm")
    records = []

    def library_grouped(a_rows, ids, w_cat):
        """One torch._grouped_mm over the pairs sorted by expert (sorted
        and concatenated outside the timing), or None."""
        if not has_grouped_mm:
            return None
        eids = ids.long()
        order = torch.argsort(eids, stable=True)
        a_sorted = a_rows[order].contiguous()
        offs = torch.cumsum(torch.bincount(eids, minlength=e), 0).to(
            torch.int32)
        nl = rotating(w_cat)

        def call():
            return torch._grouped_mm(a_sorted, nl(), offs=offs)
        try:                          # a yardstick only: the port never calls it
            call()
        except RuntimeError as err:
            print(f"torch._grouped_mm refused these operands: {err}",
                  flush=True)
            return None
        return call

    for m in (MOE_DECODE_M, MOE_PREFILL_M):
        p = m * topk
        x = torch.randn((m, h), generator=gen, device="cuda").to(cfg.dtype)
        w, idx = topk_routing(x.float() @ moe[0]["w_router"], topk)
        ids = idx.reshape(-1)
        live = int(torch.unique(ids).numel())
        pairs_x = x.repeat_interleave(topk, 0)
        act = torch.randn((p, inter), generator=gen, device="cuda").to(
            cfg.dtype)
        gate_up = [[lp["w_gate"], lp["w_up"]] for lp in moe]
        downs = [lp["w_down"] for lp in moe]
        cat_gu = ([torch.cat(gu, dim=2) for gu in gate_up[:2]]
                  if has_grouped_mm else None)
        plan = gg.plan(p, e, h, inter, cfg.dtype)
        plan_dn = gg.plan(p, e, inter, h, cfg.dtype)
        cases = [
            ("group_gemm[gate|up]", "group_gemm",
             (plan.path, plan.m_blk, "plain", p, h, (inter, inter)),
             lambda ws: gg.grouped_matmul_multi(x, ws, ids, e, topk),
             lambda ws: [gg.grouped_matmul_reference(x, wt, ids, e, topk)
                         for wt in ws], gate_up, h,
             grouped_bound_ms(live, m, p, h, inter, 2, p),
             library_grouped(pairs_x, ids, cat_gu) if cat_gu else None,
             "triton_dist_tpu/ops/group_gemm.py:139"),
            ("group_gemm[swiglu]", "group_gemm",
             (plan.path, plan.m_blk, "swiglu", p, h, (inter, inter)),
             lambda ws: [gg.grouped_swiglu(x, ws[0], ws[1], ids, e, topk)],
             lambda ws: [gg.grouped_swiglu_reference(x, ws[0], ws[1], ids,
                                                     e, topk)], gate_up, h,
             grouped_bound_ms(live, m, p, h, inter, 2, p // 2),
             library_grouped(pairs_x, ids, cat_gu) if cat_gu else None,
             "triton_dist_tpu/ops/group_gemm.py:139"),
            ("group_gemm[down]", "group_gemm",
             (plan_dn.path, plan_dn.m_blk, "plain", p, inter, (h,)),
             lambda ws: [gg.grouped_matmul(act, ws, ids, e)],
             lambda ws: [gg.grouped_matmul_reference(act, ws, ids, e)],
             downs, inter, grouped_bound_ms(live, p, p, inter, h, 1, p),
             library_grouped(act, ids, downs[:4]),
             "triton_dist_tpu/ops/group_gemm.py:139"),
        ]
        ctx = mrs.create_moe_rs_context(num_experts=e, topk=topk)
        for impl, tag in (("ring", "rounded"), ("fused", "f32")):
            cases.append((
                f"moe_rs[{tag} pairs]", "moe_rs",
                (plan_dn.path, plan_dn.m_blk, tag, p, inter, h),
                lambda ws, impl=impl: [mrs.moe_reduce_rs(act, ws, ids, w,
                                                         ctx, impl)],
                lambda ws, impl=impl: [mrs.moe_reduce_rs_reference(
                    act, ws, ids, w, e, impl == "ring")],
                downs, inter,
                grouped_bound_ms(live, p, p, inter, h, 1, m,
                                 extra_bytes=p * 4),
                library_grouped(act, ids, downs[:4]),
                "triton_dist_tpu/ops/moe_reduce_rs.py:72"))
        for (name, counter, key, kernel, plain, sets, k, (bnd, by), lib,
             replaces) in cases:
            got, again = kernel(sets[0]), kernel(sets[0])
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} P={p}: repeat differs")
            ref = plain(sets[0])
            if name.startswith("group_gemm[swiglu"):
                g = gg.grouped_matmul_reference(x, sets[0][0], ids, e, topk,
                                                torch.float32)
                u = gg.grouped_matmul_reference(x, sets[0][1], ids, e, topk,
                                                torch.float32)
                diff = (got[0].float() - ref[0].float()).abs()
                lim = (BF16_ULP_REL * torch.maximum(got[0].float().abs(),
                                                    ref[0].float().abs())
                       + 2.0 ** -16 * (torch.nn.functional.silu(g).abs()
                                       + 1.1 * u.abs()) + 1e-6)
                err, ok = diff.max().item(), bool((diff <= lim).all())
                tol = "1 bf16 ulp + 2^-16 (|silu(g)| + 1.1|u|) + 1e-6"
            elif counter == "moe_rs":
                mag = None
                if key[2] == "rounded":
                    pair = gg.grouped_matmul_reference(act, sets[0], ids, e)
                    mag = (pair.float().abs().reshape(m, topk, -1)
                           * w[..., None]).sum(1)
                err, ok = moe_error(torch, got[0], ref[0], k, mag)
                tol = (f"1 bf16 ulp + {f32_sum_atol(k):.2g}"
                       + (" + 1 ulp of sum w|pair|" if mag is not None
                          else ""))
            else:
                pairs = [moe_error(torch, a, b, k) for a, b in zip(got, ref)]
                err, ok = max(q for q, _ in pairs), all(o for _, o in pairs)
                tol = f"1 bf16 ulp + {f32_sum_atol(k):.2g}"
            check(ok, f"{name} P={p}: max abs err {err} outside tolerance "
                      f"({tol})")
            nk, np_ = rotating(sets), rotating(sets)
            ms = queued_ms(torch, lambda: kernel(nk()))
            wall = wall_ms(torch, lambda: kernel(nk()))
            plain_ms = queued_ms(torch, lambda: plain(np_()), n=3,
                                 may_wait=True)
            lib_ms = queued_ms(torch, lib) if lib is not None else None
            moe_rs = counter == "moe_rs"
            pl = plan_dn if key[4] == inter else plan
            lib_txt = (f"{lib_ms:.4f} (torch._grouped_mm"
                       f"{', no epilogue' if 'swiglu' in name else ''}"
                       f"{', the grouped product only' if moe_rs else ''})"
                       if lib_ms is not None else "—")
            print(f"kernel {name} bf16 P={p} ({m} tokens, {live} live "
                  f"experts, {pl.path}, {pl.m_blk}-row tiles, {pl.cols}-"
                  f"column items): max_abs_err="
                  f"{err:.3g} (tol {tol}) ok, repeat bit-identical; "
                  f"kernel_ms={ms:.4f} (wall {wall:.4f}) plain_ms="
                  f"{plain_ms:.4f} library_ms={lib_txt} bound_ms={bnd:.4f} "
                  f"({by}) [{card}]", flush=True)
            if key[2] == "f32":
                continue       # the fused numerics: not on the served path
            records.append(({
                "name": f"{name} P={p}", "route": "cuda",
                "source": ("triton_dist_tpu_torch/csrc/moe_rs.cu"
                           if counter == "moe_rs" else
                           "triton_dist_tpu_torch/csrc/group_gemm.cu"),
                "replaces": replaces, "launches": 0, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                "bound_by": by, "library_ms": lib_ms, "wall_ms": wall,
                "shape": [m, topk, k, list(key[-1]) if counter ==
                          "group_gemm" else key[-1]], "live_experts": live,
                "plan": pl._asdict(), "ok": ok}, counter, key))
        del cat_gu

        # The all-gather of the token rows.
        got = agk.all_gather(x)
        torch.cuda.synchronize()
        check(torch.equal(got, x) and torch.equal(agk.all_gather(x), got),
              f"all_gather ({m}, {h}) differs from its input")
        nbytes = x.numel() * x.element_size()
        out = torch.empty_like(x)
        ms = queued_ms(torch, lambda: agk.all_gather(x))
        wall = wall_ms(torch, lambda: agk.all_gather(x))
        plain_ms = queued_ms(torch, lambda: agk.all_gather_reference(x),
                             may_wait=True)
        lib_ms = queued_ms(torch, lambda: out.copy_(x))
        bnd = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        print(f"kernel all_gather bf16 ({m}, {h}): equal to its input "
              f"(tol exact), repeat bit-identical; kernel_ms={ms:.4f} (wall "
              f"{wall:.4f}) plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"(Tensor.copy_) bound_ms={bnd:.5f} (bytes) [{card}]",
              flush=True)
        records.append(({
            "name": f"all_gather ({m}, {h})", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/allgather.cu",
            "replaces": "triton_dist_tpu/ops/allgather.py:254",
            "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": "bytes",
            "library_ms": lib_ms, "wall_ms": wall, "shape": [m, h],
            "ok": True}, "all_gather", (m, h * x.element_size())))
    return records


def phase_moe_main(torch, models, counters, cfg, model, params, card: str,
                   seed: int):
    """Phase 13: Qwen3-30B-A3B served by the default (prefill xla_ar, decode
    gemm_ar), all-ag_rs and paged sp engines through serve, serve_ragged
    (not sp), serve_stream and the server, with the launch counts of every
    prefill and decode step. Returns (engines, the square prompts, tokens
    by engine, launches by counter and key)."""
    print("== phase 13: Qwen3-30B-A3B served through the grouped-GEMM, "
          "MoE-reduce and all-gather kernels", flush=True)
    engines = {name: models.Engine(model, batch=4, max_seq=1024,
                                   prefill_mode=pf, decode_mode=dc, **kw)
               for name, (pf, dc, kw) in MOE_ENGINES.items()}
    square, stream = sp_prompts(torch, cfg, seed + 10)
    mixed = [p[:n] for p, n in zip(square, (128, 77, 33, 101))]
    for eng in engines.values():                       # warm-up
        eng.serve(params, square, 2)
    for c in counters.values():                        # ---- the main path
        c.reset()
    steps = GEN - 1
    tokens = {}
    for name, (pf, dc, _) in MOE_ENGINES.items():
        eng = engines[name]
        before = moe_counts(counters)
        _, prefill_ms = sync_time(torch, lambda: eng.serve(params, square, 1))
        mid = moe_counts(counters)
        out, serve_ms = sync_time(torch,
                                  lambda: eng.serve(params, square, GEN))
        after = moe_counts(counters)
        per_prefill = {k: mid[k] - before[k] for k in mid
                       if mid[k] != before[k]}
        per_step = {}
        for k in after:
            extra = after[k] - mid[k] - per_prefill.get(k, 0)
            check(extra % steps == 0, f"({name}) {k}: {extra} launches over "
                                      f"{steps} steps")
            if extra:
                per_step[k] = extra // steps
        layers = cfg.num_hidden_layers
        for k, want in (("group_gemm", layers * (2 if pf == "sp" else 1)),
                        ("moe_rs", 0 if pf == "sp" else layers),
                        ("all_gather", layers if pf == "ag_rs" else 0)):
            check(per_prefill.get(k, 0) == want,
                  f"({name}) prefill {k} launches {per_prefill}")
        for k, want in (("group_gemm", layers * (2 if dc == "sp" else 1)),
                        ("moe_rs", 0 if dc == "sp" else layers),
                        ("all_gather", 0 if dc == "sp" else layers)):
            check(per_step.get(k, 0) == want,
                  f"({name}) decode step {k} launches {per_step}")
        check(tuple(out.shape) == (4, 128 + GEN), f"({name}) serve shape")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "token out of vocabulary")
        tokens[name] = out
        decode_ms = serve_ms - prefill_ms
        print(f"moe serve ({name}: prefill {pf}, decode {dc}): batch 4 x 128"
              f" prompt, {GEN} new tokens: prefill_ms={prefill_ms:.1f} "
              f"decode_ms={decode_ms:.1f} per_step_ms={decode_ms / steps:.2f}"
              f" decode_tokens_per_s={4 * steps / decode_ms * 1e3:.1f}; "
              f"launches per prefill {per_prefill}, per decode step "
              f"{per_step} [{card}]", flush=True)
        if pf != "sp":
            before = moe_counts(counters)
            rows, ragged_ms = sync_time(
                torch, lambda: eng.serve_ragged(params, mixed, 16))
            check([len(r) for r in rows] == [len(q) + 16 for q in mixed],
                  f"({name}) serve_ragged row lengths")
            got = {k: v - before[k] for k, v in moe_counts(counters).items()}
            check(got["group_gemm"] > 0 and got["moe_rs"] > 0,
                  f"({name}) serve_ragged launches {got}")
            print(f"moe serve_ragged ({name}): lengths "
                  f"{[len(q) for q in mixed]}, 16 new tokens in "
                  f"{ragged_ms:.1f} ms; grouped-GEMM launches "
                  f"{got['group_gemm']}, MoE-reduce {got['moe_rs']} [{card}]",
                  flush=True)
        before = moe_counts(counters)
        res, stream_ms = sync_time(
            torch, lambda: eng.serve_stream(params, stream, GEN))
        check([len(r) for r in res] == [len(q) + GEN for q in stream],
              f"({name}) serve_stream row lengths")
        got = {k: v - before[k] for k, v in moe_counts(counters).items()}
        check(got["group_gemm"] > 0, f"({name}) stream launches {got}")
        print(f"moe serve_stream ({name}): 6 prompts sharing a "
              f"{PREFIX_LEN}-token prefix through 4 rows, {GEN} new tokens "
              f"in {stream_ms:.1f} ms; grouped-GEMM launches "
              f"{got['group_gemm']}, MoE-reduce {got['moe_rs']}, all-gather "
              f"{got['all_gather']} [{card}]", flush=True)
        phase_moe_server(torch, eng, params, square, stream, mixed, name,
                         card)
    launches = {name: dict(c.by_shape) for name, c in counters.items()}
    print(f"moe main path launches: group_gemm {launches['group_gemm']}; "
          f"moe_rs {launches['moe_rs']}; all_gather "
          f"{launches['all_gather']}", flush=True)       # ---- main path ends
    for name in ("group_gemm", "moe_rs", "all_gather"):
        check(counters[name].total > 0, f"{name} never launched")
    return engines, square, tokens, launches


def phase_moe_server(torch, eng, params, square, stream, mixed, name,
                     card) -> None:
    from triton_dist_tpu_torch.serving.client import ChatClient
    from triton_dist_tpu_torch.serving.server import ModelServer
    srv = ModelServer(eng, params, host="127.0.0.1", port=0).start()
    try:
        with ChatClient(srv.host, srv.port, timeout=600) as client:
            for batch, route in ((square, "serve"), (stream, "serve_stream"),
                                 (mixed, "serve_ragged")):
                t0 = time.perf_counter()
                reply = client.generate_ids(batch, 8)
                ms = (time.perf_counter() - t0) * 1e3
                if route == "serve_ragged" and eng.paged:
                    check("non-ragged" in reply.get("error", ""),
                          f"({name}) ragged prompts were not refused")
                    print(f"moe server ({name}): ragged prompts get the "
                          f"error reply", flush=True)
                    continue
                check("tokens" in reply, f"server error: {reply}")
                if route == "serve":
                    rows = eng.serve(params, batch, 8).tolist()
                elif route == "serve_stream":
                    rows = eng.serve_stream(params, batch, 8)
                else:
                    rows = [r.tolist() for r in
                            eng.serve_ragged(params, batch, 8)]
                want = [r[len(q):] for r, q in zip(rows, batch)]
                check(reply["tokens"] == want,
                      f"({name}) server reply differs from {route}")
                print(f"moe server ({name}): {len(batch)} prompts -> 8 tokens"
                      f" each, equal to Engine.{route}; {ms:.1f} ms round "
                      f"trip [{card}]", flush=True)
    finally:
        srv.stop()


def phase_moe_checks(torch, gg, mrs, agk, ag, rs, engines, cfg, params,
                     square, tokens, card: str) -> None:
    """Phase 13, checks: the kernel path against the plain path with the
    routing held fixed (prefill logits and one decode step, mode ag_rs);
    free-running greedy agreement and flipped routing decisions (printed,
    not gated); one TPMoE layer under sync debug "error"; each engine's
    decode step wall vs device time."""
    from triton_dist_tpu_torch.layers import tp_attn, tp_moe
    from triton_dist_tpu_torch.models import KVCacheManager
    model = engines["ag_rs"].model
    ids = torch.tensor(square, device="cuda")
    routing = tp_moe.topk_routing

    def run(mode_fixed=None):
        """(prefill last logits, decode step logits, routing per call) in
        mode ag_rs; ``mode_fixed``: routing to replay, in call order."""
        seen = []

        def route(logits, k, norm=True):
            out = (mode_fixed.pop(0) if mode_fixed is not None
                   else routing(logits, k, norm))
            seen.append(out)
            return out
        tp_moe.topk_routing = route
        try:
            kv = KVCacheManager(cfg.num_hidden_layers, 4, 1024,
                                cfg.num_key_value_heads, cfg.head_dim,
                                dtype=cfg.dtype, device="cuda")
            caches = kv.init()
            with torch.no_grad():
                logits, caches = model.forward(params, ids, caches, 0,
                                               mode="ag_rs")
                tok = logits[:, -1].argmax(-1)[:, None]
                step, _ = model.forward(params, tok, caches, 128,
                                        mode="ag_rs")
        finally:
            tp_moe.topk_routing = routing
        return logits[:, -1], step[:, 0], seen

    def plain_path():
        """Patch the plain versions in at the call sites of this path."""
        saved = (ag.launch_gemm, tp_attn.gemm_rs, tp_moe.all_gather,
                 tp_moe.grouped_matmul_multi, tp_moe.moe_reduce_rs)
        ag.launch_gemm = lambda a, bs, count: ag.ag_gemm_multi_reference(
            a, bs)
        tp_attn.gemm_rs = rs.gemm_rs_reference
        tp_moe.all_gather = (lambda x, ctx=None, impl="pallas",
                             stacked=False: agk.all_gather_reference(
                                 x, 1, stacked))
        tp_moe.grouped_matmul_multi = lambda t, ws, i, e, topk=1: [
            gg.grouped_matmul_reference(t, w, i, e, topk) for w in ws]
        tp_moe.moe_reduce_rs = lambda a, w, i, wt, ctx, impl="ring": (
            mrs.moe_reduce_rs_reference(a, w, i, wt, ctx.num_experts,
                                        impl in mrs.ROUNDED_IMPLS))
        return saved

    def restore(saved):
        (ag.launch_gemm, tp_attn.gemm_rs, tp_moe.all_gather,
         tp_moe.grouped_matmul_multi, tp_moe.moe_reduce_rs) = saved

    got_pre, got_step, seen = run()
    saved = plain_path()
    try:
        ref_pre, ref_step, _ = run(list(seen))
        free_pre, free_step, free_seen = run()
        plain_tokens = engines["ag_rs"].serve(params, square, GEN)
    finally:
        restore(saved)
    for what, got, ref in (("prefill (4 x 128) last-position", got_pre,
                            ref_pre), ("decode step", got_step, ref_step)):
        check(bool(torch.isfinite(got).all()), f"non-finite moe {what} "
                                               f"logits")
        err = (got - ref).abs().max().item()
        same = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        check(err <= MOE_LOGITS_ATOL, f"moe {what} logits differ by {err}")
        print(f"moe logits (mode ag_rs, routing held fixed): {what} logits "
              f"through the kernels vs the plain versions max abs diff "
              f"{err:.4g} (tol {MOE_LOGITS_ATOL}), argmax agreement "
              f"{same:.2f} [{card}]", flush=True)
    flips = sum(int((torch.sort(a[1], -1)[0] != torch.sort(b[1], -1)[0])
                    .any(-1).sum()) for a, b in zip(seen, free_seen))
    decisions = sum(int(a[1].shape[0]) for a in seen)
    same = (tokens["ag_rs"][:, 128:] == plain_tokens[:, 128:]).float()
    print(f"moe free-running (not gated): the plain path routes "
          f"{flips} of {decisions} token-layer decisions (prefill + one "
          f"step) to another expert set; greedy tokens of the ag_rs engine "
          f"equal to the plain path's on {same.mean().item():.3f} of "
          f"positions [{card}]", flush=True)

    # One MoE layer under sync debug "error": no host round trip.
    layer = params["layers"][0]["moe"]
    for m in (MOE_DECODE_M, MOE_PREFILL_M):
        x = torch.randn((m, cfg.hidden_size), device="cuda").to(cfg.dtype)
        model.moe(layer, x, mode="ag_rs")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = model.moe(layer, x, mode="ag_rs")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(bool(torch.isfinite(y).all()), "non-finite TPMoE output")
        print(f"moe layer ({m} tokens, mode ag_rs) ran under "
              f"torch.cuda.set_sync_debug_mode('error'): no host sync",
              flush=True)

    for name, (pf, dc, _) in MOE_ENGINES.items():
        eng = engines[name]
        if eng.paged:
            fn = sp_step(torch, eng, params, square)
        else:
            kv = KVCacheManager(cfg.num_hidden_layers, 4, 1024,
                                cfg.num_key_value_heads, cfg.head_dim,
                                dtype=cfg.dtype, device="cuda")
            caches = kv.init()
            with torch.no_grad():
                model.forward(params, ids, caches, 0, mode=pf)

            def fn():
                with torch.no_grad():
                    return model.forward(params, ids[:, :1], caches, 128,
                                         mode=dc)[0]
        walls = [sync_time(torch, fn)[1] for _ in range(5)]
        wall = sorted(walls)[2]
        dev, ge, le = device_ms(torch, fn, n=3)
        print(f"moe decode step ({name}: mode {dc}, batch 4, forward only): "
              f"wall {wall:.2f} ms (median of 5), device {ge}{dev:.2f} ms, "
              f"device idle share {le}{1 - dev / wall:.2f} [{card}]",
              flush=True)
        for line in device_breakdown(torch, fn, f"moe decode step ({name})"):
            print(line, flush=True)


def moe_kernels_line(records, launches) -> list:
    out = []
    for rec, counter, key in records:
        rec = dict(rec, launches=launches[counter].get(key, 0))
        check(rec["launches"] > 0, f"{rec['name']} never launched on the "
                                   f"MoE path")
        out.append(rec)
    return out


# -- slice 5: SP long-context prefill through the flash-prefill kernel, SP
# decode over its cache, and the world = 1 collectives -------------------------
#: One 32k-token prompt at Qwen3-8B's attention width, then decode steps.
SP_S, SP_DECODE = 32768, 32
#: Phase 14's cases: (name, dtype, causal, B, S, KV heads); query heads and
#: head dim are Qwen3-8B's (32, 128). 8 KV heads: G = 4 (Qwen3-8B); 4: G = 8
#: (Qwen3-30B-A3B's). S = 1000 is no multiple of the 128-wide bf16 tiles
#: (nor of the f32 kernel's 64-wide ones).
SP_CASES = [("qwen3_8b_32k", "bf16", True, 1, SP_S, 8),
            ("b4_4096", "bf16", True, 4, 4096, 8),
            ("full_4096", "bf16", False, 1, 4096, 8),
            ("g8_4096", "bf16", True, 1, 4096, 4),
            ("odd_1000", "bf16", True, 2, 1000, 8),
            ("f32_b4_4096", "f32", True, 4, 4096, 8),
            ("f32_odd_1000", "f32", True, 1, 1000, 8),
            ("f32_full_g8_1000", "f32", False, 1, 1000, 4)]
#: The functional impls held against "ring", and the collectives' shapes.
SP_IMPL_S = 4096
COLL_SHAPES = ((1, 4, 4096), (1, 512, 4096))


def sp_error(got, ref, lim) -> tuple[float, bool, float]:
    """(max |got - ref|, within the elementwise limit ``lim`` everywhere,
    the largest share of its limit that an element uses). The limits are
    the port's own: ``sp_attention_tolerance`` for the flash prefill and
    ``bf16_attention_limit`` for flash decode (ops/sp_attention.py)."""
    diff = (got.float() - ref.float()).abs()
    return (diff.max().item(), bool((diff <= lim).all()),
            (diff / lim).max().item())


def zero_middle_tile(x, tile):
    """A copy of k or v (B, S, H, D) with the KV tile that holds position
    S // 2 zeroed: a planted fault, for the deep rows of a causal pass."""
    bad = x.clone()
    first = x.shape[1] // 2 // tile * tile
    bad[:, first:first + tile] = 0
    return bad


def fd_weight(fd, q, k, v, kv_len):
    """sum_j (p_j / l) |v_j| for each element of a decode output (f32):
    the plain flash decode in f32 over |v|."""
    return fd.flash_decode_reference(q.float(), k.float(), v.float().abs(),
                                     kv_len).float()


def sp_bound_ms(b, s, hq, hkv, d, itemsize, kind, causal):
    """(least ms, what bounds it) of one prefill attention: q, k, v read
    once and the output written once over HBM; 4 * D operations per
    (query head, live (query, key) pair), S (S + 1) / 2 pairs when
    causal."""
    by_bytes = 2 * b * s * (hq + hkv) * d * itemsize / HBM_BYTES_PER_S * 1e3
    pairs = s * (s + 1) / 2 if causal else s * s
    by_ops = 4.0 * b * hq * d * pairs / PEAK_FLOPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def sp_tflops(b, s, hq, d, causal, ms) -> float:
    """TFLOP/s of one prefill attention in ``ms``: 4 D operations per
    (query head, live (query, key) pair), as ``sp_bound_ms`` counts."""
    pairs = s * (s + 1) / 2 if causal else s * s
    return 4.0 * b * hq * d * pairs / ms / 1e9


def sp_operands(torch, dtype, b, s, hq, hkv, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((b, s, h, d), generator=gen,
                             device="cuda").to(dtype)
                 for h in (hq, hkv, hkv))


def phase_sp_attn_kernels(torch, sp, cfg, card: str):
    """Phase 14: the flash-prefill kernel against its plain version over
    SP_CASES, each held to ``sp_attention_tolerance`` and then, as a
    planted fault, with the KV tile at S / 2 zeroed for the kernel only,
    which the same limit must refuse. Times come from CUDA events around
    back-to-back calls (``wall_ms``): each call keeps the card busy for
    far longer than its host overhead, and in a full run the profiler
    missed most launches of the 34 ms kernel. Returns (the record of the
    JSON line, ``launches`` still to fill from phase 15, and the full
    case's (q, k, v, kernel output))."""
    import torch.nn.functional as F
    print("== phase 14: flash-prefill kernel vs sp_attention_fused_reference",
          flush=True)
    hq, d = cfg.num_attention_heads, cfg.head_dim
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    record, full = None, None
    for i, (name, dt, causal, b, s, hkv) in enumerate(SP_CASES):
        dtype = dtypes[dt]
        q, k, v = sp_operands(torch, dtype, b, s, hq, hkv, d, seed=40 + i)
        got = sp.launch_sp_attention(q, k, v, causal)
        again = sp.launch_sp_attention(q, k, v, causal)
        torch.cuda.synchronize()
        ref = sp.sp_attention_fused_reference(q, k, v, causal,
                                              t_sub=sp.KV_TILE)
        lim = sp.sp_attention_tolerance(got, ref, q, k, v, causal)
        err, ok, used = sp_error(got, ref, lim)
        bad = sp.launch_sp_attention(q, zero_middle_tile(k, sp.KV_TILE),
                                     zero_middle_tile(v, sp.KV_TILE), causal)
        bad_err, bad_ok, bad_used = sp_error(bad, ref, lim)
        del lim, bad
        same = torch.equal(got, again)
        finite = bool(torch.isfinite(got.float()).all())
        kernel = lambda: sp.launch_sp_attention(q, k, v, causal)  # noqa: E731
        ms = wall_ms(torch, kernel, n=5 if s > 4096 else 20)
        bnd, by = sp_bound_ms(b, s, hq, hkv, d, q.element_size(), dt, causal)
        tol = ("2^-7 max|out| + 2^-8 sum_j (p_j/l)|v_j|" if dt == "bf16"
               else sp.SP_F32_ATOL)
        rate = sp_tflops(b, s, hq, d, causal, ms)
        peak = PEAK_FLOPS[dt] / 1e12
        print(f"sp_attention {name} {dt} causal={causal} B={b} S={s} "
              f"heads {hq}/{hkv} D={d}: max_abs_err={err:.3e} (tol {tol}, "
              f"largest share used {used:.3f}) ok={ok}; planted fault "
              f"(KV tile at S/2 zeroed): max_abs_err={bad_err:.3e}, share "
              f"{bad_used:.3f}, refused={not bad_ok}; repeat "
              f"bit-identical={same} finite={finite} kernel_ms={ms:.3f} "
              f"({rate:.0f} TFLOP/s, {rate / peak:.3f} of {peak:.0f}) "
              f"bound_ms={bnd:.3f} ({by}) [{card}]", flush=True)
        check(ok and same and finite and not bad_ok,
              f"sp_attention {name}: err {err}, repeat {same}, finite "
              f"{finite}, planted fault refused {not bad_ok}")
        if name == "qwen3_8b_32k":
            plain_ms = wall_ms(
                torch, lambda: sp.sp_attention_fused_reference(
                    q, k, v, causal, t_sub=sp.KV_TILE), n=1)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib_ms = wall_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), n=5)
            del qt, kt, vt
            print(f"sp_attention {name}: plain_ms={plain_ms:.1f} "
                  f"library_ms={lib_ms:.3f} (scaled_dot_product_attention, "
                  f"is_causal, enable_gqa; "
                  f"{sp_tflops(b, s, hq, d, causal, lib_ms):.0f} TFLOP/s); "
                  f"kernel / library {ms / lib_ms:.2f} [{card}]", flush=True)
            record = {
                "name": "sp_attention", "route": "cuda",
                "source": "triton_dist_tpu_torch/csrc/sp_attention.cu",
                "replaces": "triton_dist_tpu/ops/sp_attention.py:147",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                "library_ms": lib_ms, "shape": [b, s, hq, hkv, d], "ok": ok,
                "tol_share": used, "fault_tol_share": bad_used}
            full = (q, k, v, got)
        del q, k, v, got, again, ref
    return record, full


def sp_counters(sp, fd, agk, ar, rs) -> dict:
    out = {"sp_attention": sp.sp_attention_launches,
           "all_gather": agk.all_gather_launches,
           "broadcast": agk.broadcast_launches,
           "all_reduce": ar.all_reduce_launches,
           "reduce_scatter": rs.reduce_scatter_launches}
    out.update({f"flash_decode_{n}": c for n, c in fd.launches.items()})
    return out


def phase_sp_attn_main(torch, layers, sp, fd, agk, ar, rs, cfg, full,
                       card: str) -> dict:
    """Phase 15, the main path of this slice, with every count set to 0
    just before it: ``SpAttentionLayer(impl="pallas")`` prefill of the
    32k prompt, ``SpFlashDecodeLayer`` decode steps over its cache,
    ``sp_ag_attention`` in every impl at SP_IMPL_S, and the collectives
    at COLL_SHAPES. Returns the launch counts by counter and key."""
    print("== phase 15: SP prefill (32k) and decode through the layers, the "
          "impls and the collectives", flush=True)
    counters = sp_counters(sp, fd, agk, ar, rs)
    hq, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    q, k, v, want = full
    for c in counters.values():
        c.reset()                                  # ---- main path starts
    prefill = layers.SpAttentionLayer(impl="pallas")
    t0 = time.perf_counter()
    out = prefill(q, k, v)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(sp.sp_attention_launches.total == 1,
          f"prefill launched the kernel {sp.sp_attention_launches.total} "
          f"times, not once")
    check(torch.equal(out, want), "the layer's prefill differs from the "
                                  "kernel's output on the same inputs")
    print(f"SpAttentionLayer(impl='pallas') prefill B=1 S={SP_S}: 1 kernel "
          f"launch, equal to phase 14's kernel output, wall "
          f"{prefill_s * 1e3:.1f} ms [{card}]", flush=True)

    decode = layers.SpFlashDecodeLayer(1, SP_S + SP_DECODE, hkv, d,
                                       dtype=torch.bfloat16)
    cache = decode.append(decode.init_cache(), k, v, 0)
    gen = torch.Generator(device="cuda").manual_seed(77)
    worst, share, per_step = 0.0, 0.0, set()
    t0 = time.perf_counter()
    for i in range(SP_DECODE):
        qn = torch.randn((1, hq, d), generator=gen, device="cuda").bfloat16()
        kn, vn = (torch.randn((1, 1, hkv, d), generator=gen,
                              device="cuda").bfloat16() for _ in range(2))
        cache = decode.append(cache, kn, vn, SP_S + i)
        before = sum(c.total for c in fd.launches.values())
        got = decode(qn, cache, SP_S + i + 1)
        per_step.add(sum(c.total for c in fd.launches.values()) - before)
        ref = fd.flash_decode_reference(qn, cache[0], cache[1], SP_S + i + 1)
        lim = sp.bf16_attention_limit(
            got, ref, fd_weight(fd, qn, cache[0], cache[1], SP_S + i + 1))
        err, ok, used = sp_error(got, ref, lim)
        check(ok, f"decode step {i}: max abs err {err} outside tolerance")
        worst, share = max(worst, err), max(share, used)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(per_step == {1} and fd.launches["combine"].total == 0,
          f"decode steps launched {per_step} flash-decode kernels, not the "
          f"one fused launch")
    print(f"SpFlashDecodeLayer: {SP_DECODE} append + decode steps over the "
          f"{SP_S}-position cache (max_seq {SP_S + SP_DECODE}), 1 launch "
          f"per step (the partial with its merge), max_abs_err vs "
          f"flash_decode_reference {worst:.3e} (tol 2^-7 max|out| + 2^-8 "
          f"sum_j (p_j/l)|v_j|, largest share used {share:.3f}), wall "
          f"{decode_s * 1e3 / SP_DECODE:.2f} ms per step incl. the plain "
          f"check [{card}]", flush=True)
    del cache, decode

    qs, ks, vs = (x[:, :SP_IMPL_S].contiguous() for x in (q, k, v))
    ring = sp.sp_ag_attention(qs, ks, vs, impl="ring")
    for impl in ("xla", "ulysses", "ag_pallas"):
        check(torch.equal(sp.sp_ag_attention(qs, ks, vs, impl=impl), ring),
              f"sp_ag_attention impl={impl} differs from ring")
    fused = sp.sp_ag_attention(qs, ks, vs, impl="pallas")
    err, ok, used = sp_error(fused, ring, sp.sp_attention_tolerance(
        fused, ring, qs, ks, vs))
    del fused
    check(ok, f"sp_ag_attention impl=pallas: max abs err {err} vs ring")
    print(f"sp_ag_attention S={SP_IMPL_S}: xla, ulysses and ag_pallas equal "
          f"to ring bit for bit; pallas within the bf16 tolerance "
          f"(max_abs_err {err:.3e}, largest share used {used:.3f}) "
          f"[{card}]", flush=True)
    del qs, ks, vs, ring

    gen = torch.Generator(device="cuda").manual_seed(78)
    for shape in COLL_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        for method in ar.AllReduceMethod:
            ctx = ar.create_allreduce_context(method=method)
            ran = ar.resolve_method(ctx, x.shape[1],
                                    x[0].numel() * x.element_size())
            check(torch.equal(ar.all_reduce(x, ctx),
                              ar.all_reduce_world_reference(x, ran)),
                  f"all_reduce {method.value} {shape} differs")
        for method in rs.ReduceScatterMethod:
            ctx = rs.create_reduce_scatter_context(method=method)
            check(torch.equal(rs.reduce_scatter(x, ctx),
                              rs.reduce_scatter_world_reference(
                                  x, ctx.resolve_method(
                                      x[0].numel() * x.element_size()))),
                  f"reduce_scatter {method.value} {shape} differs")
        check(torch.equal(agk.broadcast(x[0]), agk.broadcast_reference(x[0])),
              f"broadcast {shape} differs")
    torch.cuda.synchronize()
    launches = {name: dict(c.by_shape) for name, c in counters.items()}
    print(f"sp main path launches: "
          f"{ {n: c.total for n, c in counters.items()} }", flush=True)
    print(f"collectives {COLL_SHAPES} bf16: every all_reduce method, every "
          f"reduce_scatter method and broadcast equal to their plain "
          f"versions (tol exact) [{card}]", flush=True)
    return launches


def sp_fd_records(torch, sp, fd, cfg, card: str) -> list:
    """The flash-decode kernels at the decode steps' last shape (kv_len
    SP_S + SP_DECODE over a cache of that many positions), with
    ``launches`` to fill from phase 15: the path's fused launch (the
    partial with its merge tail), held bit-equal to the partial plus the
    standalone combine and, with one split left out of its merge (the
    planted fault), refused by the weight rule; and the standalone
    combine, off the path."""
    import torch.nn.functional as F
    hq, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    t = SP_S + SP_DECODE
    gen = torch.Generator(device="cuda").manual_seed(79)
    q = torch.randn((1, hq, d), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((1, t, hkv, d), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = fd.plan(1, hkv, t, sms)
    parts = fd.flash_decode_partial(q, k, v, t, p.split_len, p.splits)
    part_bytes = sum(x.numel() * 4 for x in parts)
    q_bytes = out_bytes = hq * d * 2
    kv_bytes = 2 * t * hkv * d * 2
    got = fd.flash_decode_tiled(q, k, v, t, p.split_len, p.splits)
    same = torch.equal(got, fd.flash_decode_combine(*parts, torch.bfloat16))
    want = fd.flash_decode_reference(q, k, v, t)
    lim = sp.bf16_attention_limit(got, want, fd_weight(fd, q, k, v, t))
    err, ok, used = sp_error(got, want, lim)
    # A planted fault: the middle split left out of the fused launch's
    # merge; the same limit must refuse it.
    drop = p.splits // 2
    bad_err, bad_ok, bad_used = sp_error(
        fd.flash_decode_tiled(q, k, v, t, p.split_len, p.splits, fault=drop),
        want, lim)
    print(f"flash decode at kv_len {t} (one fused launch, {p.splits} splits "
          f"of {p.split_len}): max_abs_err={err:.3e} (tol 2^-7 max|out| + "
          f"2^-8 sum_j (p_j/l)|v_j|, largest share used {used:.3f}) "
          f"ok={ok}; bit-equal to partial + standalone combine: {same}; "
          f"planted fault (split {drop} left out of the fused merge): "
          f"max_abs_err={bad_err:.3e}, share {bad_used:.3f}, refused="
          f"{not bad_ok} [{card}]", flush=True)
    check(ok and same and not bad_ok,
          f"flash decode at kv_len {t}: max abs err {err}, bit-equal to "
          f"partial + combine {same}, planted fault refused {not bad_ok}")
    del lim
    qs, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = queued_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kt, vt, enable_gqa=True))
    ctx = fd.FlashDecodeContext()      # its tickets serve every call
    cases = [
        ("flash_decode_partial[dense, kv_len 32k]", "partial", 280,
         lambda: fd.flash_decode_tiled(q, k, v, t, p.split_len, p.splits,
                                       ctx=ctx),
         lambda: fd.flash_decode_reference(q, k, v, t),
         (q_bytes + kv_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3, lib_ms),
        ("flash_decode_combine[kv_len 32k]", "combine", 218,
         lambda: fd.flash_decode_combine(*parts, torch.bfloat16),
         lambda: fd.flash_decode_combine_reference(*parts, torch.bfloat16),
         (part_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3, None)]
    out = []
    for name, counter, line, kernel, plain, bnd, lib in cases:
        ms = queued_ms(torch, kernel)
        plain_ms = queued_ms(torch, plain, may_wait=True)
        print(f"{name}: kernel_ms={ms:.5f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd:.5f} (bytes) library_ms="
              f"{'%.5f' % lib if lib else None} splits={p.splits} "
              f"[{card}]", flush=True)
        rec = {
            "name": name, "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/flash_decode.cu",
            "replaces": f"triton_dist_tpu/ops/flash_decode.py:{line}",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": "bytes",
            "library_ms": lib, "wall_ms": wall_ms(torch, kernel),
            "shape": [1, hq, hkv, d, t], "ok": ok}
        if counter == "combine":
            rec["path"] = ("off the path: its merge runs in the partial's "
                           "launch, bit-equal")
        out.append((rec, f"flash_decode_{counter}",
                    "off_path" if counter == "combine" else None))
    return out


def coll_records(torch, agk, ar, rs, card: str) -> list:
    """One record for each Pallas function whose world = 1 body the copy
    kernel runs, timed at the larger collective shape, with ``launches``
    to fill from phase 15 (the counter and the method). Each call takes
    the next of 16 inputs (64 MiB, more than the 50 MB L2), so it reads
    from HBM as the bound assumes."""
    shape = COLL_SHAPES[-1]
    xs = [torch.randn(shape, device="cuda").bfloat16() for _ in range(16)]
    x = rotating(xs)
    nbytes = xs[0][0].numel() * xs[0].element_size()
    bnd = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    out = torch.empty_like(xs[0][0])
    lib_ms = queued_ms(torch, lambda: out.copy_(x()[0]))
    AR, RS = ar.AllReduceMethod, rs.ReduceScatterMethod
    cases = [
        ("all_reduce[one_shot]", "all_reduce", AR.ONE_SHOT, "allreduce.py:114",
         lambda: ar.all_reduce(x(), ar.create_allreduce_context(
             method=AR.ONE_SHOT)),
         lambda: ar.all_reduce_world_reference(x(), AR.ONE_SHOT)),
        ("all_reduce[recursive_doubling]", "all_reduce",
         AR.RECURSIVE_DOUBLING, "allreduce.py:158",
         lambda: ar.all_reduce(x(), ar.create_allreduce_context(
             method=AR.RECURSIVE_DOUBLING)),
         lambda: ar.all_reduce_world_reference(x(), AR.RECURSIVE_DOUBLING)),
        ("all_reduce[two_shot]", "all_reduce", AR.TWO_SHOT, "allreduce.py:193",
         lambda: ar.all_reduce(x(), ar.create_allreduce_context(
             method=AR.TWO_SHOT)),
         lambda: ar.all_reduce_world_reference(x(), AR.TWO_SHOT)),
        ("reduce_scatter[ring]", "reduce_scatter", RS.RING,
         "reduce_scatter.py:92",
         lambda: rs.reduce_scatter(x(), rs.create_reduce_scatter_context(
             method=RS.RING)),
         lambda: rs.reduce_scatter_world_reference(x(), RS.RING)),
        ("reduce_scatter[one_shot]", "reduce_scatter", RS.ONE_SHOT,
         "reduce_scatter.py:150",
         lambda: rs.reduce_scatter(x(), rs.create_reduce_scatter_context(
             method=RS.ONE_SHOT)),
         lambda: rs.reduce_scatter_world_reference(x(), RS.ONE_SHOT)),
        ("broadcast", "broadcast", None, "allgather.py:218",
         lambda: agk.broadcast(x()[0]),
         lambda: agk.broadcast_reference(x()[0]))]
    records = []
    for name, counter, method, replaces, kernel, plain in cases:
        ms = queued_ms(torch, kernel)
        plain_ms = queued_ms(torch, plain, may_wait=True)
        print(f"kernel {name} bf16 {shape}: kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} library_ms={lib_ms:.4f} (Tensor.copy_) "
              f"bound_ms={bnd:.5f} (bytes) [{card}]", flush=True)
        records.append(({
            "name": name, "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/allgather.cu",
            "replaces": f"triton_dist_tpu/ops/{replaces}", "launches": 0,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": "bytes", "library_ms": lib_ms,
            "wall_ms": wall_ms(torch, kernel), "shape": list(shape),
            "ok": True}, counter, method))
    return records


def sp_kernels_line(records, launches) -> list:
    """The records with their launches on phase 15's path: a record's key
    is a method (summed over shapes), ``None`` (every launch of the
    counter), the sp_attention record's own or "off_path" (a kernel the
    path must not launch: its count must be 0)."""
    out = []
    for rec, counter, method in records:
        counts = launches[counter]
        if method in (None, "off_path"):
            n = sum(counts.values())
        else:
            n = sum(c for key, c in counts.items() if key[0] == method.value)
        rec = dict(rec, launches=n)
        if method == "off_path":
            check(n == 0, f"{rec['name']} launched on the sp path")
        else:
            check(n > 0, f"{rec['name']} never launched on the sp path")
        out.append(rec)
    return out


# -- slice 6: expert parallelism at world 4 through the all-to-all kernel --------
#: Ranks of the EP main path: each holds 1 KV head, 8 query heads and 32
#: whole experts of Qwen3-30B-A3B.
EP_WORLD = 4
#: New tokens of the EP serve (16, as phase 13's prompts: 4 x 128).
EP_GEN = 16
#: The kernel's cases: (world, tokens) at Qwen3-30B-A3B's hidden 2048:
#: decode (batch 4) and prefill (4 x 128) at W = 4 and 2, and W = 8 (the
#: model's 4 KV heads stop its attention at W = 4; the exchange itself
#: runs at the model's width).
A2A_CASES = ((4, 4), (4, 512), (2, 4), (2, 512), (8, 4), (8, 512))


def ep_capacity(world: int, tokens: int, topk: int, align: int) -> tuple:
    """(rows per rank, slab capacity) of an EP layer over ``tokens`` rows:
    EPMoE pads the rows to the ranks, EPAll2AllLayer sizes a slab for
    every pair of a rank, aligned to 8 rows (32 for the fp8 wire)."""
    t_loc = -(-tokens // world)
    cap = t_loc * topk
    return t_loc, max(align, -(-cap // align) * align)


def ep_send(torch, mu, group, x, idx, num_experts: int, cap: int):
    """The rank-major send buffer (W * W, cap, H) and counts (W * W,) of
    token rows ``x`` routed by ``idx``: EPAll2AllLayer's per-rank pack."""
    world = group.world

    def pack(xs, ids):
        meta = mu.dispatch_layout(ids, num_experts, world, cap)
        buf, _ = mu.scatter_to_slabs(xs, meta, world, cap)
        return buf, meta["send_counts"]
    return group.per_rank(pack, x, idx, in_dims=(0, 0), out_dims=(0, 0))


def bits(torch, t):
    """``t``'s bits as integers: NaN canaries compare equal."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def phase_a2a_kernel(torch, a2a, mu, rd, cfg, params, card: str) -> list:
    """Phase 16, kernel: the all-to-all against its plain version at the
    cases of :data:`A2A_CASES`, bf16 and the fp8 path's int8 wire, routed
    by layer 0's router. Returns the JSON records of the W = 4 bf16
    decode and prefill cases, ``launches`` still to fill."""
    print("== phase 16: all-to-all kernel vs fast_all_to_all_reference",
          flush=True)
    h, e, k = cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok
    router = params["layers"][0]["moe"]["w_router"]
    gen = torch.Generator(device="cuda").manual_seed(61)
    records = []
    for world, tokens in A2A_CASES:
        group = rd.create_rank_group(world)
        x = torch.randn((tokens, h), generator=gen, device="cuda").to(
            cfg.dtype)
        _, idx = mu.topk_routing(x.float() @ router, k, cfg.norm_topk_prob)
        t_pad = -(-tokens // world) * world
        if t_pad != tokens:                  # EPMoE's pad rows: expert 0
            x = torch.cat([x, x.new_zeros((t_pad - tokens, h))])
            idx = torch.cat([idx, idx.new_zeros((t_pad - tokens, k))])
        for wire in ("bf16", "int8"):
            _, cap = ep_capacity(world, tokens, k, 32 if wire == "int8"
                                 else 8)
            send, counts = ep_send(torch, mu, group, x, idx, e, cap)
            if wire == "int8":
                send = a2a.quantize_fp8_rows(send)[0].view(torch.int8)
            ctx = a2a.create_all_to_all_context(group, capacity=cap)
            chunk = ctx.resolve_chunk(send.element_size())
            canary = 127 if wire == "int8" else float("nan")

            def canvas():
                return torch.full_like(send, canary)

            want, want_counts = a2a.fast_all_to_all_reference(
                send, counts, world, chunk, out=canvas())
            runs = [a2a.fast_all_to_all(send, counts, ctx, out=canvas())
                    for _ in range(2)]
            torch.cuda.synchronize()
            got = [g for g, _ in runs]
            same = torch.equal(bits(torch, got[0]), bits(torch, want))
            again = torch.equal(bits(torch, got[0]), bits(torch, got[1]))
            counted = all(torch.equal(c, want_counts) for _, c in runs)
            # A planted fault: the fullest slab's count lowered by one
            # chunk for the kernel only; the same check must refuse it.
            bad = counts.clone()
            top = int(torch.argmax(bad))
            bad[top] = max(int(bad[top]) - chunk, 0)
            faulty = a2a.fast_all_to_all(send, bad, ctx, out=canvas())[0]
            refused = not torch.equal(bits(torch, faulty), bits(torch, want))
            live = int(counts.sum())
            rows = (torch.arange(cap, device="cuda")[None, :]
                    < a2a._xla_a2a(counts, world)[:, None])
            err = ((got[0].float() - want.float())[rows].abs().max().item()
                   if live else 0.0)
            # One entry call queues the kernel and nothing else.
            nodes, seen, names, alone = kernels_a_call(
                torch, lambda: a2a.fast_all_to_all(send, counts, ctx),
                "all_to_all")
            single = one_kernel(nodes, seen)
            check(same and again and refused and counted and single,
                  f"a2a W={world} tokens {tokens} {wire}: bit-equal {same}, "
                  f"repeat {again}, planted fault refused {refused}, "
                  f"receive counts {counted}, an entry call queued {nodes} "
                  f"(graph), {seen} kernel records a call {names} "
                  f"(profiler)")
            out = canvas()
            moved = send.view(world, world, cap, h).transpose(0, 1)
            ms = queued_ms(torch, lambda: a2a.fast_all_to_all(
                send, counts, ctx, out=out))
            plain_ms = queued_ms(torch, lambda: a2a.fast_all_to_all_reference(
                send, counts, world, chunk, out=out), n=10, may_wait=True)
            lib_ms = queued_ms(torch, lambda: out.view(
                world, world, cap, h).copy_(moved), n=10)
            bnd = 2.0 * live * h * send.element_size() / HBM_BYTES_PER_S * 1e3
            row = h * send.element_size()
            blocks, compact = a2a.grid(world, cap, chunk, row)
            print(f"kernel all_to_all W={world} tokens {tokens} {wire}: cap "
                  f"{cap} chunk {chunk}, {live} live rows of "
                  f"{world * world * cap}, grid {blocks} blocks "
                  f"({'compact body' if compact else 'a block an item'}); "
                  f"live rows bit-equal, dead-chunk canaries intact, repeat "
                  f"bit-identical, receive counts written by the kernel, "
                  f"planted fault (slab {top} count lowered by {chunk}) "
                  f"refused; an entry call queued {nodes} (graph), "
                  f"{seen} kernel records a call {names} (profiler); "
                  f"kernel_ms={ms:.5f} (the entry, queued CUDA events) "
                  f"kernel_alone_ms={fmt_ms(alone)} (profiler) "
                  f"plain_ms={plain_ms:.5f} bound_ms={bnd:.5f} (bytes) "
                  f"copy_ms={lib_ms:.5f}; rate {bnd / ms:.3f} of the HBM "
                  f"bound [{card}]", flush=True)
            if world == EP_WORLD and wire == "bf16":
                shape = "decode" if tokens == 4 else "prefill"
                records.append(({
                    "name": f"all_to_all[{shape}]", "route": "cuda",
                    "source": "triton_dist_tpu_torch/csrc/all_to_all.cu",
                    "replaces": "triton_dist_tpu/ops/all_to_all.py:155",
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bnd,
                    "bound_by": "bytes", "library_ms": lib_ms,
                    "kernel_alone_ms": alone,
                    "kernels_a_call": nodes["kernel"],
                    "wall_ms": wall_ms(torch, lambda: a2a.fast_all_to_all(
                        send, counts, ctx, out=out)),
                    "shape": [world, cap, h, live], "ok": True},
                    (world, cap, h * send.element_size())))
    return records


def phase_ep_main(torch, models, a2a, gg, cfg, params, base, card: str,
                  seed: int):
    """Phase 16, main path: Qwen3-30B-A3B with moe_parallel="ep" at world
    4 over phase 13's weights, served by Engine(prefill xla, decode xla)
    with the launch counts of every prefill and decode step. Returns
    (model, prompts, the launches by counter and key)."""
    print(f"== phase 16: Qwen3-30B-A3B served with moe_parallel='ep' at "
          f"world {EP_WORLD} through the all-to-all kernel", flush=True)
    before = torch.cuda.memory_allocated()
    model = models.AutoLLM.build(cfg, fwd_mode="xla", moe_parallel="ep",
                                 world=EP_WORLD)
    eng = models.Engine(model, batch=4, max_seq=256, prefill_mode="xla",
                        decode_mode="xla")
    print(f"EP model over the same params (per-rank views, no copy): "
          f"device memory {before / 2**30:.2f} GiB before, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after [{card}]",
          flush=True)
    square, _ = sp_prompts(torch, cfg, seed + 10)
    eng.serve(params, square, 2)                       # warm-up
    counters = {"all_to_all": a2a.a2a_launches,
                "group_gemm": gg.group_gemm_launches}
    for c in counters.values():                        # ---- the main path
        c.reset()
    steps = EP_GEN - 1
    _, prefill_ms = sync_time(torch, lambda: eng.serve(params, square, 1))
    mid = moe_counts(counters)
    out, serve_ms = sync_time(torch, lambda: eng.serve(params, square,
                                                       EP_GEN))
    after = moe_counts(counters)
    launches = {name: dict(c.by_shape) for name, c in counters.items()}
    layers = cfg.num_hidden_layers                     # ---- main path ends
    per_step = {n: (after[n] - 2 * mid[n]) / steps for n in after}
    want = {"all_to_all": 2 * layers, "group_gemm": 2 * EP_WORLD * layers}
    check(mid == want, f"EP launches per prefill {mid}, want {want}")
    check(per_step == want, f"EP launches per decode step {per_step}, want "
                            f"{want}")
    check(tuple(out.shape) == (4, 128 + EP_GEN), "EP serve shape")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "EP token out of vocabulary")
    decode_ms = serve_ms - prefill_ms
    same = (out[:, 128:] == base[:, 128:128 + EP_GEN]).float().mean().item()
    print(f"ep serve (prefill xla, decode xla, W={EP_WORLD}): batch 4 x 128 "
          f"prompt, {EP_GEN} new tokens: prefill_ms={prefill_ms:.1f} "
          f"decode_ms={decode_ms:.1f} per_step_ms={decode_ms / steps:.2f} "
          f"decode_tokens_per_s={4 * steps / decode_ms * 1e3:.1f}; launches "
          f"per prefill {mid}, per decode step {per_step}; greedy tokens "
          f"equal to phase 13's default TP engine on {same:.3f} of "
          f"positions (not gated) [{card}]", flush=True)
    print(f"ep main path launches: all_to_all {launches['all_to_all']}; "
          f"group_gemm {launches['group_gemm']}", flush=True)
    return model, square, launches


def phase_ep_checks(torch, a2a, cfg, model, params, square, card: str):
    """Phase 16, checks: prefill and decode-step logits through the kernel
    bit-equal to the same forward with the plain exchange; one EP MoE
    layer under sync debug "error"; the decode step's and the prefill's
    wall and device time, the grouped GEMM's share and the dead-slot
    share of the slots it runs."""
    from triton_dist_tpu_torch.layers import ep_a2a
    from triton_dist_tpu_torch.models import KVCacheManager
    ids = torch.tensor(square, device="cuda")
    kernel_a2a = ep_a2a.fast_all_to_all
    seen = []

    def recording(send, counts, ctx, impl="pallas"):
        seen.append((int(counts.sum()), send.shape[0] * send.shape[1]))
        return kernel_a2a(send, counts, ctx, impl=impl)

    def plain(send, counts, ctx, impl="pallas"):
        return a2a.fast_all_to_all_reference(
            send, counts, ctx.world_size,
            ctx.resolve_chunk(send.element_size()))

    def caches():
        return KVCacheManager(cfg.num_hidden_layers, 4, 256,
                              cfg.num_key_value_heads, cfg.head_dim,
                              dtype=cfg.dtype, device="cuda",
                              world=EP_WORLD).init()

    def run():
        kv = caches()
        with torch.no_grad():
            pre, kv = model.forward(params, ids, kv, 0, mode="xla")
            tok = pre[:, -1].argmax(-1)[:, None]
            step, _ = model.forward(params, tok, kv, 128, mode="xla")
        return pre[:, -1], step[:, 0]

    ep_a2a.fast_all_to_all = recording
    try:
        got = run()
        ep_a2a.fast_all_to_all = plain
        ref = run()
    finally:
        ep_a2a.fast_all_to_all = kernel_a2a
    for what, g, r in (("prefill (4 x 128) last-position", got[0], ref[0]),
                       ("decode step", got[1], ref[1])):
        check(bool(torch.isfinite(g).all()), f"non-finite EP {what} logits")
        check(torch.equal(g, r), f"EP {what} logits through the kernel "
                                 f"differ from the plain exchange by "
                                 f"{(g - r).abs().max().item()}")
        print(f"ep logits: {what} logits through the all-to-all kernel "
              f"bit-equal to the same forward with "
              f"fast_all_to_all_reference [{card}]", flush=True)
    layers = cfg.num_hidden_layers
    for name, calls in (("prefill", seen[:2 * layers]),
                        ("decode", seen[2 * layers:])):
        live = sum(n for n, _ in calls[::2])       # dispatch calls
        slots = sum(n for _, n in calls[::2])
        print(f"ep {name}: the grouped GEMM runs {slots // layers} slots per "
              f"layer over the ranks, {live / slots:.3f} of them live "
              f"(dead-slot share {1 - live / slots:.3f}; dead slots run "
              f"through each rank's last expert) [{card}]", flush=True)

    # One EP MoE layer under sync debug "error": no host round trip.
    layer = params["layers"][0]["moe"]
    for m in (MOE_DECODE_M, MOE_PREFILL_M):
        x = torch.randn((m, cfg.hidden_size), device="cuda").to(cfg.dtype)
        model.moe(layer, x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = model.moe(layer, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(bool(torch.isfinite(y).all()), "non-finite EPMoE output")
        print(f"ep moe layer ({m} tokens, W={EP_WORLD}) ran under "
              f"torch.cuda.set_sync_debug_mode('error'): no host sync",
              flush=True)

    kv = caches()
    with torch.no_grad():
        model.forward(params, ids, kv, 0, mode="xla")

    def step():
        with torch.no_grad():
            return model.forward(params, ids[:, :1], kv, 128, mode="xla")[0]

    def prefill():
        with torch.no_grad():
            return model.forward(params, ids, caches(), 0, mode="xla")[0]

    for name, fn in (("decode step", step), ("prefill (4 x 128)", prefill)):
        walls = [sync_time(torch, fn)[1] for _ in range(5)]
        wall = sorted(walls)[2]
        rows, whole = profiled_rows(torch, fn, 3, "ep step")
        ge, le = bound_marks(whole)
        dev = sum(ms for _, ms in rows) or float("nan")  # none recorded
        gg_ms = sum(ms for key, ms in rows if "group_" in key)
        a2a_ms = sum(ms for key, ms in rows if "a2a_kernel" in key)
        print(f"ep {name} (W={EP_WORLD}, mode xla, batch 4, forward only): "
              f"wall {wall:.2f} ms (median of 5), device {ge}{dev:.2f} ms, "
              f"device idle share {le}{1 - dev / wall:.2f}; grouped GEMM "
              f"{ge}{gg_ms:.3f} ms ({gg_ms / dev:.2f} of device time), "
              f"all-to-all {ge}{a2a_ms:.3f} ms ({a2a_ms / dev:.3f}) "
              f"[{card}]", flush=True)
        for kernel, ms in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"  ep {name} device time: {ms:.3f} ms ({ms / dev:.2f}) "
                  f"{kernel[:70]}", flush=True)


def ep_kernels_line(records, launches) -> list:
    out = []
    for rec, key in records:
        rec = dict(rec, launches=launches["all_to_all"].get(key, 0))
        check(rec["launches"] > 0, f"{rec['name']} never launched on the "
                                   f"EP path")
        out.append(rec)
    return out


# -- slice 7: tensor parallelism at world 4 through the ring kernels -----------
#: Ranks of the TP main path (Qwen3-8B's 8 KV heads shard over 4).
TP_WORLD = 4
#: New tokens of phase 18's serves.
TP_GEN = 16
#: The world-W engines: name -> (prefill mode, decode mode). "tdt-serve" is
#: the JAX server's default engine at world W (Engine's defaults).
TP_ENGINES = {"tdt-serve": ("xla_ar", "gemm_ar"),
              "reference": ("ag_rs", "gemm_ar"), "fused": ("ag_rs", "ag_rs")}
#: The JAX kernels the ring kernels replace, by op; for rs / ar by the
#: variant ``ring_plan`` picks (JAX's choice for the call's shape).
RING_REPLACES = {
    "gemm": "triton_dist_tpu/ops/allgather_gemm.py:265",
    "swiglu": "triton_dist_tpu/ops/allgather_gemm.py:954",
    "vmem": "triton_dist_tpu/ops/gemm_reduce_scatter.py:249",
    "hbm": "triton_dist_tpu/ops/gemm_reduce_scatter.py:353",
    "hbm_kt": "triton_dist_tpu/ops/gemm_reduce_scatter.py:533"}
RING_SOURCES = {"gemm": "ag_gemm_ring.cu", "swiglu": "ag_gemm_ring.cu",
                "rs": "gemm_rs_ring.cu", "ar": "gemm_rs_ring.cu"}
#: The AG ring's body for each world-1 plan of one rank's shard.
AG_RING_BODY = {"decode": "stream", "prefill": "mma", "fma": "fma"}


def ring_error(torch, got, ref, parts_abs, k: int, world: int):
    """(max |got - ref|, largest share of the limit) of a GEMM-RS / AR
    ring against its plain ring version. The limit is the ring's own
    rounding: each rank's partial is an f32 sum in another order than the
    plain version's, so it may round to the neighbouring bf16 value, and
    that ulp travels down the ring, so up to W ulps of the sum of the
    partials' magnitudes (2^-7 W sum_r |p_r|), plus W f32_sum_atol(k) for
    partials near zero. f32: 1e-5 of the same sum plus W f32_sum_atol."""
    rel = BF16_ULP_REL if got.dtype == torch.bfloat16 else 1e-5
    lim = world * (rel * parts_abs + f32_sum_atol(k))
    diff = (got.float() - ref.float()).abs()
    return diff.max().item(), (diff / lim).max().item()


def ring_bound_ms(op: str, m: int, k: int, widths, world: int, itemsize: int):
    """(least ms, what bounds it) of one ring call over every rank: A, the
    weights and the output moved once over HBM, plus the ring's copies
    (each a read and a write: the W - 1 chunks of A each rank receives;
    for RS the W - 1 travelling partial sums of every chunk; for AR those
    and the all-gather's W - 1 chunks); the global product's operations
    over the peak of the type."""
    n = sum(widths)
    nb = 2 if op == "swiglu" else 1
    moved = m * k + nb * k * n + m * n
    if op in ("gemm", "swiglu"):
        moved += 2 * (world - 1) * m * k
    else:
        moved += 2 * (world - 1) * m * n * (2 if op == "ar" else 1)
    by_bytes = moved * itemsize / HBM_BYTES_PER_S * 1e3
    kind = "bf16" if itemsize == 2 else "f32"
    by_ops = 2.0 * m * k * n * nb / PEAK_FLOPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def ring_case(torch, ag, rs, rd, op, world, m, ws, dirs, a):
    """Calls of one ring case over ``world`` ranks: a (m, K) activations
    (column-sharded for rs / ar, row-sharded otherwise), ws the global
    weights. Returns a dict: ctx, kernel(fault) (rank 0's outputs),
    plain, shard (the world-1 kernel on rank r's column shard, AG only),
    world1 (the world-1 kernel at the same global shape), library (one
    torch.matmul of the global product), key (the launch key), live (the
    workspace's live elements per rank), products (the decode bodies' f32
    products per rank, 0 if none) and plan (rs / ar). AG's body is checked
    against the world-1 kernel's plan of one rank's shard."""
    group = rd.create_rank_group(world)
    k = a.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if op in ("gemm", "swiglu"):
        ctx = ag.AllGatherGEMMContext(group, ring_dirs=dirs)
        widths = ((ws[0].shape[1],) if op == "swiglu"
                  else tuple(w.shape[1] for w in ws))
        shards = tuple(n // world for n in widths)
        key = (ag.ring_path(a.dtype, m, k, shards, op), world, m, k, shards)
        w1_path = ag.plan(op, m, shards, k, a.dtype, sms).path
        check(key[0] == AG_RING_BODY[w1_path],
              f"ag ring at {m}x{k}x{shards} W={world}: body {key[0]}, the "
              f"world-1 plan of a shard {w1_path}")

        def cols(w, r):
            n = w.shape[1] // world
            return w[:, r * n:(r + 1) * n].contiguous()
        if op == "gemm":
            def plain():
                return ag.ag_gemm_multi_ring_reference(a, ws, world, dirs)

            def shard(r):
                return ag.ag_gemm_multi(a, [cols(w, r) for w in ws])

            def world1():
                return ag.ag_gemm_multi(a, ws)
        else:
            def plain():
                return [ag.ag_swiglu_ring_reference(a, ws[0], ws[1],
                                                    world=world, dirs=dirs)]

            def shard(r):
                return [ag.launch_swiglu(a, *(cols(w, r) for w in ws), None,
                                         None)]

            def world1():
                return [ag.launch_swiglu(a, ws[0], ws[1], None, None)]
        cat = torch.cat(ws, dim=1)
        sizes = ag._ring_sizes(op, a.dtype, key[0], world, m // world, k,
                               shards, sms)
        return dict(
            ctx=ctx, plain=plain, shard=shard, world1=world1, key=key,
            live=m * k, plan=None, products=sizes.ws,
            kernel=lambda fault=False: ag.launch_ag_ring(op, a, ws, ctx,
                                                         fault=fault),
            library=lambda: torch.matmul(a, cat))
    ctx = rs.GEMMReduceScatterContext(group, ring_dirs=dirs)
    b = ws[0]
    n = b.shape[1]
    pad = -m % world
    mp = m + pad
    ap = torch.cat([a, a.new_zeros((pad, k))]) if pad else a
    plan = rs.ring_plan(mp, k // world, n, a.element_size(), world, dirs,
                        op == "ar")
    check(plan.variant != "xla", f"{op} at {m}x{k}x{n}: no ring (JAX psum)")
    key = (rs.ring_path(a.dtype, mp, k // world, n, plan.split), world,
           mp // world, k // world, n)
    check((key[0] == "stream") == (mp <= rs.DECODE_MAX_M),
          f"{op} at {m}x{k}x{n} W={world}: body {key[0]} for {mp} rows")

    def kernel(fault=False):
        out = rs.launch_ring(ap, b, ctx, plan.split, op == "ar", fault=fault)
        return [out[0, :m]] if op == "ar" else [out]

    def plain():
        if op == "ar":
            return [rs.gemm_ar_ring_reference(a, b, world, plan.split)]
        return [rs.gemm_rs_ring_reference(a, b, world, plan.split)]

    def world1():
        return [rs.gemm_ar(a, b) if op == "ar" else rs.gemm_rs(a, b)]
    sizes = rs._ring_sizes(a.dtype, key[0], world, mp // world, k // world,
                           n, plan.split, sms)
    return dict(ctx=ctx, kernel=kernel, plain=plain, shard=None,
                world1=world1, library=lambda: torch.matmul(a, b), key=key,
                live=(world - 1) * (mp // world) * n, plan=plan, padded=ap,
                products=sizes.ws)


def ring_rate(ag, rs, op: str, world: int, m: int, k: int, widths, ms: float,
              plan) -> str:
    """:func:`prefill_rate` of a ring's tensor-core tile body: a rank's
    tiles (AG: W chunks of its shard widths; RS / AR: W steps of the two
    directions' columns) over its blocks (``tdt_*_ring_grid``)."""
    import ctypes
    rows, out = m // world, ctypes.c_int()
    if op in ("gemm", "swiglu"):
        tiles = ag.tile_count(op, rows, [n // world for n in widths], world)
        err = ag._ring_lib().tdt_ag_ring_grid(
            int(op == "swiglu"), 0, ag.RING_PATHS["mma"], world, m,
            ctypes.byref(out))
    else:
        n = widths[0]
        tiles = ag.tile_count("gemm", rows, (plan.split, n - plan.split),
                              world)
        err = rs._ring_lib().tdt_rs_ring_grid(
            0, ag.RING_PATHS["mma"], world, rows, k // world, n,
            ctypes.byref(out))
    check(err == 0, f"ring grid of {op} at W={world}: error {err}")
    return prefill_rate(ag, m, k, widths, op == "swiglu", ms, tiles,
                        out.value)


def phase_ring_kernels(torch, ag, rs, rd, params, cfg, card: str) -> list:
    """Phase 17: the ring kernels against their plain ring versions at
    W = 2, 3, 4, 8, prefill (M = 512, 384 at W = 3) and decode (M = 4)
    shapes on the model's layer-0 weights, bf16 and f32 (smaller shapes),
    ring_dirs 1 and 2: error within the limit, bit-identical on repeat,
    GEMM-AR's W buffers bit-equal, the workspaces' NaN canaries intact and
    a planted fault (one hop's push skipped, its signal still set)
    refused. The W = 4, dirs 2, bf16 cases at the main path's shapes are
    timed and returned as JSON records, ``launches`` to fill from phase
    18. The decode bodies' cases (launch key "stream") print their
    exchange_ms (kernel_ms - world1_ms: both stream B once), and bf16 AG
    cases (decode body or tensor-core tile) are checked bit-equal to the
    world-1 kernel on the gathered A and each rank's column shard."""
    print("== phase 17: ring AG-GEMM / AG-SwiGLU / GEMM-RS / GEMM-AR kernels "
          "vs their plain ring versions", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(17)
    lp = params["layers"][0]
    qkv = [lp["attn"][n] for n in ("w_q", "w_k", "w_v")]
    gate_up = [lp["mlp"]["w_gate"], lp["mlp"]["w_up"]]
    o_proj, down = [lp["attn"]["w_o"]], [lp["mlp"]["w_down"]]

    def small(k, *widths, dtype=torch.float32):
        return [(torch.randn((k, n), generator=gen, device="cuda")
                 / k ** 0.5).to(dtype) for n in widths]
    f32 = torch.float32
    # name, op, world, M, weights, dirs, timed (a JSON record), fault
    cases = [
        ("ag_gemm_ring[prefill qkv]", "gemm", 4, 512, qkv, 2, True, True),
        ("ag_swiglu_ring[prefill]", "swiglu", 4, 512, gate_up, 2, True,
         True),
        ("ag_gemm_ring[decode qkv]", "gemm", 4, 4, qkv, 2, True, True),
        ("ag_gemm_ring[decode gate|up]", "gemm", 4, 4, gate_up, 2, True,
         True),
        ("gemm_rs_ring[prefill o_proj]", "rs", 4, 512, o_proj, 2, True, True),
        ("gemm_rs_ring[prefill down]", "rs", 4, 512, down, 2, True, False),
        ("gemm_rs_ring[decode o_proj]", "rs", 4, 4, o_proj, 2, True, False),
        ("gemm_rs_ring[decode down]", "rs", 4, 4, down, 2, True, False),
        ("gemm_ar_ring[decode o_proj]", "ar", 4, 4, o_proj, 2, True, True),
        ("gemm_ar_ring[decode down]", "ar", 4, 4, down, 2, True, False),
        ("ag_gemm_ring[qkv W=2]", "gemm", 2, 512, qkv, 2, False, False),
        ("ag_gemm_ring[gate|up W=3]", "gemm", 3, 384, gate_up, 2, False,
         False),
        ("ag_gemm_ring[qkv W=8]", "gemm", 8, 512, qkv, 2, False, False),
        ("ag_gemm_ring[qkv dirs 1]", "gemm", 4, 512, qkv, 1, False, False),
        ("ag_swiglu_ring[W=2]", "swiglu", 2, 512, gate_up, 2, False, False),
        ("gemm_rs_ring[down W=2]", "rs", 2, 512, down, 2, False, False),
        ("gemm_rs_ring[down W=3]", "rs", 3, 384, down, 2, False, False),
        ("gemm_rs_ring[o_proj W=8]", "rs", 8, 512, o_proj, 2, False, False),
        ("gemm_rs_ring[o_proj dirs 1]", "rs", 4, 512, o_proj, 1, False,
         False),
        ("gemm_ar_ring[down W=3]", "ar", 3, 4, down, 2, False, False),
        ("gemm_ar_ring[o_proj W=8]", "ar", 8, 4, o_proj, 2, False, False),
        ("gemm_ar_ring[down dirs 1]", "ar", 4, 4, down, 1, False, False),
        ("ag_gemm_ring[f32]", "gemm", 4, 64, small(512, 256, 128), 2, False,
         True),
        ("ag_swiglu_ring[f32]", "swiglu", 4, 512, small(256, 512, 512), 2,
         False, False),
        ("gemm_rs_ring[f32]", "rs", 4, 64, small(512, 512), 2, False, True),
        ("gemm_ar_ring[f32]", "ar", 4, 4, small(384, 512), 1, False, True),
        # The decode body's edges at the o_proj (M = 65: the tile), W = 2,
        # and f32 at W = 2, 3, 8. The planted fault skips the pushes of
        # chunk 0, which holds the one live row at M = 1.
        ("gemm_ar_ring[o_proj M=1]", "ar", 4, 1, o_proj, 2, False, True),
        ("gemm_rs_ring[o_proj M=64]", "rs", 4, 64, o_proj, 2, False, True),
        ("gemm_ar_ring[o_proj M=65]", "ar", 4, 65, o_proj, 2, False, True),
        ("gemm_rs_ring[decode o_proj W=2]", "rs", 2, 4, o_proj, 2, False,
         True),
        ("gemm_ar_ring[f32 W=2]", "ar", 2, 3, small(512, 512), 2, False,
         True),
        ("gemm_rs_ring[f32 W=3]", "rs", 3, 6, small(384, 256), 2, False,
         True),
        ("gemm_ar_ring[f32 W=8]", "ar", 8, 4, small(512, 512), 2, False,
         True),
        # The AG decode body at W = 2, 8 (QKV) and 3 (gate|up: 4096 does
        # not split 3 ways), M a multiple of W, one direction; M = 68 takes
        # the tile; Qwen3-30B-A3B's attention QKV (TP-MoE and EP mode "ep").
        ("ag_gemm_ring[decode qkv W=2]", "gemm", 2, 4, qkv, 2, False, True),
        ("ag_gemm_ring[decode qkv W=8]", "gemm", 8, 8, qkv, 2, False, True),
        ("ag_gemm_ring[decode gate|up W=3]", "gemm", 3, 6, gate_up, 2, False,
         True),
        ("ag_gemm_ring[decode qkv dirs 1]", "gemm", 4, 4, qkv, 1, False,
         True),
        ("ag_gemm_ring[qkv M=68]", "gemm", 4, 68, qkv, 2, False, True),
        ("ag_gemm_ring[tp-moe decode qkv]", "gemm", 4, 4,
         small(2048, 4096, 512, 512, dtype=torch.bfloat16), 2, False, True),
    ]
    records = []
    for name, op, world, m, ws, dirs, timed, fault in cases:
        dtype = ws[0].dtype
        k = ws[0].shape[0]
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        c = ring_case(torch, ag, rs, rd, op, world, m, ws, dirs, a)
        kernel, plain, key = c["kernel"], c["plain"], c["key"]
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        ref = plain()
        check(all(torch.equal(bits(torch, x), bits(torch, y))
                  for x, y in zip(got, again)), f"{name}: repeat differs")
        if op in ("gemm", "swiglu"):
            if op == "swiglu":
                err, ok = swiglu_error(torch, got[0], ref[0], a, *ws)
            else:
                pairs = [gemm_error(torch, x, y, k) for x, y in zip(got, ref)]
                err, ok = max(e for e, _ in pairs), all(o for _, o in pairs)
            share, tol = None, f"1 bf16 ulp + {f32_sum_atol(k):.2g}"
        else:
            parts = rs._ring_partials(c["padded"], ws[0],
                                      world).float().abs().sum(0)[:m]
            err, share = ring_error(torch, got[0], ref[0], parts, k // world,
                                    world)
            ok = share <= 1.0
            tol = "W (2^-7 sum_r |p_r| + f32_sum_atol(K / W))"
        check(ok, f"{name}: max abs err {err} outside tolerance ({tol})")
        extra = ""
        if op == "ar":
            bufs = rs.launch_ring(c["padded"], ws[0], c["ctx"],
                                  c["plan"].split, True)
            check(all(torch.equal(bufs[0], bufs[r]) for r in range(world)),
                  f"{name}: the ranks' GEMM-AR buffers differ")
            extra += f", the {world} ranks' buffers bit-equal"
        workspace = c["ctx"].state.workspace(c["live"], dtype)
        check(bool(workspace[:, c["live"]:].isnan().all()),
              f"{name}: a workspace canary was overwritten")
        if c["products"]:                    # the decode bodies' f32 products
            prods = c["ctx"].state.workspace(c["products"], torch.float32,
                                             "products")
            check(bool(prods[:, c["products"]:].isnan().all()),
                  f"{name}: a products canary was overwritten")
        extra += ", canaries intact"
        if fault:
            workspace.fill_(float("nan"))
            bad = kernel(fault=True)
            torch.cuda.synchronize()
            if op in ("gemm", "swiglu"):
                if op == "swiglu":
                    _, fault_ok = swiglu_error(torch, bad[0], ref[0], a, *ws)
                else:
                    fault_ok = all(gemm_error(torch, x, y, k)[1]
                                   for x, y in zip(bad, ref))
            else:
                _, fshare = ring_error(torch, bad[0], ref[0], parts,
                                       k // world, world)
                fault_ok = fshare <= 1.0
            check(not fault_ok, f"{name}: the planted fault (a push "
                                f"skipped, its signal set) was not refused")
            again = kernel()                     # the workspace recovers
            check(all(torch.equal(bits(torch, x), bits(torch, y))
                      for x, y in zip(got, again)),
                  f"{name}: differs after the fault")
            extra += ", planted fault refused"
        w1 = ""
        if op in ("gemm", "swiglu") and key[0] in ("stream", "mma"):
            same = all(torch.equal(
                g[:, r * (g.shape[1] // world):(r + 1) * (g.shape[1] // world)],
                x) for r in range(world) for g, x in zip(got, c["shard"](r)))
            check(same, f"{name}: not bit-equal to the world-1 kernel on the "
                        f"gathered A and each rank's column shard")
            w1 = ("; bit-equal to the world-1 kernel on the gathered A and "
                  "each rank's column shard (both run the decode plan's "
                  "stream body, or tiles.cuh's tile at prefill)")
        print(f"kernel {name} {str(dtype)[6:]} W={world} dirs={dirs} M={m} "
              f"K={k} N={'|'.join(str(w.shape[1]) for w in ws)} ({key[0]}):"
              f" max_abs_err={err:.3g} (tol {tol}"
              f"{'' if share is None else f', share {share:.3f}'}) ok, "
              f"repeat bit-identical{extra}{w1}", flush=True)
        widths = tuple(w.shape[1] for w in ws[:1 if op == "swiglu" else 3])
        bnd, by = ring_bound_ms(op, m, k, widths, world, a.element_size())
        if not timed and key[0] == "stream" and m <= 8 and \
                dtype == torch.bfloat16:
            # The decode body's exchange at other worlds and shapes (no
            # record).
            ms, w1_ms = queued_ms(torch, kernel), queued_ms(torch,
                                                           c["world1"])
            more = ""
            if op == "gemm":
                more = (f" library_ms={queued_ms(torch, c['library']):.4f} "
                        f"bound_ms={bnd:.4f} ({by})")
            print(f"  {name}: kernel_ms={ms:.4f} world1_ms={w1_ms:.4f} "
                  f"exchange_ms={ms - w1_ms:.4f}{more} [{card}]", flush=True)
        if not timed:
            continue
        ms = queued_ms(torch, kernel)
        plain_ms = queued_ms(torch, plain, n=5, may_wait=True)
        lib_ms = queued_ms(torch, c["library"])
        w1_ms = queued_ms(torch, c["world1"], n=10)
        exchange = ""
        if key[0] == "stream":
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            k_loc, n_loc = ((k, tuple(n // world for n in widths))
                            if op == "gemm" else (k // world, widths))
            plan_text = decode_plan_text(ag, m, n_loc, k_loc, dtype, sms)
            nodes = queued_kernels(torch, kernel, name, True)
            exchange = (f" exchange_ms={ms - w1_ms:.4f} (kernel_ms - "
                        f"world1_ms: both stream B once); a rank's shard: "
                        f"{plan_text}; a call queues {nodes}")
        rate = (ring_rate(ag, rs, op, world, m, k, widths, ms, c["plan"])
                if key[0] == "mma" else "")
        print(f"  {name}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} (one torch.matmul of the global "
              f"product{', gate|up' if op == 'swiglu' else ''}, no exchange)"
              f" world1_ms={w1_ms:.4f} (the world-1 kernel on the same global"
              f" shape) bound_ms={bnd:.4f} ({by}){exchange}{rate} [{card}]",
              flush=True)
        replaces = RING_REPLACES[c["plan"].variant if c["plan"] else op]
        records.append(({
            "name": name, "route": "cuda",
            "source": f"triton_dist_tpu_torch/csrc/{RING_SOURCES[op]}",
            "replaces": replaces, "body": key[0], "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "world1_ms": w1_ms, "world": world, "ring_dirs": dirs,
            "shape": [m, k, list(widths)], "tol_share": share, "ok": ok},
            op, key))
    return records


def ag_stream_launches(ag) -> int:
    """AG ring launches so far that ran the decode body."""
    return sum(n for key, n in ag.ag_ring_launches.by_shape.items()
               if key[0] == "stream")


def ring_counts(ag, rs) -> dict:
    return {"ag_ring": ag.ag_ring_launches.total,
            "ag_swiglu_ring": ag.ag_swiglu_ring_launches.total,
            "rs_ring": rs.rs_ring_launches.total,
            "ar_ring": rs.ar_ring_launches.total}


def phase_tp_main(torch, models, ag, rs, ops, cfg, params, base, card):
    """Phase 18: Qwen3-8B at world 4 (per-rank views of the same params)
    served by the three engines of :data:`TP_ENGINES` through serve (4 x
    128 prompts, 16 new tokens), serve_stream and the server, with the
    ring launches of every prefill and decode step; the world-1 kernels
    must not run. Returns (model, launches by counter and key)."""
    print(f"== phase 18: Qwen3-8B served at world {TP_WORLD} through the "
          f"ring kernels", flush=True)
    layers = cfg.num_hidden_layers
    before = torch.cuda.memory_allocated()
    model = models.AutoLLM.build(cfg, world=TP_WORLD)
    check(model.world == TP_WORLD, "AutoLLM did not build a world-4 model")
    engines = {name: models.Engine(model, batch=4, max_seq=1024,
                                   prefill_mode=pf, decode_mode=dc)
               for name, (pf, dc) in TP_ENGINES.items()}
    print(f"world-{TP_WORLD} model and engines over the same params: device "
          f"memory {before / 2**30:.2f} GiB before, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after [{card}]",
          flush=True)
    square, base_out = base
    host = torch.Generator().manual_seed(18)
    stream = [torch.randint(0, cfg.vocab_size, (n,), generator=host).tolist()
              for n in (100, 128, 70, 90, 120, 65)]
    for eng in engines.values():                      # warm-up
        eng.serve(params, square, 2)
    world1 = (ag.ag_gemm_launches, ag.ag_swiglu_launches,
              rs.gemm_rs_launches, ops.launches)
    rings = (ag.ag_ring_launches, ag.ag_swiglu_ring_launches,
             rs.rs_ring_launches, rs.ar_ring_launches)
    for c in world1 + rings:                         # ---- the main path
        c.reset()
    steps = TP_GEN - 1
    for name, (pf, dc) in TP_ENGINES.items():
        eng = engines[name]
        per_prefill = ({"ag_ring": layers, "ag_swiglu_ring": layers,
                        "rs_ring": 2 * layers, "ar_ring": 0} if pf == "ag_rs"
                       else dict.fromkeys(("ag_ring", "ag_swiglu_ring",
                                           "rs_ring", "ar_ring"), 0))
        per_step = ({"ag_ring": 2 * layers, "ag_swiglu_ring": 0,
                     "rs_ring": 2 * layers, "ar_ring": 0} if dc == "ag_rs"
                    else {"ag_ring": 0, "ag_swiglu_ring": 0, "rs_ring": 0,
                          "ar_ring": 2 * layers})
        before = ring_counts(ag, rs)
        _, prefill_ms = sync_time(torch, lambda: eng.serve(params, square, 1))
        got = {k: v - before[k] for k, v in ring_counts(ag, rs).items()}
        check(got == per_prefill, f"({name}) prefill launches {got}, "
                                  f"expected {per_prefill}")
        before = ring_counts(ag, rs)
        streamed = ag_stream_launches(ag)
        out, serve_ms = sync_time(
            torch, lambda: eng.serve(params, square, TP_GEN))
        got = {k: v - before[k] for k, v in ring_counts(ag, rs).items()}
        want = {k: per_prefill[k] + steps * per_step[k] for k in got}
        check(got == want, f"({name}) serve launches {got}, expected {want}")
        streamed = ag_stream_launches(ag) - streamed
        check(streamed == steps * per_step["ag_ring"],
              f"({name}) {streamed} AG ring launches keyed 'stream', "
              f"expected every decode step's {per_step['ag_ring']}")
        check(tuple(out.shape) == (4, 128 + TP_GEN), f"({name}) serve shape")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "token out of vocabulary")
        same = (out[:, 128:] == base_out[:, 128:128 + TP_GEN]).float().mean()
        decode_ms = serve_ms - prefill_ms
        print(f"tp serve ({name}: prefill {pf}, decode {dc}, W={TP_WORLD}): "
              f"batch 4 x 128 prompt, {TP_GEN} new tokens: prefill_ms="
              f"{prefill_ms:.1f} decode_ms={decode_ms:.1f} per_step_ms="
              f"{decode_ms / steps:.2f} decode_tokens_per_s="
              f"{4 * steps / decode_ms * 1e3:.1f}; ring launches per prefill"
              f" {per_prefill}, per step {per_step}; greedy tokens equal to "
              f"phase 3's world-1 engine: {same.item():.3f} (not gated) "
              f"[{card}]", flush=True)
        before = ring_counts(ag, rs)
        res, stream_ms = sync_time(
            torch, lambda: eng.serve_stream(params, stream, TP_GEN))
        check([len(r) for r in res] == [len(p) + TP_GEN for p in stream],
              f"({name}) serve_stream row lengths")
        got = {k: v - before[k] for k, v in ring_counts(ag, rs).items()}
        print(f"tp serve_stream ({name}): 6 prompts (65-128 tokens) through "
              f"4 rows, {TP_GEN} new tokens in {stream_ms:.1f} ms; ring "
              f"launches {got} [{card}]", flush=True)
        check(sum(got.values()) > 0,
              f"({name}) serve_stream launched no ring kernel")
        phase_ag_server(torch, eng, params, square, stream, f"W=4 {name}",
                        card, ragged=4)
    check(all(c.total == 0 for c in world1),
          f"world-1 kernels ran on the world-{TP_WORLD} path: "
          f"{[c.total for c in world1]}")
    launches = {"gemm": dict(ag.ag_ring_launches.by_shape),
                "swiglu": dict(ag.ag_swiglu_ring_launches.by_shape),
                "rs": dict(rs.rs_ring_launches.by_shape),
                "ar": dict(rs.ar_ring_launches.by_shape)}
    print(f"tp main path ring launches: {launches}", flush=True)
    return model, launches                           # ---- main path ends


def phase_tp_checks(torch, ag, rs, model, params, square, cfg, card) -> None:
    """Phase 18, checks: prefill and decode-step logits through the ring
    kernels within LOGITS_ATOL of the same world-4 model in its plain
    modes (xla for ag_rs, xla_ar for gemm_ar); one layer under sync debug
    "error"; wall and device time of a decode step and a prefill, and the
    device time by kernel."""
    from triton_dist_tpu_torch.models import KVCacheManager
    ids = torch.tensor(square, device="cuda")

    def caches():
        return KVCacheManager(cfg.num_hidden_layers, 4, 1024,
                              cfg.num_key_value_heads, cfg.head_dim,
                              dtype=cfg.dtype, device="cuda",
                              world=TP_WORLD).init()

    def prefill(mode, kv=None):
        with torch.no_grad():
            return model.forward(params, ids, kv or caches(), 0, mode=mode)

    pre_plain, kv_plain = prefill("xla")
    pre_ring, kv_ring = prefill("ag_rs")
    tok = pre_plain[:, -1].argmax(-1)[:, None]
    for what, got, ref in [("prefill ag_rs vs xla", pre_ring[:, -1],
                            pre_plain[:, -1])] + [
            (f"decode step {mode} vs {plain}",
             model.forward(params, tok, kv_ring, 128, mode=mode)[0][:, 0],
             model.forward(params, tok, kv_plain, 128, mode=plain)[0][:, 0])
            for mode, plain in (("gemm_ar", "xla_ar"), ("ag_rs", "xla"))]:
        check(bool(torch.isfinite(got).all()), f"non-finite {what} logits")
        err = (got - ref).abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        check(err <= LOGITS_ATOL, f"world-4 {what} logits differ by {err}")
        print(f"tp logits (W={TP_WORLD}): {what} max abs diff {err:.4g} (tol"
              f" {LOGITS_ATOL}), argmax agreement {agree:.2f} [{card}]",
              flush=True)

    lp = params["layers"][0]
    x = torch.randn((512, cfg.hidden_size), device="cuda").to(cfg.dtype)
    pos = torch.arange(128, device="cuda").expand(4, 128)
    for mode in ("ag_rs", "gemm_ar"):
        def layer():
            a, _ = model.attn(lp["attn"], x, pos, model.rope_cache,
                              kv_ring[0], 0, mode=mode)
            return model.mlp(lp["mlp"], x + a, mode=mode)
        layer()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = layer()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(bool(torch.isfinite(y).all()), f"non-finite {mode} layer")
        print(f"tp layer (attention + MLP, 512 rows, W={TP_WORLD}, mode "
              f"{mode}) ran under torch.cuda.set_sync_debug_mode('error'): "
              f"no host sync", flush=True)

    for name, (pf, dc) in TP_ENGINES.items():
        kv = caches()
        prefill(pf, kv)

        def step():
            with torch.no_grad():
                return model.forward(params, tok, kv, 128, mode=dc)[0]

        for what, fn in ((f"decode step ({dc})", step),
                         (f"prefill 4 x 128 ({pf})",
                          lambda: prefill(pf)[0])):
            walls = [sync_time(torch, fn)[1] for _ in range(5)]
            wall = sorted(walls)[2]
            rows, whole = profiled_rows(torch, fn, 3, "tp step")
            dev = sum(ms for _, ms in rows) or float("nan")  # none recorded
            ring = sum(ms for key, ms in rows
                       if "ring_kernel" in key or "ring_wg_kernel" in key)
            ge, le = bound_marks(whole)
            print(f"tp {what}, engine {name}, W={TP_WORLD}, forward only: "
                  f"wall {wall:.2f} ms (median of 5), device {ge}{dev:.2f} "
                  f"ms, device idle share {le}{1 - dev / wall:.2f}; ring "
                  f"kernels {ge}{ring:.3f} ms ({ring / dev:.2f} of device "
                  f"time{'' if whole else ', from a session that lost records'}"
                  f") [{card}]", flush=True)
            for kernel, ms in sorted(rows, key=lambda r: -r[1])[:6]:
                print(f"  tp {what} device time: {ms:.3f} ms "
                      f"({ms / dev:.2f}) {kernel[:70]}", flush=True)


def ring_kernels_line(records, launches) -> list:
    out = []
    for rec, op, key in records:
        rec = dict(rec, launches=launches[op].get(key, 0))
        check(rec["launches"] > 0, f"{rec['name']} never launched on the "
                                   f"world-{TP_WORLD} path")
        out.append(rec)
    return out


# -- slice 9: sequence parallelism at world 4 (mode "sp" over a sequence-split
# cache) through the flash-decode exchange and the ring-KV prefill ------------
SPW_WORLD = 4
#: Phase 19's worlds of the flash-decode exchange and of the ring prefill.
SPW_FD_WORLDS, SPW_RING_WORLDS = (2, 3, 4, 8), (2, 4, 8)
#: Positions per rank of phase 19's decode caches.
SPW_T_LOC = 256
#: Phase 20's engines: name -> (max_seq, Engine options, the launch counter
#: of its decode steps, the key's cache kind). (a) paged, (b) contiguous
#: with 8 MiB per rank (the tiled variant), (c) contiguous with 2 MiB per
#: rank (the single-pass variant), prefilled in chunks of 64.
SPW_ENGINES = {"a": (1024, {"paged": True, "page_size": FD_PAGE},
                     "world_tiled", "paged"),
               "b": (4096, {}, "world_tiled", "dense"),
               "c": (1024, {"prefill_chunk": 64}, "world_single", "dense")}
SPW_REPLACES = {"world_single": 262, "world_tiled": 280}


def spw_paged(torch, k, v, world: int):
    """Each rank's positions of k/v (B, world t_loc, Hkv, D) page by page
    in a seeded random order over its own pool of one row's pages more
    than they fill: (pool_k, pool_v, table (world, B, n_pages))."""
    b, t = k.shape[:2]
    t_loc = t // world
    n_pages = t_loc // FD_PAGE
    per = b * n_pages + 1
    gen = torch.Generator().manual_seed(world)
    table = torch.stack([torch.randperm(per - 1, generator=gen)[:b * n_pages]
                         for _ in range(world)]).reshape(world, b, n_pages)
    rows = (table + torch.arange(world)[:, None, None] * per).reshape(-1)
    pools = []
    for x in (k, v):
        pool = torch.zeros((world * per, FD_PAGE) + tuple(x.shape[2:]),
                           dtype=x.dtype, device="cuda")
        pool[rows.cuda()] = x.reshape(b, world, n_pages, FD_PAGE,
                                      *x.shape[2:]).transpose(0, 1).reshape(
            -1, FD_PAGE, *x.shape[2:])
        pools.append(pool)
    return pools[0], pools[1], table.to(torch.int32).cuda()


def spw_weight(fd, q, k, v, lens, world: int):
    """sum_j (p_j / l)|v_j| of a world-W decode output: its plain version
    in f32 over |v|."""
    return fd.flash_decode_world_reference(q.float(), k.float(),
                                           v.float().abs(), lens,
                                           world).float()


def phase_sp_world_kernels(torch, fd, sp, rd, cfg, card: str) -> None:
    """Phase 19: the world-W flash-decode exchange (``tdt_flash_decode_
    world``) against the plain world-W decode at W = 2, 3, 4, 8, single /
    tiled dense / tiled paged, bf16 and f32, over kv_len 1 (every rank but
    the first empty), a ragged row per rank count and a full cache, held
    to the weight rule with the W rank outputs bit-equal and repeats
    bit-identical; a push skipped with its signal still set (on a fresh
    context, whose combine buffers are NaN) must fail the rule. Then the
    ring-KV prefill (``tdt_sp_ring_attention``) at W = 2, 4, 8 against
    the plain world-W fused prefill, within ``sp_attention_tolerance``,
    with a skipped forward refused."""
    print("== phase 19: world-W flash-decode exchange and ring-KV prefill "
          "vs their plain versions", flush=True)
    t0 = time.perf_counter()
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    n_cases, worst = 0, {}
    for world in SPW_FD_WORLDS:
        group = rd.create_rank_group(world, "sp", "cuda")
        t = world * SPW_T_LOC
        for dt, dtype in dtypes.items():
            q, k, v = fd_operands(torch, dtype, t, seed=190 + world)
            pool_k, pool_v, table = spw_paged(torch, k, v, world)
            for name, lens in (("kv_len 1", [1] * FD_B),
                               ("ragged", [1, 17, SPW_T_LOC + 44, t]),
                               ("full", [t] * FD_B)):
                lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
                want = fd.flash_decode_world_reference(q, k, v, lt, world)
                w = spw_weight(fd, q, k, v, lt, world)
                ctx = fd.create_flash_decode_context(group)
                for variant, paged in (("single", False), ("tiled", False),
                                       ("tiled", True)):
                    kk, vv = (pool_k, pool_v) if paged else (k, v)
                    tab = table if paged else None
                    outs = fd.flash_decode_world(q, kk, vv, lt, ctx, variant,
                                                 tab)
                    again = fd.flash_decode_world(q, kk, vv, lt, ctx,
                                                  variant, tab)
                    torch.cuda.synchronize()
                    err, ok = fd_error(torch, outs[0], want, w)
                    equal = all(torch.equal(outs[0], outs[r])
                                for r in range(world))
                    check(ok and equal and torch.equal(outs, again),
                          f"world decode W={world} {variant} paged={paged} "
                          f"{dt} {name}: err {err} ok {ok}, ranks "
                          f"bit-equal {equal}")
                    key = (variant, dt)
                    worst[key] = max(worst.get(key, 0.0), err)
                    n_cases += 1
            lt = torch.full((FD_B,), t, dtype=torch.int32, device="cuda")
            want = fd.flash_decode_world_reference(q, k, v, lt, world)
            w = spw_weight(fd, q, k, v, lt, world)
            for variant in ("single", "tiled"):
                bad = fd.flash_decode_world(
                    q, k, v, lt, fd.create_flash_decode_context(group),
                    variant, fault=True)
                torch.cuda.synchronize()
                bad_err, bad_ok = fd_error(torch, bad[1], want, w)
                check(not bad_ok, f"world decode W={world} {variant} {dt}: "
                                  f"the planted fault was not refused")
    print(f"flash decode at W = {SPW_FD_WORLDS}: {n_cases} cases (single, "
          f"tiled dense, tiled paged; bf16, f32; kv_len 1, ragged, full) "
          f"within the weight rule (f32: {F32_ATOL / 3:.0e}), rank outputs "
          f"bit-equal, repeats bit-identical; worst max_abs_err by variant "
          f"{ {f'{v}/{d}': float(f'{e:.3g}') for (v, d), e in worst.items()} }"
          f"; a skipped push (its signal set) refused at every W, variant "
          f"and dtype [{card}]", flush=True)

    hq, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    cases = [(w, "bf16", True, 4096) for w in SPW_RING_WORLDS] + [
        (4, "bf16", False, 4096), (4, "f32", True, 512)]
    for world, dt, causal, s in cases:
        group = rd.create_rank_group(world, "sp", "cuda")
        q, k, v = sp_operands(torch, dtypes[dt], 1, s, hq, hkv, d,
                              seed=195 + world)
        ctx = sp.create_sp_attention_context(causal=causal, group=group)
        got = sp.launch_sp_ring_attention(q, k, v, ctx)
        again = sp.launch_sp_ring_attention(q, k, v, ctx)
        torch.cuda.synchronize()
        ref = sp.sp_attention_fused_reference(q, k, v, causal, sp.KV_TILE,
                                              world)
        lim = sp.sp_attention_tolerance(got, ref, q, k, v, causal)
        err, ok, used = sp_error(got, ref, lim)
        bad = sp.launch_sp_ring_attention(
            q, k, v, sp.create_sp_attention_context(causal=causal,
                                                    group=group), fault=True)
        bad_err, bad_ok, _ = sp_error(bad, ref, lim)
        same = torch.equal(got, again)
        ms = wall_ms(torch, lambda: sp.launch_sp_ring_attention(q, k, v, ctx))
        w1 = wall_ms(torch, lambda: sp.launch_sp_attention(q, k, v, causal))
        print(f"sp ring prefill W={world} {dt} causal={causal} S={s} heads "
              f"{hq}/{hkv} D={d}: max_abs_err={err:.3e} (largest share of "
              f"the tolerance {used:.3f}) ok={ok}; repeat bit-identical="
              f"{same}; planted fault (rank 0's first forward skipped, its "
              f"signal set): max_abs_err={bad_err}, refused={not bad_ok}; "
              f"ring {ms:.3f} ms ({sp_tflops(1, s, hq, d, causal, ms):.0f} "
              f"TFLOP/s), the world-1 kernel at the same global shape "
              f"{w1:.3f} ms, ring / world 1 {ms / w1:.2f} [{card}]",
              flush=True)
        check(ok and same and not bad_ok,
              f"sp ring prefill W={world} {dt}: err {err}, repeat {same}, "
              f"fault refused {not bad_ok}")
        del q, k, v, got, again, bad, ref, lim
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s", flush=True)


def spw_counts(fd, sp) -> dict:
    out = {f"flash_decode_{n}": c.total for n, c in fd.launches.items()}
    out["sp_attention"] = sp.sp_attention_launches.total
    out["sp_ring"] = sp.sp_ring_launches.total
    return out


def spw_plain(fd, dense):
    """Route the sp forward's decode through the plain world-W versions
    (``flash_decode_world_reference`` and its paged form); the returned
    function restores the kernels."""
    saved = dense.gqa_fwd_batch_decode, dense.gqa_fwd_batch_decode_paged
    dense.gqa_fwd_batch_decode = (
        lambda q, k, v, lens, ctx=None:
        fd.flash_decode_world_reference(q, k, v, lens, ctx.world_size))
    dense.gqa_fwd_batch_decode_paged = (
        lambda q, pk, pv, table, lens, ctx=None:
        fd.flash_decode_paged_reference(q, pk, pv, table, lens))

    def restore():
        dense.gqa_fwd_batch_decode, dense.gqa_fwd_batch_decode_paged = saved
    return restore


def phase_sp_world_main(torch, models, fd, sp, ops, cfg, params, square,
                        base_sp, card: str):
    """Phase 20, this slice's main path: Qwen3-8B (full width and depth,
    phase 3's params) as ``DenseLLM(sp_axis="sp", sp_world=4)``, served by
    the engines of :data:`SPW_ENGINES` (4 x 128 prompts, GEN new tokens),
    a prefix-cache stream through the paged engine and the server over
    it, every count set to 0 just before: per decode step one world-W
    launch per layer of the engine's variant, no world-1 flash-decode
    kernel, no prefill kernel. Then a decode step's logits against the
    same step through the plain world-4 decode, and the step's wall and
    device time. Returns (the launch counts by counter and key, the
    engines)."""
    from triton_dist_tpu_torch.models import dense
    print(f"== phase 20: Qwen3-8B served in mode 'sp' at sequence world "
          f"{SPW_WORLD} through the world-W flash-decode kernel", flush=True)
    t0 = time.perf_counter()
    layers = cfg.num_hidden_layers
    model = models.AutoLLM.build(cfg, sp_axis="sp", sp_world=SPW_WORLD)
    check(model.sp_world == SPW_WORLD and model.fd_ctx.world_size
          == SPW_WORLD, "AutoLLM did not build a sequence-world-4 model")
    engines = {name: models.Engine(model, batch=4, max_seq=max_seq,
                                   prefill_mode="sp", decode_mode="sp", **kw)
               for name, (max_seq, kw, _, _) in SPW_ENGINES.items()}
    engines["a'"] = models.Engine(model, batch=4, max_seq=1024,
                                  prefill_mode="sp", decode_mode="sp",
                                  paged=True, page_size=FD_PAGE,
                                  kv_slots_per_dev=STREAM_SLOTS)
    _, stream = sp_prompts(torch, cfg, 20)
    for name in SPW_ENGINES:                      # warm-up
        engines[name].serve(params, square, 2)
    engines["a'"].serve_stream(params, stream[:2], 2)
    counters = list(fd.launches.values()) + [sp.sp_attention_launches,
                                             sp.sp_ring_launches,
                                             ops.launches]
    for c in counters:                            # ---- the main path starts
        c.reset()
    steps = GEN - 1
    for name, (max_seq, _, counter, kind) in SPW_ENGINES.items():
        eng = engines[name]
        before = spw_counts(fd, sp)
        _, prefill_ms = sync_time(torch, lambda: eng.serve(params, square, 1))
        check(spw_counts(fd, sp) == before,
              f"({name}) the prefill launched a kernel")
        out, serve_ms = sync_time(torch,
                                  lambda: eng.serve(params, square, GEN))
        after = spw_counts(fd, sp)
        got = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        want = {f"flash_decode_{counter}": layers * steps}
        check(got == want, f"({name}) launches {got}, expected {want}")
        check(tuple(out.shape) == (4, 128 + GEN), f"({name}) serve shape")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "token out of vocabulary")
        same = (out[:, 128:] == base_sp[:, 128:]).float().mean().item()
        decode_ms = serve_ms - prefill_ms
        print(f"sp serve ({name}: "
              f"{'paged' if eng.paged else 'contiguous'}, max_seq {max_seq}"
              f"{', prefill_chunk 64' if eng.prefill_chunk else ''}, W="
              f"{SPW_WORLD}): batch 4 x 128 prompt, {GEN} new tokens: "
              f"prefill_ms={prefill_ms:.1f} decode_ms={decode_ms:.1f} "
              f"per_step_ms={decode_ms / steps:.2f} decode_tokens_per_s="
              f"{4 * steps / decode_ms * 1e3:.1f}; launches {got} = "
              f"{layers} x {steps} {counter}; greedy tokens equal to phase "
              f"8's world-1 engine on {same:.3f} (not gated) [{card}]",
              flush=True)
    eng = engines["a'"]
    before = spw_counts(fd, sp)
    res, stream_ms = sync_time(
        torch, lambda: eng.serve_stream(params, stream, GEN))
    check([len(r) for r in res] == [len(p) + GEN for p in stream],
          "sp serve_stream row lengths")
    stats, audit = eng.kv.prefix.stats(), eng.kv.block_audit()
    check(stats["hit_blocks"] > 0, f"no prefix hits: {stats}")
    check(audit["active"] == 0 and audit["committed"] == 0
          and audit["free"] + audit["evictable"] == audit["total"],
          f"block audit not clean: {audit}")
    after = spw_counts(fd, sp)
    got = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    check(set(got) == {"flash_decode_world_tiled"}
          and got["flash_decode_world_tiled"] % layers == 0,
          f"stream launches {got}")
    print(f"sp serve_stream (a': paged, W={SPW_WORLD}, {STREAM_SLOTS} "
          f"blocks per rank): 6 prompts sharing a {PREFIX_LEN}-token prefix "
          f"through 4 rows, {GEN} new tokens in {stream_ms:.1f} ms; decode "
          f"steps {got['flash_decode_world_tiled'] // layers}; prefix "
          f"{stats}; audit {audit} [{card}]", flush=True)
    phase_sp_server(torch, engines["a"], params, square, stream, card)
    launches = {n: dict(c.by_shape) for n, c in fd.launches.items()}
    check(all(fd.launches[n].total == 0 for n in ("partial", "combine",
                                                  "single"))
          and ops.launches.total == 0 and sp.sp_attention_launches.total
          == 0 and sp.sp_ring_launches.total == 0,
          f"a world-1 or prefill kernel ran on the world-{SPW_WORLD} path: "
          f"{spw_counts(fd, sp)}, gemm_ar {ops.launches.total}")
    print(f"sp world-{SPW_WORLD} main path launches: {launches}",
          flush=True)                             # ---- main path ends

    for name in SPW_ENGINES:
        step = sp_step(torch, engines[name], params, square)
        got = step()
        restore = spw_plain(fd, dense)
        try:
            ref = step()
        finally:
            restore()
        check(bool(torch.isfinite(got).all()), "non-finite sp logits")
        err = (got - ref).abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        check(err <= LOGITS_ATOL, f"({name}) W={SPW_WORLD} decode logits "
                                  f"differ from the plain decode by {err}")
        walls = [sync_time(torch, step)[1] for _ in range(5)]
        wall = sorted(walls)[2]
        dev, ge, le = device_ms(torch, step, n=3)
        print(f"sp decode step ({name}, W={SPW_WORLD}, forward only): "
              f"logits vs the plain world-{SPW_WORLD} decode max abs diff "
              f"{err:.4g} (tol {LOGITS_ATOL}), argmax agreement {agree:.2f}; "
              f"wall {wall:.2f} ms (median of 5), device {ge}{dev:.2f} ms, "
              f"device idle share {le}{1 - dev / wall:.2f} [{card}]",
              flush=True)
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, engines


def spw_decode_bound(live: int, b: int, world: int, itemsize: int,
                     kind: str):
    """(least ms, what bounds it) of one world-W decode: the live K/V rows,
    q and the W outputs once over HBM, plus each rank's (acc, l, m)
    partial written into W - 1 peers' buffers and read there once (the
    exchange moves HBM to HBM on one card); 4 operations per (query head,
    live position, head-dim element)."""
    kv = 2 * live * FD_HKV * FD_D * itemsize
    q_out = (1 + world) * b * FD_HQ * FD_D * itemsize
    exchange = 2 * world * (world - 1) * b * FD_HQ * (FD_D + 2) * 4
    by_bytes = (kv + q_out + exchange) / HBM_BYTES_PER_S * 1e3
    by_ops = 4.0 * FD_HQ * FD_D * live / PEAK_FLOPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def spw_fd_records(torch, fd, rd, launches) -> list:
    """The JSON records of the world-W decode at phase 20's shapes: bf16,
    batch 4, kv_len 160 (the last decode step of a 128-token prompt and
    GEN - 1 steps), W = 4: engine (a)'s paged pool, (b)'s 4096 and (c)'s
    1024 positions. ``library_ms``: one ``scaled_dot_product_attention``
    with the kv_len mask over the global (B, T) cache, a yardstick the
    port never calls. ``launches``: phase 20's, by key. ``ms``: the
    call's time by queued CUDA events (:func:`queued_ms`; the wrapper's
    small tensor ops around the launch included). ``w1_ms``: the world-1
    call of the same variant on the global dense cache; ``exchange_ms``:
    ms − w1_ms."""
    import torch.nn.functional as F
    from triton_dist_tpu_torch.models.kv_cache import PagedKVCacheManager
    world, dtype, kind = SPW_WORLD, torch.bfloat16, "bf16"
    group = rd.create_rank_group(world, "sp", "cuda")
    lens = torch.full((FD_B,), 160, dtype=torch.int32, device="cuda")
    out = []
    for name, t, variant, paged in (
            ("flash_decode_world_tiled[paged]", 1024, "tiled", True),
            ("flash_decode_world_tiled[dense]", 4096, "tiled", False),
            ("flash_decode_world_single", 1024, "single", False)):
        q, k, v = fd_operands(torch, dtype, t, seed=200 + t)
        kk, vv, tab = (spw_paged(torch, k, v, world) if paged
                       else (k, v, None))
        ctx = fd.create_flash_decode_context(group)

        def kernel():
            return fd.flash_decode_world(q, kk, vv, lens, ctx, variant, tab)

        def plain():
            if paged:
                return fd.flash_decode_paged_reference(q, kk, vv, tab, lens)
            return fd.flash_decode_world_reference(q, k, v, lens, world)
        got = kernel()
        want = fd.flash_decode_world_reference(q, k, v, lens, world)
        err, ok = fd_error(torch, got[0], want,
                           spw_weight(fd, q, k, v, lens, world))
        check(ok, f"{name}: max abs err {err} outside tolerance")
        view = (PagedKVCacheManager.gathered_view(kk, tab),
                PagedKVCacheManager.gathered_view(vv, tab)) if paged else (k,
                                                                          v)
        mask = (torch.arange(t, device="cuda")[None, :]
                < lens[:, None])[:, None, None]
        q4, k4, v4 = q[:, :, None], view[0].transpose(1, 2), \
            view[1].transpose(1, 2)
        counter = "world_" + variant
        key = ("paged" if paged else "dense", world, FD_B, t // world)
        bnd, by = spw_decode_bound(160 * FD_B, FD_B, world, 2, kind)
        w1_ctx = fd.FlashDecodeContext(
            variant="einsum" if variant == "single" else "tiled")
        ms = queued_ms(torch, kernel)
        w1_ms = queued_ms(torch, lambda: fd.gqa_fwd_batch_decode(
            q, k, v, lens, w1_ctx))
        out.append({
            "name": name, "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/flash_decode.cu",
            "replaces": f"triton_dist_tpu/ops/flash_decode.py:"
                        f"{SPW_REPLACES[counter]}",
            "launches": launches[counter].get(key, 0), "max_abs_err": err,
            "ms": ms, "w1_ms": w1_ms, "exchange_ms": ms - w1_ms,
            "plain_ms": queued_ms(torch, plain, may_wait=True),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": queued_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, enable_gqa=True)),
            "wall_ms": wall_ms(torch, kernel),
            "shape": [world, FD_B, FD_HQ, FD_HKV, FD_D, t, 160], "ok": ok})
        check(out[-1]["launches"] > 0, f"{name} never launched on the "
                                       f"world-{SPW_WORLD} path")
        print(f"kernel {name} W={world} bf16 kv_len 160 of {t}: "
              f"kernel_ms={ms:.5f} w1_ms={w1_ms:.5f} exchange_ms="
              f"{ms - w1_ms:.5f} plain_ms="
              f"{out[-1]['plain_ms']:.4f} library_ms="
              f"{out[-1]['library_ms']:.4f} bound_ms={bnd:.5f} ({by}) "
              f"launches={out[-1]['launches']} max_abs_err={err:.3e}",
              flush=True)
    return out


def phase_sp_world_long(torch, layers, fd, sp, rd, cfg, full, card: str):
    """Phase 21, the long-context path at sequence world 4, every count set
    to 0 just before it: ``SpAttentionLayer(impl="pallas")`` over a group
    of 4 on phase 14's 32768-token inputs (one ring launch, within
    ``sp_attention_tolerance`` of the plain world-4 fused prefill), then
    SP_DECODE append + decode steps through ``SpFlashDecodeLayer`` over
    the sequence-split cache (one world-W launch each, within the weight
    rule of the plain world-4 decode). Returns the JSON records of the
    ring prefill and of the decode at kv_len SP_S + SP_DECODE."""
    import torch.nn.functional as F
    print(f"== phase 21: SP long context at sequence world {SPW_WORLD}: the "
          f"32k ring prefill and decode over the split cache", flush=True)
    t_start = time.perf_counter()
    hq, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    world = SPW_WORLD
    group = rd.create_rank_group(world, "sp", "cuda")
    q, k, v, _ = full
    counters = list(fd.launches.values()) + [sp.sp_attention_launches,
                                             sp.sp_ring_launches]
    for c in counters:
        c.reset()                                  # ---- main path starts
    prefill = layers.SpAttentionLayer(impl="pallas", group=group)
    out, prefill_ms = sync_time(torch, lambda: prefill(q, k, v))
    check(sp.sp_ring_launches.total == 1
          and sp.sp_attention_launches.total == 0,
          f"the world-{world} prefill launched {spw_counts(fd, sp)}")
    decode = layers.SpFlashDecodeLayer(1, SP_S + SP_DECODE, hkv, d,
                                       dtype=torch.bfloat16, group=group)
    cache = decode.append(decode.init_cache(), k, v, 0)
    gen = torch.Generator(device="cuda").manual_seed(210)
    steps = []
    for i in range(SP_DECODE):
        qn = torch.randn((1, hq, d), generator=gen, device="cuda").bfloat16()
        kn, vn = (torch.randn((1, 1, hkv, d), generator=gen,
                              device="cuda").bfloat16() for _ in range(2))
        cache = decode.append(cache, kn, vn, SP_S + i)
        before = fd.launches["world_tiled"].total
        steps.append((qn, decode(qn, cache, SP_S + i + 1)))
        check(fd.launches["world_tiled"].total == before + 1,
              f"decode step {i} did not launch the world-W kernel once")
    torch.cuda.synchronize()
    launches = {"sp_ring": dict(sp.sp_ring_launches.by_shape),
                "world_tiled": dict(fd.launches["world_tiled"].by_shape)}
    check(all(fd.launches[n].total == 0 for n in ("partial", "combine",
                                                  "single", "world_single")),
          f"a world-1 decode kernel ran: {spw_counts(fd, sp)}")
    print(f"sp world-{world} long-context path launches: "
          f"{spw_counts(fd, sp)} {launches}", flush=True)
    # ---- main path ends

    ref = sp.sp_attention_fused_reference(q, k, v, True, sp.KV_TILE, world)
    lim = sp.sp_attention_tolerance(out, ref, q, k, v, True)
    err, ok, used = sp_error(out, ref, lim)
    check(ok and bool(torch.isfinite(out.float()).all()),
          f"the world-{world} 32k prefill: max abs err {err}")
    del ref, lim
    worst, share = 0.0, 0.0
    for i, (qn, got) in enumerate(steps):
        n = SP_S + i + 1
        ref = fd.flash_decode_world_reference(qn, cache[0], cache[1], n,
                                              world)
        lim = sp.bf16_attention_limit(got, ref, spw_weight(
            fd, qn, cache[0], cache[1], n, world))
        e, o, u = sp_error(got, ref, lim)
        check(o, f"decode step {i}: max abs err {e} outside tolerance")
        worst, share = max(worst, e), max(share, u)
    ctx = sp.create_sp_attention_context(group=group)
    kernel = lambda: sp.launch_sp_ring_attention(q, k, v, ctx)  # noqa: E731
    ms = wall_ms(torch, kernel, n=5)
    plain_ms = wall_ms(torch, lambda: sp.sp_attention_fused_reference(
        q, k, v, True, sp.KV_TILE, world), n=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = wall_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), n=5)
    del qt, kt, vt
    # The least time: q, k, v read and the output written once, plus the
    # ring's copies (each rank's K/V chunk into W workspaces, read and
    # written once each) as HBM traffic; or the causal pass's operations.
    copies = 2 * 2 * world * SP_S * hkv * d * 2
    by_bytes = (2 * SP_S * (hq + hkv) * d * 2 + copies) \
        / HBM_BYTES_PER_S * 1e3
    by_ops = sp_bound_ms(1, SP_S, hq, hkv, d, 2, "bf16", True)[0]
    bnd, by = ((by_bytes, "bytes") if by_bytes >= by_ops
               else (by_ops, "operations"))
    ring_rec = {
        "name": "sp_ring_attention", "route": "cuda",
        "source": "triton_dist_tpu_torch/csrc/sp_attention.cu",
        "replaces": "triton_dist_tpu/ops/sp_attention.py:147",
        "launches": sum(launches["sp_ring"].values()), "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": lib_ms, "shape": [world, 1, SP_S, hq, hkv, d],
        "ok": ok, "tol_share": used}
    w1_ms = wall_ms(torch, lambda: sp.launch_sp_attention(q, k, v, True),
                    n=5)
    ring_rec["w1_ms"] = w1_ms
    print(f"SpAttentionLayer(impl='pallas', W={world}) prefill B=1 S={SP_S}:"
          f" 1 ring launch, wall {prefill_ms:.1f} ms; max_abs_err vs the "
          f"plain world-{world} version {err:.3e} (largest share of the "
          f"tolerance {used:.3f}); kernel_ms={ms:.3f} (CUDA events; "
          f"{sp_tflops(1, SP_S, hq, d, True, ms):.0f} TFLOP/s) "
          f"plain_ms={plain_ms:.1f} library_ms={lib_ms:.3f} (SDPA, global "
          f"causal) bound_ms={bnd:.3f} ({by}); the world-1 kernel on the "
          f"same inputs {w1_ms:.3f} ms, ring / world 1 {ms / w1_ms:.2f} "
          f"[{card}]", flush=True)

    t = SP_S + SP_DECODE
    qn = steps[-1][0]
    dctx = fd.create_flash_decode_context(group)
    dkernel = lambda: fd.flash_decode_world(  # noqa: E731
        qn, cache[0], cache[1], t, dctx, "tiled")
    dms = queued_ms(torch, dkernel)
    w1_ctx = fd.FlashDecodeContext()
    w1_dms = queued_ms(torch, lambda: fd.gqa_fwd_batch_decode(
        qn, cache[0], cache[1], t, w1_ctx))
    dplain = queued_ms(torch, lambda: fd.flash_decode_world_reference(
        qn, cache[0], cache[1], t, world), may_wait=True)
    kq, kk, kv_ = qn[:, :, None], cache[0].transpose(1, 2), \
        cache[1].transpose(1, 2)
    dlib = queued_ms(torch, lambda: F.scaled_dot_product_attention(
        kq, kk, kv_, enable_gqa=True))
    kv_bytes = 2 * t * hkv * d * 2
    exchange = 2 * world * (world - 1) * hq * (d + 2) * 4
    dbnd = (kv_bytes + (1 + world) * hq * d * 2 + exchange) \
        / HBM_BYTES_PER_S * 1e3
    dec_rec = {
        "name": "flash_decode_world_tiled[dense, kv_len 32k]",
        "route": "cuda",
        "source": "triton_dist_tpu_torch/csrc/flash_decode.cu",
        "replaces": "triton_dist_tpu/ops/flash_decode.py:280",
        "launches": sum(launches["world_tiled"].values()),
        "max_abs_err": worst, "ms": dms, "w1_ms": w1_dms,
        "exchange_ms": dms - w1_dms, "plain_ms": dplain,
        "bound_ms": dbnd, "bound_by": "bytes", "library_ms": dlib,
        "wall_ms": wall_ms(torch, dkernel),
        "shape": [world, 1, hq, hkv, d, t], "ok": True}
    print(f"SpFlashDecodeLayer(W={world}): {SP_DECODE} append + decode steps "
          f"over the split {SP_S}-position cache, 1 world-W launch each, "
          f"max_abs_err vs the plain world-{world} decode {worst:.3e} "
          f"(largest share of the weight rule {share:.3f}); a step's kernel "
          f"{dms:.5f} ms device (world 1's fused launch on the same "
          f"cache: {w1_dms:.5f} ms, exchange_ms {dms - w1_dms:.5f}), plain "
          f"{dplain:.4f}, SDPA {dlib:.4f}, bound {dbnd:.4f} ms (bytes) "
          f"[{card}]", flush=True)
    print(f"phase 21 took {time.perf_counter() - t_start:.1f} s", flush=True)
    del cache, decode, steps
    return [ring_rec, dec_rec]


def phase_ep_mode(torch, ag, rs, a2a, cfg, model, params, square, card):
    """Phase 16, mode "ep" (JAX's EP forward): attention through the ring
    kernels (ag_rs: 4 x 128 and 4 rows both split over the ranks), the
    MoE through the all-to-all; one prefill and four decode steps, every
    count set to 0 just before, against the same steps in mode "xla"
    with the routing held fixed (replayed from the ep run, as phase 13
    holds it: near-tied experts flip under bf16 differences), within
    MOE_LOGITS_ATOL."""
    from triton_dist_tpu_torch.layers import ep_moe
    from triton_dist_tpu_torch.models import KVCacheManager
    ids = torch.tensor(square, device="cuda")
    layers = cfg.num_hidden_layers
    routing = ep_moe.topk_routing
    counters = {"ag_ring": ag.ag_ring_launches,
                "rs_ring": rs.rs_ring_launches,
                "all_to_all": a2a.a2a_launches}

    def run(mode, replay=None, tokens=None):
        """Prefill + 4 decode steps in ``mode``: (last-position logits of
        each, the tokens fed, the routing of each MoE call, launches of
        each forward). ``replay``: routing to use, in call order."""
        seen, launches, logits = [], [], []

        def route(lg, k, norm=True):
            out = replay.pop(0) if replay is not None else routing(lg, k,
                                                                  norm)
            seen.append(out)
            return out
        kv = KVCacheManager(layers, 4, 256, cfg.num_key_value_heads,
                            cfg.head_dim, dtype=cfg.dtype, device="cuda",
                            world=EP_WORLD).init()
        ep_moe.topk_routing = route
        try:
            with torch.no_grad():
                x, tok, fed = ids, None, []
                for i in range(5):
                    for c in counters.values():
                        c.reset()
                    out, _ = model.forward(params, x, kv,
                                           0 if i == 0 else 127 + i,
                                           mode=mode)
                    launches.append({n: c.total
                                     for n, c in counters.items()})
                    logits.append(out[:, -1])
                    tok = (tokens[i] if tokens is not None
                           else out[:, -1].argmax(-1)[:, None])
                    fed.append(tok)
                    x = tok
        finally:
            ep_moe.topk_routing = routing
        return logits, fed, seen, launches

    ep, fed, seen, launches = run("ep")
    xla, _, _, _ = run("xla", replay=list(seen), tokens=fed)
    want = {"ag_ring": layers, "rs_ring": layers, "all_to_all": 2 * layers}
    check(all(n == want for n in launches),
          f"mode ep launches per forward {launches}, want {want}")
    for i, (got, ref) in enumerate(zip(ep, xla)):
        what = ("prefill (4 x 128) last-position" if i == 0
                else f"decode step {i}")
        check(bool(torch.isfinite(got).all()), f"non-finite ep {what}")
        err = (got - ref).abs().max().item()
        check(err <= MOE_LOGITS_ATOL, f"mode ep {what} logits differ from "
                                      f"mode xla by {err}")
        print(f"ep mode 'ep' (W={EP_WORLD}, attention ag_rs through the ring"
              f" kernels): {what} logits vs mode xla, routing held fixed, "
              f"max abs diff {err:.4g} (tol {MOE_LOGITS_ATOL}); launches "
              f"{want} [{card}]", flush=True)


# -- slice 10: tensor-parallel MoE at world 4 through the world-W all-gather --
#: Ranks of the TP-MoE main path: each holds 8 query heads, 1 KV head and a
#: 192-wide column shard of every expert of Qwen3-30B-A3B.
TPM_WORLD = 4
#: New tokens of phase 23's serves (as phase 16's).
TPM_GEN = 16
#: The engines of phase 23: name -> (prefill mode, decode mode).
TPM_ENGINES = {"default": ("xla_ar", "gemm_ar"), "fused": ("ag_rs", "ag_rs")}
#: Phase 22's worlds, and its shapes at Qwen3-30B-A3B's hidden 2048: the
#: decode (4 tokens) and prefill (4 x 128) all-gather of TPMoE, padded to a
#: multiple of the ranks as TPMoE pads them, and one large one.
AGW_WORLDS = (2, 3, 4, 8)
AGW_SHAPES = (("decode", 4, 2048), ("prefill", 512, 2048),
              ("large", 8192, 4096))
#: The TPU kernel each method of the world-W kernel replaces
#: (triton_dist_tpu/ops/allgather.py line).
AGW_REPLACES = {"full_mesh_push": 254, "ring_1d": 133, "ring_bidir": 133,
                "broadcast": 218}


def agw_bound_ms(world: int, chunk_bytes: int, broadcast: bool):
    """(least ms, "bytes") of a world-W all-gather (every input chunk read
    once, W copies of the W chunks written once) or broadcast (the root's
    chunk read once, W copies of it written once), over HBM."""
    moved = (1 + world) * chunk_bytes if broadcast else \
        (world + world * world) * chunk_bytes
    return moved / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_agw_kernels(torch, agk, rd, card: str) -> list:
    """Phase 22: the world-W all-gather (full-mesh push, ring, bidirectional
    ring) and broadcast (``csrc/allgather.cu``) against their plain versions
    at W = 2, 3, 4, 8, bf16 and f32, at the shapes of :data:`AGW_SHAPES`:
    every rank's copy written into NaN-filled buffers bit-equal to the
    plain version (so the W copies are bit-equal), a repeat bit-identical,
    and a push (or forward) skipped with its signal still set refused (its
    NaN stays). Then the W = 4 bf16 cases of every method: an entry call
    must queue exactly one kernel (:func:`kernels_a_call`), and each is
    timed by :func:`queued_ms` (the entry, launch gaps included) and by
    the profiler (the kernel alone), beside the plain
    version, one ``Tensor.copy_`` of the same bytes and the bound. Returns
    the JSON records, ``launches`` to fill from phase 23."""
    print("== phase 22: world-W all-gather and broadcast kernels vs their "
          "plain versions", flush=True)
    t0 = time.perf_counter()
    methods = ("full_mesh_push", "ring_1d", "ring_bidir")
    nan = float("nan")
    n_cases = 0
    for world in AGW_WORLDS:
        group = rd.create_rank_group(world, device="cuda")
        ctxs = {m: agk.create_allgather_context(
            method=agk.AllGatherMethod(m), group=group) for m in methods}
        bctx = agk.create_allgather_context(group=group)
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for name, m, n in AGW_SHAPES:
                rows = -(-m // world) * world
                x = torch.randn(rows, n, device="cuda").to(dtype)
                want = agk.all_gather_reference(x, world, stacked=True)
                for meth in methods:
                    mm = agk.AllGatherMethod(meth)
                    got = agk.launch_all_gather_world(
                        x, ctxs[meth], mm, out=torch.full_like(want, nan))
                    again = agk.launch_all_gather_world(x, ctxs[meth], mm)
                    torch.cuda.synchronize()
                    ok = torch.equal(bits(torch, got), bits(torch, want))
                    same = torch.equal(bits(torch, again), bits(torch, got))
                    del got, again
                    bad = agk.launch_all_gather_world(
                        x, agk.create_allgather_context(method=mm,
                                                        group=group),
                        mm, out=torch.full_like(want, nan), fault=True)
                    torch.cuda.synchronize()
                    refused = bool(bad.isnan().any())
                    del bad
                    check(ok and same and refused,
                          f"all-gather W={world} {meth} {dt} {name}: "
                          f"bit-equal {ok}, repeat {same}, fault refused "
                          f"{refused}")
                    n_cases += 1
                del want
                for root in (0, world - 1):
                    want = agk.broadcast_reference(x, root, world)
                    out = torch.full((world, *want.shape), nan, dtype=dtype,
                                     device="cuda")
                    got = agk.launch_broadcast_world(x, root, bctx, out=out)
                    again = agk.launch_broadcast_world(x, root, bctx)
                    bad = agk.launch_broadcast_world(
                        x, root, agk.create_allgather_context(group=group),
                        out=torch.full_like(out, nan), fault=True)
                    torch.cuda.synchronize()
                    ok = all(torch.equal(bits(torch, got[r]),
                                         bits(torch, want))
                             for r in range(world))
                    same = torch.equal(bits(torch, again), bits(torch, got))
                    refused = bool(bad.isnan().any())
                    check(ok and same and refused,
                          f"broadcast W={world} root {root} {dt} {name}: "
                          f"bit-equal {ok}, repeat {same}, fault refused "
                          f"{refused}")
                    n_cases += 1
                    del want, out, got, again, bad
                del x
        torch.cuda.empty_cache()
    print(f"world-W all-gather (full-mesh push, ring, bidirectional ring) "
          f"and broadcast (roots 0 and W - 1) at W = {AGW_WORLDS}, bf16 and "
          f"f32, {[s[0] for s in AGW_SHAPES]} shapes: {n_cases} cases, every"
          f" rank's copy bit-equal to the plain version (NaN-filled "
          f"buffers), repeats bit-identical, the skipped push (its signal "
          f"set) refused in every case [{card}]", flush=True)

    world = TPM_WORLD
    group = rd.create_rank_group(world, device="cuda")
    records = []
    for name, m, n in AGW_SHAPES:
        x = torch.randn(-(-m // world) * world, n,
                        device="cuda").to(torch.bfloat16)
        chunk = x.numel() * x.element_size() // world
        for meth in methods + ("broadcast",):
            b = meth == "broadcast"
            ctx = agk.create_allgather_context(
                group=group, **({} if b else
                                {"method": agk.AllGatherMethod(meth)}))
            out = torch.empty((world, *(x[:x.shape[0] // world].shape if b
                                        else x.shape)),
                              dtype=x.dtype, device="cuda")
            src = (x[:x.shape[0] // world] if b else x).reshape(1, -1)

            def kernel():
                if b:
                    return agk.launch_broadcast_world(x, 0, ctx)
                return agk.launch_all_gather_world(
                    x, ctx, agk.AllGatherMethod(meth))

            def plain():
                if b:
                    return torch.stack([agk.broadcast_reference(x, 0, world)
                                        for _ in range(world)])
                return agk.all_gather_reference(x, world, stacked=True)

            def library():
                return out.view(world, -1).copy_(src.expand(world, -1))
            nodes, seen, names, alone = kernels_a_call(torch, kernel, meth)
            check(one_kernel(nodes, seen),
                  f"all_gather_world[{meth}] {name}: an entry call queued "
                  f"{nodes} (graph), {seen} kernel records a call {names} "
                  f"(profiler)")
            ms = queued_ms(torch, kernel)
            bnd, by = agw_bound_ms(world, chunk, b)
            lib_ms = queued_ms(torch, library)
            print(f"kernel all_gather_world[{meth}] W={world} bf16 {name} "
                  f"{tuple(x.shape)}: an entry call queued {nodes} "
                  f"(graph), {seen} kernel records a call {names} "
                  f"(profiler); kernel_ms={ms:.5f} (the entry, queued CUDA "
                  f"events) kernel_alone_ms={fmt_ms(alone)} (profiler) "
                  f"copy_ms={lib_ms:.5f} bound_ms={bnd:.5f} ({by}); kernel "
                  f"rate {bnd / ms:.3f} of the HBM bound [{card}]",
                  flush=True)
            if name == "large":
                continue
            rows = x.shape[0] // world
            records.append(({
                "name": f"all_gather_world_{meth}[{name}]", "route": "cuda",
                "source": "triton_dist_tpu_torch/csrc/allgather.cu",
                "replaces": f"triton_dist_tpu/ops/allgather.py:"
                            f"{AGW_REPLACES[meth]}",
                "max_abs_err": 0.0, "ms": ms,
                "plain_ms": queued_ms(torch, plain, may_wait=True),
                "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
                "kernel_alone_ms": alone, "kernels_a_call": nodes["kernel"],
                "wall_ms": wall_ms(torch, kernel),
                "shape": [world, *x.shape], "ok": True},
                "broadcast" if b else "all_gather",
                (meth, world, x.shape[0], x.shape[1] * x.element_size())))
        del x
    print(f"phase 22 took {time.perf_counter() - t0:.1f} s", flush=True)
    return records


def tpm_counters(agk, gg, mrs, ag, rs, ops) -> dict:
    """The launch counters of phase 23: the path's kernels, then the
    world-1 kernels that must not run there."""
    return {"all_gather": agk.all_gather_launches,
            "group_gemm": gg.group_gemm_launches,
            "moe_rs": mrs.moe_rs_launches,
            "ag_ring": ag.ag_ring_launches, "rs_ring": rs.rs_ring_launches,
            "ar_ring": rs.ar_ring_launches,
            "ag_swiglu_ring": ag.ag_swiglu_ring_launches,
            "ag_gemm": ag.ag_gemm_launches, "gemm_rs": rs.gemm_rs_launches,
            "gemm_ar": ops.launches, "broadcast": agk.broadcast_launches}


def tpm_expected(mode: str, layers: int) -> dict:
    """Launches of one prefill or decode step in ``mode`` at world 4: per
    layer one all-gather in MoE mode ag_rs (model modes ag_rs, gemm_ar),
    one grouped-GEMM (gate|up) and one MoE-reduce launch per rank in every
    mode, and attention's rings (ag_rs: AG-GEMM QKV + GEMM-RS o_proj;
    gemm_ar: the GEMM-AR o_proj)."""
    w = TPM_WORLD
    out = dict.fromkeys(("all_gather", "group_gemm", "moe_rs", "ag_ring",
                         "rs_ring", "ar_ring", "ag_swiglu_ring", "ag_gemm",
                         "gemm_rs", "gemm_ar", "broadcast"), 0)
    out.update(group_gemm=w * layers, moe_rs=w * layers)
    if mode in ("ag_rs", "gemm_ar"):
        out["all_gather"] = layers
    if mode == "ag_rs":
        out.update(ag_ring=layers, rs_ring=layers)
    if mode == "gemm_ar":
        out["ar_ring"] = layers
    return out


def phase_tpm_main(torch, models, counters, cfg, params, base, card: str,
                   seed: int):
    """Phase 23: Qwen3-30B-A3B with moe_parallel="tp" at world 4 over
    phase 12's weights (per-rank views), served by the engines of
    :data:`TPM_ENGINES` through serve (4 x 128 prompts, 16 new tokens)
    and the server, every count set to 0 just before, with the launches
    of every prefill and decode step checked against
    :func:`tpm_expected`. Returns (model, engines, prompts, tokens by
    engine, the launches by counter and key)."""
    print(f"== phase 23: Qwen3-30B-A3B served with moe_parallel='tp' at "
          f"world {TPM_WORLD} through the world-W all-gather", flush=True)
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    model = models.AutoLLM.build(cfg, world=TPM_WORLD)
    check(model.moe_parallel == "tp" and model.moe.world == TPM_WORLD,
          "AutoLLM did not build a world-4 TP MoE model")
    engines = {name: models.Engine(model, batch=4, max_seq=256,
                                   prefill_mode=pf, decode_mode=dc)
               for name, (pf, dc) in TPM_ENGINES.items()}
    print(f"TP MoE model over the same params (per-rank views, no copy): "
          f"device memory {before / 2**30:.2f} GiB before, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after [{card}]",
          flush=True)
    square, _ = sp_prompts(torch, cfg, seed + 10)
    for eng in engines.values():                       # warm-up
        eng.serve(params, square, 2)
    for c in counters.values():                        # ---- the main path
        c.reset()
    layers = cfg.num_hidden_layers
    steps = TPM_GEN - 1
    tokens = {}
    for name, (pf, dc) in TPM_ENGINES.items():
        eng = engines[name]
        start = moe_counts(counters)
        _, prefill_ms = sync_time(torch, lambda: eng.serve(params, square, 1))
        mid = moe_counts(counters)
        out, serve_ms = sync_time(torch, lambda: eng.serve(params, square,
                                                           TPM_GEN))
        end = moe_counts(counters)
        per_prefill = {k: mid[k] - start[k] for k in mid}
        per_step = {k: (end[k] - mid[k] - per_prefill[k]) / steps
                    for k in end}
        check(per_prefill == tpm_expected(pf, layers),
              f"({name}) prefill launches {per_prefill}, expected "
              f"{tpm_expected(pf, layers)}")
        check(per_step == tpm_expected(dc, layers),
              f"({name}) decode step launches {per_step}, expected "
              f"{tpm_expected(dc, layers)}")
        check(tuple(out.shape) == (4, 128 + TPM_GEN), f"({name}) serve shape")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "token out of vocabulary")
        tokens[name] = out
        decode_ms = serve_ms - prefill_ms
        same = (out[:, 128:] == base[:, 128:128 + TPM_GEN]).float().mean()
        print(f"tp-moe serve ({name}: prefill {pf}, decode {dc}, W="
              f"{TPM_WORLD}): batch 4 x 128 prompt, {TPM_GEN} new tokens: "
              f"prefill_ms={prefill_ms:.1f} decode_ms={decode_ms:.1f} "
              f"per_step_ms={decode_ms / steps:.2f} decode_tokens_per_s="
              f"{4 * steps / decode_ms * 1e3:.1f}; launches per prefill "
              f"{ {k: v for k, v in per_prefill.items() if v} }, per decode "
              f"step { {k: v for k, v in per_step.items() if v} }; greedy "
              f"tokens equal to phase 13's world-1 default engine on "
              f"{same.item():.3f} of positions (not gated) [{card}]",
              flush=True)
        from triton_dist_tpu_torch.serving.client import ChatClient
        from triton_dist_tpu_torch.serving.server import ModelServer
        srv = ModelServer(eng, params, host="127.0.0.1", port=0).start()
        try:
            with ChatClient(srv.host, srv.port, timeout=600) as client:
                t1 = time.perf_counter()
                reply = client.generate_ids(square, 8)
                ms = (time.perf_counter() - t1) * 1e3
        finally:
            srv.stop()
        check("tokens" in reply, f"tp-moe server error: {reply}")
        check(reply["tokens"] == out[:, 128:136].tolist(),
              f"({name}) server reply differs from Engine.serve")
        print(f"tp-moe server ({name}): 4 prompts -> 8 tokens each, equal to "
              f"Engine.serve; {ms:.1f} ms round trip [{card}]", flush=True)
    launches = {name: dict(c.by_shape) for name, c in counters.items()}
    print(f"tp-moe main path launches: all_gather {launches['all_gather']}",
          flush=True)                                  # ---- main path ends
    check(all(k[0] == "full_mesh_push" for k in launches["all_gather"]),
          "the TP-MoE path ran an all-gather other than the world-W push")
    print(f"phase 23 (serving) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return model, engines, square, tokens, launches


def phase_tpm_checks(torch, gg, mrs, agk, cfg, model, params, square,
                     card: str) -> dict:
    """Phase 23, checks: prefill (ag_rs) and decode-step (gemm_ar, ag_rs)
    logits through the kernels within MOE_LOGITS_ATOL of the plain
    world-4 path (mode xla / xla_ar, the MoE's all-gather, grouped GEMM
    and MoE-reduce through their plain versions) with the routing held
    fixed (replayed from the kernel run, PR 4's rule); one TPMoE layer
    under sync debug "error"; the decode steps' and the prefill's wall and
    device time, idle share and the all-gather's share. Returns layer 0's
    routing (its (T, top-k) expert ids) in the kernel run's prefill
    (4 x 128 tokens) and first decode step (4 tokens), by shape name, and
    layer 0's MoE inputs ((T, hidden) rows) of the same two calls."""
    from triton_dist_tpu_torch.layers import tp_moe
    from triton_dist_tpu_torch.models import KVCacheManager
    t0 = time.perf_counter()
    ids = torch.tensor(square, device="cuda")
    layers = cfg.num_hidden_layers
    routing = tp_moe.topk_routing

    def caches():
        return KVCacheManager(layers, 4, 256, cfg.num_key_value_heads,
                              cfg.head_dim, dtype=cfg.dtype, device="cuda",
                              world=TPM_WORLD).init()

    def run(modes, replay=None, tok=None):
        """Prefill and two decode steps at position 128 in ``modes``:
        (their last-position logits, the token fed, the routing of each
        MoE call). ``replay``: routing to use, in call order."""
        seen = []

        def route(logits, k, norm=True):
            out = replay.pop(0) if replay is not None else routing(logits, k,
                                                                  norm)
            seen.append(out)
            return out
        tp_moe.topk_routing = route
        try:
            kv = caches()
            with torch.no_grad():
                pre, kv = model.forward(params, ids, kv, 0, mode=modes[0])
                if tok is None:
                    tok = pre[:, -1].argmax(-1)[:, None]
                steps = [model.forward(params, tok, kv, 128, mode=m)[0][:, 0]
                         for m in modes[1:]]
        finally:
            tp_moe.topk_routing = routing
        return [pre[:, -1]] + steps, tok, seen

    saved = (tp_moe.all_gather, tp_moe.grouped_matmul_multi,
             tp_moe.moe_reduce_rs)
    inputs = []                      # each MoE call's rows, in call order

    def gather(x, *args, **kwargs):
        inputs.append(x)
        return saved[0](x, *args, **kwargs)
    tp_moe.all_gather = gather
    try:
        got, tok, seen = run(("ag_rs", "gemm_ar", "ag_rs"))
    finally:
        tp_moe.all_gather = saved[0]
    hidden = {"prefill": inputs[0], "decode": inputs[layers]}
    del inputs
    tp_moe.all_gather = (lambda x, ctx=None, impl="pallas", stacked=False:
                         agk.all_gather_reference(x, ctx.world_size, stacked))
    tp_moe.grouped_matmul_multi = lambda t, ws, i, e, topk=1: [
        gg.grouped_matmul_reference(t, w, i, e, topk) for w in ws]
    tp_moe.moe_reduce_rs = lambda a, w, i, wt, ctx, impl="ring": (
        mrs.moe_reduce_rs_world_reference(a, w, i, wt, ctx.num_experts,
                                          ctx.world_size, impl))
    try:
        ref, _, _ = run(("xla", "xla_ar", "xla"), list(seen), tok)
    finally:
        (tp_moe.all_gather, tp_moe.grouped_matmul_multi,
         tp_moe.moe_reduce_rs) = saved
    for what, g, r in zip(("prefill (ag_rs vs xla) last-position",
                           "decode step (gemm_ar vs xla_ar)",
                           "decode step (ag_rs vs xla)"), got, ref):
        check(bool(torch.isfinite(g).all()), f"non-finite tp-moe {what} "
                                             f"logits")
        err = (g - r).abs().max().item()
        same = (g.argmax(-1) == r.argmax(-1)).float().mean().item()
        check(err <= MOE_LOGITS_ATOL, f"tp-moe {what} logits differ by {err}")
        print(f"tp-moe logits (W={TPM_WORLD}, routing held fixed): {what} "
              f"logits through the kernels vs the plain world-4 path max abs"
              f" diff {err:.4g} (tol {MOE_LOGITS_ATOL}), argmax agreement "
              f"{same:.2f} [{card}]", flush=True)

    # One TP MoE layer under sync debug "error": no host round trip.
    layer = params["layers"][0]["moe"]
    for m in (MOE_DECODE_M, MOE_PREFILL_M):
        x = torch.randn((m, cfg.hidden_size), device="cuda").to(cfg.dtype)
        model.moe(layer, x, mode="ag_rs")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = model.moe(layer, x, mode="ag_rs")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(bool(torch.isfinite(y).all()), "non-finite TPMoE output")
        print(f"tp-moe layer ({m} tokens, W={TPM_WORLD}, mode ag_rs) ran "
              f"under torch.cuda.set_sync_debug_mode('error'): no host sync",
              flush=True)

    kv = caches()
    with torch.no_grad():
        model.forward(params, ids, kv, 0, mode="ag_rs")

    def step(mode):
        def fn():
            with torch.no_grad():
                return model.forward(params, ids[:, :1], kv, 128,
                                     mode=mode)[0]
        return fn

    def prefill():
        with torch.no_grad():
            return model.forward(params, ids, caches(), 0, mode="ag_rs")[0]

    for name, fn in (("decode step (gemm_ar)", step("gemm_ar")),
                     ("decode step (ag_rs)", step("ag_rs")),
                     ("prefill (ag_rs, 4 x 128)", prefill)):
        walls = [sync_time(torch, fn)[1] for _ in range(5)]
        wall = sorted(walls)[2]
        rows, whole = profiled_rows(torch, fn, 3, "tp-moe step")
        dev = sum(ms for _, ms in rows) or float("nan")  # none recorded
        ag_ms = sum(ms for key, ms in rows if "gather_world" in key)
        ring = sum(ms for key, ms in rows if "ag_stream_ring_kernel" in key
                   or "ag_ring_kernel" in key or "ag_ring_wg_kernel" in key)
        ge, le = bound_marks(whole)
        print(f"tp-moe {name} (W={TPM_WORLD}, batch 4, forward only): wall "
              f"{wall:.2f} ms (median of 5), device {ge}{dev:.2f} ms, device "
              f"idle share {le}{1 - dev / wall:.2f}; world-W all-gather "
              f"{ag_ms:.3f} ms ({ag_ms / dev:.3f} of device time); AG-GEMM "
              f"ring {ge}{ring:.3f} ms [{card}]", flush=True)
        for kernel, ms in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"  tp-moe {name} device time: {ms:.3f} ms "
                  f"({ms / dev:.2f}) {kernel[:70]}", flush=True)
    print(f"phase 23 (checks) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return ({"prefill": seen[0][1], "decode": seen[layers][1]}, hidden)


def agw_kernels_line(records, launches) -> list:
    """The records of phase 22 with their launches on phase 23's path;
    the push is the path's (AUTO's choice at W <= 4) and must have run,
    the ring methods and the broadcast are not on it (0)."""
    out = []
    for rec, counter, key in records:
        rec = dict(rec, launches=launches[counter].get(key, 0))
        if key[0] == "full_mesh_push":
            check(rec["launches"] > 0, f"{rec['name']} never launched on "
                                       f"the TP-MoE path")
        out.append(rec)
    return out



#: Phase 24's worlds and shapes: Qwen3-30B-A3B's gate|up rows at decode (4
#: tokens x top-8 = 32) and prefill (512 x 8 = 4096), routed as phase 23's
#: served batch was at layer 0.
AGG_WORLDS = (2, 3, 4, 8)
AGG_SHAPES = (("decode", MOE_DECODE_M), ("prefill", MOE_PREFILL_M))
AGG_REPLACES = "triton_dist_tpu/ops/group_gemm.py:139"


def agg_bound_ms(live: int, m: int, k: int, n: int, world: int,
                 itemsize: int):
    """(least ms, what bounds it) of one world-W ag_group_gemm call over
    every rank (as :func:`ring_bound_ms` counts a ring): x (M, K) read
    once, the ``live`` experts' (K, N) weights read once, the (M, N)
    output written once, plus the ring's copies (the W - 1 chunks each
    rank receives, written and read); 2 M K N operations over the type's
    peak."""
    moved = m * k + live * k * n + m * n + 2 * (world - 1) * m * k
    by_bytes = moved * itemsize / HBM_BYTES_PER_S * 1e3
    kind = "bf16" if itemsize == 2 else "f32"
    by_ops = 2.0 * m * k * n / PEAK_FLOPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def agg_error(torch, got, ref, k: int) -> tuple[float, bool]:
    """(max |got - ref|, within the grouped GEMM's limit): bf16 as
    :func:`moe_error`; f32 1e-5 of the larger value plus F32_ATOL."""
    if got.dtype == torch.bfloat16:
        return moe_error(torch, got, ref, k)
    diff = (got - ref).abs()
    lim = 1e-5 * torch.maximum(got.abs(), ref.abs()) + F32_ATOL
    return diff.max().item(), bool((diff <= lim).all())


def agg_operands(torch, cfg, routing, name: str, seed: int):
    """(x, ids) of one shape: the served batch's tokens drawn from the
    seed at unit scale, each repeated for its top-k pairs, and the
    routing's expert ids, one a row."""
    ids = routing[name].reshape(-1).to(torch.int32).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randn((ids.numel() // cfg.num_experts_per_tok,
                          cfg.hidden_size), generator=gen, device="cuda")
    return (tokens.to(cfg.dtype).repeat_interleave(cfg.num_experts_per_tok,
                                                   0), ids)


def agg_padded(torch, x, ids, world: int, e: int):
    """(x, ids) with zero rows of sentinel id ``e`` appended up to a
    multiple of ``world`` rows (as TPMoE pads its all-gather)."""
    pad = -x.shape[0] % world
    if not pad:
        return x, ids
    return (torch.cat([x, x.new_zeros((pad, x.shape[1]))]),
            torch.cat([ids, ids.new_full((pad,), e)]))


def phase_agg_kernels(torch, gg, rd, cfg, params, routing, card: str):
    """Phase 24 (a, c): the world-W ring AG + grouped GEMM
    (``csrc/ag_group_gemm.cu``, impl "fused") at W = 2, 3, 4, 8, bf16 and
    f32, at the decode (32 rows) and prefill (4096 rows) shapes on layer
    0's w_gate (E = 128, K = 2048, N = 768; 96-wide shards at W = 8) with
    the served routing: bit-equal to impls "xla" and "ring" (the world-1
    kernel once a rank on its strided shard), within the grouped GEMM's
    limit of the plain version, every rank's columns bit-identical on a
    repeat, the workspaces' NaN canaries intact and a skipped push (its
    signal still set) refused; a quarter of the ids set to the sentinel,
    the valid rows compared (W = 3: rows padded to a multiple of W with
    sentinel ids, :func:`agg_padded`). Then the W = 4 bf16 cases timed on
    the card (:func:`queued_ms`) beside the bound, impl "xla", the
    world-1 kernel at the same global shape ("w1") and one
    ``torch._grouped_mm`` of the gathered, expert-sorted rows against the
    full weights, and the plain version. Returns the JSON records, ``launches`` to fill from :func:`phase_agg_main`."""
    print("== phase 24: world-W ring AG + grouped GEMM kernel vs impls xla "
          "/ ring and its plain version", flush=True)
    free, total = torch.cuda.mem_get_info()
    print(f"device memory: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
          f"reserved, {free / 2**30:.2f} of {total / 2**30:.2f} GiB free",
          flush=True)
    t0 = time.perf_counter()
    e, k = cfg.num_experts, cfg.hidden_size
    nan = float("nan")
    w_bf16 = params["layers"][0]["moe"]["w_gate"]
    n_cases = 0
    errs = {}
    for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        w = w_bf16.to(dtype)
        for name, t in AGG_SHAPES:
            x0, ids0 = agg_operands(torch, cfg, routing, name, seed=24 + t)
            for world in AGG_WORLDS:
                x, ids = agg_padded(torch, x0.to(dtype), ids0, world, e)
                dead = ids.clone()
                dead[torch.arange(dead.numel(), device="cuda") % 4 == 3] = e
                ctx = gg.create_ag_group_gemm_context(
                    group=rd.create_rank_group(world, device="cuda"))
                got = gg.ag_group_gemm(x, w, ids, e, ctx, impl="fused")
                again = gg.ag_group_gemm(x, w, ids, e, ctx, impl="fused")
                same = torch.equal(bits(torch, got), bits(torch, again))
                xla = all(torch.equal(bits(torch, got), bits(
                    torch, gg.ag_group_gemm(x, w, ids, e, ctx, impl)))
                    for impl in ("xla", "ring"))
                err, ok = agg_error(
                    torch, got, gg.ag_group_gemm_reference(x, w, ids, e,
                                                           world), k)
                ws = gg.ring_workspace(x, ctx)
                canary = bool(ws[:, x.numel():].isnan().all())
                ws.fill_(nan)
                bad = gg.launch_ag_group_gemm(x, w, ids, e, ctx, fault=True)
                refused = bool(bad.isnan().any())
                live = dead < e
                sent = gg.ag_group_gemm(x, w, dead, e, ctx, impl="fused")
                s_err, s_ok = agg_error(torch, sent[live], gg.
                                        ag_group_gemm_reference(
                                            x, w, dead, e, world)[live], k)
                check(same and xla and ok and canary and refused and s_ok,
                      f"ag_group_gemm W={world} {dt} {name}: repeat {same}, "
                      f"bit-equal to xla / ring {xla}, max abs err {err} "
                      f"ok {ok}, canaries {canary}, fault refused {refused}"
                      f", sentinel rows max abs err {s_err} ok {s_ok}")
                n_cases += 1
                errs[(world, dt, name)] = err
                del got, again, bad, sent, ctx, x
        del w
    torch.cuda.empty_cache()
    print(f"ag_group_gemm (impl fused) at W = {AGG_WORLDS}, bf16 and f32, "
          f"decode and prefill rows on layer 0's w_gate with the served "
          f"routing: {n_cases} cases, each bit-equal to impls xla and ring, "
          f"within the grouped GEMM's limit of the plain version, repeats "
          f"bit-identical, canaries intact, the skipped push refused, "
          f"sentinel ids' valid rows within the limit [{card}]", flush=True)

    world = TPM_WORLD
    group = rd.create_rank_group(world, device="cuda")
    gates = [lp["moe"]["w_gate"] for lp in params["layers"][:4]]
    records = []
    for name, t in AGG_SHAPES:
        x, ids = agg_operands(torch, cfg, routing, name, seed=24 + t)
        m, n = x.shape[0], gates[0].shape[2]
        live = int(torch.unique(ids).numel())
        ctx = gg.create_ag_group_gemm_context(group=group)
        nk, nw, nl = rotating(gates), rotating(gates), rotating(gates)
        p = gg.plan(m // world, e, k, n // world, x.dtype, (k, n, k * n))
        key = (p.path, p.m_blk, world, m, k, n // world)

        def kernel():
            return gg.ag_group_gemm(x, nk(), ids, e, ctx, impl="fused")
        ms = queued_ms(torch, kernel)
        xla_ms = queued_ms(torch, lambda: gg.ag_group_gemm(
            x, nw(), ids, e, ctx, impl="xla"))
        w1_ms = queued_ms(torch, lambda: gg.grouped_matmul(x, nw(), ids, e))
        plain_ms = queued_ms(torch, lambda: gg.ag_group_gemm_reference(
            x, gates[0], ids, e, world), n=3, may_wait=True)
        order = torch.argsort(ids.long(), stable=True)
        x_sorted = x[order].contiguous()
        offs = torch.cumsum(torch.bincount(ids.long(), minlength=e),
                            0).to(torch.int32)
        lib_ms = None
        if hasattr(torch, "_grouped_mm"):   # a yardstick, never on a path
            lib_ms = queued_ms(torch, lambda: torch._grouped_mm(
                x_sorted, nl(), offs=offs))
        bnd, by = agg_bound_ms(live, m, k, n, world, x.element_size())
        ws_bytes = ctx.state.nbytes()
        lib_txt = f"{lib_ms:.5f}" if lib_ms is not None else "none"
        print(f"kernel ag_group_gemm_world W={world} bf16 {name} (M={m}, "
              f"{live} live experts, {p.path} path, {p.m_blk}-row tiles): "
              f"ms={ms:.5f} (2 launches a call: group_schedule, "
              f"the ring kernel; and the wrapper's rank tables) "
              f"bound_ms={bnd:.5f} ({by}) "
              f"xla_ms={xla_ms:.5f} ({world} grouped launches) w1_ms="
              f"{w1_ms:.5f} plain_ms={plain_ms:.5f} grouped_mm_ms={lib_txt};"
              f" workspaces and signals {ws_bytes / 2**20:.2f} MiB; "
              f"times by CUDA events around queued calls [{card}]",
              flush=True)
        records.append(({
            "name": f"ag_group_gemm_world[{name}]", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/ag_group_gemm.cu",
            "replaces": AGG_REPLACES,
            "max_abs_err": errs[(world, "bf16", name)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms, "w1_ms": w1_ms, "xla_ms": xla_ms,
            "wall_ms": wall_ms(torch, kernel), "shape": [world, m, k, n],
            "live_experts": live, "ok": True}, key))
        del x, ctx
    print(f"phase 24 (kernels) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return records


def phase_agg_main(torch, gg, mrs, agk, rd, cfg, params, routing, card: str,
                   seed: int) -> dict:
    """Phase 24 (b), this slice's main path: ``ag_group_gemm(impl="fused")``
    at TP world 4 on the gate and the up weights of one full-width layer,
    at the decode and prefill rows with the served routing, every count
    set to 0 just before: one ring call (schedule + cooperative launch)
    each, no grouped-GEMM, MoE-reduce or all-gather launch; then each
    output bit-equal to impls "xla" and "ring" and finite. Returns the
    launches by key."""
    t0 = time.perf_counter()
    group = rd.create_rank_group(TPM_WORLD, device="cuda")
    ctx = gg.create_ag_group_gemm_context(group=group)
    moe = params["layers"][0]["moe"]
    e = cfg.num_experts
    operands = {name: agg_operands(torch, cfg, routing, name, seed + 240 + t)
                for name, t in AGG_SHAPES}
    counters = {"ag_group_gemm": gg.ag_group_gemm_launches,
                "group_gemm": gg.group_gemm_launches,
                "moe_rs": mrs.moe_rs_launches,
                "all_gather": agk.all_gather_launches}
    for c in counters.values():                        # ---- the main path
        c.reset()
    outs = {(name, wn): gg.ag_group_gemm(x, moe[wn], ids, e, ctx,
                                         impl="fused")
            for name, (x, ids) in operands.items()
            for wn in ("w_gate", "w_up")}
    torch.cuda.synchronize()
    totals = {name: c.total for name, c in counters.items()}
    launches = dict(gg.ag_group_gemm_launches.by_shape)  # ---- main path ends
    check(totals == {"ag_group_gemm": 4, "group_gemm": 0, "moe_rs": 0,
                     "all_gather": 0},
          f"ag_group_gemm path launches {totals}, expected 4 ring calls")
    for (name, wn), got in outs.items():
        x, ids = operands[name]
        check(bool(torch.isfinite(got).all()), f"non-finite {name} {wn}")
        for impl in ("xla", "ring"):
            ref = gg.ag_group_gemm(x, moe[wn], ids, e, ctx, impl=impl)
            check(torch.equal(bits(torch, got), bits(torch, ref)),
                  f"ag_group_gemm {name} {wn}: fused differs from {impl}")
        print(f"ag_group_gemm path (W={TPM_WORLD}, impl fused) {name} {wn}: "
              f"{tuple(x.shape)} x {tuple(moe[wn].shape)} -> "
              f"{tuple(got.shape)}, bit-equal to impls xla and ring "
              f"[{card}]", flush=True)
    print(f"ag_group_gemm main path launches: {launches} (each call one "
          f"group_schedule + one cooperative ag_group_gemm_kernel); phase "
          f"24 (path) took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def agg_kernels_line(records, launches) -> list:
    """The records of phase 24 with their launches on its main path; each
    must have run there."""
    out = []
    for rec, key in records:
        rec = dict(rec, launches=launches.get(key, 0))
        check(rec["launches"] > 0, f"{rec['name']} never launched on the "
                                   f"ag_group_gemm path")
        out.append(rec)
    return out

#: Phase 25: the fused MoE-reduce ring at Qwen3-30B-A3B's down projection
#: (E = 128, I = 768, H = 2048), decode (4 tokens x top-8 = 32 pairs) and
#: prefill (512 x 8 = 4096), routed as phase 23's served batch was at
#: layer 0 (its layer-0 MoE inputs through layer 0's router).
MRR_WORLDS = (2, 3, 4, 8)
MRR_REPLACES = "triton_dist_tpu/ops/moe_reduce_rs.py:72"


def mrr_error(torch, got, ref, mag, i_loc: int, world: int):
    """(max |got - ref|, within the limit) of the fused ring against its
    plain version: phase 13's MoE-reduce rule with W roundings. bf16: one
    ulp of the larger value and of each of the W rounded values (``mag``,
    their magnitudes summed), plus W f32 sums of I / W terms in two
    orders (W f32_sum_atol(I / W)); f32: 1e-5 of ``mag`` plus W F32_ATOL."""
    diff = (got.float() - ref.float()).abs()
    if got.dtype == torch.bfloat16:
        lim = (BF16_ULP_REL * (torch.maximum(got.float().abs(),
                                             ref.float().abs()) + mag)
               + world * f32_sum_atol(i_loc))
    else:
        lim = 1e-5 * mag + world * F32_ATOL
    return diff.max().item(), bool((diff <= lim).all())


def mrr_bound_ms(live: int, pairs: int, t: int, i: int, h: int, world: int,
                 itemsize: int):
    """(least ms, what bounds it) of one world-W fused MoE-reduce call over
    every rank: act (pairs, I) read once, the ``live`` experts' (I, H)
    weights read once, the (T, H) output written once, plus the ring's
    W (W - 1) chunk partials of T / W rows (written and read); 2 pairs I
    H operations over the type's peak."""
    moved = pairs * i + live * i * h + t * h + 2 * (world - 1) * t * h
    by_bytes = moved * itemsize / HBM_BYTES_PER_S * 1e3
    kind = "bf16" if itemsize == 2 else "f32"
    by_ops = 2.0 * pairs * i * h / PEAK_FLOPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def mrr_routing(torch, mu, cfg, params, hidden, name: str):
    """(routing weights (T, k) f32, pair ids (T k,) int32) of layer 0's
    router on the served batch's layer-0 MoE inputs of one shape."""
    moe = params["layers"][0]["moe"]
    wts, idx = mu.topk_routing(hidden[name].float() @ moe["w_router"],
                               cfg.num_experts_per_tok, cfg.norm_topk_prob)
    return wts, idx.reshape(-1).to(torch.int32).contiguous()


def mrr_padded(torch, act, ids, wts, world: int, e: int):
    """The operands with zero tokens appended up to a multiple of
    ``world`` (zero activations and routing weights, sentinel ids), as
    TPMoE pads its rows."""
    t, k = wts.shape
    pad = -t % world
    if not pad:
        return act, ids, wts
    return (torch.cat([act, act.new_zeros((pad * k, act.shape[1]))]),
            torch.cat([ids, ids.new_full((pad * k,), e)]),
            torch.cat([wts, wts.new_zeros((pad, k))]))


def phase_mrr_kernels(torch, mrs, mu, cfg, params, hidden, card: str):
    """Phase 25 (a): the fused MoE-reduce ring (``csrc/moe_rs_ring.cu``,
    ``moe_reduce_rs(impl="fused")``) at W = 2, 3, 4, 8, bf16 and f32, at
    the decode (32 pairs) and prefill (4096 pairs) shapes on layer 0's
    w_down with the served routing and activations drawn from the seed:
    within :func:`mrr_error` of ``moe_reduce_rs_fused_world_reference``,
    repeats bit-identical, the workspaces' NaN canaries intact, a skipped
    push (its signal still set) refused by the same limit (W = 3: tokens
    padded to a multiple of W with sentinel ids, :func:`mrr_padded`), each
    case timed (:func:`queued_ms`) beside impl "ring" and the bound. Then
    the W = 4 bf16 cases timed again (layers 0-3's w_down in turn) beside
    the bound, impl "ring" at W = 4, the world-1 kernel at the same global shape ("w1"),
    one ``torch._grouped_mm`` of the expert-sorted pairs against the full
    w_down (the grouped product only: no single PyTorch call computes the
    whole function) and the plain version. Returns the JSON records,
    ``launches`` to fill from :func:`phase_mrr_main`."""
    print("== phase 25: world-W fused MoE-reduce ring kernel vs its plain "
          "version", flush=True)
    t0 = time.perf_counter()
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    nan = float("nan")
    wd_bf16 = params["layers"][0]["moe"]["w_down"]
    i, h = wd_bf16.shape[1], wd_bf16.shape[2]
    operands = {}
    for name, t in AGG_SHAPES:
        wts, ids = mrr_routing(torch, mu, cfg, params, hidden, name)
        gen = torch.Generator(device="cuda").manual_seed(250 + t)
        act = torch.randn((ids.numel(), i), generator=gen, device="cuda")
        operands[name] = (act, ids, wts)
    n_cases, errs = 0, {}
    for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        wd = wd_bf16.to(dtype)
        for name, _ in AGG_SHAPES:
            act0, ids0, wts0 = operands[name]
            for world in MRR_WORLDS:
                act, ids, wts = mrr_padded(torch, act0.to(dtype), ids0, wts0,
                                           world, e)
                ctx = mrs.create_moe_rs_context(num_experts=e, topk=k,
                                                world_size=world)
                got = mrs.moe_reduce_rs(act, wd, ids, wts, ctx, impl="fused")
                again = mrs.moe_reduce_rs(act, wd, ids, wts, ctx,
                                          impl="fused")
                same = torch.equal(bits(torch, got), bits(torch, again))
                ref, mag = mrs.moe_reduce_rs_fused_world_reference(
                    act, wd, ids, wts, e, world, magnitude=True)
                err, ok = mrr_error(torch, got, ref, mag, i // world, world)
                prods, recv = mrs.ring_workspaces(act, wd, wts, ctx)
                rows = wts.shape[0] // world
                canary = (bool(prods[:, ids.numel() * h:].isnan().all())
                          and bool(recv[:, (world - 1) * rows * h:]
                                   .isnan().all()))
                recv.fill_(nan)
                bad = mrs.launch_moe_rs_ring(act, wd, ids, wts, ctx,
                                             fault=True)
                _, bad_ok = mrr_error(torch, bad, ref, mag, i // world,
                                      world)
                check(same and ok and canary and not bad_ok,
                      f"moe_rs_ring W={world} {dt} {name}: repeat {same}, "
                      f"max abs err {err} ok {ok}, canaries {canary}, "
                      f"fault refused {not bad_ok}")
                n_cases += 1
                errs[(world, dt, name)] = err
                # Impl "ring" launches 3 kernels and ~10 tensor ops a
                # rank: 5 calls stay inside the card's launch queue.
                ms = queued_ms(torch, lambda: mrs.moe_reduce_rs(
                    act, wd, ids, wts, ctx, impl="fused"))
                ring_ms = queued_ms(torch, lambda: mrs.moe_reduce_rs(
                    act, wd, ids, wts, ctx, impl="ring"), n=5)
                bnd, by = mrr_bound_ms(int(torch.unique(ids).numel()),
                                       ids.numel(), wts.shape[0], i, h,
                                       world, act.element_size())
                print(f"moe_rs_ring W={world} {dt} {name}: max abs err "
                      f"{err:.4g} ms={ms:.5f} ring_ms={ring_ms:.5f} "
                      f"bound_ms={bnd:.5f} ({by}) [{card}]", flush=True)
                del got, again, bad, ref, mag, ctx, prods, recv
        del wd
    torch.cuda.empty_cache()
    print(f"moe_reduce_rs (impl fused) at W = {MRR_WORLDS}, bf16 and f32, "
          f"decode and prefill pairs on layer 0's w_down with the served "
          f"routing: {n_cases} cases within the limit of the plain version "
          f"(bf16: 2^-7 (max(|got|, |ref|) + the W rounded values' "
          f"magnitudes) + W f32_sum_atol(I / W); f32: 1e-5 of those "
          f"magnitudes + W {F32_ATOL:g}), repeats bit-identical, canaries "
          f"intact, the skipped push refused by the same limit; max abs "
          f"err bf16 {max(v for (_, d, _), v in errs.items() if d == 'bf16'):.4g}"
          f" [{card}]", flush=True)

    world = TPM_WORLD
    downs = [lp["moe"]["w_down"] for lp in params["layers"][:4]]
    records = []
    for name, _ in AGG_SHAPES:
        act, ids, wts = operands[name]
        act = act.to(cfg.dtype)
        t = wts.shape[0]
        live = int(torch.unique(ids).numel())
        ctx = mrs.create_moe_rs_context(num_experts=e, topk=k,
                                        world_size=world)
        one = mrs.create_moe_rs_context(num_experts=e, topk=k)
        nk, nr, n1, nl = (rotating(downs) for _ in range(4))
        p = mrs.plan(t * k, e, i // world, h, act.dtype,
                     (i, h, i * h))
        key = (p.path, p.m_blk, world, t * k, i, h)

        def kernel():
            return mrs.moe_reduce_rs(act, nk(), ids, wts, ctx, impl="fused")
        ms = queued_ms(torch, kernel)
        ring_ms = queued_ms(torch, lambda: mrs.moe_reduce_rs(
            act, nr(), ids, wts, ctx, impl="ring"), n=5)
        w1_ms = queued_ms(torch, lambda: mrs.moe_reduce_rs(
            act, n1(), ids, wts, one, impl="fused"))
        plain_ms = queued_ms(torch, lambda: mrs.
                             moe_reduce_rs_fused_world_reference(
                                 act, downs[0], ids, wts, e, world), n=3,
                             may_wait=True)
        order = torch.argsort(ids.long(), stable=True)
        act_sorted = act[order].contiguous()
        offs = torch.cumsum(torch.bincount(ids.long(), minlength=e),
                            0).to(torch.int32)
        lib_ms = None
        if hasattr(torch, "_grouped_mm"):   # a yardstick, never on a path
            lib_ms = queued_ms(torch, lambda: torch._grouped_mm(
                act_sorted, nl(), offs=offs))
        bnd, by = mrr_bound_ms(live, t * k, t, i, h, world,
                               act.element_size())
        ws_bytes = ctx.ring_state(act.device).nbytes()
        lib_txt = f"{lib_ms:.5f}" if lib_ms is not None else "none"
        print(f"kernel moe_rs_ring W={world} bf16 {name} (T={t}, {t * k} "
              f"pairs, {live} live experts, {p.path} path, {p.m_blk}-row "
              f"tiles): ms={ms:.5f} (2 launches a call: group_schedule, "
              f"moe_rs_ring_kernel; and the wrapper's rank tables) "
              f"bound_ms={bnd:.5f} ({by}) ring_ms={ring_ms:.5f} ({world} "
              f"MoE-reduce launches and the plain ring sum) w1_ms="
              f"{w1_ms:.5f} plain_ms={plain_ms:.5f} grouped_mm_ms={lib_txt} "
              f"(the grouped product only); workspaces and signals "
              f"{ws_bytes / 2**20:.2f} MiB; times by CUDA events around "
              f"queued calls [{card}]", flush=True)
        records.append(({
            "name": f"moe_rs_ring[{name}]", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/moe_rs_ring.cu",
            "replaces": MRR_REPLACES,
            "max_abs_err": errs[(world, "bf16", name)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms, "library": "torch._grouped_mm, the "
            "grouped product only", "w1_ms": w1_ms, "ring_ms": ring_ms,
            "wall_ms": wall_ms(torch, kernel), "shape": [world, t, k, i, h],
            "live_experts": live, "ok": True}, key))
        del ctx, one
    print(f"phase 25 (kernels) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return records


def phase_mrr_main(torch, gg, mrs, mu, agk, rd, cfg, params, hidden,
                   card: str) -> dict:
    """Phase 25 (b), this slice's main path: the expert half of one
    ``TPMoE`` layer at TP world 4 through both fused world-W kernels, on
    layer 0's MoE inputs of the served batch (decode 4 tokens, prefill
    512), every count set to 0 just before: layer 0's routing, gate and up
    by ``ag_group_gemm(impl="fused")``, the SwiGLU, then
    ``moe_reduce_rs(impl="fused")``: 2 ring AG + grouped GEMM calls and
    one MoE-reduce ring call a shape, no world-1 grouped-GEMM or
    MoE-reduce launch and no all-gather. Then each output against
    ``TPMoE(world=4)``'s own forward of the layer (mode ag_rs: the
    all-gather kernel, the grouped GEMM a rank, impl "ring"): one bf16
    ulp of the fused ring's W rounded values and of each pair product
    that the ring route rounds (sum_j w_j |pair_j| over the ranks), plus
    W f32_sum_atol(I / W). Returns the ring kernel's launches by key."""
    from triton_dist_tpu_torch.layers.tp_moe import TPMoE
    t0 = time.perf_counter()
    world = TPM_WORLD
    group = rd.create_rank_group(world, device="cuda")
    agg_ctx = gg.create_ag_group_gemm_context(group=group)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    rs_ctx = mrs.create_moe_rs_context(num_experts=e, topk=k,
                                       world_size=world)
    moe = params["layers"][0]["moe"]
    i = moe["w_down"].shape[1]
    counters = {"ag_group_gemm": gg.ag_group_gemm_launches,
                "moe_rs_ring": mrs.moe_rs_ring_launches,
                "group_gemm": gg.group_gemm_launches,
                "moe_rs": mrs.moe_rs_launches,
                "all_gather": agk.all_gather_launches}
    xs = {name: hidden[name] for name, _ in AGG_SHAPES}
    for c in counters.values():                        # ---- the main path
        c.reset()
    outs = {}
    for name, x in xs.items():
        wts, idx = mu.topk_routing(x.float() @ moe["w_router"], k,
                                   cfg.norm_topk_prob)
        ids = idx.reshape(-1).to(torch.int32)
        pairs = x.repeat_interleave(k, 0)
        gate = gg.ag_group_gemm(pairs, moe["w_gate"], ids, e, agg_ctx,
                                impl="fused")
        up = gg.ag_group_gemm(pairs, moe["w_up"], ids, e, agg_ctx,
                              impl="fused")
        act = (torch.nn.functional.silu(gate.float())
               * up.float()).to(x.dtype)
        outs[name] = (mrs.moe_reduce_rs(act, moe["w_down"], ids, wts,
                                        rs_ctx, impl="fused"), act, ids, wts)
    torch.cuda.synchronize()
    totals = {name: c.total for name, c in counters.items()}
    launches = dict(mrs.moe_rs_ring_launches.by_shape)  # ---- main path ends
    want = {"ag_group_gemm": 4, "moe_rs_ring": 2, "group_gemm": 0,
            "moe_rs": 0, "all_gather": 0}
    check(totals == want, f"TP-MoE expert path launches {totals}, expected "
                          f"{want}")
    layer = TPMoE(cfg.hidden_size, i, e, k, dtype=cfg.dtype,
                  norm_topk_prob=cfg.norm_topk_prob, group=group)
    for name, x in xs.items():
        got, act, ids, wts = outs[name]
        ref = layer(moe, x, mode="ag_rs")
        _, mag = mrs.moe_reduce_rs_fused_world_reference(
            act, moe["w_down"], ids, wts, e, world, magnitude=True)
        pair_mag = torch.zeros_like(mag)
        for a, wd in zip(group.shard(act, 1), group.shard(moe["w_down"], 1)):
            pair = mrs.grouped_matmul_reference(a, wd, ids, e).float()
            pair_mag += (pair.abs().reshape(x.shape[0], k, -1)
                         * wts[..., None]).sum(1)
        diff = (got.float() - ref.float()).abs()
        lim = (BF16_ULP_REL * (torch.maximum(got.float().abs(),
                                             ref.float().abs())
                               + mag + pair_mag)
               + world * f32_sum_atol(i // world))
        check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
              f"TP-MoE expert path {name}: non-finite or shape "
              f"{tuple(got.shape)}")
        check(bool((diff <= lim).all()),
              f"TP-MoE expert path {name}: fused differs from TPMoE's ring "
              f"route by {diff.max().item()} (beyond the stated limit)")
        print(f"TP-MoE expert path (W={world}, fused AG + grouped GEMM, "
              f"SwiGLU, fused MoE-reduce ring) {name}: {tuple(x.shape)} -> "
              f"{tuple(got.shape)}, max abs diff {diff.max().item():.4g} "
              f"from TPMoE(world=4) mode ag_rs (limit: 2^-7 (max(|got|, "
              f"|ref|) + the ring's W rounded values + sum_j w_j |pair_j|) "
              f"+ W f32_sum_atol(I / W); {(diff > 0).float().mean().item():.3f}"
              f" of the outputs differ) [{card}]", flush=True)
    print(f"TP-MoE expert path launches: {totals}; moe_rs_ring by key "
          f"{launches}; phase 25 (path) took {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    return launches


def mrr_kernels_line(records, launches) -> list:
    """The records of phase 25 with their launches on its main path; each
    must have run there."""
    out = []
    for rec, key in records:
        rec = dict(rec, launches=launches.get(key, 0))
        check(rec["launches"] > 0, f"{rec['name']} never launched on the "
                                   f"TP-MoE expert path")
        out.append(rec)
    return out


#: Phase 26: the world-W reduce-scatter and all-reduce at Qwen3-8B's
#: hidden 4096 (TP world 4: decode 4 rows, prefill 4 x 128 = 512 rows; at
#: W = 3 and 8, where 4 or 512 rows do not split, 6 or 8 and 513 rows).
ARW_WORLDS = (2, 3, 4, 8)
ARW_CASES = (("all_reduce", "one_shot"), ("all_reduce", "two_shot"),
             ("all_reduce", "recursive_doubling"),
             ("reduce_scatter", "ring"), ("reduce_scatter", "one_shot"))
ARW_REPLACES = {
    ("all_reduce", "one_shot"): "triton_dist_tpu/ops/allreduce.py:114",
    ("all_reduce", "recursive_doubling"):
        "triton_dist_tpu/ops/allreduce.py:158",
    ("all_reduce", "two_shot"): "triton_dist_tpu/ops/allreduce.py:193",
    ("reduce_scatter", "ring"): "triton_dist_tpu/ops/reduce_scatter.py:92",
    ("reduce_scatter", "one_shot"):
        "triton_dist_tpu/ops/reduce_scatter.py:150"}


def arw_rows(world: int) -> dict:
    """Phase 26's row counts at ``world``: decode and prefill."""
    return {"decode": 4 if 4 % world == 0 else (6 if world == 3 else 8),
            "prefill": 512 if 512 % world == 0 else 513}


def arw_bound_ms(op: str, world: int, m: int, n: int, itemsize: int):
    """Least ms of one call over every rank: the W partials read once and
    the output written once (the all-reduce's W copies, the
    reduce-scatter's one (M, N)), over HBM."""
    out = world if op == "all_reduce" else 1
    return (world + out) * m * n * itemsize / HBM_BYTES_PER_S * 1e3


def arw_plain(ar, rs, x, op: str, method: str):
    if op == "all_reduce":
        return ar.all_reduce_world_reference(x, ar.AllReduceMethod(method))
    return rs.reduce_scatter_world_reference(
        x, rs.ReduceScatterMethod(method))


def arw_context(ar, rs, op: str, method: str, group, straggler=None):
    if op == "all_reduce":
        return ar.create_allreduce_context(
            method=ar.AllReduceMethod(method), group=group,
            straggler_option=straggler)
    return rs.create_reduce_scatter_context(
        method=rs.ReduceScatterMethod(method), group=group)


def arw_call(ar, rs, x, ctx, op: str, stacked: bool = True):
    """The op's entry on ``x`` (the all-reduce stacked: every copy)."""
    if op == "all_reduce":
        return ar.all_reduce(x, ctx, stacked=stacked)
    return rs.reduce_scatter(x, ctx)


def arw_method(ar, rs, ctx, x, op: str) -> str:
    """The method the entry runs on ``x`` (JAX's fix-ups at W = 3)."""
    m, n = x.shape[1], x.shape[2]
    if op == "all_reduce":
        return ar.resolve_method(ctx, m, m * n * x.element_size()).value
    return ctx.resolve_method(m // x.shape[0] * n * x.element_size()).value


def phase_arw_kernels(torch, ar, rs, rd, card: str) -> list:
    """Phase 26 (a): the world-W reduce-scatter and all-reduce
    (``csrc/reduce_world.cu``) at W = 2, 3, 4, 8, every method, bf16 and
    f32, at the decode and prefill rows of :func:`arw_rows` and Qwen3-8B's
    hidden 4096, partials of rank r drawn at scale 4^r: the entry's output
    (every rank's copy of the all-reduce) and a launch into a NaN-filled
    buffer bit-equal to the plain version, a repeat bit-identical, every
    copy bit-equal, the workspace's NaN canaries (row tails, a one-shot
    rank's own stage slot) intact, a straggling rank (JAX's
    straggler_option) changing no bit, and a skipped push (its signal
    still set) over a NaN-filled workspace refused. Then the W = 4 bf16
    cases timed (:func:`queued_ms`, each call on the next of 8 inputs:
    128 MiB at prefill, more than the L2) beside the bound, one
    ``torch.sum(x, 0)``, impl "xla", the plain version and the world-1
    copy at the same per-rank shape. Returns the JSON records with their
    launch keys, ``launches`` to fill from :func:`phase_arw_main`."""
    print("== phase 26: world-W reduce-scatter and all-reduce kernels vs "
          "their plain versions", flush=True)
    t0 = time.perf_counter()
    n, nan, cases = 4096, float("nan"), 0
    for world in ARW_WORLDS:
        group = rd.create_rank_group(world, device="cuda")
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for name, m in arw_rows(world).items():
                gen = torch.Generator(device="cuda").manual_seed(260 + m)
                scale = 4.0 ** torch.arange(world, device="cuda")
                x = (torch.randn((world, m, n), generator=gen, device="cuda")
                     * scale[:, None, None]).to(dtype)
                for op, asked in ARW_CASES:
                    ctx = arw_context(ar, rs, op, asked, group)
                    method = arw_method(ar, rs, ctx, x, op)
                    want = arw_plain(ar, rs, x, op, method)
                    got = arw_call(ar, rs, x, ctx, op)
                    shape = tuple(got.shape)
                    out = rs.launch_reduce_world(
                        x, ctx, op, method,
                        out=torch.full(shape, nan, dtype=dtype,
                                       device="cuda"))
                    straggler = (world - 1, 100_000)
                    if op == "all_reduce":         # JAX's straggler_option
                        ctx.straggler_option = straggler
                        late = arw_call(ar, rs, x, ctx, op)
                        ctx.straggler_option = None
                    else:
                        late = rs.launch_reduce_world(x, ctx, op, method,
                                                      straggler=straggler)
                    copies = list(got) if op == "all_reduce" else [got]
                    exact = all(torch.equal(bits(torch, c), bits(torch, want))
                                for c in copies)
                    same = (torch.equal(bits(torch, out), bits(torch, got))
                            and torch.equal(bits(torch, late),
                                            bits(torch, got)))
                    kind = rs.KINDS[(op, method)]
                    ws, _ = rs.world_buffers(x, ctx.state, kind)
                    live = rs._lib().tdt_reduce_world_workspace(kind, world,
                                                                m * n)
                    canary = bool(ws[:, live:].isnan().all())
                    if method == "one_shot":
                        unit = live // world
                        canary = canary and all(
                            bool(ws[r, r * unit:(r + 1) * unit].isnan().all())
                            for r in range(world))
                    ws.fill_(nan)
                    bad = rs.launch_reduce_world(x, ctx, op, method,
                                                 fault=True)
                    refused = bool(bad.isnan().any())
                    check(exact and same and canary and refused,
                          f"{op} W={world} {asked} (ran {method}) {dt} {name}"
                          f" ({m} rows): bit-equal {exact}, repeat / "
                          f"straggler {same}, canaries {canary}, fault "
                          f"refused {refused}")
                    cases += 1
                    del ctx, ws, got, out, late, bad, want
                del x
    torch.cuda.empty_cache()
    print(f"world-W all_reduce (one_shot, two_shot, recursive_doubling) and "
          f"reduce_scatter (ring, one_shot) at W = {ARW_WORLDS}, bf16 and "
          f"f32, N = {n}, rows {[arw_rows(w) for w in ARW_WORLDS]} (W = 3: "
          f"recursive doubling runs one-shot, two-shot runs one-shot on 513 "
          f"rows, JAX's rules): {cases} cases bit-equal to the plain "
          f"versions, every copy, repeats and a straggling rank bit-identical"
          f", canaries intact, a skipped push refused "
          f"({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)

    world = TP_WORLD
    group = rd.create_rank_group(world, device="cuda")
    records = []
    for name, m in arw_rows(world).items():
        xs = [torch.randn((world, m, n), device="cuda").bfloat16()
              for _ in range(8)]
        nxt = rotating(xs)
        lib_ms = queued_ms(torch, lambda: torch.sum(nxt(), 0))
        for op, method in ARW_CASES:
            ctx = arw_context(ar, rs, op, method, group)
            one = arw_context(ar, rs, op, method, None)
            check(arw_method(ar, rs, ctx, xs[0], op) == method,
                  f"{op} {method} at W={world} {name} runs another method")
            ms = queued_ms(torch, lambda: arw_call(ar, rs, nxt(), ctx, op,
                                                   stacked=False))
            xla_ms = queued_ms(torch, lambda: (
                ar.all_reduce(nxt(), ctx, impl="xla") if op == "all_reduce"
                else rs.reduce_scatter(nxt(), ctx, impl="xla")))
            plain_ms = queued_ms(torch, lambda: arw_plain(ar, rs, nxt(), op,
                                                          method),
                                 may_wait=True)
            w1_ms = queued_ms(torch, lambda: arw_call(ar, rs, nxt()[:1], one,
                                                      op, stacked=False))
            bnd = arw_bound_ms(op, world, m, n, 2)
            grid, resident = rs.world_grid(xs[0], op, method)
            print(f"kernel {op}_world[{method}] W={world} bf16 {name} "
                  f"({world}, {m}, {n}): ms={ms:.5f} bound_ms={bnd:.5f} "
                  f"(bytes) torch_sum_ms={lib_ms:.5f} xla_ms={xla_ms:.5f} "
                  f"plain_ms={plain_ms:.5f} w1_ms={w1_ms:.5f} (the world-1 "
                  f"copy of one ({m}, {n}) partial); grid {grid} of "
                  f"{resident} resident blocks; times by CUDA events around "
                  f"queued calls [{card}]", flush=True)
            records.append(({
                "name": f"{op}_world[{method},{name}]", "route": "cuda",
                "source": "triton_dist_tpu_torch/csrc/reduce_world.cu",
                "replaces": ARW_REPLACES[(op, method)],
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd, "bound_by": "bytes", "library_ms": lib_ms,
                "library": "torch.sum(x, 0)", "xla_ms": xla_ms,
                "w1_ms": w1_ms,
                "wall_ms": wall_ms(torch, lambda: arw_call(
                    ar, rs, xs[0], ctx, op, stacked=False)),
                "shape": [world, m, n], "ok": True},
                (op, (method, world, m, n, "bfloat16"))))
            del ctx, one
        del xs
    torch.cuda.empty_cache()
    print(f"phase 26 (kernels) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return records


def phase_arw_main(torch, ar, rs, agk, rd, cfg, model, params, square,
                   card: str) -> dict:
    """Phase 26 (b), this slice's main path: layer 0 of Qwen3-8B at TP
    world 4. Its MLP inputs of the served prompts (4 x 128 = 512 prefill
    rows through the world-4 model in mode "xla", then the 4 rows of the
    first decode step) make each rank's down-projection partial as
    ``TPMLP._xla_fwd``'s body computes it (gate and up column shards in
    f32, the SwiGLU rounded once, the down row shard's product rounded),
    stacked to (4, M, 4096); their ``group.psum`` must equal the layer's
    own mode-"xla" output. Every count set to 0 just before: the decode
    and prefill partials through ``all_reduce(impl="pallas")`` in each
    method and through ``reduce_scatter(impl="pallas")`` in both, one
    world-W launch a call and no copy-kernel or all-gather launch; each
    output within W bf16 ulps of the partials' magnitudes summed
    (2^-7 W sum_r |p_r|: it rounds W - 1 times, the psum once) of
    ``group.psum``. Returns the launches by op and key."""
    t0 = time.perf_counter()
    world = TP_WORLD
    group = rd.create_rank_group(world, device="cuda")
    from triton_dist_tpu_torch.models import KVCacheManager
    layer0 = params["layers"][0]
    seen = []
    ffn = model._ffn

    def spy(lp, h, mode):
        if lp is layer0:
            seen.append(h)
        return ffn(lp, h, mode)
    model._ffn = spy
    try:
        ids = torch.tensor(square, device="cuda")
        kv = KVCacheManager(cfg.num_hidden_layers, 4, 1024,
                            cfg.num_key_value_heads, cfg.head_dim,
                            dtype=cfg.dtype, device="cuda",
                            world=world).init()
        with torch.no_grad():
            logits, kv = model.forward(params, ids, kv, 0, mode="xla")
            tok = logits[:, -1].argmax(-1)[:, None]
            model.forward(params, tok, kv, ids.shape[1], mode="xla")
    finally:
        del model._ffn
    hidden = {"prefill": seen[0], "decode": seen[1]}
    mlp = layer0["mlp"]
    shards = [group.shard(mlp["w_gate"], 1), group.shard(mlp["w_up"], 1),
              group.shard(mlp["w_down"], 0)]
    partials = {}
    for name, h in hidden.items():
        parts = []
        for r in range(world):
            hf = h.float()
            act = (torch.nn.functional.silu(hf @ shards[0][r].float())
                   * (hf @ shards[1][r].float())).to(h.dtype)
            parts.append((act.float() @ shards[2][r].float()).to(h.dtype))
        partials[name] = torch.stack(parts)
        ref = group.psum(parts)
        check(torch.equal(ref, model.mlp(mlp, h, mode="xla")),
              f"layer-0 {name} partials: their psum is not TPMLP's xla "
              f"forward")
    counters = {"all_reduce": ar.all_reduce_launches,
                "reduce_scatter": rs.reduce_scatter_launches,
                "all_gather": agk.all_gather_launches,
                "broadcast": agk.broadcast_launches}
    for c in counters.values():                        # ---- the main path
        c.reset()
    outs = []
    for name, x in partials.items():
        for op, method in ARW_CASES:
            ctx = arw_context(ar, rs, op, method, group)
            outs.append((name, op, method,
                         arw_call(ar, rs, x, ctx, op, stacked=False)))
    torch.cuda.synchronize()
    totals = {k: c.total for k, c in counters.items()}
    launches = {op: dict(counters[op].by_shape)
                for op in ("all_reduce", "reduce_scatter")}
    want = {"all_reduce": 6, "reduce_scatter": 4, "all_gather": 0,
            "broadcast": 0}                            # ---- main path ends
    check(totals == want, f"layer-0 collective path launches {totals}, "
                          f"expected {want}")
    check(all(len(key) == 5 and key[1] == world
              for counts in launches.values() for key in counts),
          f"a world-1 copy ran on the world-{world} path: {launches}")
    for name, op, method, got in outs:
        x = partials[name]
        ref = group.psum(list(x))
        parts_abs = x.float().abs().sum(0)
        diff = (got.float() - ref.float()).abs()
        share = (diff / (BF16_ULP_REL * world * parts_abs + 1e-30)).max()
        check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
              f"{op} {method} {name}: non-finite or shape "
              f"{tuple(got.shape)}")
        check(share.item() <= 1.0,
              f"{op} {method} {name}: differs from group.psum by "
              f"{diff.max().item()} (beyond 2^-7 W sum_r |p_r|)")
        print(f"layer-0 MLP partials (W={world}) {name} {tuple(x.shape)} "
              f"through {op} ({method}): max abs diff from group.psum "
              f"{diff.max().item():.4g}, largest share of the limit "
              f"{share.item():.3f}, {(diff > 0).float().mean().item():.3f} "
              f"of the outputs differ [{card}]", flush=True)
    print(f"phase 26 path launches {totals}; by key {launches}; phase 26 "
          f"(path) took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def arw_kernels_line(records, launches) -> list:
    """The records of phase 26 with their launches on its main path; each
    must have run there."""
    out = []
    for rec, (op, key) in records:
        rec = dict(rec, launches=launches[op].get(key, 0))
        check(rec["launches"] > 0, f"{rec['name']} never launched on the "
                                   f"layer-0 collective path")
        out.append(rec)
    return out


# -- phase 27: the pipeline shift and the KV ship hop (csrc/p2p.cu) ---------
P2P_WORLDS = (2, 3, 4, 8)
#: Qwen3-8B's layers split into this many pipeline stages in phase 27.
PP_STAGES = 4
#: Bytes of one Qwen3-8B KV block as ``pack_block`` writes it: 36 layers x
#: (k, v) x (16, 8, 128) f32.
KV_BLOCK_BYTES = 36 * 2 * 16 * 8 * 128 * 4
P2P_REPLACES = {"pp_shift": "triton_dist_tpu/ops/p2p.py:70",
                "symm_ship": "triton_dist_tpu/serving/kv_stream.py:151"}


def p2p_deltas(world: int) -> tuple:
    """Phase 27's deltas: one hop each way, and beyond the world each way
    (the ``span`` rule of ``shift_partners``)."""
    return 1, -1, world + 1, -(world + 2)


def p2p_inputs(torch, world: int, gen) -> dict:
    """Phase 27 (a)'s inputs at ``world``: Qwen3-8B's decode hop (4 rows of
    4096 a rank) and prefill hop (512 rows) in bf16 and f32, one KV block
    as bytes and a W x 37-byte payload (shards off 16-byte alignment)."""
    out = {}
    for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for name, rows in (("decode", 4), ("prefill", 512)):
            out[f"{name}_{dt}"] = torch.randn(
                (world * rows, 4096), generator=gen, device="cuda").to(dtype)
    for name, n in (("kv_block", KV_BLOCK_BYTES), ("bytes37", world * 37)):
        out[name] = torch.randint(0, 255, (n,), generator=gen, device="cuda",
                                  dtype=torch.uint8)
    return out


def p2p_bound_ms(x) -> float:
    """Least ms of one hop: every rank's block read once and written once
    (2 W C bytes), over HBM."""
    return 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3


def phase_p2p_kernels(torch, p2p, ks, rd, card: str) -> list:
    """Phase 27 (a): the shift kernel (``csrc/p2p.cu``) behind ``pp_shift``
    and ``symm_ship`` at W = 2, 3, 4, 8 and every delta of
    :func:`p2p_deltas`, on the inputs of :func:`p2p_inputs`: both entries,
    a launch into a NaN-filled (0xFF-filled for bytes) buffer and a repeat
    bit-equal to the plain roll, and rank 0's first piece skipped (its
    signal still set) refused. Then the W = 4 cases timed
    (:func:`queued_ms`) beside the bound, one ``torch.roll(x.view(W, -1),
    delta, 0)`` and the plain version. Returns the JSON records of the
    main path's shapes with their launch keys (entry, key)."""
    print("== phase 27: the pipeline shift and the KV ship hop vs the plain "
          "roll", flush=True)
    t0 = time.perf_counter()
    cases = 0
    for world in P2P_WORLDS:
        gen = torch.Generator(device="cuda").manual_seed(270 + world)
        ctx = p2p.create_p2p_context(rd.create_rank_group(world, "pp",
                                                          device="cuda"))
        ship = rd.create_rank_group(world, "tp", device="cuda")
        for name, x in p2p_inputs(torch, world, gen).items():
            fill = 255 if x.dtype == torch.uint8 else float("nan")
            for delta in p2p_deltas(world):
                want = p2p.pp_shift_reference(x, world, delta)
                got = p2p.pp_shift(x, ctx, delta=delta)
                shipped = ks.symm_ship(x, ship, delta=delta)
                into = p2p.launch_shift(x, ctx, delta, p2p.pp_shift_launches,
                                        out=torch.full_like(x, fill))
                again = p2p.pp_shift(x, ctx, delta=delta)
                bad = p2p.launch_shift(x, ctx, delta, p2p.pp_shift_launches,
                                       out=torch.full_like(x, fill),
                                       fault=True)
                exact = all(torch.equal(bits(torch, t), bits(torch, want))
                            for t in (got, shipped, into, again))
                refused = not torch.equal(bits(torch, bad), bits(torch, want))
                check(exact and refused,
                      f"shift W={world} {name} delta={delta}: bit-equal "
                      f"{exact}, fault refused {refused}")
                cases += 1
                del want, got, shipped, into, again, bad
        del ctx
    torch.cuda.empty_cache()
    print(f"shift kernel through pp_shift and symm_ship at W = {P2P_WORLDS},"
          f" deltas (1, -1, W + 1, -(W + 2)), decode / prefill hops bf16 and "
          f"f32, a KV block and W x 37 bytes: {cases} cases bit-equal to the "
          f"plain roll (into NaN- / 0xFF-filled buffers, repeats), a skipped "
          f"piece refused ({time.perf_counter() - t0:.1f} s) [{card}]",
          flush=True)

    world = TP_WORLD
    ctx = p2p.create_p2p_context(rd.create_rank_group(world, "pp",
                                                      device="cuda"))
    ship = rd.create_rank_group(world, "tp", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(279)
    records = []
    for name, x in p2p_inputs(torch, world, gen).items():
        if name == "bytes37":
            continue
        entry = "symm_ship" if name == "kv_block" else "pp_shift"
        if entry == "symm_ship":
            def call():
                return ks.symm_ship(x, ship, delta=1)
        else:
            def call():
                return p2p.pp_shift(x, ctx, delta=1)
        ms = queued_ms(torch, call)
        plain_ms = queued_ms(torch, lambda: p2p.pp_shift_reference(x, world,
                                                                   1))
        lib_ms = queued_ms(torch, lambda: torch.roll(x.view(world, -1), 1, 0))
        bnd = p2p_bound_ms(x)
        grid, resident = p2p.shift_grid(x, world)
        chunk = x.numel() * x.element_size() // world
        rows = x.shape[0] // world
        print(f"kernel {entry}[{name}] W={world} {tuple(x.shape)} "
              f"{str(x.dtype).removeprefix('torch.')}: ms={ms:.5f} "
              f"bound_ms={bnd:.5f} (bytes) torch_roll_ms={lib_ms:.5f} "
              f"plain_ms={plain_ms:.5f}; grid {grid} of {resident} resident "
              f"blocks, {p2p._lib().tdt_shift_signals(chunk, world)} pieces "
              f"a rank; times by CUDA events around queued calls [{card}]",
              flush=True)
        if name.endswith("_f32"):                  # off the main path
            continue
        records.append(({
            "name": f"{entry}[{name.removesuffix('_bf16')}]",
            "route": "cuda", "source": "triton_dist_tpu_torch/csrc/p2p.cu",
            "replaces": P2P_REPLACES[entry], "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": "bytes",
            "library_ms": lib_ms, "library": "torch.roll(x.view(W, -1), 1, 0)",
            "wall_ms": wall_ms(torch, call),
            "shape": list(x.shape), "ok": True},
            (entry, (world, rows, chunk // rows))))
    del ctx
    torch.cuda.empty_cache()
    print(f"phase 27 (kernels) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return records


def phase_p2p_main(torch, models, p2p, ks, lp, rd, cfg, model, params,
                   square, card: str) -> dict:
    """Phase 27 (b, c), this slice's main path, every count set to 0 just
    before: (b) Qwen3-8B (phase 3's params) as a 4-stage pipeline,
    ``pipeline_forward(stage_fn, x, group=RankGroup(4, "pp"),
    impl="pallas")``, stage s running decoder layers 9s..9s+8 through
    ``DenseLLM.decoder_layer`` in mode ag_rs (the world-1 kernels) with
    fresh contiguous caches on every call, on phase 3's 4 x 128 prompts
    embedded (rank 0's block; the others zeros): exactly 4 shift launches,
    and the final norm and f32 LM head of rank 0's block bit-equal to
    ``DenseLLM.forward``'s prefill logits in mode ag_rs; its wall time
    beside the sequential prefill's (not gated); then ``CommOp`` sends and
    receives the decode rows (W x 4, 4096) once, bit-equal to the plain
    roll. (c) a world-1 paged sp engine (page 16) serves one of the
    prompts (128 tokens: 8 blocks); ``pack_block`` packs each block from
    its pools over all 36 layers, ``symm_ship(group=RankGroup(4, "tp"))``
    moves it by +1 (equal to the plain rotation, JAX's semantics) and back
    by -1: 16 launches, the round trip's bytes equal to the packed bytes
    and ``unpack_block`` of them equal to the pool's pages. Returns the
    launches by entry and key."""
    t0 = time.perf_counter()
    world = PP_STAGES
    group = rd.create_rank_group(world, "pp", device="cuda")
    ids = torch.tensor(square, device="cuda")
    b, s = ids.shape
    layers = cfg.num_hidden_layers
    per = layers // world

    def caches(n):
        return models.KVCacheManager(n, b, s, cfg.num_key_value_heads,
                                     cfg.head_dim, dtype=cfg.dtype,
                                     device="cuda").init()

    pos = torch.arange(s, device="cuda")[None].expand(b, s)

    def stage_fn(stage, h):
        kv = caches(per)
        for i, layer in enumerate(params["layers"][stage * per:
                                                   (stage + 1) * per]):
            h = model.decoder_layer(layer, h, pos, kv[i], 0, "ag_rs")
        return h

    from triton_dist_tpu_torch.layers.common import rms_norm
    x = params["embed"][ids].reshape(b * s, cfg.hidden_size)
    x0 = torch.cat([x, x.new_zeros(((world - 1) * b * s, cfg.hidden_size))])

    def pipelined():
        h = lp.pipeline_forward(stage_fn, x0, group, impl="pallas")
        out = rms_norm(h[:b * s], params["final_norm"], cfg.rms_norm_eps)
        return (out.float() @ params["lm_head_f32"].t()).reshape(
            b, s, cfg.vocab_size)

    def sequential():
        return model.forward(params, ids, caches(layers), 0,
                             mode="ag_rs")[0]

    sp_model = models.DenseLLM(cfg, sp_axis="sp")
    eng = models.Engine(sp_model, batch=1, max_seq=1024, prefill_mode="sp",
                        decode_mode="sp", paged=True, page_size=FD_PAGE)
    with torch.no_grad():
        sequential()                                   # warm-up
        pipelined()
        eng.serve(params, [square[0]], 1)
        counters = {"pp_shift": p2p.pp_shift_launches,
                    "symm_ship": ks.symm_ship_launches}
        for c in counters.values():                    # ---- the main path
            c.reset()
        want, seq_ms = sync_time(torch, sequential)
        got, pipe_ms = sync_time(torch, pipelined)
        check(p2p.pp_shift_launches.total == world
              and ks.symm_ship_launches.total == 0,
              f"pipeline: {p2p.pp_shift_launches.total} shift and "
              f"{ks.symm_ship_launches.total} ship launches, expected "
              f"{world} and 0")
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"pipeline logits non-finite or shape {tuple(got.shape)}")
        same = torch.equal(got, want)
        diff = (got - want).abs().max().item()
        check(same, f"pipeline logits differ from the sequential prefill by "
                    f"{diff}")
        print(f"Qwen3-8B as a {world}-stage pipeline ({per} layers a stage, "
              f"mode ag_rs, 4 x 128 prompts): logits {tuple(got.shape)} "
              f"bit-equal to DenseLLM.forward's prefill; {world} shift "
              f"launches; wall {pipe_ms:.1f} ms against the sequential "
              f"prefill's {seq_ms:.1f} ms ({pipe_ms / seq_ms:.2f}x: every "
              f"tick runs all {world} stages, as JAX's does) [{card}]",
              flush=True)
        del want, got
        op = lp.CommOp(group=group)
        rows = torch.randn((world * 4, cfg.hidden_size),
                           device="cuda").to(cfg.dtype)
        op.send(rows)
        check(torch.equal(bits(torch, op.recv()), bits(
            torch, p2p.pp_shift_reference(rows, world, 1))),
            "CommOp's hop differs from the plain roll")
        check(p2p.pp_shift_launches.total == world + 1,
              f"CommOp: {p2p.pp_shift_launches.total - world} launches")
        print(f"CommOp: the decode rows {tuple(rows.shape)} sent and "
              f"received through one launch, bit-equal to the plain roll",
              flush=True)

        seen = []
        forward = sp_model.forward

        def spy(*args, **kw):
            seen.append(args[2])
            return forward(*args, **kw)
        sp_model.forward = spy
        try:
            eng.serve(params, [square[0]], 1)
        finally:
            del sp_model.forward
        pools = seen[0]
        table = eng.kv.block_table()
        n_blocks = ks.block_span(len(square[0]), eng.kv.page_size)
        ship = rd.create_rank_group(world, "tp", device="cuda")
        shape = pools[0][0].shape[1:]
        for j, s_ in ks.ship_schedule(n_blocks, 0):
            slot = int(table[0, 0, j])
            pages = [(pk[slot], pv[slot]) for pk, pv in pools]
            data = ks.pack_block(pages)
            check(len(data) == layers * 2 * shape.numel() * 4,
                  f"block {j}: {len(data)} packed bytes")
            staged = torch.frombuffer(bytearray(data), dtype=torch.uint8
                                      ).to("cuda")
            moved = ks.symm_ship(staged, ship, delta=1)
            back = ks.symm_ship(moved, ship, delta=-1)
            check(torch.equal(moved, p2p.pp_shift_reference(staged, world,
                                                            1)),
                  f"block {j} (seq {s_}): the hop is not JAX's rotation")
            back_bytes = back.cpu().numpy().tobytes()
            check(back_bytes == data, f"block {j}: round trip changed bytes")
            for (k, v), (pk, pv) in zip(ks.unpack_block(back_bytes, layers,
                                                        shape), pages):
                check(torch.equal(k, pk.float().cpu())
                      and torch.equal(v, pv.float().cpu()),
                      f"block {j}: unpacked pages differ from the pool's")
        torch.cuda.synchronize()
        check(ks.symm_ship_launches.total == 2 * n_blocks and n_blocks == 8,
              f"KV ship: {ks.symm_ship_launches.total} launches for "
              f"{n_blocks} blocks")
        print(f"KV ship: a served 128-token prompt's {n_blocks} blocks of "
              f"{len(data)} bytes packed from the paged pools, shipped "
              f"by +1 (JAX's rotation of the {world} shards) and back by -1 "
              f"through {ks.symm_ship_launches.total} launches, bytes and "
              f"unpacked pages equal to the pool's [{card}]", flush=True)
    launches = {k: dict(c.by_shape) for k, c in counters.items()}
    print(f"phase 27 path launches {launches}; phase 27 (path) took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del eng, sp_model
    return launches


def p2p_kernels_line(records, launches) -> list:
    """The records of phase 27 with their launches on its main path; each
    must have run there."""
    out = []
    for rec, (entry, key) in records:
        rec = dict(rec, launches=launches[entry].get(key, 0))
        check(rec["launches"] > 0, f"{rec['name']} never launched on the "
                                   f"pipeline / KV ship path")
        out.append(rec)
    return out


def phase_records(torch, models, card: str, seed: int) -> None:
    """``--records`` (ROADMAP.md, Queue C item C6), in a fresh process:
    phase 5's decode step (Qwen3-8B, full width and depth, gemm_ar path)
    under the profiler. (1) One step with CPU and CUDA activities: the
    kernel records matched by correlation id to the launch calls CUPTI
    saw, the port's main-kernel records against the calls its wrappers
    counted, records by kernel. (2) 400 sessions of one step each, as the
    smoke's sessions run, then 10 sessions of 20 steps: each session's
    share of the port's launches recorded."""
    import collections
    import re
    from torch.profiler import ProfilerActivity, profile
    from triton_dist_tpu_torch.models import KVCacheManager
    print("== records check: profiler records of a decode step", flush=True)
    cfg = models.presets.qwen3_8b()
    model = models.DenseLLM(cfg)
    params = model.init(seed)
    host = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (4, 128), generator=host).cuda()
    caches = KVCacheManager(cfg.num_hidden_layers, 4, 1024,
                            cfg.num_key_value_heads, cfg.head_dim,
                            dtype=cfg.dtype, device="cuda").init()
    with torch.no_grad():
        logits, caches = model.forward(params, ids, caches, 0, mode="xla_ar")
    tok = logits[:, -1].argmax(-1)[:, None]

    def step():
        with torch.no_grad():
            model.forward(params, tok, caches, 128, mode="gemm_ar")
    step()
    torch.cuda.synchronize()
    pattern = re.compile(r"\b(" + "|".join(port_kernel_names()) + r")\b")
    before = port_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    counted = port_launches() - before
    events = prof.profiler.kineto_results.events()
    on_card = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type() == on_card
               and not e.name().startswith(("Memcpy", "Memset"))]
    calls = [e for e in events if "LaunchKernel" in e.name()
             or "LaunchCooperativeKernel" in e.name()]
    kinds = {"device": sum(e.device_type() == on_card for e in events),
             "host": sum(e.device_type() != on_card for e in events)}
    call_ids = {e.correlation_id() for e in calls}
    matched = sum(e.correlation_id() in call_ids for e in kernels)
    port = [e for e in kernels if pattern.search(e.name())]
    print(f"records (one step, CPU + CUDA activities): event kinds "
          f"{dict(kinds)}; {len(calls)} launch calls, {len(kernels)} kernel "
          f"records, {matched} of them matched to a launch call by "
          f"correlation id; port main kernels {len(port)} records, "
          f"{counted} calls counted by the wrappers [{card}]", flush=True)
    by_name = collections.Counter(e.name()[:60] for e in kernels)
    for name, count in by_name.most_common(12):
        print(f"  records: {count} x {name}", flush=True)
    by_call = collections.Counter(e.name() for e in calls)
    print(f"  launch calls by name: {dict(by_call)}", flush=True)

    def sessions(count, n):
        shares = []
        for _ in range(count):
            _, recorded, counted = port_session(torch, step, n)
            shares.append(recorded / counted)
        low = [i for i, v in enumerate(shares) if v < 1.0]
        return (f"min share {min(shares):.4f}, {len(low)} below 1.0"
                + (f" (first at session {low[0]})" if low else ""))
    t0 = time.perf_counter()
    print(f"records: 400 sessions of 1 step: {sessions(400, 1)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"records: 10 sessions of 20 steps: {sessions(10, 20)}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--records", action="store_true",
                    help="only the profiler records check (ROADMAP C6)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from triton_dist_tpu_torch import models
    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as ops
    from triton_dist_tpu_torch.ops import allgather as agk
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.layers import sp_flash_decode as layers
    from triton_dist_tpu_torch.ops import allreduce as ar
    from triton_dist_tpu_torch.ops import reduce_scatter as rs
    from triton_dist_tpu_torch.ops import sp_attention as sp
    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.ops import moe_utils as mu
    from triton_dist_tpu_torch.runtime import dist as rd
    from triton_dist_tpu_torch.ops import p2p
    from triton_dist_tpu_torch.layers import p2p as pipe
    from triton_dist_tpu_torch.serving import kv_stream as kvs

    print("== phase 1: setup", flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("matmul: allow_tf32 =", torch.backends.cuda.matmul.allow_tf32,
          "(set False), allow_bf16_reduced_precision_reduction =",
          torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "(set False)", flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {sorted(built)} with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.records:
        phase_records(torch, models, card, args.seed)
        return 0

    phase_kernel(torch, ops, card)
    cfg, model, params, eng, prompts, base = phase_model(torch, models, ops,
                                                         card, args.seed)
    phase_server(torch, eng, params, prompts, card)
    main_launches = dict(ops.launches.by_shape)    # ---- main path ends
    print(f"main path gemm_ar launches: {ops.launches.total} "
          f"by (K, N): {main_launches}", flush=True)
    phase_logits(torch, ops, model, params, prompts, cfg, card)
    phase_flash_kernels(torch, fd, card)
    engines, square, stream, fd_launches, sp_tokens = phase_sp_main(
        torch, models, ops, fd, cfg, params, card, args.seed)
    phase_sp_checks(torch, fd, engines, params, square, stream, card)
    del engines
    ag_records = phase_ag_kernels(torch, ag, ops, params, cfg, card)
    ag_engines, ag_launches = phase_ag_rs_main(torch, models, ag, ops, ops,
                                               cfg, params, base, card)
    phase_ag_checks(torch, ag, ag_engines, params, base[0], cfg, card)
    del ag_engines
    t17 = time.perf_counter()
    ring_records = phase_ring_kernels(torch, ag, ops, rd, params, cfg, card)
    t18 = time.perf_counter()
    tp_model, ring_launches = phase_tp_main(torch, models, ag, ops, ops, cfg,
                                            params, base, card)
    phase_tp_checks(torch, ag, ops, tp_model, params, base[0], cfg, card)
    print(f"phase 17 took {t18 - t17:.1f} s, phase 18 "
          f"{time.perf_counter() - t18:.1f} s", flush=True)
    arw_records = phase_arw_kernels(torch, ar, rs, rd, card)
    arw_launches = phase_arw_main(torch, ar, rs, agk, rd, cfg, tp_model,
                                  params, base[0], card)
    del tp_model
    t27 = time.perf_counter()
    p2p_records = phase_p2p_kernels(torch, p2p, kvs, rd, card)
    p2p_launches = phase_p2p_main(torch, models, p2p, kvs, pipe, rd, cfg,
                                  model, params, base[0], card)
    print(f"phase 27 took {time.perf_counter() - t27:.1f} s", flush=True)
    phase_sp_world_kernels(torch, fd, sp, rd, cfg, card)
    spw_launches, spw_engines = phase_sp_world_main(
        torch, models, fd, sp, ops, cfg, params, square, sp_tokens, card)
    del spw_engines
    # The dense kernels' records read the Qwen3-8B weights: before they go.
    kernels = phase_kernels_line(torch, ops, params, cfg, main_launches)
    kernels += phase_fd_kernels_line(torch, fd, fd_launches)
    kernels += ag_kernels_line(ag_records, ag_launches)
    kernels += ring_kernels_line(ring_records, ring_launches)
    kernels += arw_kernels_line(arw_records, arw_launches)
    kernels += p2p_kernels_line(p2p_records, p2p_launches)
    kernels += spw_fd_records(torch, fd, rd, spw_launches)
    del cfg, model, params, eng, prompts, base
    gc.collect()
    torch.cuda.empty_cache()
    print(f"Qwen3-8B released: device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    cfg = models.presets.qwen3_8b()
    sp_record, full = phase_sp_attn_kernels(torch, sp, cfg, card)
    sp_launches = phase_sp_attn_main(torch, layers, sp, fd, agk, ar, rs, cfg,
                                     full, card)
    spw_records = phase_sp_world_long(torch, layers, fd, sp, rd, cfg, full,
                                      card)
    del full
    records = [(sp_record, "sp_attention", None)]
    records += sp_fd_records(torch, sp, fd, cfg, card)
    records += coll_records(torch, agk, ar, rs, card)
    kernels += sp_kernels_line(records, sp_launches)
    kernels += spw_records
    gc.collect()
    torch.cuda.empty_cache()

    counters = moe_counters(ag, ops, ops, fd, gg, mrs, agk)
    cfg, model, params = phase_moe_load(torch, models, card, args.seed)
    moe_records = phase_moe_kernels(torch, gg, mrs, agk, cfg, params, card)
    engines, square, tokens, moe_launches = phase_moe_main(
        torch, models, counters, cfg, model, params, card, args.seed)
    phase_moe_checks(torch, gg, mrs, agk, ag, ops, engines, cfg, params,
                     square, tokens, card)
    kernels += moe_kernels_line(moe_records, moe_launches)
    del engines
    gc.collect()
    torch.cuda.empty_cache()

    a2a_records = phase_a2a_kernel(torch, a2a, mu, rd, cfg, params, card)
    ep_model, square, ep_launches = phase_ep_main(
        torch, models, a2a, gg, cfg, params, tokens["default"], card,
        args.seed)
    phase_ep_checks(torch, a2a, cfg, ep_model, params, square, card)
    phase_ep_mode(torch, ag, ops, a2a, cfg, ep_model, params, square, card)
    kernels += ep_kernels_line(a2a_records, ep_launches)
    del ep_model
    gc.collect()
    torch.cuda.empty_cache()

    agw_records = phase_agw_kernels(torch, agk, rd, card)
    tpm_model, tpm_engines, square, _, tpm_launches = phase_tpm_main(
        torch, models, tpm_counters(agk, gg, mrs, ag, ops, ops), cfg, params,
        tokens["default"], card, args.seed)
    del tpm_engines
    routing, hidden = phase_tpm_checks(torch, gg, mrs, agk, cfg, tpm_model,
                                       params, square, card)
    kernels += agw_kernels_line(agw_records, tpm_launches)
    del tpm_model
    agg_records = phase_agg_kernels(torch, gg, rd, cfg, params, routing,
                                    card)
    agg_launches = phase_agg_main(torch, gg, mrs, agk, rd, cfg, params,
                                  routing, card, args.seed)
    kernels += agg_kernels_line(agg_records, agg_launches)
    mrr_records = phase_mrr_kernels(torch, mrs, mu, cfg, params, hidden,
                                    card)
    mrr_launches = phase_mrr_main(torch, gg, mrs, mu, agk, rd, cfg, params,
                                  hidden, card)
    kernels += mrr_kernels_line(mrr_records, mrr_launches)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
