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
   are device time from the profiler; ``wall_ms`` is the kernel's time per
   call when called back to back, host overhead included.
7. flash-decode kernels: the split-KV ``partial`` (dense rows and pages
   through a block table), ``combine`` and ``single`` kernels against their
   plain versions at Qwen3-8B's decode shapes, kv_len 1, 17, 160, 1024 and
   ragged, bf16 and f32, with the stated tolerance; repeats must give the
   same bits, and paged and dense addressing of the same rows too.
8. sp main path (flash decode's): Qwen3-8B served in mode "sp" by three
   engines, (a) paged (page 16), (b) contiguous with max_seq 1024 (the
   split kernel) and (c) contiguous with max_seq 512 (the single-pass
   kernel), 4 x 128-token prompts for 32 tokens each: flash-decode launches
   per decode step must be 36 x 2 (a, b) or 36 x 1 (c), gemm_ar launches 0,
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
    the gate|up products without their epilogue) and the bound.
11. ag_rs main path: Qwen3-8B (default model mode "ag_rs") served by the
    reference engine (prefill "ag_rs", decode "gemm_ar") and the fused one
    (both "ag_rs") through serve, serve_stream (6 prompts of 65-128
    tokens, every admission bucket 128) and the server: per prefill 36
    ag_gemm, 36 ag_swiglu and 72 gemm_rs launches; per decode step 72
    ag_gemm + 72 gemm_rs (fused) or 72 gemm_ar (reference); the share of
    greedy tokens equal to phase 3's engine; then the prefill's
    last-position logits through the kernels against the plain versions
    (within 0.25) and each engine's decode step wall vs device time.

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
    all-gather; none for the MoE-reduce).
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
    version ``sp_attention_fused_reference`` (64-wide KV tiles, as the
    kernel's) after every Qwen3-8B object is released, at Qwen3-8B's
    attention width (32 query heads, D = 128): bf16 and f32, causal and
    full, G = 4 and 8, S = 1000 (no multiple of the tiles), B = 4 at
    S = 4096 and the full case B = 1, S = 32768; each within the port's
    tolerance (``sp_attention_tolerance``: bf16 2^-7 |out| + 2^-8 sum_j
    (p_j / l) |v_j| elementwise), a planted fault (the KV tile at S / 2
    zeroed for the kernel only) refused by that same limit, bit-identical
    on repeat, with its time beside the bound;
    the full case also with the plain version's time and one
    ``scaled_dot_product_attention(is_causal, enable_gqa)``. These times
    come from CUDA events around back-to-back calls, not the profiler.
15. sp main path (this slice's), every count set to 0 just before it:
    ``SpAttentionLayer(impl="pallas")`` prefill of the 32k prompt (one
    kernel launch, equal to phase 14's output), ``SpFlashDecodeLayer``
    over a cache of 32768 + 32 positions filled by ``append``, then 32
    append-then-decode steps (partial + combine per step) each against
    ``flash_decode_reference`` (2^-7 |out| + 2^-8 sum_j (p_j / l) |v_j|); ``sp_ag_attention`` in xla, ulysses and
    ag_pallas (the all-gather kernel) equal to ring, and pallas within
    tolerance, at S = 4096; every all_reduce and reduce_scatter method
    and broadcast at (1, 4, 4096) and (1, 512, 4096) bf16 equal to their
    plain versions; then the flash-decode kernels at kv_len 32800 (with a
    planted fault, one split dropped, refused by the same limit) and the
    copy kernel under each collective are timed for the JSON line.

Phases 7-15 run between phases 5 and 6 (14-15 after the Qwen3-8B
release, before the Qwen3-30B-A3B load); the JSON line covers all five
slices.

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


def device_ms(torch, fn, n: int = 20) -> float:
    """Mean device time in ms of one ``fn()`` call: the GPU time of every
    kernel it launches, summed by the profiler (CUPTI) over ``n`` calls
    after one warm-up. Host overhead between launches is not in it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no kernels: retry
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total
                       for e in prof.key_averages())
        if total_us > 0:
            return total_us / n / 1e3
    raise SmokeFailure("the profiler saw no device time in 3 sessions")


def device_breakdown(torch, fn, n: int = 3, top: int = 8) -> list:
    """The ``top`` kernels of one ``fn()`` call by device time: [(kernel
    name cut to 70 characters, ms per call, share of the call's device
    time)], from the profiler over ``n`` calls after one warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / n / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(ms for _, ms in rows) or 1.0
    rows.sort(key=lambda r: -r[1])
    return [(k[:70], ms, ms / total) for k, ms in rows[:top]]


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
                k_ms = device_ms(torch, lambda: ops.gemm_ar(a, nb()))
                k_wall = wall_ms(torch, lambda: ops.gemm_ar(a, nb()))
                bf = [b.to(torch.bfloat16) for b in bs] \
                    if dtype != torch.bfloat16 else bs
                ab = a.to(torch.bfloat16)
                nl = rotating(bf)
                lib_ms = device_ms(torch, lambda: torch.matmul(ab, nl()))
                path = ("mma" if ops.plan(m, n, k, dtype, sms).tensor_cores
                        else "fma")
                bnd, by = bound_ms(m, k, n, dtype.itemsize, kind)
                tol = ("1 bf16 ulp" if dtype == torch.bfloat16
                       else f"{F32_ATOL:g} abs")
                print(f"kernel gemm_ar {kind} M={m} K={k} N={n} ({path}): "
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
    dev = device_ms(torch, step, n=3)
    print(f"decode step (batch 4, max_seq 1024, forward only): wall "
          f"{wall:.2f} ms (median of 5), device {dev:.2f} ms, device idle "
          f"share {1 - dev / wall:.2f} [{card}]", flush=True)


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
        ms = device_ms(torch, lambda: ops.gemm_ar(a, nk()))
        wall = wall_ms(torch, lambda: ops.gemm_ar(a, nk()))
        plain = device_ms(torch, lambda: ops.gemm_ar_reference(a, np_()))
        lib = device_ms(torch, lambda: torch.matmul(a, nl()))
        bnd, by = bound_ms(4, k, n, 2, "bf16")
        out.append({
            "name": name, "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/gemm_ar.cu",
            "replaces": f"triton_dist_tpu/ops/gemm_reduce_scatter.py:{line}",
            "launches": main_launches.get((k, n), 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib,
            "wall_ms": wall, "shape": [4, k, n], "ok": ok})
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
#: launches per layer of a decode step).
SP_ENGINES = {"a": (1024, {"paged": True, "page_size": FD_PAGE}, 2),
              "b": (1024, {}, 2),
              "c": (512, {}, 1)}
#: Block pool of the stream phase: 24 pages hold two of its requests at a
#: time (each needs 7-13), so admission waits for retirements.
STREAM_SLOTS = 24
PREFIX_LEN = 64


def fd_error(torch, got, ref, v) -> tuple[float, bool]:
    """(max |got - ref|, within tolerance) of attention outputs. f32: 1e-5
    (f32 sums in another order). bf16: the kernel rounds each probability
    to bf16 against its 64-position chunk's running max, the plain
    version against the row's final max, so a probability moves by up to
    2^-8 of itself and an output by up to 2^-8 * max|v|; both outputs
    then round to bf16 once (2^-7 of the value)."""
    diff = (got.float() - ref.float()).abs()
    if got.dtype == v.dtype == torch.float32:
        lim = torch.full_like(diff, F32_ATOL / 3)
    else:
        lim = (2.0 ** -8 * v.float().abs().max() + BF16_ULP_REL
               * torch.maximum(got.float().abs(), ref.float().abs()) + 1e-6)
    return diff.max().item(), bool((diff <= lim).all())


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
        errs = {"partial": 0.0, "combine": 0.0, "single": 0.0}
        for lens in FD_LENS:
            lens = list(lens) if isinstance(lens, tuple) else lens
            runs = []
            for _ in range(2):               # the repeat must match bits
                dense = fd.flash_decode_partial(q, k, v, lens, p.split_len,
                                                p.splits)
                paged = fd.flash_decode_partial(q, pool_k, pool_v, lens,
                                                p.split_len, p.splits,
                                                table=table[0])
                runs.append((dense, paged,
                             fd.flash_decode_combine(*dense, dtype),
                             fd.flash_decode_single(q, k5, v5, lens)))
            torch.cuda.synchronize()
            (dense, paged, merged, single), again = runs
            flat = [t for r in runs for t in (*r[0], *r[1], r[2], r[3])]
            half = len(flat) // 2
            check(all(torch.equal(a, b)
                      for a, b in zip(flat[:half], flat[half:])),
                  f"flash decode {kind} kv_len {lens}: repeat differs")
            check(all(torch.equal(a, b) for a, b in zip(dense, paged)),
                  f"flash decode {kind} kv_len {lens}: paged and dense "
                  f"partials differ")
            # partial: both partials merged by the plain combine.
            plain = fd.flash_decode_partials_reference(q, k, v, lens,
                                                       p.split_len, p.splits)
            err, ok = fd_error(torch,
                               fd.flash_decode_combine_reference(*dense,
                                                                 dtype),
                               fd.flash_decode_combine_reference(*plain,
                                                                 dtype), v)
            check(ok, f"partial {kind} kv_len {lens}: err {err}")
            errs["partial"] = max(errs["partial"], err)
            err, ok = fd_error(torch, merged,
                               fd.flash_decode_combine_reference(*dense,
                                                                 dtype),
                               torch.ones(1, dtype=dtype))
            check(ok, f"combine {kind} kv_len {lens}: err {err}")
            errs["combine"] = max(errs["combine"], err)
            err, ok = fd_error(torch, single,
                               fd.flash_decode_reference(q, k5, v5, lens), v)
            check(ok, f"single {kind} kv_len {lens}: err {err}")
            errs["single"] = max(errs["single"], err)
            err, ok = fd_error(torch, merged,
                               fd.flash_decode_reference(q, k, v, lens), v)
            check(ok, f"partial+combine {kind} kv_len {lens}: err {err}")
        tol = ("1e-5" if dtype == torch.float32 else
               "2^-8 max|v| + 1 bf16 ulp")
        print(f"kernel flash_decode {kind} B={FD_B} Hq={FD_HQ} Hkv={FD_HKV} "
              f"D={FD_D}, kv_len {list(FD_LENS)}: "
              f"partial (T=1024 dense and paged, {p.splits} splits of "
              f"{p.split_len}) max_abs_err={errs['partial']:.3g}, combine "
              f"{errs['combine']:.3g}, single (T=512) {errs['single']:.3g} "
              f"(tol {tol}); repeats bit-identical, paged == dense bits "
              f"[{card}]", flush=True)


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
    server over (a). Returns (engines, tokens by engine, launches)."""
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
    check(launched > 0 and launched % (2 * layers) == 0,
          f"stream flash-decode launches {launched}")
    print(f"sp serve_stream (a': paged, {STREAM_SLOTS}-block pool): 6 "
          f"prompts sharing a {PREFIX_LEN}-token prefix through 4 rows, "
          f"{GEN} new tokens in {stream_ms:.1f} ms; decode steps "
          f"{launched // (2 * layers)}; prefix {stats}; audit {audit} "
          f"[{card}]", flush=True)

    phase_sp_server(torch, engines["a"], params, square, stream, card)
    fd_launches = {n: dict(c.by_shape) for n, c in fd.launches.items()}
    check(ops.launches.total == 0, "gemm_ar launched on the sp path")
    print(f"sp main path: gemm_ar launches 0; flash-decode launches "
          f"{fd_launches}", flush=True)               # ---- main path ends
    for t in list(tokens.values()) + [torch.tensor(r) for r in res]:
        check(bool(((t >= 0) & (t < cfg.vocab_size)).all()),
              "token out of vocabulary")
    return engines, square, stream, fd_launches


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
        dev = device_ms(torch, fn, n=3)
        print(f"sp decode step ({name}, forward only): wall {wall:.2f} ms "
              f"(median of 5), device {dev:.2f} ms, device idle share "
              f"{1 - dev / wall:.2f} [{card}]", flush=True)

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
    ``library_ms``: one ``scaled_dot_product_attention`` with the kv_len
    mask over the contiguous (B, T) view, a yardstick the port never
    calls (the combine pass has none)."""
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

    def paged_partial():
        return fd.flash_decode_partial(q, pool_k, pool_v, lens, p.split_len,
                                       p.splits, table[0])

    def dense_partial():
        return fd.flash_decode_partial(q, k, v, lens, p.split_len, p.splits)

    parts = dense_partial()
    part_bytes = sum(x.numel() * 4 for x in parts)
    ref = fd.flash_decode_reference(q, k, v, lens)
    merge = fd.flash_decode_combine_reference
    # name, counter, launch key, replaced line, kernel, plain version,
    # (kernel result, plain result, v for the tolerance), library, bound
    cases = [
        ("flash_decode_partial[paged]", "partial", ("paged", FD_B, 1024),
         280, paged_partial,
         lambda: fd.flash_decode_partials_reference(
             q, view(pool_k, table), view(pool_v, table), lens,
             p.split_len, p.splits),
         (merge(*paged_partial(), dtype), ref, v),
         library(view(pool_k, table), view(pool_v, table)),
         attn_bound_ms(lens, 1024, 2, kind, part_bytes)),
        ("flash_decode_partial[dense]", "partial", ("dense", FD_B, 1024),
         280, dense_partial,
         lambda: fd.flash_decode_partials_reference(
             q, k, v, lens, p.split_len, p.splits),
         (merge(*parts, dtype), ref, v), library(k, v),
         attn_bound_ms(lens, 1024, 2, kind, part_bytes)),
        ("flash_decode_combine", "combine", None, 218,
         lambda: fd.flash_decode_combine(*parts, dtype),
         lambda: merge(*parts, dtype),
         (fd.flash_decode_combine(*parts, dtype), merge(*parts, dtype),
          torch.ones(1, dtype=dtype)), None,
         ((part_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3, "bytes")),
        ("flash_decode_single", "single", ("dense", FD_B, 512), 262,
         lambda: fd.flash_decode_single(q, k5, v5, lens),
         lambda: fd.flash_decode_reference(q, k5, v5, lens),
         (fd.flash_decode_single(q, k5, v5, lens),
          fd.flash_decode_reference(q, k5, v5, lens), v),
         library(k5, v5), attn_bound_ms(lens, 512, 2, kind, out_bytes)),
    ]
    out = []
    for (name, counter, key, line, kernel, plain, (got, want, vv), lib,
         (bnd, by)) in cases:
        err, ok = fd_error(torch, got, want, vv)
        check(ok, f"{name}: max abs err {err} outside tolerance")
        launches = (fd_launches[counter].get(key, 0) if key is not None
                    else sum(fd_launches[counter].values()))
        out.append({
            "name": name, "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/flash_decode.cu",
            "replaces": f"triton_dist_tpu/ops/flash_decode.py:{line}",
            "launches": launches, "max_abs_err": err,
            "ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, plain),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": device_ms(torch, lib) if lib else None,
            "wall_ms": wall_ms(torch, kernel),
            "shape": [FD_B, FD_HQ, FD_HKV, FD_D, 160], "ok": ok})
        check(launches > 0, f"{name} never launched on the path")
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
        ms = device_ms(torch, lambda: kernel(nk()))
        wall = wall_ms(torch, lambda: kernel(nk()))
        plain_ms = device_ms(torch, lambda: plain(np_()))
        if op == "rs":
            nl = rotating([w[0] for w in sets])
            lib_ms = device_ms(torch, lambda: torch.matmul(a, nl()))
        else:
            nl = rotating(cat[id(sets[0][0])])
            lib_ms = device_ms(torch, lambda: torch.matmul(a, nl()))
        if op == "swiglu":
            bnd, by = gemm_bound_ms(m, k, widths[:1], 2)
        else:
            bnd, by = gemm_bound_ms(m, k, widths)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
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
        print(f"kernel {name} bf16 M={m} K={k} N={'|'.join(map(str, widths))}"
              f" ({path}): max_abs_err={err:.3g} (tol {tol}) ok, repeat "
              f"bit-identical; kernel_ms={ms:.4f} (wall {wall:.4f}) "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}"
              f"{' (matmul of the gate|up products, no epilogue)' if op == 'swiglu' else ''}"
              f" bound_ms={bnd:.4f} ({by}) [{card}]", flush=True)
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


def phase_ag_server(torch, eng, params, square, stream, name, card) -> None:
    from triton_dist_tpu_torch.serving.client import ChatClient
    from triton_dist_tpu_torch.serving.server import ModelServer
    srv = ModelServer(eng, params, host="127.0.0.1", port=0).start()
    try:
        with ChatClient(srv.host, srv.port, timeout=600) as client:
            for batch, route in ((square, "serve"), (stream, "serve_stream"),
                                 (stream[:3], "serve_ragged")):
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
        dev = device_ms(torch, step, n=3)
        _, pre_wall = sync_time(torch, prefill)
        pre_dev = device_ms(torch, prefill, n=3)
        print(f"ag_rs decode step ({name}: mode {dc}, batch 4, forward "
              f"only): wall {wall:.2f} ms (median of 5), device {dev:.2f} "
              f"ms, device idle share {1 - dev / wall:.2f}; prefill "
              f"forward wall {pre_wall:.2f} ms, device {pre_dev:.2f} ms "
              f"[{card}]", flush=True)


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
                None, "triton_dist_tpu/ops/moe_reduce_rs.py:72"))
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
            ms = device_ms(torch, lambda: kernel(nk()))
            wall = wall_ms(torch, lambda: kernel(nk()))
            plain_ms = device_ms(torch, lambda: plain(np_()), n=3)
            lib_ms = device_ms(torch, lib) if lib is not None else None
            lib_txt = (f"{lib_ms:.4f} (torch._grouped_mm"
                       f"{', no epilogue' if 'swiglu' in name else ''})"
                       if lib_ms is not None else "—")
            print(f"kernel {name} bf16 P={p} ({m} tokens, {live} live "
                  f"experts, {key[0]}, {key[1]}-row tiles): max_abs_err="
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
                "ok": ok}, counter, key))
        del cat_gu

        # The all-gather of the token rows.
        got = agk.all_gather(x)
        torch.cuda.synchronize()
        check(torch.equal(got, x) and torch.equal(agk.all_gather(x), got),
              f"all_gather ({m}, {h}) differs from its input")
        nbytes = x.numel() * x.element_size()
        out = torch.empty_like(x)
        ms = device_ms(torch, lambda: agk.all_gather(x))
        wall = wall_ms(torch, lambda: agk.all_gather(x))
        plain_ms = device_ms(torch, lambda: agk.all_gather_reference(x))
        lib_ms = device_ms(torch, lambda: out.copy_(x))
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
        tp_moe.all_gather = lambda x, ctx=None, impl="pallas": (
            agk.all_gather_reference(x))
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
        dev = device_ms(torch, fn, n=3)
        print(f"moe decode step ({name}: mode {dc}, batch 4, forward only): "
              f"wall {wall:.2f} ms (median of 5), device {dev:.2f} ms, device"
              f" idle share {1 - dev / wall:.2f} [{card}]", flush=True)
        for kernel, ms, share in device_breakdown(torch, fn):
            print(f"  moe decode step ({name}) device time: {ms:.3f} ms "
                  f"({share:.2f}) {kernel}", flush=True)


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
#: (Qwen3-30B-A3B's). S = 1000 is no multiple of the 64-wide tiles.
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
        print(f"sp_attention {name} {dt} causal={causal} B={b} S={s} "
              f"heads {hq}/{hkv} D={d}: max_abs_err={err:.3e} (tol {tol}, "
              f"largest share used {used:.3f}) ok={ok}; planted fault "
              f"(KV tile at S/2 zeroed): max_abs_err={bad_err:.3e}, share "
              f"{bad_used:.3f}, refused={not bad_ok}; repeat "
              f"bit-identical={same} finite={finite} kernel_ms={ms:.3f} "
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
                  f"is_causal, enable_gqa) [{card}]", flush=True)
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
    check(per_step == {2}, f"decode steps launched {per_step} flash-decode "
                           f"kernels, not partial + combine")
    print(f"SpFlashDecodeLayer: {SP_DECODE} append + decode steps over the "
          f"{SP_S}-position cache (max_seq {SP_S + SP_DECODE}), 2 launches "
          f"per step (partial + combine), max_abs_err vs "
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
            check(torch.equal(ar.all_reduce(x, ctx),
                              ar.all_reduce_reference(x)),
                  f"all_reduce {method.value} {shape} differs")
        for method in rs.ReduceScatterMethod:
            ctx = rs.create_reduce_scatter_context(method=method)
            check(torch.equal(rs.reduce_scatter(x, ctx),
                              rs.reduce_scatter_reference(x)),
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
    ``launches`` to fill from phase 15."""
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
    got = fd.flash_decode_combine(*parts, torch.bfloat16)
    want = fd.flash_decode_reference(q, k, v, t)
    lim = sp.bf16_attention_limit(got, want, fd_weight(fd, q, k, v, t))
    err, ok, used = sp_error(got, want, lim)
    # A planted fault: the middle split's partial dropped before the
    # combine kernel; the same limit must refuse it.
    a, l, m = (x.clone() for x in parts)
    drop = p.splits // 2
    a[:, :, drop], l[:, :, drop], m[:, :, drop] = 0.0, 0.0, -1e30
    bad_err, bad_ok, bad_used = sp_error(
        fd.flash_decode_combine(a, l, m, torch.bfloat16), want, lim)
    print(f"flash decode at kv_len {t}: max_abs_err={err:.3e} (tol 2^-7 "
          f"max|out| + 2^-8 sum_j (p_j/l)|v_j|, largest share used "
          f"{used:.3f}) ok={ok}; planted fault (split {drop} of {p.splits} "
          f"dropped): max_abs_err={bad_err:.3e}, share {bad_used:.3f}, "
          f"refused={not bad_ok} [{card}]", flush=True)
    check(ok and not bad_ok, f"flash decode at kv_len {t}: max abs err "
                             f"{err}, planted fault refused {not bad_ok}")
    del a, l, m, lim
    qs, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kt, vt, enable_gqa=True))
    cases = [
        ("flash_decode_partial[dense, kv_len 32k]", "partial", 280,
         lambda: fd.flash_decode_partial(q, k, v, t, p.split_len, p.splits),
         lambda: fd.flash_decode_partials_reference(q, k, v, t, p.split_len,
                                                    p.splits),
         (q_bytes + kv_bytes + part_bytes) / HBM_BYTES_PER_S * 1e3, lib_ms),
        ("flash_decode_combine[kv_len 32k]", "combine", 218,
         lambda: fd.flash_decode_combine(*parts, torch.bfloat16),
         lambda: fd.flash_decode_combine_reference(*parts, torch.bfloat16),
         (part_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3, None)]
    out = []
    for name, counter, line, kernel, plain, bnd, lib in cases:
        ms = device_ms(torch, kernel)
        plain_ms = device_ms(torch, plain)
        print(f"{name}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd:.4f} (bytes) library_ms="
              f"{'%.4f' % lib if lib else None} splits={p.splits} "
              f"[{card}]", flush=True)
        out.append(({
            "name": name, "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/flash_decode.cu",
            "replaces": f"triton_dist_tpu/ops/flash_decode.py:{line}",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": "bytes",
            "library_ms": lib, "wall_ms": wall_ms(torch, kernel),
            "shape": [1, hq, hkv, d, t], "ok": ok},
            f"flash_decode_{counter}", None))
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
    lib_ms = device_ms(torch, lambda: out.copy_(x()[0]))
    AR, RS = ar.AllReduceMethod, rs.ReduceScatterMethod
    cases = [
        ("all_reduce[one_shot]", "all_reduce", AR.ONE_SHOT, "allreduce.py:114",
         lambda: ar.all_reduce(x(), ar.create_allreduce_context(
             method=AR.ONE_SHOT)), lambda: ar.all_reduce_reference(x())),
        ("all_reduce[recursive_doubling]", "all_reduce",
         AR.RECURSIVE_DOUBLING, "allreduce.py:158",
         lambda: ar.all_reduce(x(), ar.create_allreduce_context(
             method=AR.RECURSIVE_DOUBLING)),
         lambda: ar.all_reduce_reference(x())),
        ("all_reduce[two_shot]", "all_reduce", AR.TWO_SHOT, "allreduce.py:193",
         lambda: ar.all_reduce(x(), ar.create_allreduce_context(
             method=AR.TWO_SHOT)), lambda: ar.all_reduce_reference(x())),
        ("reduce_scatter[ring]", "reduce_scatter", RS.RING,
         "reduce_scatter.py:92",
         lambda: rs.reduce_scatter(x(), rs.create_reduce_scatter_context(
             method=RS.RING)), lambda: rs.reduce_scatter_reference(x())),
        ("reduce_scatter[one_shot]", "reduce_scatter", RS.ONE_SHOT,
         "reduce_scatter.py:150",
         lambda: rs.reduce_scatter(x(), rs.create_reduce_scatter_context(
             method=RS.ONE_SHOT)), lambda: rs.reduce_scatter_reference(x())),
        ("broadcast", "broadcast", None, "allgather.py:218",
         lambda: agk.broadcast(x()[0]),
         lambda: agk.broadcast_reference(x()[0]))]
    records = []
    for name, counter, method, replaces, kernel, plain in cases:
        ms = device_ms(torch, kernel)
        plain_ms = device_ms(torch, plain)
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
    counter) or the sp_attention record's own."""
    out = []
    for rec, counter, method in records:
        counts = launches[counter]
        if method is None:
            n = sum(counts.values())
        else:
            n = sum(c for key, c in counts.items() if key[0] == method.value)
        rec = dict(rec, launches=n)
        check(n > 0, f"{rec['name']} never launched on the sp path")
        out.append(rec)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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

    phase_kernel(torch, ops, card)
    cfg, model, params, eng, prompts, base = phase_model(torch, models, ops,
                                                         card, args.seed)
    phase_server(torch, eng, params, prompts, card)
    main_launches = dict(ops.launches.by_shape)    # ---- main path ends
    print(f"main path gemm_ar launches: {ops.launches.total} "
          f"by (K, N): {main_launches}", flush=True)
    phase_logits(torch, ops, model, params, prompts, cfg, card)
    phase_flash_kernels(torch, fd, card)
    engines, square, stream, fd_launches = phase_sp_main(
        torch, models, ops, fd, cfg, params, card, args.seed)
    phase_sp_checks(torch, fd, engines, params, square, stream, card)
    del engines
    ag_records = phase_ag_kernels(torch, ag, ops, params, cfg, card)
    ag_engines, ag_launches = phase_ag_rs_main(torch, models, ag, ops, ops,
                                               cfg, params, base, card)
    phase_ag_checks(torch, ag, ag_engines, params, base[0], cfg, card)
    del ag_engines
    # The dense kernels' records read the Qwen3-8B weights: before they go.
    kernels = phase_kernels_line(torch, ops, params, cfg, main_launches)
    kernels += phase_fd_kernels_line(torch, fd, fd_launches)
    kernels += ag_kernels_line(ag_records, ag_launches)
    del cfg, model, params, eng, prompts, base
    gc.collect()
    torch.cuda.empty_cache()
    print(f"Qwen3-8B released: device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    cfg = models.presets.qwen3_8b()
    sp_record, full = phase_sp_attn_kernels(torch, sp, cfg, card)
    sp_launches = phase_sp_attn_main(torch, layers, sp, fd, agk, ar, rs, cfg,
                                     full, card)
    del full
    records = [(sp_record, "sp_attention", None)]
    records += sp_fd_records(torch, sp, fd, cfg, card)
    records += coll_records(torch, agk, ar, rs, card)
    kernels += sp_kernels_line(records, sp_launches)
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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
