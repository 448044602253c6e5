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

Phases 7-9 run between phases 5 and 6; the JSON line covers both slices.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card
the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
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
    return cfg, model, params, eng, prompts


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
    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as ops

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
    cfg, model, params, eng, prompts = phase_model(torch, models, ops, card,
                                                   args.seed)
    phase_server(torch, eng, params, prompts, card)
    main_launches = dict(ops.launches.by_shape)    # ---- main path ends
    print(f"main path gemm_ar launches: {ops.launches.total} "
          f"by (K, N): {main_launches}", flush=True)
    phase_logits(torch, ops, model, params, prompts, cfg, card)
    phase_flash_kernels(torch, fd, card)
    engines, square, stream, fd_launches = phase_sp_main(
        torch, models, ops, fd, cfg, params, card, args.seed)
    phase_sp_checks(torch, fd, engines, params, square, stream, card)
    kernels = phase_kernels_line(torch, ops, params, cfg, main_launches)
    kernels += phase_fd_kernels_line(torch, fd, fd_launches)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
