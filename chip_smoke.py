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
6. kernels: one JSON line with each kernel's launches on the main path
   (phases 3-4), error, time, plain time, bound and library time. Times
   (``ms``, ``plain_ms``, ``library_ms``) are device time from the
   profiler; ``wall_ms`` is the kernel's time per call when called back to
   back, host overhead included.

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
    kernels = phase_kernels_line(torch, ops, params, cfg, main_launches)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
