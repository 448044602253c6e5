"""Step and kernel times of whatever checkout is the working directory, with
the card's name and power limit on every line. Groups:

* ``moe``: one decode step of full-depth Qwen3-30B-A3B at world 4, through
  the EP all-to-all (mode "xla") and through TP MoE's world-W all-gather
  (mode "gemm_ar"), and the exchange kernel's share;
* ``dense``: the prefill (4 x 128 prompts) of full-depth Qwen3-8B in mode
  "ag_rs", the reference engine's at world 1 and the fused engine's at TP
  world 4, and the share of the prefill tile kernels (``tiles.cuh``'s body:
  the world-1 kernel and the two rings);
* ``tiles``: the eight prefill products of those prefills alone, QKV,
  SwiGLU, o_proj and down at world 1 (the 36 layers' weights in turn, so B
  is cold in L2, as ``chip_smoke.py``'s phase 10) and through the W = 4
  rings (layer 0's weights, as phase 17), by ``chip_smoke.queued_ms``,
  beside one ``torch.matmul`` of the same product.
* ``sp``: the flash prefill (``csrc/sp_attention.cu``) at Qwen3-8B's
  attention width (32 / 8 heads, D 128, bf16, causal): the 32k prompt at
  world 1 and through the W = 4 ring, and phase 14's B 4 x 4096, full 4096
  and G 8 4096 cases, by CUDA events around back-to-back calls
  (``chip_smoke.wall_ms``, as phases 14 and 21 time them), each with its
  TFLOP/s; the 32k case beside one masked SDPA call.

Steps give wall (median of 7), device time and kernels a step from a
profiler session that recorded every port launch (retried up to 8 times,
``chip_smoke.port_session``; a lower bound, marked ">= ", when none did).

A script beside ``chip_smoke.py``, whose helpers it uses. It imports
``chip_smoke`` and ``triton_dist_tpu_torch`` from the working directory,
so the same file times any checkout: to compare two commits in one call,
unpack the parent into a git-ignored directory and run parent, change,
change, parent on the card, e.g.::

    python step_times.py change dense tiles
    (cd parent && python ../step_times.py parent dense tiles)

With no group named it runs all four.
"""

from __future__ import annotations

import os
import re
import sys
import time

GROUPS = ("dense", "tiles", "moe", "sp")
#: (what, model options, prefill mode, step mode, exchange kernel name).
STEPS = (("EP decode step", {"fwd_mode": "xla", "moe_parallel": "ep",
                             "world": 4}, "xla", "xla", "a2a_kernel"),
         ("TP-MoE gemm_ar decode step", {"world": 4}, "ag_rs", "gemm_ar",
          "gather_world"))
#: The prefill tile kernels by name, before and after the wgmma tile.
TILE_KERNELS = re.compile(r"tile_(mma|wg)<|ring_(wg_)?kernel")


def device_time(torch, cs, fn, pattern):
    """(device ms of one fn() call, its kernels, the ms of the kernels whose
    names match ``pattern``, the prefix ">= " when no session recorded
    every port launch, the session's record counts)."""
    for _ in range(cs.PROFILER_SESSIONS):
        events, recorded, counted = cs.port_session(torch, fn, 3)
        if recorded >= counted:
            break
    dev = sum(e.self_device_time_total for e in events) / 3 / 1e3
    part = sum(e.self_device_time_total for e in events
               if pattern.search(e.key)) / 3 / 1e3
    kernels = sum(e.count for e in events) / 3
    return (dev, kernels, part, "" if recorded >= counted else ">= ",
            f"{recorded} of {counted} port launches recorded over 3 calls")


def dense_prefills(torch, cs, models, cfg, params, label, card):
    from triton_dist_tpu_torch.models import KVCacheManager
    ids = torch.randint(0, cfg.vocab_size, (4, 128),
                        generator=torch.Generator().manual_seed(10)).cuda()
    for what, world in (("Qwen3-8B ag_rs prefill, reference engine, world "
                         "1", 1), ("Qwen3-8B ag_rs prefill, fused engine, TP "
                                   "world 4", 4)):
        model = models.AutoLLM.build(cfg, world=world)

        def prefill():
            kv = KVCacheManager(cfg.num_hidden_layers, 4, 256,
                                cfg.num_key_value_heads, cfg.head_dim,
                                dtype=cfg.dtype, device="cuda",
                                world=world).init()
            with torch.no_grad():
                return model.forward(params, ids, kv, 0, mode="ag_rs")[0]
        walls = sorted(cs.sync_time(torch, prefill)[1] for _ in range(7))
        dev, kernels, tiles, ge, rec = device_time(torch, cs, prefill,
                                                   TILE_KERNELS)
        print(f"[{label}] {what}: wall {walls[3]:.2f} ms (median of 7), "
              f"device {ge}{dev:.3f} ms, {kernels:.0f} kernels a prefill "
              f"({rec}), prefill tile kernels {ge}{tiles:.3f} ms [{card}]",
              flush=True)
        del model


def tile_rows(torch, cs, cfg, params, label, card):
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    gen = torch.Generator(device="cuda").manual_seed(3)
    layers = params["layers"]
    world, m = 4, 512

    def weights(*keys):
        return [[lp[a][b] for a, b in keys] for lp in layers]
    sets = {"qkv": weights(("attn", "w_q"), ("attn", "w_k"), ("attn", "w_v")),
            "swiglu": weights(("mlp", "w_gate"), ("mlp", "w_up")),
            "o_proj": weights(("attn", "w_o")),
            "down": weights(("mlp", "w_down"))}
    group = create_rank_group(world, device="cuda")
    ag_ctx = ag.AllGatherGEMMContext(group, ring_dirs=2)
    rs_ctx = rs.GEMMReduceScatterContext(group, ring_dirs=2)
    for name, ws in sets.items():
        k = ws[0][0].shape[0]
        a = torch.randn((m, k), generator=gen, device="cuda").to(cfg.dtype)
        nxt = cs.rotating(ws)
        cat = torch.cat(ws[0], dim=1)
        flops = 2.0 * m * k * cat.shape[1]
        if name == "qkv":
            def w1():
                return ag.ag_gemm_multi(a, nxt())

            def ring():
                return ag.launch_ag_ring("gemm", a, ws[0], ag_ctx)
        elif name == "swiglu":
            def w1():
                g, u = nxt()
                return ag.launch_swiglu(a, g, u, None, None)

            def ring():
                return ag.launch_ag_ring("swiglu", a, ws[0], ag_ctx)
        else:
            n = ws[0][0].shape[1]
            plan = rs.ring_plan(m, k // world, n, a.element_size(), world, 2,
                                False)

            def w1():
                return rs.gemm_rs(a, nxt()[0])

            def ring():
                return rs.launch_ring(a, ws[0][0], rs_ctx, plan.split, False)
        lib = cs.queued_ms(torch, lambda: torch.matmul(a, cat))
        for where, fn in (("world 1", w1), (f"ring W={world}", ring)):
            ms = cs.queued_ms(torch, fn)
            print(f"[{label}] prefill tile {name} M={m} K={k} N={cat.shape[1]}"
                  f" {where}: {ms:.5f} ms ({flops / ms / 1e9:.0f} TFLOP/s), "
                  f"torch.matmul {lib:.5f} ms [{card}]", flush=True)


def sp_rows(torch, cs, label, card):
    import torch.nn.functional as F

    from triton_dist_tpu_torch.ops import sp_attention as sp
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    hq, d = 32, 128
    rows = (("32k world 1", 1, cs.SP_S, 8, True, 1),
            ("32k ring W=4", 1, cs.SP_S, 8, True, 4),
            ("B=4 S=4096", 4, 4096, 8, True, 1),
            ("full S=4096", 1, 4096, 8, False, 1),
            ("G=8 S=4096", 1, 4096, 4, True, 1))
    for what, b, s, hkv, causal, world in rows:
        q, k, v = cs.sp_operands(torch, torch.bfloat16, b, s, hq, hkv, d,
                                 seed=40)
        if world == 1:
            def fn():
                return sp.launch_sp_attention(q, k, v, causal)
        else:
            ctx = sp.create_sp_attention_context(
                causal=causal, group=create_rank_group(world, "sp", "cuda"))

            def fn():
                return sp.launch_sp_ring_attention(q, k, v, ctx)
        ms = cs.wall_ms(torch, fn, n=5 if s > 4096 else 20)
        flops = 4.0 * b * hq * d * (s * (s + 1) / 2 if causal else s * s)
        bound = cs.sp_bound_ms(b, s, hq, hkv, d, 2, "bf16", causal)[0]
        extra = ""
        if s > 4096 and world == 1:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = cs.wall_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), n=5)
            extra = (f", SDPA {lib:.3f} ms ({flops / lib / 1e9:.0f} "
                     f"TFLOP/s)")
            del qt, kt, vt
        print(f"[{label}] flash prefill {what} B={b} S={s} heads {hq}/{hkv} "
              f"D={d} causal={causal}: {ms:.3f} ms ({flops / ms / 1e9:.0f} "
              f"TFLOP/s, {flops / ms / 1e9 / 989:.3f} of 989), bound "
              f"{bound:.3f} ms{extra} [{card}]", flush=True)
        del q, k, v


def moe_steps(torch, cs, models, label, card):
    from triton_dist_tpu_torch.models import KVCacheManager
    cfg = models.presets.qwen3_30b_a3b()
    params = models.AutoLLM.build(cfg, sp_axis="sp").init(0)
    ids = torch.randint(0, cfg.vocab_size, (4, 128),
                        generator=torch.Generator().manual_seed(10)).cuda()
    for what, options, pre_mode, step_mode, exchange in STEPS:
        model = models.AutoLLM.build(cfg, **options)
        kv = KVCacheManager(cfg.num_hidden_layers, 4, 256,
                            cfg.num_key_value_heads, cfg.head_dim,
                            dtype=cfg.dtype, device="cuda", world=4).init()
        with torch.no_grad():
            model.forward(params, ids, kv, 0, mode=pre_mode)

        def step():
            with torch.no_grad():
                return model.forward(params, ids[:, :1], kv, 128,
                                     mode=step_mode)[0]
        walls = sorted(cs.sync_time(torch, step)[1] for _ in range(7))
        dev, kernels, ex, ge, rec = device_time(torch, cs, step,
                                                re.compile(exchange))
        print(f"[{label}] {what}: wall {walls[3]:.2f} ms (median of 7), "
              f"device {ge}{dev:.3f} ms, {kernels:.0f} kernels a step "
              f"({rec}), {exchange} {ex:.3f} ms [{card}]", flush=True)
        del model, kv


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("step_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())          # the checkout being timed
    import chip_smoke as cs
    from triton_dist_tpu_torch import models
    from triton_dist_tpu_torch.ops import _build

    label = sys.argv[1] if sys.argv[1:] else "tree"
    groups = [g for g in sys.argv[2:] if g in GROUPS] or list(GROUPS)
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    _build.build_all(["sp_attention"] if groups == ["sp"] else None)
    print(f"[{label}] build {time.perf_counter() - t0:.1f} s", flush=True)
    if "dense" in groups or "tiles" in groups:
        cfg = models.presets.qwen3_8b()
        params = models.DenseLLM(cfg).init(0)
        if "dense" in groups:
            dense_prefills(torch, cs, models, cfg, params, label, card)
        if "tiles" in groups:
            tile_rows(torch, cs, cfg, params, label, card)
        del params
        torch.cuda.empty_cache()
    if "sp" in groups:
        sp_rows(torch, cs, label, card)
    if "moe" in groups:
        moe_steps(torch, cs, models, label, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
