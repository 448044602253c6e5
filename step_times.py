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
* ``grouped``: the grouped products of full-depth Qwen3-30B-A3B (bf16, 128
  experts, top-8) by ``chip_smoke.queued_ms``, the 48 layers' weights in
  turn (cold in L2, as ``chip_smoke.py``'s phase 12): at world 1 gate|up,
  SwiGLU, down and the MoE-reduce (pairs rounded and f32) at decode (4
  tokens, 32 pairs) and prefill (512 tokens, 4096 pairs), each beside its
  bound and one ``torch._grouped_mm`` of the same products; the W = 4
  rings ``ag_group_gemm(impl="fused")`` (gate) and
  ``moe_reduce_rs(impl="fused")`` at both shapes beside their bounds; and
  the world-1 ag_rs prefill (4 x 128 prompts) with the grouped kernels'
  share of its device time.
* ``decode``: the bf16 decode products (M = 4) of full-depth Qwen3-8B on
  the decode body (``csrc/stream.cuh``), the 36 layers' weights in turn
  (B cold in L2, as ``chip_smoke.py``'s phases 6 and 10), by
  ``chip_smoke.queued_ms``, each beside its bound, one ``torch.matmul`` of
  the same product and its plan: at world 1 gemm_ar o_proj and down,
  ag_gemm QKV and gate|up, gemm_rs down; through the W = 4 rings GEMM-AR /
  GEMM-RS o_proj and down and AG-GEMM QKV and gate|up; then one decode
  step (batch 4 after a 128-token prefill) of the gemm_ar engine (decode
  mode "gemm_ar") and of the fused engine (mode "ag_rs").
* ``collectives``: the world-1 copy (``tdt_copy``) under TP-MoE's
  all-gather at (4, 2048) and (512, 2048) and the one-shot all-reduce at
  (1, 512, 4096), bf16, each call on the next of copies that hold 128
  MiB, beside ``Tensor.copy_`` and the bound, once back to back and once
  each call behind the work ahead of it on its path (TP-MoE's router for
  the all-gather, one elementwise kernel for the all-reduce), the copy's
  time there being the pair's less that work's; then the world-W exchanges
  at W = 4 on Qwen3-8B's widths
  (bf16), by ``chip_smoke.queued_ms``, each beside its bound, one library
  call of the same function and the node types one call queues (a CUDA
  graph captured from it): ``all_reduce`` (one-shot, two-shot, recursive
  doubling) and ``reduce_scatter`` (ring, one-shot) on (4, M, 4096)
  partials at decode (M = 4) and prefill (M = 512), each call on the next
  of 8 inputs, as ``chip_smoke.py``'s phase 26; ``pp_shift`` on the decode
  (16, 4096) and prefill (2048, 4096) hops and ``symm_ship`` on one KV
  block (4,718,592 bytes), as phase 27, each call on the next of copies
  that hold 128 MiB together. So every prefill-sized input is read from
  HBM, not from the 50 MB L2. It builds only ``allgather``,
  ``reduce_world`` and ``p2p``.
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

With no group named it runs all seven.
"""

from __future__ import annotations

import os
import re
import sys
import time

GROUPS = ("dense", "tiles", "moe", "sp", "grouped", "decode", "collectives")
#: (what, model options, prefill mode, step mode, exchange kernel name).
STEPS = (("EP decode step", {"fwd_mode": "xla", "moe_parallel": "ep",
                             "world": 4}, "xla", "xla", "a2a_kernel"),
         ("TP-MoE gemm_ar decode step", {"world": 4}, "ag_rs", "gemm_ar",
          "gather_world"))
#: The prefill tile kernels by name, before and after the wgmma tile.
TILE_KERNELS = re.compile(r"tile_(mma|wg)<|ring_(wg_)?kernel")
#: The decode products' kernels by name, before and after the cluster
#: body: the tensor-core kernel, its split reduce, the FMA kernel.
DECODE_KERNELS = re.compile(r"stream_(mma|tc)<|splitk_reduce|gemm_ar_partial")
#: The world-1 grouped kernels by name, before and after the wgmma body:
#: the products, the expert schedule and the MoE-reduce's top-k sum.
GROUPED_KERNELS = re.compile(r"group_(mma|wg|fma|schedule)|topk_reduce_rows")


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


def decode_rows(torch, cs, models, cfg, params, label, card):
    from triton_dist_tpu_torch.models import KVCacheManager
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    gen = torch.Generator(device="cuda").manual_seed(22)
    layers = params["layers"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    world, m = 4, 4

    def weights(*keys):
        return [[lp[a][b] for a, b in keys] for lp in layers]
    sets = {"o_proj": weights(("attn", "w_o")),
            "down": weights(("mlp", "w_down")),
            "qkv": weights(("attn", "w_q"), ("attn", "w_k"), ("attn", "w_v")),
            "gate|up": weights(("mlp", "w_gate"), ("mlp", "w_up"))}
    group = create_rank_group(world, device="cuda")
    ag_ctx = ag.AllGatherGEMMContext(group, ring_dirs=2)
    rs_ctx = rs.GEMMReduceScatterContext(group, ring_dirs=2)
    for name, ws in sets.items():
        k = ws[0][0].shape[0]
        widths = tuple(w.shape[1] for w in ws[0])
        a = torch.randn((m, k), generator=gen, device="cuda").to(cfg.dtype)
        cats = [torch.cat(w, dim=1) for w in ws[:4]]
        lib = cs.queued_ms(torch, lambda nl=cs.rotating(cats):
                           torch.matmul(a, nl()))
        bnd = cs.gemm_bound_ms(m, k, widths)[0]
        # A checkout older than the cluster body has no plan mirror.
        plan = (cs.decode_plan_text(ag, m, widths, k, cfg.dtype, sms)
                if hasattr(ag, "stream_plan") else "the checkout's plan")
        rows = []
        if len(widths) == 1:
            n = widths[0]
            rows += [("gemm_ar world 1", lambda nx=cs.rotating(ws):
                      rs.gemm_ar(a, nx()[0])),
                     ("gemm_rs world 1", lambda nx=cs.rotating(ws):
                      rs.gemm_rs(a, nx()[0]))]
            for op, ar in (("GEMM-AR", True), ("GEMM-RS", False)):
                split = rs.ring_plan(m, k // world, n, 2, world, 2, ar).split
                rows.append((f"{op} ring W={world}",
                             lambda nx=cs.rotating(ws), s=split, ar=ar:
                             rs.launch_ring(a, nx()[0], rs_ctx, s, ar)))
        else:
            rows += [("ag_gemm world 1", lambda nx=cs.rotating(ws):
                      ag.ag_gemm_multi(a, nx())),
                     (f"AG-GEMM ring W={world}", lambda nx=cs.rotating(ws):
                      ag.launch_ag_ring("gemm", a, nx(), ag_ctx))]
        for where, fn in rows:
            ms = cs.queued_ms(torch, fn)
            ring = "ring" in where
            b = (cs.ring_bound_ms({"GEMM-AR": "ar", "GEMM-RS": "rs"}.get(
                where.split()[0], "gemm"), m, k, widths, world, 2)[0]
                 if ring else bnd)
            print(f"[{label}] decode {name} M={m} K={k} "
                  f"N={'|'.join(map(str, widths))} {where}: {ms:.5f} ms, "
                  f"bound {b:.5f}, {ms / b:.2f}x bound, torch.matmul "
                  f"{lib:.5f} ({ms / lib:.2f}x)"
                  f"{'' if ring else f'; {plan}'} [{card}]", flush=True)
        del cats
    del ag_ctx, rs_ctx
    ids = torch.randint(0, cfg.vocab_size, (4, 128),
                        generator=torch.Generator().manual_seed(10)).cuda()
    model = models.DenseLLM(cfg)
    for what, mode in (("gemm_ar engine", "gemm_ar"),
                       ("fused engine", "ag_rs")):
        kv = KVCacheManager(cfg.num_hidden_layers, 4, 256,
                            cfg.num_key_value_heads, cfg.head_dim,
                            dtype=cfg.dtype, device="cuda").init()
        with torch.no_grad():
            model.forward(params, ids, kv, 0, mode="ag_rs")

        def step():
            with torch.no_grad():
                return model.forward(params, ids[:, :1], kv, 128,
                                     mode=mode)[0]
        walls = sorted(cs.sync_time(torch, step)[1] for _ in range(7))
        dev, kernels, part, ge, rec = device_time(torch, cs, step,
                                                  DECODE_KERNELS)
        print(f"[{label}] Qwen3-8B {what} decode step (mode {mode}, batch "
              f"4): wall {walls[3]:.2f} ms (median of 7), device "
              f"{ge}{dev:.3f} ms, {kernels:.0f} kernels a step ({rec}), "
              f"decode GEMM kernels {ge}{part:.3f} ms [{card}]", flush=True)
        del kv


#: The world-W reduce's rows: (op, method).
REDUCE_ROWS = (("all_reduce", "one_shot"), ("all_reduce", "two_shot"),
               ("all_reduce", "recursive_doubling"),
               ("reduce_scatter", "ring"), ("reduce_scatter", "one_shot"))


#: Bytes the inputs of one hop row hold together: more than the L2.
HOP_BYTES = 128 << 20


def copy_cases(torch, cs, gen):
    """The world-1 copy rows of ``collectives`` (``csrc/allgather.cu``'s
    ``tdt_copy``), bf16: TP-MoE's all-gather of Qwen3-30B-A3B's decode (4,
    2048) and prefill (512, 2048) token rows and the one-shot all-reduce
    of one (1, 512, 4096) Qwen3-8B partial, each call on the next of
    copies that hold :data:`HOP_BYTES`, beside one ``Tensor.copy_`` of the
    same bytes into one output. ``before(t)`` is the work queued ahead of
    the copy in the ``behind`` rows: for the all-gather what precedes it
    in ``layers/tp_moe.py`` (the f32 router product over 128 experts and
    the top-8 routing), for the all-reduce one elementwise kernel over
    its input."""
    from triton_dist_tpu_torch.ops import allgather as agk
    from triton_dist_tpu_torch.ops import allreduce as ar
    from triton_dist_tpu_torch.ops.moe_utils import topk_routing
    cases = []
    one_shot = ar.create_allreduce_context(method=ar.AllReduceMethod.ONE_SHOT)
    w_router = torch.randn((2048, 128), generator=gen, device="cuda")
    for shape in ((4, 2048), (512, 2048), (1, 512, 4096)):
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        out = torch.empty_like(x)
        gather = len(shape) == 2
        cases.append(dict(
            name=f"{'all_gather' if gather else 'all_reduce one_shot'} W=1 "
                 f"{shape} bf16 (tdt_copy)",
            run=(agk.all_gather if gather else
                 (lambda t: ar.all_reduce(t, one_shot))),
            xs=[x] + [x.clone() for _ in
                      range(-(-HOP_BYTES // x.nbytes) - 1)],
            bound=cs.p2p_bound_ms(x),
            library=lambda t, out=out: out.copy_(t),
            lib_name="Tensor.copy_",
            before=((lambda t: topk_routing(t.float() @ w_router, 8))
                    if gather else (lambda t: t.mul(1.5))),
            before_name="the router" if gather else "one mul"))
    return cases


def behind_row(torch, cs, c, label, card):
    """One copy row queued behind ``c["before"]`` on the same input: the
    copy's time is the pair's less ``before``'s alone, for the kernel and
    for ``Tensor.copy_``, so the kernel that runs ahead of the copy is not
    another copy."""
    nx = cs.rotating(c["xs"])
    n = 50

    def pair(copy):
        t = nx()
        c["before"](t)
        copy(t)
    alone = cs.queued_ms(torch, lambda: c["before"](nx()), n=n)
    ms = cs.queued_ms(torch, lambda: pair(c["run"]), n=n) - alone
    lib = cs.queued_ms(torch, lambda: pair(c["library"]), n=n) - alone
    print(f"[{label}] {c['name']} behind {c['before_name']} "
          f"({alone:.5f} ms alone): {ms:.5f} ms, {c['lib_name']} "
          f"{lib:.5f} ({ms / lib:.2f}x) [{card}]", flush=True)


def collective_cases(torch, cs):
    """The W = 4 rows of ``collectives``, bf16 on Qwen3-8B's widths: dicts
    of the row's name, ``run(x)`` (the entry on one input; every copy of
    the all-reduce), its inputs (8 partials for a reduce, copies that hold
    :data:`HOP_BYTES` for a hop, so each timed call takes the next), the
    bound in ms and ``library(x)`` (one ``torch.sum`` / ``torch.roll`` of
    the same function)."""
    from triton_dist_tpu_torch.ops import allreduce as ar
    from triton_dist_tpu_torch.ops import p2p
    from triton_dist_tpu_torch.ops import reduce_scatter as rs
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    from triton_dist_tpu_torch.serving import kv_stream as ks
    world, n = 4, 4096
    group = create_rank_group(world, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(23)
    cases = copy_cases(torch, cs, gen)
    for name, m in (("decode", 4), ("prefill", 512)):
        xs = [torch.randn((world, m, n), generator=gen, device="cuda")
              .mul(4.0 ** torch.arange(world, device="cuda")[:, None, None])
              .bfloat16() for _ in range(8)]
        for op, method in REDUCE_ROWS:
            if op == "all_reduce":
                ctx = ar.create_allreduce_context(
                    method=ar.AllReduceMethod(method), group=group)
                run = (lambda x, ctx=ctx:
                       ar.all_reduce(x, ctx, stacked=True))
            else:
                ctx = rs.create_reduce_scatter_context(
                    method=rs.ReduceScatterMethod(method), group=group)
                run = (lambda x, ctx=ctx: rs.reduce_scatter(x, ctx))
            cases.append(dict(
                name=f"{op} {method} W={world} {name} ({world}, {m}, {n}) "
                     f"bf16", run=run, xs=xs,
                bound=cs.arw_bound_ms(op, world, m, n, 2),
                library=lambda x: torch.sum(x, 0), lib_name="torch.sum"))
    ctx = p2p.create_p2p_context(create_rank_group(world, "pp",
                                                   device="cuda"))
    ship = create_rank_group(world, "tp", device="cuda")
    for name, x in (
            ("decode hop", torch.randn((world * 4, n), generator=gen,
                                       device="cuda").bfloat16()),
            ("prefill hop", torch.randn((world * 512, n), generator=gen,
                                        device="cuda").bfloat16()),
            ("KV block", torch.randint(0, 255, (36 * 2 * 16 * 8 * 128 * 4,),
                                       generator=gen, device="cuda",
                                       dtype=torch.uint8))):
        ship_it = name == "KV block"
        cases.append(dict(
            name=f"{'symm_ship' if ship_it else 'pp_shift'} {name} W={world} "
                 f"{tuple(x.shape)} {str(x.dtype).removeprefix('torch.')}",
            run=((lambda t: ks.symm_ship(t, ship, delta=1)) if ship_it
                 else (lambda t: p2p.pp_shift(t, ctx, delta=1))),
            xs=[x] + [x.clone() for _ in
                      range(-(-HOP_BYTES // x.nbytes) - 1)],
            bound=cs.p2p_bound_ms(x),
            library=lambda t: torch.roll(t.view(world, -1), 1, 0),
            lib_name="torch.roll"))
    return cases


def collective_rows(torch, cs, label, card):
    from triton_dist_tpu_torch.tools.queued import queued_work
    for c in collective_cases(torch, cs):
        nx = cs.rotating(c["xs"])
        ms = cs.queued_ms(torch, lambda: c["run"](nx()))
        lib = cs.queued_ms(torch, lambda: c["library"](nx()))
        nodes = dict(queued_work(lambda: c["run"](c["xs"][0])))
        print(f"[{label}] {c['name']}: {ms:.5f} ms, bound {c['bound']:.5f} "
              f"({ms / c['bound']:.1f}x), {c['lib_name']} {lib:.5f} "
              f"({ms / lib:.2f}x); a call queues {nodes} [{card}]",
              flush=True)
        if "before" in c:
            behind_row(torch, cs, c, label, card)


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


def grouped_rows(torch, cs, models, label, card):
    from triton_dist_tpu_torch.models import KVCacheManager
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.ops.moe_utils import topk_routing
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    cfg = models.presets.qwen3_30b_a3b()
    model = models.AutoLLM.build(cfg)
    params = model.init(0)
    e, topk = cfg.num_experts, cfg.num_experts_per_tok
    h, inter = cfg.hidden_size, cfg.moe_intermediate_size
    moe = [lp["moe"] for lp in params["layers"]]
    gate_up = [[lp["w_gate"], lp["w_up"]] for lp in moe]
    downs = [lp["w_down"] for lp in moe]
    gates = [lp["w_gate"] for lp in moe]
    cat_gu = [torch.cat(gu, dim=2) for gu in gate_up[:2]]
    gen = torch.Generator(device="cuda").manual_seed(4)
    world = 4
    group = create_rank_group(world, device="cuda")

    def library(a_rows, ids, ws):
        order = torch.argsort(ids.long(), stable=True)
        a_sorted = a_rows[order].contiguous()
        offs = torch.cumsum(torch.bincount(ids.long(), minlength=e), 0).to(
            torch.int32)
        nl = cs.rotating(ws)
        return cs.queued_ms(torch, lambda: torch._grouped_mm(
            a_sorted, nl(), offs=offs))

    for m in (cs.MOE_DECODE_M, cs.MOE_PREFILL_M):
        p = m * topk
        x = torch.randn((m, h), generator=gen, device="cuda").to(cfg.dtype)
        w, idx = topk_routing(x.float() @ moe[0]["w_router"], topk)
        ids = idx.reshape(-1)
        live = int(torch.unique(ids).numel())
        pairs_x = x.repeat_interleave(topk, 0)
        act = torch.randn((p, inter), generator=gen, device="cuda").to(
            cfg.dtype)
        ctx = mrs.create_moe_rs_context(num_experts=e, topk=topk)
        rows = (
            ("gate|up", lambda ws: gg.grouped_matmul_multi(x, ws, ids, e,
                                                           topk), gate_up,
             cs.grouped_bound_ms(live, m, p, h, inter, 2, p),
             library(pairs_x, ids, cat_gu)),
            ("SwiGLU", lambda ws: gg.grouped_swiglu(x, ws[0], ws[1], ids, e,
                                                    topk), gate_up,
             cs.grouped_bound_ms(live, m, p, h, inter, 2, p // 2),
             library(pairs_x, ids, cat_gu)),
            ("down", lambda ws: gg.grouped_matmul(act, ws, ids, e), downs,
             cs.grouped_bound_ms(live, p, p, inter, h, 1, p),
             library(act, ids, downs[:4])),
            ("moe_rs rounded", lambda ws: mrs.moe_reduce_rs(
                act, ws, ids, w, ctx, "ring"), downs,
             cs.grouped_bound_ms(live, p, p, inter, h, 1, m,
                                 extra_bytes=p * 4),
             library(act, ids, downs[:4])),
            ("moe_rs f32", lambda ws: mrs.moe_reduce_rs(
                act, ws, ids, w, ctx, "fused"), downs,
             cs.grouped_bound_ms(live, p, p, inter, h, 1, m,
                                 extra_bytes=p * 4),
             library(act, ids, downs[:4])))
        for name, fn, sets, (bnd, by), lib in rows:
            nxt = cs.rotating(sets)
            ms = cs.queued_ms(torch, lambda: fn(nxt()))
            print(f"[{label}] grouped {name} P={p} ({m} tokens, {live} live "
                  f"experts) world 1: {ms:.5f} ms, bound {bnd:.5f} ({by}), "
                  f"{ms / bnd:.2f}x bound, torch._grouped_mm {lib:.5f} "
                  f"({ms / lib:.2f}x) [{card}]", flush=True)
        agg_ctx = gg.create_ag_group_gemm_context(group=group)
        mrr_ctx = mrs.create_moe_rs_context(num_experts=e, topk=topk,
                                            world_size=world)
        nk, nd = cs.rotating(gates), cs.rotating(downs)
        for name, fn, (bnd, by) in (
                ("ag_group_gemm fused (gate)", lambda: gg.ag_group_gemm(
                    pairs_x, nk(), ids, e, agg_ctx, impl="fused"),
                 cs.agg_bound_ms(live, p, h, inter, world, 2)),
                ("moe_reduce_rs fused", lambda: mrs.moe_reduce_rs(
                    act, nd(), ids, w, mrr_ctx, impl="fused"),
                 cs.mrr_bound_ms(live, p, m, inter, h, world, 2))):
            ms = cs.queued_ms(torch, fn)
            print(f"[{label}] grouped ring {name} W={world} P={p} ({live} "
                  f"live experts): {ms:.5f} ms, bound {bnd:.5f} ({by}), "
                  f"{ms / bnd:.2f}x bound [{card}]", flush=True)
        del agg_ctx, mrr_ctx, ctx
    del cat_gu
    ids = torch.randint(0, cfg.vocab_size, (4, 128),
                        generator=torch.Generator().manual_seed(10)).cuda()

    def prefill():
        kv = KVCacheManager(cfg.num_hidden_layers, 4, 256,
                            cfg.num_key_value_heads, cfg.head_dim,
                            dtype=cfg.dtype, device="cuda").init()
        with torch.no_grad():
            return model.forward(params, ids, kv, 0, mode="ag_rs")[0]
    walls = sorted(cs.sync_time(torch, prefill)[1] for _ in range(5))
    dev, kernels, part, ge, rec = device_time(torch, cs, prefill,
                                              GROUPED_KERNELS)
    print(f"[{label}] Qwen3-30B-A3B ag_rs prefill world 1: wall "
          f"{walls[2]:.2f} ms (median of 5), device {ge}{dev:.3f} ms, "
          f"{kernels:.0f} kernels a prefill ({rec}), grouped kernels "
          f"{ge}{part:.3f} ms ({part / dev:.3f} of device) [{card}]",
          flush=True)
    del model, params


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
    only = {("sp",): ["sp_attention"],
            ("collectives",): ["allgather", "reduce_world", "p2p"]}
    _build.build_all(only.get(tuple(groups)))
    print(f"[{label}] build {time.perf_counter() - t0:.1f} s", flush=True)
    if {"dense", "tiles", "decode"} & set(groups):
        cfg = models.presets.qwen3_8b()
        params = models.DenseLLM(cfg).init(0)
        if "dense" in groups:
            dense_prefills(torch, cs, models, cfg, params, label, card)
        if "tiles" in groups:
            tile_rows(torch, cs, cfg, params, label, card)
        if "decode" in groups:
            decode_rows(torch, cs, models, cfg, params, label, card)
        del params
        torch.cuda.empty_cache()
    if "collectives" in groups:
        collective_rows(torch, cs, label, card)
    if "sp" in groups:
        sp_rows(torch, cs, label, card)
    if "grouped" in groups:
        grouped_rows(torch, cs, models, label, card)
        torch.cuda.empty_cache()
    if "moe" in groups:
        moe_steps(torch, cs, models, label, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
