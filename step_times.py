"""One decode step of full-depth Qwen3-30B-A3B at world 4, through the EP
all-to-all (mode "xla") and through TP MoE's world-W all-gather (mode
"gemm_ar"): wall (median of 7), device time and kernels a step from a
profiler session that recorded every port launch (retried up to 8 times,
``chip_smoke.port_session``), and the exchange kernel's share, with the
card's name and power limit on every line.

A script beside ``chip_smoke.py``, whose helpers it uses. It imports
``chip_smoke`` and ``triton_dist_tpu_torch`` from the working directory,
so the same file times any checkout: to compare two commits in one call,
unpack the parent into a git-ignored directory and run parent, change,
change, parent on the card, e.g.::

    python step_times.py change
    (cd parent && python ../step_times.py parent)
"""

from __future__ import annotations

import os
import sys
import time

#: (what, model options, prefill mode, step mode, exchange kernel name).
STEPS = (("EP decode step", {"fwd_mode": "xla", "moe_parallel": "ep",
                             "world": 4}, "xla", "xla", "a2a_kernel"),
         ("TP-MoE gemm_ar decode step", {"world": 4}, "ag_rs", "gemm_ar",
          "gather_world"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("step_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())          # the checkout being timed
    import chip_smoke as cs
    from triton_dist_tpu_torch import models
    from triton_dist_tpu_torch.models import KVCacheManager
    from triton_dist_tpu_torch.ops import _build

    label = sys.argv[1] if sys.argv[1:] else "tree"
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[{label}] build {time.perf_counter() - t0:.1f} s", flush=True)
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
        for _ in range(cs.PROFILER_SESSIONS):
            events, recorded, counted = cs.port_session(torch, step, 3)
            if recorded >= counted:
                break
        dev = sum(e.self_device_time_total for e in events) / 3 / 1e3
        ex = sum(e.self_device_time_total for e in events
                 if exchange in e.key) / 3 / 1e3
        kernels = sum(e.count for e in events) / 3
        print(f"[{label}] {what}: wall {walls[3]:.2f} ms (median of 7), "
              f"device {'' if recorded >= counted else '>= '}{dev:.3f} ms, "
              f"{kernels:.0f} kernels a step ({recorded} of {counted} port "
              f"launches recorded over 3 steps), {exchange} {ex:.3f} ms "
              f"[{card}]", flush=True)
        del model, kv
    return 0


if __name__ == "__main__":
    sys.exit(main())
