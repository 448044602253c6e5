"""Parallelism planner (the port of ``triton_dist_tpu.parallel.plan``):
model config + card count -> a recommended layout.

The rules are JAX's (plan.py:36-153), on the port's
``ModelConfig.param_split``:

- **tp** divides BOTH the kv-head count and the MLP intermediate
  (gcd-based cap) and grows until the per-card parameter bytes fit in
  half the device memory;
- **ep** covers the expert dim when the config is MoE;
- **sp** takes the remaining factor when the serving context is long;
- anything left replicates as **dp**; cards that no legal factoring can
  use are reported in ``reasons`` rather than silently dropped.

Two divergences (ROADMAP.md, deliberate divergences): the default
``hbm_bytes`` is one H100's 80 GiB, where JAX's 16 GiB is a TPU v5e's;
and :meth:`Plan.groups` returns the plan's ``RankGroup`` s, one per axis
name, on one device, where JAX's ``Plan.mesh()`` returns a
``jax.sharding.Mesh`` over devices.

``python -m triton_dist_tpu_torch.parallel.plan --preset qwen3-8b
--chips 4`` prints the plan as JSON.
"""

from __future__ import annotations

import dataclasses
import math

from triton_dist_tpu_torch.runtime.dist import RankGroup

#: One H100's device memory.
H100_HBM_BYTES = 80 * 2 ** 30


@dataclasses.dataclass(frozen=True)
class Plan:
    """A recommended parallel layout over ``n_chips``."""
    tp: int = 1
    sp: int = 1
    ep: int = 1
    dp: int = 1
    prefill_mode: str = "ag_rs"
    decode_mode: str = "gemm_ar"
    moe_parallel: str | None = None   # None for dense configs
    reasons: tuple = ()

    @property
    def axis_names(self) -> tuple:
        names = []
        for name in ("dp", "ep", "tp", "sp"):
            if getattr(self, name) > 1 or name == "tp":
                names.append(name)
        return tuple(names)

    def groups(self, device=None) -> dict:
        """``{axis name: RankGroup}`` for every name in
        :attr:`axis_names`, each of the plan's size, on ``device``
        (``None``: the CUDA card)."""
        return {n: RankGroup(getattr(self, n), n, device)
                for n in self.axis_names}


def _divisors_leq(n: int, cap: int) -> list:
    """All divisors of ``n`` that are <= cap, ascending (>= [1])."""
    return [d for d in range(1, max(1, min(n, cap)) + 1) if n % d == 0]


def plan_parallelism(config, n_chips: int, max_seq: int = 4096,
                     decode_batch: int = 8,
                     hbm_bytes: int = H100_HBM_BYTES) -> Plan:
    """Pick (dp, ep, tp, sp) for ``config`` over ``n_chips`` (JAX
    ``plan_parallelism``, the same rules and ``reasons``).

    Heuristics (each recorded in ``Plan.reasons``):
      1. MoE configs give the expert dim first claim on cards.
      2. tp in divisors(gcd(kv_heads, intermediate)) grows until the
         per-card parameter bytes fit in half of ``hbm_bytes`` (leaving
         room for activations + KV); if no legal tp fits, the largest
         legal one is taken and the shortfall is recorded.
      3. Long contexts (max_seq > 8k) spend remaining cards on sp.
      4. Anything left becomes dp; cards no legal factoring can use are
         reported, never silently idled.
    """
    c = config
    reasons = []
    remaining = n_chips
    is_moe = getattr(c, "num_experts", 0) and c.num_experts > 0

    ep = 1
    if is_moe:
        ep = _divisors_leq(c.num_experts, remaining)[-1]
        remaining //= ep
        reasons.append(f"ep={ep}: {c.num_experts} experts spread first "
                       "(EP moves routed tokens only)")

    # Parameter bytes per card under tp (dense part + experts under ep),
    # bf16 = 2 bytes, from the config's own split (tied embeddings once).
    inter = getattr(c, "intermediate_size", 0) or getattr(
        c, "moe_intermediate_size", 0)
    attn_p, mlp_p, embed_p = c.param_split()
    per_layer = 2 * (attn_p + mlp_p / max(ep, 1))
    total = per_layer * c.num_hidden_layers + 2 * embed_p

    # tp must divide BOTH the kv heads and the intermediate.
    cap_basis = c.num_key_value_heads
    if inter:
        cap_basis = math.gcd(cap_basis, inter)
    tp = 1
    for d in _divisors_leq(cap_basis, remaining):  # ascending
        tp = d
        if total / d <= hbm_bytes // 2:
            break
    if total / tp > hbm_bytes // 2:
        reasons.append(
            f"WARNING: even tp={tp} (largest legal) leaves "
            f"{total / tp / 2**30:.1f} GiB params/chip")
    remaining //= tp
    reasons.append(f"tp={tp}: ~{total / tp / 2**30:.1f} GiB params/chip "
                   f"(gcd cap {cap_basis})")

    sp = 1
    if max_seq > 8192 and remaining > 1:
        sp = remaining
        remaining = 1
        reasons.append(f"sp={sp}: max_seq {max_seq} wants the "
                       "sequence-sharded cache")
    dp = max(1, remaining)
    if dp > 1:
        reasons.append(f"dp={dp}: leftover chips replicate for "
                       "throughput")
    used = ep * tp * sp * dp
    if used < n_chips:
        reasons.append(f"NOTE: {n_chips - used} of {n_chips} chips "
                       "unused (no legal factoring absorbs them; "
                       "consider a chip count matching the expert/"
                       "head divisors)")

    if sp > 1:
        prefill = decode = "sp"
    else:
        prefill = "ag_rs"
        # JAX's rule (its crossover was measured on a TPU and is not
        # re-measured on the card): replicated GEMM-AR for small decode
        # batches, the sharded path once the batch splits across tp.
        decode = "gemm_ar" if decode_batch < 8 * tp else "ag_rs"
        reasons.append(f"decode={decode} at batch {decode_batch}")

    return Plan(tp=tp, sp=sp, ep=ep, dp=dp, prefill_mode=prefill,
                decode_mode=decode,
                moe_parallel=("ep" if ep > 1 else
                              ("tp" if is_moe else None)),
                reasons=tuple(reasons))


def main(argv=None):
    """Recommend a parallel layout for a model + cards; prints JSON."""
    import argparse
    import json

    from triton_dist_tpu_torch.models import ModelConfig, presets

    ap = argparse.ArgumentParser(
        description="Recommend (dp, ep, tp, sp) for a model")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-dir", default=None,
                     help="HF checkpoint dir (reads config.json)")
    src.add_argument("--preset", default=None,
                     choices=sorted(presets.PRESETS),
                     help="named architecture (models/presets.py)")
    ap.add_argument("--chips", type=int, required=True)
    ap.add_argument("--max-seq", type=int, default=4096)
    ap.add_argument("--decode-batch", type=int, default=8)
    ap.add_argument("--hbm-gib", type=float,
                    default=H100_HBM_BYTES / 2 ** 30)
    args = ap.parse_args(argv)
    cfg = (presets.PRESETS[args.preset]() if args.preset
           else ModelConfig.from_hf_config(args.model_dir))
    p = plan_parallelism(cfg, args.chips, max_seq=args.max_seq,
                         decode_batch=args.decode_batch,
                         hbm_bytes=int(args.hbm_gib * 2 ** 30))
    print(json.dumps({
        "mesh": {n: getattr(p, n) for n in p.axis_names},
        "prefill_mode": p.prefill_mode, "decode_mode": p.decode_mode,
        "moe_parallel": p.moe_parallel, "reasons": list(p.reasons),
    }, indent=2))


if __name__ == "__main__":
    main()
