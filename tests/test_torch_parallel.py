"""The port's parallelism planner and facade against the JAX package's
(``triton_dist_tpu.parallel``), on the CPU.

* ``plan_parallelism`` equal to JAX's (tp, sp, ep, dp, modes,
  moe_parallel and reasons) for every preset both packages share, at 1..8
  cards, max_seq 4096 and 32768, decode batches 1 and 8, with
  ``hbm_bytes`` given to both (the port's default is one H100's 80 GiB,
  JAX's a TPU v5e's 16 GiB); the port's default at Qwen3-8B.
* ``Plan.groups`` (the counterpart of JAX's ``Plan.mesh``): one
  ``RankGroup`` per axis name, of the plan's size.
* The facade's exports resolve and its strategy tuples name the port's
  layers, as tests/test_parallel_facade.py checks JAX's.
"""

import dataclasses

import pytest

from triton_dist_tpu.models import presets as jax_presets
from triton_dist_tpu.parallel import plan as jplan
from triton_dist_tpu_torch.models import presets
from triton_dist_tpu_torch.parallel import plan

SHARED = sorted(set(presets.PRESETS) & set(jax_presets.PRESETS))
GIB = 2 ** 30


def _fields(p) -> dict:
    d = dataclasses.asdict(p)
    d["axis_names"] = p.axis_names
    return d


def test_the_packages_share_presets():
    assert SHARED == sorted(presets.PRESETS)
    assert "qwen3-8b" in SHARED and "qwen3-30b-a3b" in SHARED


@pytest.mark.parametrize("hbm_gib", [16, 80])
@pytest.mark.parametrize("name", SHARED)
def test_plan_parallelism_matches_jax(name, hbm_gib):
    cfg, jcfg = presets.PRESETS[name](), jax_presets.PRESETS[name]()
    for chips in range(1, 9):
        for max_seq in (4096, 32768):
            for batch in (1, 8):
                kw = dict(max_seq=max_seq, decode_batch=batch,
                          hbm_bytes=hbm_gib * GIB)
                got = plan.plan_parallelism(cfg, chips, **kw)
                want = jplan.plan_parallelism(jcfg, chips, **kw)
                assert _fields(got) == _fields(want), (chips, max_seq, batch)
                assert got.tp * got.sp * got.ep * got.dp <= chips


def test_default_hbm_is_one_h100():
    cfg = presets.qwen3_8b()
    assert plan.H100_HBM_BYTES == 80 * GIB
    assert plan.plan_parallelism(cfg, 4) == plan.plan_parallelism(
        cfg, 4, hbm_bytes=80 * GIB)
    # Qwen3-8B's ~15.3 GiB of bf16 weights fit half of one H100 (JAX's
    # 16 GiB default needs tp = 2).
    assert plan.plan_parallelism(cfg, 4).tp == 1
    assert jplan.plan_parallelism(jax_presets.qwen3_8b(), 4).tp == 2


def test_plan_groups_are_rank_groups_of_the_plan():
    p = plan.Plan(tp=2, sp=1, ep=1, dp=4)
    groups = p.groups(device="cpu")
    assert tuple(groups) == p.axis_names == ("dp", "tp")
    assert groups["dp"].world == 4 and groups["dp"].axis == "dp"
    assert groups["tp"].world == 2 and str(groups["tp"].device) == "cpu"
    assert tuple(plan.Plan(sp=4).groups(device="cpu")) == ("tp", "sp")


def test_facade_exports_resolve():
    import triton_dist_tpu.parallel as jpar
    import triton_dist_tpu_torch.parallel as par
    assert par.__all__ == jpar.__all__
    for name in par.__all__:
        assert getattr(par, name) is not None, name


def test_strategy_groupings_name_the_ports_layers():
    from triton_dist_tpu_torch import layers, parallel as par
    from triton_dist_tpu_torch.layers import (
        ep_a2a, ep_moe, p2p, sp_flash_decode, tp_attn, tp_mlp, tp_moe)
    assert par.TP_LAYERS == (tp_mlp.TPMLP, tp_attn.TPAttn, tp_moe.TPMoE)
    assert par.EP_LAYERS == (ep_a2a.EPAll2AllLayer, ep_moe.EPMoE)
    assert par.SP_LAYERS == (sp_flash_decode.SpFlashDecodeLayer,
                             sp_flash_decode.SpAttentionLayer)
    assert par.PP_LAYERS == (p2p.CommOp,)
    groups = [par.TP_LAYERS, par.EP_LAYERS, par.SP_LAYERS, par.PP_LAYERS]
    seen = set()
    for g in groups:
        for cls in g:
            assert cls not in seen, cls
            assert cls.__module__.startswith(layers.__name__)
            seen.add(cls)


def test_plan_cli_prints_the_plan(capsys):
    import json
    plan.main(["--preset", "qwen3-30b-a3b", "--chips", "8",
               "--hbm-gib", "16"])
    out = json.loads(capsys.readouterr().out)
    want = jplan.plan_parallelism(jax_presets.qwen3_30b_a3b(), 8,
                                  hbm_bytes=16 * GIB)
    assert out["mesh"] == {n: getattr(want, n) for n in want.axis_names}
    assert out["reasons"] == list(want.reasons)
    assert out["moe_parallel"] == want.moe_parallel == "ep"
