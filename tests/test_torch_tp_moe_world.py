"""Tensor-parallel MoE at world 4: the port's ``moe_reduce_rs``, ``TPMoE``
and ``Qwen3MoE(moe_parallel="tp", world=4)`` with its engines and server
against the JAX package's on 4 devices of the 8-device CPU mesh, on the
CPU.

* ``ring_reduce_scatter`` sums each row block in JAX's ring order (rank
  me + 1 first, rank me last), shown on partials whose f32 sum depends on
  the order.
* ``moe_reduce_rs`` impls "ring" and "xla" at W = 4 within 1e-5 of
  JAX's (f32); "fused" at W = 4 runs its plain version
  (``tests/test_torch_moe_rs_world.py`` holds it to JAX's kernel);
  "auto" at world > 1 raises naming its item.
* ``TPMoE`` at W = 4 in modes ag_rs (JAX's all-gather kernel in Pallas
  interpret mode) and xla, at 8 rows and at 6 (padded to 8), within 1e-5.
* A tiny f32 ``Qwen3MoE(moe_parallel="tp", world=4)`` (2 layers, hidden
  64, 8 experts of width 64, top-2, 8/4 heads): prefill and decode
  logits in every mode within 1e-5 of JAX's and of the port's world-1
  model on the same weights; the default (xla_ar / gemm_ar) and fused
  (ag_rs / ag_rs) engines' greedy tokens equal the JAX engines', and so
  do the server's replies over each. The JAX model runs impl "xla" (its
  world-4 XLA bodies): its Pallas kernels run in interpret mode above
  (the all-gather in ``TPMoE``; its rings in ``test_torch_tp_world.py``),
  and a jitted whole-model forward over them can abort in interpret
  mode's semaphore waits on a loaded host.

The port's side runs the plain versions on CPU tensors; the CUDA kernels
run on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.layers.tp_moe import TPMoE as JaxTPMoE
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models import Qwen3MoE as JaxMoE
from triton_dist_tpu.models.kv_cache import KVCacheManager as JaxKV
from triton_dist_tpu.ops import moe_reduce_rs as jmrs
from triton_dist_tpu_torch.layers.tp_moe import TPMoE
from triton_dist_tpu_torch.models import (
    AutoLLM, Engine, KVCacheManager, ModelConfig, Qwen3MoE, params_from_jax)
from triton_dist_tpu_torch.ops import allgather as ag
from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
from triton_dist_tpu_torch.runtime.dist import create_rank_group
from triton_dist_tpu_torch.serving import server
from triton_dist_tpu_torch.serving.client import ChatClient
from triton_dist_tpu_torch.serving.server import ModelServer

TOL = dict(rtol=1e-5, atol=1e-5)
W = 4
TINY = dict(hidden_size=64, moe_intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=4, head_dim=8,
            vocab_size=128, max_position_embeddings=64, num_experts=8,
            num_experts_per_tok=2, intermediate_size=0)
B, S, MAX_SEQ, GEN = 4, 8, 32, 3
MODES = ("xla_ar", "gemm_ar", "ag_rs", "xla")
#: (prefill mode, decode mode) of the engines.
ENGINES = {"default": ("xla_ar", "gemm_ar"), "fused": ("ag_rs", "ag_rs")}


def _mesh():
    return Mesh(np.array(jax.devices()[:W]), ("tp",))


def _group():
    return create_rank_group(W, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the ops ------------------------------------------------------------------------
def test_ring_reduce_scatter_sums_in_jax_ring_order():
    """Block c sums ranks c + 1, c + 2, ..., c in f32: with 1e8, -1e8 and
    1 the order decides whether the 1 survives."""
    vals = [1e8, 1.0, -1e8, 1.0]
    parts = [torch.full((W, 1), v) for v in vals]
    got = mrs.ring_reduce_scatter(parts)
    for c in range(W):
        acc = np.float32(vals[(c + 1) % W])
        for s in range(2, W + 1):
            acc = np.float32(acc + np.float32(vals[(c + s) % W]))
        assert got[c, 0].item() == acc, c
    assert sorted(got[:, 0].tolist()) != [2.0] * W   # the order shows


def _moe_rs_inputs(seed=5, t=8, k=2, i=32, h=24, e=8):
    rng = np.random.RandomState(seed)
    act = rng.randn(t * k, i).astype(np.float32)
    w_down = (rng.randn(e, i, h) * i ** -0.5).astype(np.float32)
    ids = rng.randint(0, e, size=t * k).astype(np.int32)
    wts = rng.rand(t, k).astype(np.float32)
    return act, w_down, ids, wts


@pytest.mark.parametrize("impl", ["ring", "xla"])
def test_moe_reduce_rs_world4_matches_jax(impl):
    act, w_down, ids, wts = _moe_rs_inputs()
    jctx = jmrs.create_moe_rs_context(_mesh(), "tp", 8, 2)
    want = jmrs.moe_reduce_rs(*map(jnp.asarray, (act, w_down, ids, wts)),
                              jctx, impl=impl)
    ctx = mrs.create_moe_rs_context(num_experts=8, topk=2, world_size=W)
    got = mrs.moe_reduce_rs(*map(_t, (act, w_down, ids, wts)), ctx,
                            impl=impl)
    assert got.shape == (8, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, mrs.moe_reduce_rs_world_reference(
        *map(_t, (act, w_down, ids, wts)), 8, W, impl))


def test_moe_reduce_rs_world_runs_fused_and_refuses_auto_and_bad_splits():
    act, w_down, ids, wts = map(_t, _moe_rs_inputs())
    ctx = mrs.create_moe_rs_context(num_experts=8, topk=2, world_size=W)
    got = mrs.moe_reduce_rs(act, w_down, ids, wts, ctx, impl="fused")
    assert got.shape == (8, 24)
    assert torch.equal(got, mrs.moe_reduce_rs_fused_world_reference(
        act, w_down, ids, wts, 8, W))
    with pytest.raises(NotImplementedError, match="Queue A item 19"):
        mrs.moe_reduce_rs(act, w_down, ids, wts, ctx, impl="auto")
    with pytest.raises(ValueError, match="split"):
        mrs.moe_reduce_rs(act[:12], w_down, ids[:12], wts[:6], ctx)


# -- the layer ----------------------------------------------------------------------
@pytest.mark.parametrize("m", [8, 6], ids=["split", "padded"])
@pytest.mark.parametrize("mode", ["ag_rs", "xla"])
def test_tp_moe_world4_matches_jax(mode, m):
    h, i, e, k = 32, 64, 8, 2
    jlayer = JaxTPMoE(h, i, e, k, mesh=_mesh(), dtype=jnp.float32,
                      impl="pallas")
    jp = jlayer.init(jax.random.PRNGKey(2))
    x = np.random.RandomState(m).randn(m, h).astype(np.float32)
    want = jlayer(jp, jnp.asarray(x), mode=mode)
    layer = TPMoE(h, i, e, k, dtype=torch.float32, group=_group())
    params = {name: _t(v) for name, v in jp.items()}
    counts = ag.all_gather_launches.total
    got = layer(params, _t(x), mode=mode)
    assert got.shape == (m, h) and ag.all_gather_launches.total == counts
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tp_moe_shards_are_views_of_the_global_params():
    layer = TPMoE(32, 64, 8, 2, dtype=torch.float32, group=_group())
    params = layer.init(torch.Generator().manual_seed(0), "cpu")
    shards = layer.shard_params(params)
    assert shards["w_gate"][1].shape == (8, 32, 16)
    assert shards["w_down"][3].shape == (8, 16, 32)
    assert shards["w_router"][2] is params["w_router"]
    for name in ("w_gate", "w_up", "w_down"):
        for r in range(W):
            assert shards[name][r].untyped_storage().data_ptr() == \
                params[name].untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="shard"):
        TPMoE(32, 66, 8, 2, group=_group())


# -- the model, engines and server ------------------------------------------------
def _ids():
    return np.random.RandomState(31).randint(
        1, TINY["vocab_size"], size=(B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxMoE(JaxConfig(dtype=jnp.float32, **TINY), mesh=_mesh(),
                    axis="tp", impl="xla")
    jparams = jmodel.init(jax.random.PRNGKey(6))
    jmodel.forward = jax.jit(jmodel.forward, static_argnames=("mode",))
    model = Qwen3MoE(ModelConfig(dtype=torch.float32, **TINY), device="cpu",
                     world=W)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return jmodel, jparams, model, params


def _jax_caches(jmodel):
    c = jmodel.config
    return JaxKV(c.num_hidden_layers, B, MAX_SEQ, c.num_key_value_heads,
                 c.head_dim, mesh=jmodel.mesh, axis="tp",
                 dtype=jnp.float32).init()


def _caches(model):
    c = model.config
    return KVCacheManager(c.num_hidden_layers, B, MAX_SEQ,
                          c.num_key_value_heads, c.head_dim,
                          dtype=torch.float32, device="cpu",
                          world=model.world).init()


def _jax_logits(jmodel, jparams, mode):
    """JAX's prefill and one decode step's logits in ``mode``."""
    caches = _jax_caches(jmodel)
    pre, caches = jmodel.forward(jparams, jnp.asarray(_ids()), caches, 0,
                                 mode=mode)
    tok = np.asarray(jnp.argmax(pre[:, -1], -1)).astype(np.int32)[:, None]
    step, _ = jmodel.forward(jparams, jnp.asarray(tok), caches, S,
                             mode=mode)
    return np.asarray(pre), tok, np.asarray(step)


@pytest.fixture(scope="module")
def jax_out(models):
    """JAX's logits in every mode and its engines' greedy tokens,
    computed once for the module."""
    jmodel, jparams, _, _ = models
    out = {mode: _jax_logits(jmodel, jparams, mode) for mode in MODES}
    for name, (prefill, decode) in ENGINES.items():
        eng = JaxEngine(jmodel, batch=B, max_seq=MAX_SEQ,
                        prefill_mode=prefill, decode_mode=decode)
        out[name] = np.asarray(eng.serve(
            jparams, jnp.asarray(_ids()), GEN)).tolist()
    return out


def _port_logits(model, params, mode, tok):
    caches = _caches(model)
    ids = torch.from_numpy(_ids()).long()
    pre, caches = model.forward(params, ids, caches, 0, mode=mode)
    step, _ = model.forward(params, torch.from_numpy(tok).long(), caches, S,
                            mode=mode)
    return pre, step


@pytest.mark.parametrize("mode", MODES)
def test_tp_moe_model_world4_matches_jax(models, jax_out, mode):
    _, _, model, params = models
    want_pre, tok, want_step = jax_out[mode]
    pre, step = _port_logits(model, params, mode, tok)
    np.testing.assert_allclose(pre.numpy(), want_pre, **TOL)
    np.testing.assert_allclose(step.numpy(), want_step, **TOL)


@pytest.mark.parametrize("mode", ["ag_rs", "gemm_ar"])
def test_tp_moe_model_world4_matches_its_world1_model(models, jax_out,
                                                      mode):
    """The same weights at world 1 and world 4 (f32: the shards' products
    and the ring's sums differ only in order)."""
    _, _, model, params = models
    one = Qwen3MoE(model.config, device="cpu")
    tok = jax_out[mode][1]
    for got, want in zip(_port_logits(model, params, mode, tok),
                         _port_logits(one, params, mode, tok)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("name", list(ENGINES))
def test_tp_moe_world4_engines_and_server_match_jax(models, jax_out, name):
    _, _, model, params = models
    prefill, decode = ENGINES[name]
    eng = Engine(model, batch=B, max_seq=MAX_SEQ, prefill_mode=prefill,
                 decode_mode=decode)
    assert eng.kv.world == W
    want = jax_out[name]
    assert eng.serve(params, _ids(), GEN).tolist() == want
    srv = ModelServer(eng, params, port=0).start()
    try:
        with ChatClient(srv.host, srv.port, timeout=120) as client:
            reply = client.generate_ids(_ids().tolist(), GEN)
        assert reply["tokens"] == [row[S:] for row in want]
    finally:
        srv.stop()


def test_tp_moe_world4_builds_through_autollm_and_the_server_flag():
    cfg = ModelConfig(dtype=torch.float32, **TINY)
    built = AutoLLM.build(cfg, device="cpu", world=W)
    assert type(built) is Qwen3MoE and built.moe_parallel == "tp"
    assert built.world == W and built.moe.world == W
    args = server.parse_args(["--preset", "qwen3-30b-a3b", "--device", "cpu",
                              "--world", str(W)])
    model, _ = server.build_model(args, **dict(TINY, dtype=torch.float32))
    assert type(model) is Qwen3MoE and model.moe.world == W
    with pytest.raises(ValueError, match="world 1"):
        Qwen3MoE(cfg, device="cpu", world=W, sp_axis="sp")
