"""The port's expert parallelism against the JAX package's, on the CPU.

W ranks of the port run on one device (``runtime.dist.RankGroup``); JAX
runs them on W devices of its 8-device CPU mesh, its ``_a2a_kernel`` in
Pallas interpret mode. Weights cross through numpy, f32 throughout.

* ``dispatch_layout``, ``scatter_to_slabs`` and ``live_slot_mask`` equal
  JAX's, capacity drops included.
* ``EPAll2AllLayer.dispatch`` / ``combine`` at W = 4 (f32) and W = 2
  (the fp8 wire, bf16): received slots, local expert ids, the handle and
  the combined rows equal JAX's.
* ``EPMoE`` against JAX's ``EPMoE`` on the same params at W = 4 and 8:
  within 1e-5.
* The world-W XLA bodies of ``ag_gemm_multi``, ``gemm_rs`` and
  ``gemm_ar`` against JAX's at W = 4, and their rings (impl "pallas")
  against JAX's Pallas kernels in interpret mode.
* ``Qwen3MoE(moe_parallel="ep", world=4)`` (tiny, 2 layers) in mode
  "xla": prefill and one decode step's logits within 1e-5 of JAX's, and
  ``Engine(prefill_mode="xla", decode_mode="xla")``'s ``serve`` and
  ``serve_ragged`` greedy tokens identical to the JAX engine's; the port's EP model against its TP model
  on the same weights within JAX's own 3e-3; mode "ep" (attention
  through the rings, the MoE through the all-to-all) against JAX's mode
  "ep", and modes ag_rs / gemm_ar against JAX's logits, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.layers.ep_a2a import EPAll2AllLayer as JaxEPA2A
from triton_dist_tpu.layers.ep_moe import EPMoE as JaxEPMoE
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models import Qwen3MoE as JaxMoE
from triton_dist_tpu.models.kv_cache import KVCacheManager as JaxKV
from triton_dist_tpu.ops import moe_utils as jax_mu
from triton_dist_tpu_torch.layers.ep_a2a import EPAll2AllLayer
from triton_dist_tpu_torch.layers.ep_moe import EPMoE
from triton_dist_tpu_torch.models import (
    AutoLLM, Engine, KVCacheManager, ModelConfig, Qwen3MoE, params_from_jax)
from triton_dist_tpu_torch.ops import moe_utils
from triton_dist_tpu_torch.runtime.dist import create_rank_group

TINY = dict(hidden_size=64, moe_intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=8, head_dim=8,
            vocab_size=128, max_position_embeddings=64, num_experts=8,
            num_experts_per_tok=2, intermediate_size=0)
W, B, S, MAX_SEQ, GEN = 4, 4, 8, 32, 3


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _put(mesh, a):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("tp")))


def _ids():
    return np.random.RandomState(21).randint(
        1, TINY["vocab_size"], size=(B, S)).astype(np.int32)


# -- the helpers ------------------------------------------------------------------
@pytest.mark.parametrize("capacity", [3, 6, 24])
def test_dispatch_layout_and_scatter_match_jax(capacity):
    rng = np.random.RandomState(capacity)
    t, k, e, world, h = 12, 2, 8, 4, 5
    ids = rng.randint(0, e, size=(t, k)).astype(np.int32)
    ids[:4] = 0                          # a hot expert: drops at small caps
    x = rng.randn(t, h).astype(np.float32)
    want = jax_mu.dispatch_layout(jnp.asarray(ids), e, world, capacity)
    got = moe_utils.dispatch_layout(torch.from_numpy(ids), e, world,
                                    capacity)
    for name in ("dest", "pos", "valid", "send_counts", "local_expert"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    if capacity < 6:
        assert not got["valid"].all()    # the case drops pairs
    jbuf, jex = jax_mu.scatter_to_slabs(
        jnp.asarray(x), want, world, capacity,
        extra={"local_expert": want["local_expert"]})
    buf, ex = moe_utils.scatter_to_slabs(
        torch.from_numpy(x), got, world, capacity,
        extra={"local_expert": got["local_expert"]})
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(ex["local_expert"].numpy(),
                                  np.asarray(jex["local_expert"]))
    counts = got["send_counts"]
    np.testing.assert_array_equal(
        moe_utils.live_slot_mask(counts, world, capacity).numpy(),
        np.asarray(jax_mu.live_slot_mask(jnp.asarray(counts.numpy()), world,
                                         capacity)))


@pytest.mark.parametrize("wire,world", [(None, W), ("fp8", 2)])
def test_ep_all_to_all_layer_matches_jax(wire, world):
    rows, h, e, topk = 4, 32, 16, 2
    t = world * rows
    rng = np.random.RandomState(7)
    x = rng.randn(t, h).astype(np.float32)
    idx = rng.randint(0, e, size=(t, topk)).astype(np.int32)
    wts = rng.rand(t, topk).astype(np.float32)
    jdt, dt = ((jnp.bfloat16, torch.bfloat16) if wire else
               (jnp.float32, torch.float32))
    mesh = _mesh(world)
    jlayer = JaxEPA2A(max_tokens=rows, hidden=h, topk=topk, num_experts=e,
                      mesh=mesh, axis="tp", dtype=jdt, impl="pallas",
                      wire_dtype=wire)
    layer = EPAll2AllLayer(max_tokens=rows, hidden=h, topk=topk,
                           num_experts=e,
                           group=create_rank_group(world, device="cpu"),
                           dtype=dt, wire_dtype=wire)
    assert layer.capacity == jlayer.capacity
    jx = jnp.asarray(x).astype(jdt)
    jtok, jexp, jh = jlayer.dispatch(_put(mesh, jx), _put(mesh, idx))
    tok, exp, handle = layer.dispatch(torch.from_numpy(x).to(dt),
                                      torch.from_numpy(idx))
    np.testing.assert_array_equal(tok.float().numpy(),
                                  np.asarray(jtok.astype(jnp.float32)))
    np.testing.assert_array_equal(exp.numpy(), np.asarray(jexp))
    for name in ("dest", "pos", "valid", "recv_counts"):
        np.testing.assert_array_equal(getattr(handle, name).numpy(),
                                      np.asarray(getattr(jh, name)))
    # Combine: each slot's row scaled by its local expert id + 1.
    jout = jlayer.combine(jtok * (jexp[:, None] + 1).astype(jdt),
                          _put(mesh, wts), jh)
    out = layer.combine(tok * (exp[:, None] + 1).to(dt),
                        torch.from_numpy(wts), handle)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", [4, 8])
def test_ep_moe_layer_matches_jax(world):
    rows, h, i, e, topk = 4, 16, 24, 16, 2
    t = world * rows
    mesh = _mesh(world)
    jlayer = JaxEPMoE(h, i, e, topk, mesh=mesh, axis="tp",
                      dtype=jnp.float32, impl="pallas")
    jparams = jlayer.init(jax.random.PRNGKey(world))
    x = (np.random.RandomState(world).randn(t, h) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(jlayer.__call__)(jparams, _put(mesh, x)))
    layer = EPMoE(h, i, e, topk, create_rank_group(world, device="cpu"),
                  dtype=torch.float32)
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    got = layer(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # A decode-sized batch that does not split over the ranks pads; no
    # pair is dropped, so each token's row is the one JAX computed.
    got = layer(params, torch.from_numpy(x[:3]))
    np.testing.assert_allclose(got.numpy(), want[:3], rtol=1e-5, atol=1e-5)


def test_world_xla_bodies_match_jax():
    """ag_gemm_multi / gemm_rs / gemm_ar over 4 ranks, impl "xla", against
    JAX's XLA bodies on its 4-device mesh (all-gather + dot, dot +
    psum_scatter / psum; gemm_ar pads rows that do not split); their
    Pallas impls (the plain rings on CPU tensors) against JAX's Pallas
    rings in interpret mode."""
    from triton_dist_tpu.ops.allgather_gemm import (
        ag_gemm_multi as jax_ag_gemm_multi, create_ag_gemm_context)
    from triton_dist_tpu.ops.gemm_reduce_scatter import (
        create_gemm_rs_context, gemm_ar as jax_gemm_ar,
        gemm_rs as jax_gemm_rs)
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs
    mesh = _mesh(W)
    group = create_rank_group(W, device="cpu")
    rng = np.random.RandomState(2)
    a, x = rng.randn(8, 16), rng.randn(8, 16)
    b1, b2, w = rng.randn(16, 8), rng.randn(16, 12), rng.randn(16, 12)
    a, x, b1, b2, w = (t.astype(np.float32) for t in (a, x, b1, b2, w))

    def put(t, spec):
        return jax.device_put(jnp.asarray(t), NamedSharding(mesh, spec))
    want = jax_ag_gemm_multi(put(a, P("tp")), [put(b1, P(None, "tp")),
                                              put(b2, P(None, "tp"))],
                             create_ag_gemm_context(mesh, "tp"), impl="xla")
    got = ag.ag_gemm_multi(torch.from_numpy(a), [torch.from_numpy(b1),
                                                 torch.from_numpy(b2)],
                           group, impl="xla")
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5,
                                   atol=1e-5)
    ctx = create_gemm_rs_context(mesh, "tp")
    for rows, jfn, fn in ((8, jax_gemm_rs, rs.gemm_rs),
                          (8, jax_gemm_ar, rs.gemm_ar),
                          (6, jax_gemm_ar, rs.gemm_ar)):
        want = jfn(put(x[:rows], P(None, "tp")), put(w, P("tp")), ctx,
                   impl="xla")
        got = fn(torch.from_numpy(x[:rows]), torch.from_numpy(w), group,
                 impl="xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    t = torch.from_numpy
    want = jax_ag_gemm_multi(put(a, P("tp")), [put(b1, P(None, "tp"))],
                             create_ag_gemm_context(mesh, "tp"),
                             impl="pallas")
    got = ag.ag_gemm_multi(t(a), [t(b1)], group)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    for rows, jfn, fn in ((8, jax_gemm_rs, rs.gemm_rs),
                          (6, jax_gemm_ar, rs.gemm_ar)):
        want = jfn(put(x[:rows], P(None, "tp")), put(w, P("tp")), ctx,
                   impl="pallas")
        got = fn(t(x[:rows]), t(w), group)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# -- the model and the engine -----------------------------------------------------
@pytest.fixture(scope="module")
def models():
    mesh = _mesh(W)
    jmodel = JaxMoE(JaxConfig(dtype=jnp.float32, **TINY), mesh=mesh,
                    axis="tp", fwd_mode="xla", impl="pallas",
                    moe_parallel="ep")
    jparams = jmodel.init(jax.random.PRNGKey(4))
    model = Qwen3MoE(ModelConfig(dtype=torch.float32, **TINY), device="cpu",
                     fwd_mode="xla", moe_parallel="ep", world=W)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def jax_out(models):
    """JAX's prefill and decode-step logits and its engine's greedy
    tokens, computed once for the module."""
    jmodel, jparams, _, _ = models
    c = jmodel.config
    # One jit of the forward serves these calls and the engine's prefill
    # and decode traces (its interpret-mode Pallas calls are slow to run
    # eagerly); the calls pass the engine's arguments.
    jmodel.forward = jax.jit(jmodel.forward, static_argnames=("mode",))
    caches = JaxKV(c.num_hidden_layers, B, MAX_SEQ, c.num_key_value_heads,
                   c.head_dim, mesh=jmodel.mesh, axis="tp",
                   dtype=jnp.float32).init()
    ids = _ids()
    start = jnp.zeros((B,), jnp.int32)
    pre, caches = jmodel.forward(jparams, jnp.asarray(ids), caches, 0,
                                 mode="xla", kv_start=start)
    tok = np.asarray(jnp.argmax(pre[:, -1], -1)).astype(np.int32)[:, None]
    step, _ = jmodel.forward(jparams, jnp.asarray(tok), caches, S,
                             mode="xla", kv_start=start)
    eng = JaxEngine(jmodel, batch=B, max_seq=MAX_SEQ, prefill_mode="xla",
                    decode_mode="xla")
    served = eng.serve(jparams, jnp.asarray(ids), GEN)
    # Ragged prompts padded to S: the same traces as serve's.
    ragged = [r.tolist() for r in eng.serve_ragged(jparams, _ragged(), GEN)]
    return {"prefill": np.asarray(pre), "tok": tok, "step": np.asarray(step),
            "serve": np.asarray(served).tolist(), "ragged": ragged}


def _ragged():
    return [row[:n].tolist() for row, n in zip(_ids(), (S, 5, 3, 7))]


def _caches(model, world=W):
    c = model.config
    return KVCacheManager(c.num_hidden_layers, B, MAX_SEQ,
                          c.num_key_value_heads, c.head_dim,
                          dtype=torch.float32, device="cpu",
                          world=world).init()


def test_ep_forward_matches_jax(models, jax_out):
    _, _, model, params = models
    caches = _caches(model)
    pre, caches = model.forward(params, torch.from_numpy(_ids()).long(),
                                caches, 0, mode="xla")
    np.testing.assert_allclose(pre.numpy(), jax_out["prefill"], rtol=1e-5,
                               atol=1e-5)
    step, _ = model.forward(params, torch.from_numpy(jax_out["tok"]).long(),
                            caches, S, mode="xla")
    np.testing.assert_allclose(step.numpy(), jax_out["step"], rtol=1e-5,
                               atol=1e-5)


def test_ep_engine_serve_matches_jax(models, jax_out):
    _, _, model, params = models
    eng = Engine(model, batch=B, max_seq=MAX_SEQ, prefill_mode="xla",
                 decode_mode="xla")
    assert eng.kv.world == W
    out = eng.serve(params, _ids(), GEN)
    assert out.tolist() == jax_out["serve"]
    rows = eng.serve_ragged(params, _ragged(), GEN)
    assert [r.tolist() for r in rows] == jax_out["ragged"]


def test_ep_model_matches_tp_model(models):
    """EP and TP parallelizations of the same weights agree (JAX's
    ``test_moe_ep_mode_matches_tp`` tolerance), in modes xla and xla_ar."""
    _, _, model, params = models
    tp = Qwen3MoE(model.config, device="cpu", fwd_mode="xla")
    ids = torch.from_numpy(_ids()).long()
    ref, _ = tp.forward(params, ids, _caches(tp, 1), 0, mode="xla")
    for mode in ("xla", "xla_ar"):
        out, _ = model.forward(params, ids, _caches(model), 0, mode=mode)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=3e-3,
                                   atol=3e-3, err_msg=mode)


def test_ep_at_world_one_runs_mode_ep(models):
    """At world 1 mode "ep" is JAX's: fused ag_rs attention, the EP MoE
    (whose exchange is the identity)."""
    _, _, model, params = models
    ep1 = Qwen3MoE(model.config, device="cpu", moe_parallel="ep")
    tp = Qwen3MoE(model.config, device="cpu")
    ids = torch.from_numpy(_ids()).long()
    want, _ = tp.forward(params, ids, _caches(tp, 1), 0, mode="ag_rs")
    got, _ = ep1.forward(params, ids, _caches(ep1, 1), 0, mode="ep")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_ep_mode_at_world_matches_jax(models):
    """Mode "ep" at world 4: attention through the rings (ag_rs: the rows
    split over the ranks), the MoE through the all-to-all; prefill and one
    decode step against JAX's mode "ep" (the forward the jax_out fixture
    jitted)."""
    jmodel, jparams, model, params = models
    c = jmodel.config
    jc = JaxKV(c.num_hidden_layers, B, MAX_SEQ, c.num_key_value_heads,
               c.head_dim, mesh=jmodel.mesh, axis="tp",
               dtype=jnp.float32).init()
    tc = _caches(model)
    ids = _ids()
    assert model._attn_mode("ep", ids.size) == "ag_rs"
    assert model._attn_mode("ep", 3) == "gemm_ar"
    jl, jc = jmodel.forward(jparams, jnp.asarray(ids), jc, 0, mode="ep")
    tl, tc = model.forward(params, torch.from_numpy(ids).long(), tc, 0,
                           mode="ep")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    jl2, _ = jmodel.forward(jparams, jnp.asarray(tok), jc, S, mode="ep")
    tl2, _ = model.forward(params, torch.from_numpy(tok).long(), tc, S,
                           mode="ep")
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-5,
                               atol=1e-5)


def test_ep_kv_cache_ranks_view_their_heads(models):
    _, _, model, _ = models
    c = model.config
    kv = KVCacheManager(c.num_hidden_layers, B, MAX_SEQ,
                        c.num_key_value_heads, c.head_dim,
                        dtype=torch.float32, device="cpu", world=W)
    k, _ = kv.init()[0]
    assert k.shape == (B, MAX_SEQ, c.num_key_value_heads, c.head_dim)
    for r, kr in enumerate(model.group.shard(k, 2)):
        kr.fill_(r + 1)
        assert kr.shape[2] == c.num_key_value_heads // W
        assert kr.data_ptr() == k[:, :, r * 2].data_ptr()
    assert k[0, 0, :, 0].tolist() == [1, 1, 2, 2, 3, 3, 4, 4]
    with pytest.raises(ValueError, match="do not shard"):
        KVCacheManager(1, 1, 4, 6, 2, device="cpu", world=4)


def test_unported_world_modes_raise(models, jax_out):
    """Modes ag_rs and gemm_ar at world W run the rings (their logits
    within 1e-5 of JAX's, f32: every mode computes the same products);
    TP MoE at world W builds, and ep x sp raises as JAX asserts."""
    _, _, model, params = models
    ids = torch.from_numpy(_ids()).long()
    for mode in ("ag_rs", "gemm_ar"):
        out, _ = model.forward(params, ids, _caches(model), 0, mode=mode)
        np.testing.assert_allclose(out.numpy(), jax_out["prefill"],
                                   rtol=1e-5, atol=1e-5, err_msg=mode)
    tp = Qwen3MoE(model.config, device="cpu", world=W)
    assert tp.moe_parallel == "tp" and tp.moe.world == W
    with pytest.raises(ValueError, match="moe_parallel='tp'"):
        Qwen3MoE(model.config, device="cpu", moe_parallel="ep",
                 sp_axis="sp")
    built = AutoLLM.build(model.config, device="cpu", moe_parallel="ep",
                          world=W)
    assert built.moe_parallel == "ep" and built.world == W
    assert isinstance(built.moe, EPMoE)
