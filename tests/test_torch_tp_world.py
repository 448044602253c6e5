"""Tensor parallelism at world 4: the port's layers, dense model, engines
and server over a ``RankGroup`` of 4 ranks against the JAX package's on 4
devices of the 8-device CPU mesh, on the CPU.

* ``TPMLP`` (with and without biases, at M = 512 where ag_rs fuses the
  SwiGLU and M = 8 where it composes) and ``TPAttn`` (prefill, offset
  and per-row decode forms) in modes xla_ar, gemm_ar, ag_rs and xla.
* A tiny f32 ``DenseLLM(world=4)`` (2 layers, hidden 64, inter 512, 8/4
  heads): a 4 x 128-token prefill (ag_rs fuses the SwiGLU) and one decode
  step in every mode.

The engines and the server at world 4 are ``test_torch_tp_engine.py``'s.
The JAX side runs ``impl="pallas"``, its ring kernels in Pallas interpret
mode (its model forward jitted in the fixture). The port's side runs the
plain ring versions on CPU tensors. f32 throughout, within 1e-5 (atol and
rtol: the two sides differ only in summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.layers import common as jcommon
from triton_dist_tpu.layers.tp_attn import TPAttn as JaxAttn
from triton_dist_tpu.layers.tp_mlp import TPMLP as JaxMLP
from triton_dist_tpu.models import DenseLLM as JaxDense
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models.kv_cache import KVCacheManager as JaxKV
from triton_dist_tpu_torch.layers import common
from triton_dist_tpu_torch.layers.tp_attn import TPAttn
from triton_dist_tpu_torch.layers.tp_mlp import TPMLP
from triton_dist_tpu_torch.models import (
    AutoLLM, DenseLLM, KVCacheManager, ModelConfig, params_from_jax)
from triton_dist_tpu_torch.ops import allgather_gemm
from triton_dist_tpu_torch.runtime.dist import create_rank_group

TOL = dict(rtol=1e-5, atol=1e-5)
W = 4
H, HQ, HKV, D = 64, 8, 4, 16
TINY = dict(hidden_size=H, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=HQ, num_key_value_heads=HKV, head_dim=D,
            vocab_size=96, max_position_embeddings=192)
#: A 4 x 128-token prefill: 128 rows per rank, where ag_rs fuses.
B, S, MAX_SEQ = 4, 128, 136
MODES = ("xla_ar", "gemm_ar", "ag_rs", "xla")


def _mesh():
    return Mesh(np.array(jax.devices()[:W]), ("tp",))


def _t(a):
    return torch.from_numpy(np.array(a))


def _group():
    return create_rank_group(W, device="cpu")


# -- the layers --------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("m", [8, 512], ids=["composed", "fused"])
def test_tp_mlp_world4_matches_jax(mode, use_bias, m):
    inter = TINY["intermediate_size"]
    jmlp = JaxMLP(H, inter, mesh=_mesh(), dtype=jnp.float32, impl="pallas",
                  use_bias=use_bias)
    jp = jmlp.init(jax.random.PRNGKey(7))
    rng = np.random.RandomState(7)
    if use_bias:
        for name in ("b_gate", "b_up", "b_down"):
            jp[name] = jnp.asarray(rng.randn(*jp[name].shape), jnp.float32)
    x = rng.randn(m, H).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jmlp(p, x, mode=mode))(
        jp, jnp.asarray(x)))
    mlp = TPMLP(H, inter, dtype=torch.float32, use_bias=use_bias,
                group=_group())
    assert allgather_gemm.swiglu_fuses(m // W, H, inter // W, 4) == (m == 512)
    got = mlp({k: _t(v) for k, v in jp.items()}, _t(x), mode=mode).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode,offset,b,s", [
    ("xla_ar", 0, 2, 4), ("gemm_ar", 3, 2, 3), ("gemm_ar", "per_row", 4, 1),
    ("ag_rs", 0, 2, 64), ("ag_rs", 5, 2, 2), ("ag_rs", "per_row", 4, 1),
    ("xla", 0, 2, 64), ("xla", "per_row", 4, 1)])
def test_tp_attn_world4_matches_jax(mode, offset, b, s):
    t = 72
    jattn = JaxAttn(H, HQ, HKV, D, mesh=_mesh(), dtype=jnp.float32,
                    impl="pallas")
    jp = jattn.init(jax.random.PRNGKey(5))
    rng = np.random.RandomState(6)
    x = rng.randn(b * s, H).astype(np.float32)
    if offset == "per_row":
        off = np.arange(b, dtype=np.int64) * 3 + 2
        pos = off[:, None]
    else:
        off = offset
        pos = np.tile(np.arange(s) + offset, (b, 1))
    ck = rng.randn(b, t, HKV, D).astype(np.float32)
    cv = rng.randn(b, t, HKV, D).astype(np.float32)
    cos_j, sin_j = jcommon.precompute_rope_cache(D, 80, 1e6)
    jout, (jk, jv) = jax.jit(
        lambda p, x, pos, rope, cache, off: jattn(p, x, pos, rope, cache,
                                                  off, mode=mode))(
        jp, jnp.asarray(x), jnp.asarray(pos, jnp.int32), (cos_j, sin_j),
        (jnp.asarray(ck), jnp.asarray(cv)), jnp.asarray(off, jnp.int32))
    attn = TPAttn(H, HQ, HKV, D, dtype=torch.float32, group=_group())
    cache = (_t(ck), _t(cv))
    toff = _t(off).long() if offset == "per_row" else off
    out, cache = attn({k: _t(v) for k, v in jp.items()}, _t(x),
                      _t(pos).long(),
                      common.precompute_rope_cache(D, 80, 1e6), cache, toff,
                      mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(cache[0].numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(cache[1].numpy(), np.asarray(jv), **TOL)


# -- the model, the engines and the server --------------------------------------------
@pytest.fixture(scope="module")
def models():
    jmodel = JaxDense(JaxConfig(dtype=jnp.float32, **TINY), mesh=_mesh(),
                      axis="tp", impl="pallas")
    jparams = jmodel.init(jax.random.PRNGKey(3))
    # Eager interpret-mode forwards would trace each Pallas call anew.
    jmodel.forward = jax.jit(jmodel.forward,
                             static_argnames=("mode", "remat"))
    model = DenseLLM(ModelConfig(dtype=torch.float32, **TINY), device="cpu",
                     world=W)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return jmodel, jparams, model, params


def _caches(world_model, jmodel=None):
    c = world_model.config
    tc = KVCacheManager(c.num_hidden_layers, B, MAX_SEQ,
                        c.num_key_value_heads, c.head_dim,
                        dtype=torch.float32, device="cpu",
                        world=world_model.world).init()
    if jmodel is None:
        return tc
    jc = JaxKV(c.num_hidden_layers, B, MAX_SEQ, c.num_key_value_heads,
               c.head_dim, mesh=jmodel.mesh, dtype=jnp.float32).init()
    return tc, jc


@pytest.mark.parametrize("mode", MODES)
def test_dense_world4_forward_matches_jax(models, mode):
    jmodel, jparams, model, params = models
    tc, jc = _caches(model, jmodel)
    ids = np.random.RandomState(11).randint(1, TINY["vocab_size"],
                                            size=(B, S))
    jl, jc = jmodel.forward(jparams, jnp.asarray(ids, jnp.int32), jc, 0,
                            mode=mode)
    tl, tc = model.forward(params, torch.from_numpy(ids), tc, 0, mode=mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = tl[:, -1].argmax(-1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    jl2, _ = jmodel.forward(jparams, jtok, jc, S, mode=mode)
    tl2, _ = model.forward(params, ttok, tc, S, mode=mode)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)


def test_world_model_shards_views_and_refuses_what_jax_refuses(models):
    _, _, model, params = models
    assert model.group.world == W and model.attn.world == W \
        and model.mlp.world == W
    with pytest.raises(ValueError, match="must split"):
        model.forward(params, torch.ones((1, 3), dtype=torch.long),
                      _caches(model), 0, mode="ag_rs")
    sp = DenseLLM(model.config, device="cpu", world=W, sp_axis="sp")
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        sp.forward(params, torch.ones((1, 4), dtype=torch.long),
                   _caches(model), 0, mode="sp")
    built = AutoLLM.build(model.config, device="cpu", world=W)
    assert isinstance(built, DenseLLM) and built.world == W
    with pytest.raises(ValueError, match="no experts"):
        AutoLLM.build(model.config, device="cpu", moe_parallel="ep",
                      world=W)


