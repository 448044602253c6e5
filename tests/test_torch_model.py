"""The port's model layer (triton_dist_tpu_torch.models: config, presets,
DenseLLM) against the JAX package's on the CPU, and against a
random-init HF ``Qwen3ForCausalLM``.

The JAX model runs on a 1-device mesh with impl="pallas" (the gemm_ar
Pallas kernel in interpret mode); its params reach the port through
``params_from_jax``. f32 logits agree within 1e-5 (atol and rtol, only
the summation order differs) and greedy tokens are identical; bf16 logits
agree within 2e-2 (bf16 rounds at other places in the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import DenseLLM as JaxDense
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models import presets as jax_presets
from triton_dist_tpu.models.kv_cache import KVCacheManager as JaxKV
from triton_dist_tpu_torch.models import (
    DenseLLM, KVCacheManager, ModelConfig, params_from_jax, presets)

TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            vocab_size=96, max_position_embeddings=64)


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_presets_param_count_matches_jax(name):
    ours = presets.PRESETS[name]()
    theirs = jax_presets.PRESETS[name]()
    assert presets.param_count(ours) == jax_presets.param_count(theirs)
    assert ours.param_split() == theirs.param_split()
    assert ours.dtype == torch.bfloat16


def test_from_hf_config_matches_jax():
    cfg = {"hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 3, "num_attention_heads": 8,
           "num_key_value_heads": 2, "vocab_size": 100,
           "model_type": "llama", "eos_token_id": [7, 9],
           "tie_word_embeddings": True}
    ours = dataclasses.asdict(ModelConfig.from_hf_config(cfg))
    theirs = dataclasses.asdict(JaxConfig.from_hf_config(cfg))
    ours.pop("dtype"), theirs.pop("dtype")
    assert ours == theirs


def _pair(dtype_j, dtype_t, seed=0):
    jmodel = JaxDense(JaxConfig(dtype=dtype_j, **TINY), mesh=_mesh1(),
                      axis="tp", impl="pallas")
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = DenseLLM(ModelConfig(dtype=dtype_t, **TINY), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return jmodel, jparams, model, params


def _jax_caches(jmodel, b, t):
    c = jmodel.config
    return JaxKV(c.num_hidden_layers, b, t, c.num_key_value_heads,
                 c.head_dim, mesh=jmodel.mesh, dtype=c.dtype).init()


def _port_caches(model, b, t):
    c = model.config
    return KVCacheManager(c.num_hidden_layers, b, t, c.num_key_value_heads,
                          c.head_dim, dtype=c.dtype, device="cpu").init()


def _prefill_then_decode(jmodel, jparams, model, params, kv_start=None):
    """Prefill (B, 5) then one decode step at offset 5, both models; the
    decode feeds each model its own greedy token. Returns the four
    logits arrays and the two token vectors."""
    rng = np.random.RandomState(3)
    ids = rng.randint(0, TINY["vocab_size"], size=(2, 5))
    jc, tc = _jax_caches(jmodel, 2, 16), _port_caches(model, 2, 16)
    ks = None if kv_start is None else jnp.asarray(kv_start, jnp.int32)
    jfwd = jax.jit(jmodel.forward, static_argnames="mode")
    jl, jc = jfwd(jparams, jnp.asarray(ids, jnp.int32), jc, 0,
                  mode="xla_ar", kv_start=ks)
    tl, tc = model.forward(params, torch.from_numpy(ids), tc, 0,
                           mode="xla_ar", kv_start=kv_start)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = tl[:, -1].argmax(-1)
    jl2, _ = jfwd(jparams, jtok[:, None], jc, 5, mode="gemm_ar",
                  kv_start=ks)
    tl2, _ = model.forward(params, ttok[:, None], tc, 5, mode="gemm_ar",
                           kv_start=kv_start)
    return (np.asarray(jl, np.float32), tl.numpy(),
            np.asarray(jl2, np.float32), tl2.numpy(),
            np.asarray(jtok), ttok.numpy())


@pytest.mark.parametrize("kv_start", [None, [0, 2]], ids=["square", "ragged"])
def test_dense_forward_f32_matches_jax(kv_start):
    jmodel, jparams, model, params = _pair(jnp.float32, torch.float32)
    jl, tl, jl2, tl2, jtok, ttok = _prefill_then_decode(
        jmodel, jparams, model, params, kv_start)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_allclose(tl2, jl2, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tl2[:, -1].argmax(-1),
                                  jl2[:, -1].argmax(-1))


def test_dense_forward_bf16_matches_jax():
    jmodel, jparams, model, params = _pair(jnp.bfloat16, torch.bfloat16,
                                           seed=1)
    jl, tl, jl2, tl2, jtok, ttok = _prefill_then_decode(
        jmodel, jparams, model, params)
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=2e-2)
    if np.array_equal(ttok, jtok):      # decode from the same token only
        np.testing.assert_allclose(tl2, jl2, atol=2e-2, rtol=2e-2)


def test_bf16_params_carry_one_f32_head_copy():
    _, _, model, params = _pair(jnp.bfloat16, torch.bfloat16)
    assert params["lm_head"].dtype == torch.bfloat16
    assert params["lm_head_f32"].dtype == torch.float32
    assert torch.equal(params["lm_head_f32"], params["lm_head"].float())
    assert model.init(0)["lm_head_f32"].dtype == torch.float32
    _, _, _, p32 = _pair(jnp.float32, torch.float32)
    assert p32["lm_head_f32"] is p32["lm_head"]


def test_forward_updates_caches_in_place():
    _, _, model, params = _pair(jnp.float32, torch.float32)
    caches = _port_caches(model, 1, 8)
    k0 = caches[0][0]
    _, out = model.forward(params, torch.tensor([[1, 2, 3]]), caches, 0)
    assert out[0][0] is k0
    assert k0[:, :3].abs().sum() > 0 and k0[:, 3:].abs().sum() == 0


def test_init_is_seeded_and_scaled():
    model = DenseLLM(ModelConfig(dtype=torch.float32, **TINY), device="cpu")
    a, b, c = model.init(3), model.init(3), model.init(4)
    wq = a["layers"][0]["attn"]["w_q"]
    assert torch.equal(wq, b["layers"][0]["attn"]["w_q"])
    assert not torch.equal(wq, c["layers"][0]["attn"]["w_q"])
    assert wq.shape == (TINY["hidden_size"],
                        TINY["num_attention_heads"] * TINY["head_dim"])
    assert abs(wq.std().item() - TINY["hidden_size"] ** -0.5) < 0.05


def test_hf_qwen3_parity_through_load_hf_state_dict():
    from transformers import Qwen3Config, Qwen3ForCausalLM
    hf_cfg = Qwen3Config(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=8, num_key_value_heads=4, head_dim=8,
        vocab_size=128, max_position_embeddings=64, rope_theta=1e6,
        rms_norm_eps=1e-6, tie_word_embeddings=False,
        attention_bias=False, attention_dropout=0.0)
    torch.manual_seed(0)
    hf = Qwen3ForCausalLM(hf_cfg).eval()
    cfg = dataclasses.replace(
        ModelConfig.from_hf_config({**hf_cfg.to_dict(),
                                    "model_type": "qwen3"}),
        dtype=torch.float32)
    model = DenseLLM(cfg, device="cpu")
    params = model.load_hf_state_dict(hf.state_dict())
    ids = np.random.RandomState(0).randint(0, 128, size=(2, 8))
    ours, _ = model.forward(params, torch.from_numpy(ids),
                            _port_caches(model, 2, 16), 0)
    with torch.no_grad():
        theirs = hf(torch.from_numpy(ids)).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_sp_mode_raises():
    _, _, model, params = _pair(jnp.float32, torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.forward(params, torch.tensor([[1]]), _port_caches(model, 1, 4),
                      0, mode="sp")
