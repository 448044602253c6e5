"""The port's Qwen3-MoE against the JAX package's, on the CPU.

A tiny f32 Qwen3-MoE (2 layers, hidden 64, 8 experts, top-2, expert width
64) at batch 2 x 64-token prompts, so a prefill routes 256 pairs. The
JAX side is ``Qwen3MoE(impl="pallas", sp_axis="sp")`` on a 1-device
("tp", "sp") mesh, its Pallas kernels in interpret mode and its forward
jitted once in the fixture; weights cross through ``params_from_jax``.

* ``TPMoE`` and ``Qwen3MoE.forward`` in modes xla_ar, gemm_ar, ag_rs, xla
  and sp: each layer's routing indices equal JAX's ``topk_routing`` on
  the same router logits (asserted first), then logits within 1e-5 (f32
  sums in other orders).
* The default (prefill xla_ar, decode gemm_ar), all-ag_rs and paged sp
  engines through ``serve``, ``serve_ragged`` (not sp), ``serve_stream``
  and the server: greedy tokens identical to the JAX engine's.
* ``AutoLLM`` builds and loads the right model (a random-init HF
  ``Qwen3MoeForCausalLM`` through ``from_pretrained`` matches HF's logits
  within 1e-5), ``DenseLLM`` refuses an MoE config, and the server's
  model construction of the ``qwen3-30b-a3b`` preset yields a
  ``Qwen3MoE``.
"""

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
from triton_dist_tpu.ops.moe_utils import topk_routing as jax_topk_routing
from triton_dist_tpu_torch.layers import tp_moe
from triton_dist_tpu_torch.models import (
    AutoLLM, DenseLLM, Engine, KVCacheManager, ModelConfig, Qwen3MoE,
    params_from_jax, qwen_moe)
from triton_dist_tpu_torch.ops import moe_utils
from triton_dist_tpu_torch.serving import server
from triton_dist_tpu_torch.serving.client import ChatClient
from triton_dist_tpu_torch.serving.server import ModelServer

TINY = dict(hidden_size=64, intermediate_size=0, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            vocab_size=96, max_position_embeddings=192, num_experts=8,
            num_experts_per_tok=2, moe_intermediate_size=64)
B, S, MAX_SEQ, GEN = 2, 64, 128, 4
PAGED = dict(paged=True, page_size=8)
#: name -> (prefill mode, decode mode, extra Engine options).
ENGINES = {"default": ("xla_ar", "gemm_ar", {}),
           "ag_rs": ("ag_rs", "ag_rs", {}),
           "paged_sp": ("sp", "sp", PAGED)}
MODES = ["xla_ar", "gemm_ar", "ag_rs", "xla", "sp"]


def _prompts():
    rng = np.random.RandomState(12)

    def rand(n):
        return rng.randint(1, TINY["vocab_size"], size=n).tolist()
    square = [rand(S) for _ in range(B)]
    ragged = [rand(S), rand(37)]
    stream = [rand(40), rand(20), rand(56)]
    return square, ragged, stream


SQUARE, RAGGED, STREAM = _prompts()


@pytest.fixture(scope="module")
def models():
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("tp", "sp"))
    jmodel = JaxMoE(JaxConfig(dtype=jnp.float32, **TINY), mesh=mesh,
                    axis="tp", impl="pallas", sp_axis="sp")
    jparams = jmodel.init(jax.random.PRNGKey(4))
    # One jit of the forward serves every prefill and decode of the JAX
    # engines (its interpret-mode Pallas calls are slow to run eagerly).
    jmodel.forward = jax.jit(jmodel.forward,
                             static_argnames=("mode",))
    model = Qwen3MoE(ModelConfig(dtype=torch.float32, **TINY), device="cpu",
                     sp_axis="sp")
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def jax_tokens(models):
    """Each JAX engine's greedy outputs, computed once for the module."""
    jmodel, jparams, _, _ = models
    out = {}
    for name, (prefill, decode, kw) in ENGINES.items():
        eng = JaxEngine(jmodel, batch=B, max_seq=MAX_SEQ,
                        prefill_mode=prefill, decode_mode=decode, **kw)
        out[name] = {
            "serve": np.asarray(eng.serve(
                jparams, jnp.asarray(SQUARE, jnp.int32), GEN)).tolist(),
            "stream": eng.serve_stream(jparams, STREAM, GEN),
        }
        if prefill != "sp":
            out[name]["ragged"] = [r.tolist() for r in
                                   eng.serve_ragged(jparams, RAGGED, GEN)]
    return out


def _record_routing(monkeypatch):
    """Record (router logits, indices) of every routing call of the port's
    MoE (the layer and the sp FFN)."""
    seen = []

    def recording(logits, k, norm=True):
        w, idx = moe_utils.topk_routing(logits, k, norm)
        seen.append((logits.detach().numpy().copy(), idx.numpy().copy(), k,
                     norm))
        return w, idx
    monkeypatch.setattr(tp_moe, "topk_routing", recording)
    monkeypatch.setattr(qwen_moe, "topk_routing", recording)
    return seen


def _assert_routing_matches_jax(seen, calls):
    assert len(seen) == calls
    for logits, idx, k, norm in seen:
        _, jidx = jax_topk_routing(jnp.asarray(logits), k, norm)
        np.testing.assert_array_equal(idx, np.asarray(jidx))


def test_tp_moe_layer_matches_jax(models, monkeypatch):
    jmodel, jparams, model, params = models
    x = np.random.RandomState(5).randn(B * S, 64).astype(np.float32)
    jmoe = JaxTPMoE(64, 64, 8, 2, mesh=jmodel.mesh, axis="tp",
                    dtype=jnp.float32, impl="pallas")
    lp, jlp = params["layers"][0]["moe"], jparams["layers"][0]["moe"]
    for mode in ("ag_rs", "xla"):
        seen = _record_routing(monkeypatch)
        got = model.moe(lp, torch.from_numpy(x), mode=mode)
        _assert_routing_matches_jax(seen, 1)
        want = jmoe(jlp, jnp.asarray(x), mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_moe_forward_matches_jax(models, mode, monkeypatch):
    jmodel, jparams, model, params = models
    c = jmodel.config
    layers, kvh, d = c.num_hidden_layers, c.num_key_value_heads, c.head_dim
    ids = np.asarray(SQUARE, np.int64)
    if mode == "sp":
        jc = JaxKV(layers, B, 96, kvh, d, mesh=jmodel.mesh, axis="sp",
                   seq_shard=True, dtype=c.dtype).init()
    else:
        jc = JaxKV(layers, B, 96, kvh, d, mesh=jmodel.mesh,
                   dtype=c.dtype).init()
    tc = KVCacheManager(layers, B, 96, kvh, d, dtype=torch.float32,
                        device="cpu").init()
    seen = _record_routing(monkeypatch)
    tl, tc = model.forward(params, torch.from_numpy(ids), tc, 0, mode=mode)
    _assert_routing_matches_jax(seen, layers)
    jl, jc = jmodel.forward(jparams, jnp.asarray(ids, jnp.int32), jc, 0,
                            mode=mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    # One decode step (M = 2) from each side's own greedy token.
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = tl[:, -1].argmax(-1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    seen.clear()
    tl2, _ = model.forward(params, ttok, tc, S, mode=mode)
    _assert_routing_matches_jax(seen, layers)
    jl2, _ = jmodel.forward(jparams, jtok, jc, S, mode=mode)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-5,
                               atol=1e-5)


def _engine(models, name):
    prefill, decode, kw = ENGINES[name]
    return Engine(models[2], batch=B, max_seq=MAX_SEQ, prefill_mode=prefill,
                  decode_mode=decode, **kw)


@pytest.mark.parametrize("name", list(ENGINES))
def test_moe_engines_serve_greedy_matches_jax(models, jax_tokens, name):
    eng = _engine(models, name)
    params, want = models[3], jax_tokens[name]
    assert eng.serve(params, SQUARE, GEN).tolist() == want["serve"]
    if "ragged" in want:
        assert [r.tolist() for r in eng.serve_ragged(params, RAGGED, GEN)] \
            == want["ragged"]
    assert eng.serve_stream(params, STREAM, GEN) == want["stream"]


@pytest.mark.parametrize("name", list(ENGINES))
def test_server_over_moe_engine_answers_what_jax_answers(models, jax_tokens,
                                                         name):
    eng = _engine(models, name)
    srv = ModelServer(eng, models[3], port=0).start()
    try:
        with ChatClient(srv.host, srv.port, timeout=120) as client:
            for prompts, key in ((SQUARE, "serve"), (RAGGED, "ragged"),
                                 (STREAM, "stream")):
                reply = client.generate_ids(prompts, GEN)
                if key not in jax_tokens[name]:
                    assert "non-ragged" in reply.get("error", ""), reply
                    continue
                want = [row[len(p):] for row, p in
                        zip(jax_tokens[name][key], prompts)]
                assert reply["tokens"] == want, key
    finally:
        srv.stop()


# -- AutoLLM, DenseLLM's guard, the server's construction --------------------------
def _tiny_config(**kw):
    return ModelConfig(dtype=torch.float32, **dict(TINY, **kw))


def test_autollm_builds_by_config():
    moe = AutoLLM.build(_tiny_config(), device="cpu")
    dense = AutoLLM.build(_tiny_config(num_experts=0, intermediate_size=96),
                          device="cpu")
    assert type(moe) is Qwen3MoE and type(dense) is DenseLLM
    assert moe.fwd_mode == dense.fwd_mode == "ag_rs"
    sp = AutoLLM.build(_tiny_config(), device="cpu", sp_axis="sp")
    assert sp.sp_axis == "sp"


def test_dense_refuses_an_moe_config():
    with pytest.raises(ValueError, match="Qwen3MoE"):
        DenseLLM(_tiny_config(), device="cpu")
    with pytest.raises(ValueError, match="DenseLLM"):
        Qwen3MoE(_tiny_config(num_experts=0, intermediate_size=96),
                 device="cpu")
    # Expert parallelism and TP MoE over more than one rank are ported
    # (tests/test_torch_ep_moe.py and test_torch_tp_moe_world.py hold them
    # against JAX).
    assert Qwen3MoE(_tiny_config(), device="cpu",
                    moe_parallel="ep").moe_parallel == "ep"
    assert Qwen3MoE(_tiny_config(), device="cpu", world=2).moe.world == 2


def test_server_builds_the_moe_preset_as_qwen3_moe():
    args = server.parse_args(["--preset", "qwen3-30b-a3b", "--device", "cpu"])
    tiny = dict(TINY, dtype=torch.float32)
    model, params = server.build_model(args, **tiny)
    assert type(model) is Qwen3MoE and model.config.num_experts == 8
    assert params["layers"][0]["moe"]["w_router"].dtype == torch.float32
    # Full width, were it not overridden: the preset's MoE fields.
    full = server.preset_config(args)
    assert (full.num_experts, full.num_experts_per_tok,
            full.moe_intermediate_size) == (128, 8, 768)


def test_params_from_jax_keeps_the_router_f32():
    rng = np.random.RandomState(0)
    tree = {"embed": rng.randn(6, 4), "lm_head": rng.randn(6, 4),
            "layers": [{"moe": {"w_router": rng.randn(4, 2),
                                "w_gate": rng.randn(2, 4, 3)}}]}
    cfg = _tiny_config()
    cfg.dtype = torch.bfloat16
    got = params_from_jax(tree, cfg, "cpu")["layers"][0]["moe"]
    assert got["w_router"].dtype == torch.float32
    assert got["w_gate"].dtype == torch.bfloat16


def test_from_pretrained_matches_hf_qwen3_moe(tmp_path):
    from transformers import Qwen3MoeConfig, Qwen3MoeForCausalLM
    torch.manual_seed(0)
    hf_cfg = Qwen3MoeConfig(
        vocab_size=96, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        num_experts=8, num_experts_per_tok=2, norm_topk_prob=True,
        max_position_embeddings=128, tie_word_embeddings=False)
    hf = Qwen3MoeForCausalLM(hf_cfg).eval()
    hf.save_pretrained(tmp_path)
    model, params = AutoLLM.from_pretrained(str(tmp_path), device="cpu",
                                            dtype=torch.float32)
    assert type(model) is Qwen3MoE
    ids = torch.from_numpy(np.asarray([SQUARE[0][:24], SQUARE[1][:24]]))
    caches = KVCacheManager(2, 2, 32, 2, 16, dtype=torch.float32,
                            device="cpu").init()
    got, _ = model.forward(params, ids, caches, 0)
    with torch.no_grad():
        want = hf(ids).logits
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
