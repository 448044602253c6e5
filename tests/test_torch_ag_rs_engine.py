"""The fused TP mode "ag_rs" of the port against the JAX package's, on the
CPU: ``DenseLLM.forward`` in modes ag_rs and xla, and the two ag_rs
engines -- the reference engine (prefill "ag_rs", decode "gemm_ar") and
the all-fused one (prefill and decode "ag_rs") -- through ``serve``,
``serve_ragged``, ``serve_stream`` and the server.

A tiny f32 Qwen3 (2 layers, hidden 64, inter 128) at batch 2 x 64-token
prompts, so the prefill's M = 128 takes JAX's fused AG-SwiGLU kernel and
the decode batch composes AG-GEMM with a plain SwiGLU. The JAX side is
``DenseLLM(impl="pallas")`` on a 1-device mesh, its Pallas kernels in
interpret mode; weights cross through ``params_from_jax``. Logits within
1e-5 (f32 sums in other orders); greedy tokens identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import DenseLLM as JaxDense
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models.kv_cache import KVCacheManager as JaxKV
from triton_dist_tpu_torch.models import (
    DenseLLM, Engine, KVCacheManager, ModelConfig, params_from_jax)
from triton_dist_tpu_torch.ops import allgather_gemm
from triton_dist_tpu_torch.serving.client import ChatClient
from triton_dist_tpu_torch.serving.server import ModelServer

TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            vocab_size=96, max_position_embeddings=192)
B, S, MAX_SEQ, GEN = 2, 64, 160, 4
#: (prefill mode, decode mode) of the two engines.
ENGINES = {"reference": ("ag_rs", "gemm_ar"), "fused": ("ag_rs", "ag_rs")}


def _prompts():
    rng = np.random.RandomState(11)

    def rand(n):
        return rng.randint(1, TINY["vocab_size"], size=n).tolist()
    square = [rand(S) for _ in range(B)]
    ragged = [rand(S), rand(41)]
    # Admission buckets of 128 (the fused SwiGLU) and 32 (composed).
    stream = [rand(100), rand(20), rand(70)]
    return square, ragged, stream


SQUARE, RAGGED, STREAM = _prompts()


@pytest.fixture(scope="module")
def models():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jmodel = JaxDense(JaxConfig(dtype=jnp.float32, **TINY), mesh=mesh,
                      axis="tp", impl="pallas")
    jparams = jmodel.init(jax.random.PRNGKey(3))
    # The JAX engine runs its prefill eagerly, each interpret-mode Pallas
    # call traced anew (~10 s a prefill here); one jit of the forward is
    # shared by every prefill of both JAX engines (f32 within 1e-5 of the
    # eager result).
    jmodel.forward = jax.jit(jmodel.forward,
                             static_argnames=("mode", "remat"))
    model = DenseLLM(ModelConfig(dtype=torch.float32, **TINY), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def jax_tokens(models):
    """Each JAX engine's greedy outputs, computed once for the module."""
    jmodel, jparams, _, _ = models
    out = {}
    for name, (prefill, decode) in ENGINES.items():
        eng = JaxEngine(jmodel, batch=B, max_seq=MAX_SEQ,
                        prefill_mode=prefill, decode_mode=decode)
        out[name] = {
            "serve": np.asarray(eng.serve(
                jparams, jnp.asarray(SQUARE, jnp.int32), GEN)).tolist(),
            "ragged": [r.tolist() for r in
                       eng.serve_ragged(jparams, RAGGED, GEN)],
            "stream": eng.serve_stream(jparams, STREAM, GEN),
        }
    return out


def _engine(models, name):
    prefill, decode = ENGINES[name]
    return Engine(models[2], batch=B, max_seq=MAX_SEQ, prefill_mode=prefill,
                  decode_mode=decode)


@pytest.mark.parametrize("mode", ["ag_rs", "xla"])
def test_dense_forward_matches_jax(models, mode):
    jmodel, jparams, model, params = models
    c = jmodel.config
    ids = np.asarray(SQUARE, np.int64)
    jc = JaxKV(c.num_hidden_layers, B, 96, c.num_key_value_heads, c.head_dim,
               mesh=jmodel.mesh, dtype=c.dtype).init()
    tc = KVCacheManager(c.num_hidden_layers, B, 96, c.num_key_value_heads,
                        c.head_dim, dtype=torch.float32, device="cpu").init()
    jfwd = jmodel.forward                  # jitted by the fixture
    jl, jc = jfwd(jparams, jnp.asarray(ids, jnp.int32), jc, 0, mode=mode)
    tl, tc = model.forward(params, torch.from_numpy(ids), tc, 0, mode=mode)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    # One decode step (M = 2) from each side's own greedy token.
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = tl[:, -1].argmax(-1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    jl2, _ = jfwd(jparams, jtok, jc, S, mode=mode)
    tl2, _ = model.forward(params, ttok, tc, S, mode=mode)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-5,
                               atol=1e-5)


def test_model_default_mode_is_ag_rs(models):
    """The port's default forward is JAX's: mode ag_rs."""
    _, _, model, params = models
    assert model.fwd_mode == "ag_rs"
    caches = [KVCacheManager(2, B, 96, 2, 16, dtype=torch.float32,
                             device="cpu").init() for _ in range(2)]
    ids = torch.tensor(SQUARE)
    default, _ = model.forward(params, ids, caches[0], 0)
    fused, _ = model.forward(params, ids, caches[1], 0, mode="ag_rs")
    assert torch.equal(default, fused)


@pytest.mark.parametrize("name", list(ENGINES))
def test_engines_serve_greedy_matches_jax(models, jax_tokens, name):
    eng = _engine(models, name)
    params, want = models[3], jax_tokens[name]
    assert eng.serve(params, SQUARE, GEN).tolist() == want["serve"]
    assert [r.tolist() for r in eng.serve_ragged(params, RAGGED, GEN)] \
        == want["ragged"]
    assert eng.serve_stream(params, STREAM, GEN) == want["stream"]


def test_both_engines_and_the_default_modes_agree(models, jax_tokens):
    """f32: every mode computes the same products, so the greedy tokens of
    the two ag_rs engines equal those of the default (xla_ar / gemm_ar)
    engine."""
    plain = Engine(models[2], batch=B, max_seq=MAX_SEQ)
    out = plain.serve(models[3], SQUARE, GEN).tolist()
    assert out == jax_tokens["reference"]["serve"] \
        == jax_tokens["fused"]["serve"]


def test_prefill_takes_the_fused_swiglu_rule(models):
    """The engines' prefill M = 128 fuses; the decode batch and a 32-token
    admission bucket compose (JAX's rule, here on the CPU's plain
    versions)."""
    h, i = TINY["hidden_size"], TINY["intermediate_size"]
    assert allgather_gemm.swiglu_fuses(B * S, h, i, 4)
    assert allgather_gemm.swiglu_fuses(128, h, i, 4)
    assert not allgather_gemm.swiglu_fuses(B, h, i, 4)
    assert not allgather_gemm.swiglu_fuses(32, h, i, 4)


def test_stream_session_per_row_offsets_in_mode_ag_rs(models, jax_tokens):
    eng = _engine(models, "fused")
    sess = eng.stream_session(models[3])
    first = sess.prefill_into_row(1, STREAM[1])
    got = [first] + [int(sess.decode_step()[1]) for _ in range(GEN - 1)]
    assert STREAM[1] + got == jax_tokens["fused"]["stream"][1]
    assert sess.offsets.tolist() == [0, len(STREAM[1]) + GEN - 1]


@pytest.mark.parametrize("name", list(ENGINES))
def test_server_over_ag_rs_engine_answers_what_the_engine_answers(
        models, jax_tokens, name):
    eng = _engine(models, name)
    srv = ModelServer(eng, models[3], port=0).start()
    try:
        with ChatClient(srv.host, srv.port, timeout=120) as client:
            for prompts, key in ((SQUARE, "serve"), (RAGGED, "ragged"),
                                 (STREAM, "stream")):
                reply = client.generate_ids(prompts, GEN)
                want = [row[len(p):] for row, p in
                        zip(jax_tokens[name][key], prompts)]
                assert reply["tokens"] == want, key
    finally:
        srv.stop()
