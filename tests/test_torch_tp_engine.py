"""The world-4 engines and server of the port against the JAX package's,
on the CPU: the engines JAX's ``tdt-serve`` and the fused path run at world
W -- (prefill, decode) = (xla_ar, gemm_ar), (ag_rs, gemm_ar) and (ag_rs,
ag_rs) -- over a tiny f32 ``DenseLLM(world=4)`` (2 layers, hidden 64,
inter 512, 8/4 heads) through ``serve``, ``serve_ragged`` and
``serve_stream`` (5 prompts through the 4-row window), and the server over
each (which routes the 5 prompts to ``serve_stream``), on 4 x 32-token
prompts: greedy tokens equal the JAX engine's.

The JAX engines run its model with ``impl="xla"`` (its world-4 XLA bodies;
one interpret-mode engine here costs ~45 s a call pattern), so these tests
hold the serving loop at world 4 -- the sharded caches, the ragged and
per-row offsets, admission -- against JAX's. The ring kernels' numbers are
held against JAX's Pallas kernels by ``test_torch_tp_rings.py`` and, in the
model, by ``test_torch_tp_world.py``; one engine (ag_rs for both phases)
also runs against the JAX engine over ``impl="pallas"`` here. f32: every
mode computes the same products, so the tokens of every engine agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import DenseLLM as JaxDense
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu_torch.models import (
    DenseLLM, Engine, ModelConfig, params_from_jax)
from triton_dist_tpu_torch.serving.client import ChatClient
from triton_dist_tpu_torch.serving.server import ModelServer

W = 4
TINY = dict(hidden_size=64, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=4, head_dim=16,
            vocab_size=96, max_position_embeddings=192)
B, S, MAX_SEQ, GEN = 4, 32, 48, 3
#: (prefill mode, decode mode) of the engines.
ENGINES = {"default": ("xla_ar", "gemm_ar"), "reference": ("ag_rs", "gemm_ar"),
           "fused": ("ag_rs", "ag_rs")}


def _prompts():
    rng = np.random.RandomState(11)

    def rand(n):
        return rng.randint(1, TINY["vocab_size"], size=n).tolist()
    square = [rand(S) for _ in range(B)]
    ragged = [rand(S), rand(21), rand(30), rand(9)]
    stream = [rand(n) for n in (30, 20, 25, 31, 18)]   # one bucket of 32
    return square, ragged, stream


SQUARE, RAGGED, STREAM = _prompts()


@pytest.fixture(scope="module")
def models():
    mesh = Mesh(np.array(jax.devices()[:W]), ("tp",))
    jmodels = {impl: JaxDense(JaxConfig(dtype=jnp.float32, **TINY),
                              mesh=mesh, axis="tp", impl=impl)
               for impl in ("xla", "pallas")}
    jparams = jmodels["xla"].init(jax.random.PRNGKey(3))
    for jm in jmodels.values():
        jm.forward = jax.jit(jm.forward, static_argnames=("mode", "remat"))
    model = DenseLLM(ModelConfig(dtype=torch.float32, **TINY), device="cpu",
                     world=W)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return jmodels, jparams, model, params


@pytest.fixture(scope="module")
def jax_tokens(models):
    """Each JAX engine's greedy outputs, computed once for the module."""
    jmodels, jparams, _, _ = models
    out = {}
    for name, (prefill, decode) in ENGINES.items():
        eng = JaxEngine(jmodels["xla"], batch=B, max_seq=MAX_SEQ,
                        prefill_mode=prefill, decode_mode=decode)
        out[name] = {
            "serve": np.asarray(eng.serve(
                jparams, jnp.asarray(SQUARE, jnp.int32), GEN)).tolist(),
            "ragged": [r.tolist() for r in
                       eng.serve_ragged(jparams, RAGGED, GEN)],
            "stream": eng.serve_stream(jparams, STREAM, GEN),
        }
    return out


@pytest.mark.parametrize("name", list(ENGINES))
def test_world4_engines_serve_greedy_matches_jax(models, jax_tokens, name):
    prefill, decode = ENGINES[name]
    eng = Engine(models[2], batch=B, max_seq=MAX_SEQ, prefill_mode=prefill,
                 decode_mode=decode)
    params, want = models[3], jax_tokens[name]
    assert eng.serve(params, SQUARE, GEN).tolist() == want["serve"]
    assert [r.tolist() for r in eng.serve_ragged(params, RAGGED, GEN)] \
        == want["ragged"]
    assert eng.serve_stream(params, STREAM, GEN) == want["stream"]


@pytest.mark.parametrize("name", list(ENGINES))
def test_server_over_world4_engine_answers_what_jax_answers(
        models, jax_tokens, name):
    prefill, decode = ENGINES[name]
    eng = Engine(models[2], batch=B, max_seq=MAX_SEQ, prefill_mode=prefill,
                 decode_mode=decode)
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


def test_fused_engine_matches_the_jax_engine_over_its_pallas_rings(
        models, jax_tokens):
    jmodels, jparams, model, params = models
    jeng = JaxEngine(jmodels["pallas"], batch=B, max_seq=MAX_SEQ,
                     prefill_mode="ag_rs", decode_mode="ag_rs")
    want = np.asarray(jeng.serve(jparams, jnp.asarray(SQUARE, jnp.int32),
                                 GEN)).tolist()
    eng = Engine(model, batch=B, max_seq=MAX_SEQ, prefill_mode="ag_rs",
                 decode_mode="ag_rs")
    assert eng.serve(params, SQUARE, GEN).tolist() == want \
        == jax_tokens["fused"]["serve"]


def test_world4_engine_refuses_rows_that_do_not_split(models):
    """Decode rows shard over the ranks in mode ag_rs: 3 rows do not
    split over 4 (JAX asserts the same)."""
    eng = Engine(models[2], batch=B, max_seq=MAX_SEQ, prefill_mode="ag_rs",
                 decode_mode="ag_rs")
    with pytest.raises(ValueError, match="must split"):
        eng.serve(models[3], SQUARE[:3], GEN)
