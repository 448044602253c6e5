"""Mode-"sp" serving at sequence world 4: the port's contiguous and paged
sp engines and its server over a tiny f32 ``DenseLLM(sp_axis="sp",
sp_world=4)`` against the JAX ``Engine`` over ``DenseLLM(impl="pallas",
sp_axis="sp")`` on a (1, 4) ("tp", "sp") mesh of the 8-device CPU mesh
(flash decode in Pallas interpret mode), on the same weights: greedy
tokens equal for ``serve`` (prompts of 8, a multiple of the world), the
contiguous engine's ``prefill_chunk`` stream, ``serve_stream`` with
prefix hits through a pool of one lane per rank, and the server. The
ops, layers, allocator and model are ``test_torch_sp_world.py``'s."""

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
    AutoLLM, Engine, ModelConfig, params_from_jax)
from triton_dist_tpu_torch.ops import flash_decode as fd
from triton_dist_tpu_torch.serving.client import ChatClient
from triton_dist_tpu_torch.serving.server import ModelServer

W = 4
TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=4, head_dim=16,
            vocab_size=96, max_position_embeddings=64)
SP = dict(prefill_mode="sp", decode_mode="sp")
PAGED = dict(SP, paged=True, page_size=4)
SQUARE = [[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16]]
PREFIX = [3, 1, 4, 1, 5, 9, 2, 6, 5]        # two full pages of 4 + one
STREAM = [PREFIX + [7], [11, 12, 13], PREFIX + [8, 9], PREFIX]
GEN = 4


@pytest.fixture(scope="module")
def models():
    mesh = Mesh(np.array(jax.devices()[:W]).reshape(1, W), ("tp", "sp"))
    jmodel = JaxDense(JaxConfig(dtype=jnp.float32, **TINY), mesh=mesh,
                      axis="tp", impl="pallas", sp_axis="sp")
    jparams = jmodel.init(jax.random.PRNGKey(5))
    model = AutoLLM.build(ModelConfig(dtype=torch.float32, **TINY),
                          device="cpu", sp_axis="sp", sp_world=W)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX paged engine's greedy outputs, computed once: greedy
    results depend on neither the pool nor the cache layout, so they are
    the reference of every port engine below."""
    jmodel, jparams, _, _ = models
    paged = JaxEngine(jmodel, batch=2, max_seq=32, **PAGED)
    assert paged.kv.world == W and paged.kv.pages_per_seq_dev == 2
    return {
        "serve": np.asarray(paged.serve(
            jparams, jnp.asarray(SQUARE, jnp.int32), GEN)).tolist(),
        "stream": paged.serve_stream(jparams, STREAM, GEN),
    }


def test_world4_paged_engine_matches_jax(models, jax_tokens):
    eng = Engine(models[2], batch=2, max_seq=32, **PAGED)
    assert eng.kv.world == W and eng.kv.pages_per_seq_dev == 2
    assert eng.serve(models[3], SQUARE, GEN).tolist() == jax_tokens["serve"]
    assert eng.kv.block_table().shape == (W, 2, 2)
    assert eng.serve_stream(models[3], STREAM, GEN) == jax_tokens["stream"]
    assert eng.kv.prefix.stats()["hit_blocks"] > 0
    audit = eng.kv.block_audit()
    assert audit["active"] == 0 and audit["committed"] == 0
    assert audit["total"] == W * eng.kv.slots_per_dev


def test_world4_contiguous_engine_matches_jax(models, jax_tokens):
    eng = Engine(models[2], batch=2, max_seq=32, **SP)
    assert eng.kv.world == W and eng.kv.seq_shard
    before = {n: c.total for n, c in fd.launches.items()}
    assert eng.serve(models[3], SQUARE, GEN).tolist() == jax_tokens["serve"]
    assert eng.serve_stream(models[3], STREAM, GEN) == jax_tokens["stream"]
    assert {n: c.total for n, c in fd.launches.items()} == before
    chunked = Engine(models[2], batch=2, max_seq=32, prefill_chunk=4, **SP)
    assert chunked.serve(models[3], SQUARE, GEN).tolist() == \
        jax_tokens["serve"]


def test_world4_engine_checks_its_geometry(models):
    with pytest.raises(ValueError, match="4 devices x 4-token pages"):
        Engine(models[2], batch=2, max_seq=24, **PAGED)
    sess = Engine(models[2], batch=2, max_seq=32, **SP).stream_session(
        models[3])
    assert [sess._bucket(n) for n in (3, 8, 9)] == [8, 8, 16]


@pytest.fixture()
def server(models):
    srv = ModelServer(Engine(models[2], batch=2, max_seq=32, **PAGED),
                      models[3], port=0).start()
    yield srv
    srv.stop()


def test_server_over_world4_paged_engine(server, jax_tokens):
    with ChatClient(server.host, server.port, timeout=60) as client:
        reply = client.generate_ids(SQUARE, GEN)
        assert reply["tokens"] == [r[len(p):] for r, p in
                                   zip(jax_tokens["serve"], SQUARE)]
        reply = client.generate_ids(STREAM, GEN)     # more prompts than rows
        assert reply["tokens"] == [r[len(p):] for r, p in
                                   zip(jax_tokens["stream"], STREAM)]
