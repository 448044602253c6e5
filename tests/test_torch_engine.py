"""The port's engine and server (triton_dist_tpu_torch.models.engine,
.serving) against the JAX package's on the CPU: greedy tokens of
``serve``, ``serve_ragged`` and ``serve_stream`` must be identical to the
JAX ``Engine`` over ``DenseLLM(impl="pallas")`` (a 1-device mesh, the
gemm_ar Pallas kernel in interpret mode) on the same f32 weights; the
port's ``ModelServer``, driven by the JAX package's ``ChatClient``, must
return the JAX engine's tokens."""

import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import DenseLLM as JaxDense
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models import sample_token as jax_sample
from triton_dist_tpu.serving.client import ChatClient as JaxClient
from triton_dist_tpu_torch.models import (
    DenseLLM, Engine, ModelConfig, params_from_jax, sample_token)
from triton_dist_tpu_torch.serving.client import ChatClient, request_once
from triton_dist_tpu_torch.serving.server import ModelServer

TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            vocab_size=64, max_position_embeddings=64)
SQUARE = [[1, 2, 3, 4], [5, 6, 7, 8]]
RAGGED = [[1, 2, 3], [4, 5, 6, 7, 8]]
STREAM = [[1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11]]
GEN = 5


@pytest.fixture(scope="module")
def models():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jmodel = JaxDense(JaxConfig(dtype=jnp.float32, **TINY), mesh=mesh,
                      axis="tp", impl="pallas")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = DenseLLM(ModelConfig(dtype=torch.float32, **TINY), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX engine's greedy outputs, computed once for the module."""
    jmodel, jparams, _, _ = models
    eng = JaxEngine(jmodel, batch=2, max_seq=32)
    return {
        "serve": np.asarray(eng.serve(
            jparams, jnp.asarray(SQUARE, jnp.int32), GEN)).tolist(),
        "ragged": [r.tolist() for r in
                   eng.serve_ragged(jparams, RAGGED, GEN)],
        "stream": eng.serve_stream(jparams, STREAM, GEN),
    }


@pytest.fixture()
def engine(models):
    _, _, model, _ = models
    return Engine(model, batch=2, max_seq=32)


def test_serve_greedy_matches_jax(models, jax_tokens, engine):
    out = engine.serve(models[3], SQUARE, GEN)
    assert out.tolist() == jax_tokens["serve"]


def test_serve_ragged_greedy_matches_jax(models, jax_tokens, engine):
    rows = engine.serve_ragged(models[3], RAGGED, GEN)
    assert [r.tolist() for r in rows] == jax_tokens["ragged"]


def test_serve_stream_greedy_matches_jax(models, jax_tokens, engine):
    assert engine.serve_stream(models[3], STREAM, GEN) == jax_tokens["stream"]


def test_serve_stream_equals_serving_each_prompt_alone(models, jax_tokens,
                                                       engine):
    solo = Engine(models[2], batch=1, max_seq=32)
    for prompt, row in zip(STREAM, jax_tokens["stream"]):
        assert solo.serve(models[3], [prompt], GEN)[0].tolist() == row


def test_serve_stop_token_pads_stopped_rows(models, jax_tokens, engine):
    full = jax_tokens["serve"]
    stop = full[0][len(SQUARE[0]) + 1]           # row 0's 2nd new token
    out = engine.serve(models[3], SQUARE, GEN, stop_tokens=[stop]).tolist()
    for want, got in zip(full, out):
        gen = want[len(SQUARE[0]):]
        if stop in gen:
            cut = gen.index(stop) + 1
            gen = gen[:cut] + [stop] * (len(gen) - cut)
        assert got == want[:len(SQUARE[0])] + gen


def test_stream_session_verbs(models, jax_tokens):
    eng = Engine(models[2], batch=2, max_seq=32)
    sess = eng.stream_session(models[3])
    first = sess.prefill_into_row(1, STREAM[0])
    with pytest.raises(ValueError, match="occupied"):
        sess.prefill_into_row(1, STREAM[1])
    got = [first] + [int(sess.decode_step()[1]) for _ in range(GEN - 1)]
    assert STREAM[0] + got == jax_tokens["stream"][0]
    assert sess.live == [False, True]
    sess.retire_row(1)
    assert sess.live == [False, False]
    # Row 0 stayed free: it re-emits its token and does not advance.
    assert sess.offsets.tolist() == [0, len(STREAM[0]) + GEN - 1]
    # Chunked admission (2 + 2 + 1 tokens): row 0 is neither live nor
    # free until its last chunk lands with the JAX engine's first token.
    assert sess.prefill_into_row(0, STREAM[1], chunk=2) is None
    assert sess.free_rows() == [1]
    assert sess.prefill_step(0) is None
    assert sess.prefill_step(0) == \
        jax_tokens["stream"][1][len(STREAM[1])]
    assert sess.live == [True, False] and sess.free_rows() == [1]


@pytest.fixture()
def server(models):
    srv = ModelServer(Engine(models[2], batch=2, max_seq=32), models[3],
                      port=0).start()
    yield srv
    srv.stop()


def test_server_driven_by_jax_client_returns_jax_tokens(server, jax_tokens):
    client = JaxClient(server.host, server.port, timeout=60)
    try:
        for prompts, key in ((SQUARE, "serve"), (RAGGED, "ragged"),
                             (STREAM, "stream")):
            reply = client.generate_ids(prompts, GEN)
            assert reply["gen_len"] == GEN
            want = [row[len(p):] for row, p in zip(jax_tokens[key], prompts)]
            assert reply["tokens"] == want, key
    finally:
        client.close()


def test_server_with_port_client_and_request_once(server, jax_tokens):
    want = [row[len(p):] for row, p in zip(jax_tokens["ragged"], RAGGED)]
    with ChatClient(server.host, server.port, timeout=60) as client:
        assert client.generate_ids(RAGGED, GEN)["tokens"] == want
        # gen_len is clamped to the engine's room: max_seq - longest prompt.
        assert client.generate_ids([[1]], 100)["gen_len"] == 31
    reply = request_once(f"{server.host}:{server.port}",
                         {"prompt_ids": RAGGED, "gen_len": GEN}, timeout=60)
    assert reply["tokens"] == want


def test_server_refuses_control_verbs_and_bad_json(server):
    reply = request_once((server.host, server.port), {"cmd": "metrics"},
                         timeout=60)
    assert set(reply) == {"error"} and "unknown cmd" in reply["error"]
    client = JaxClient(server.host, server.port, timeout=60)
    try:
        with pytest.raises(RuntimeError):     # the JAX client's contract
            client.health()
    finally:
        client.close()
    with socket.create_connection((server.host, server.port),
                                  timeout=60) as s, s.makefile("rwb") as f:
        f.write(b"{not json\n")
        f.write(json.dumps({"prompt_ids": [[1]], "gen_len": 1}).encode()
                + b"\n")
        f.flush()
        bad, good = json.loads(f.readline()), json.loads(f.readline())
    assert bad["type"] == "JSONDecodeError" and "malformed" in bad["error"]
    assert len(good["tokens"][0]) == 1


_SP = {"prefill_mode": "sp", "decode_mode": "sp"}


@pytest.mark.parametrize("kwargs", [
    # Paged and sp serving, the prefix cache and chunked sp prefill are
    # ported (tests/test_torch_sp_engine.py); the decode paths and
    # speculation they can be combined with are not.
    {"paged": True, "decode_path": "mega", **_SP}, {"decode_path": "mega"},
    {"decode_path": "auto"}, {"use_mega": True}, {"spec": object()},
    {"prefill_chunk": 4, "use_mega": True, **_SP},
    {"spec": object(), **_SP},
    {"prefix_cache": True, "paged": True, "decode_path": "auto", **_SP},
], ids=["paged", "mega", "auto", "use_mega", "spec", "prefill_chunk", "sp",
        "prefix_cache"])
def test_unported_engine_options_raise(models, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(models[2], batch=2, max_seq=32, **kwargs)


def test_sample_token_greedy_matches_jax():
    logits = np.random.RandomState(4).randn(5, 37).astype(np.float32)
    logits[2, 3] = logits[2, 9] = logits[2].max() + 1    # a tie: first wins
    want = np.asarray(jax_sample(jnp.asarray(logits)))
    assert sample_token(torch.from_numpy(logits)).tolist() == want.tolist()


@pytest.mark.parametrize("kwargs", [{"top_k": 1}, {"top_p": 0.0}])
def test_sample_token_filters_degenerate_to_argmax(kwargs):
    logits = torch.from_numpy(
        np.random.RandomState(5).randn(6, 50).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    got = sample_token(logits, gen, temperature=0.7, **kwargs)
    assert torch.equal(got, logits.argmax(-1))


def test_temperature_serving_is_seeded(models):
    outs = [Engine(models[2], batch=2, max_seq=32, temperature=1.0,
                   seed=s).serve(models[3], SQUARE, GEN).tolist()
            for s in (7, 7, 8)]
    assert outs[0] == outs[1]
    assert all(0 <= t < TINY["vocab_size"] for row in outs[2] for t in row)
