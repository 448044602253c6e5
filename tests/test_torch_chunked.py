"""Chunked stream admission of the port (``StreamSession.prefill_into_row``
with ``chunk``, ``prefill_step``, ``cancel_prefill``, ``free_rows``)
against the JAX package's on the CPU.

A tiny f32 Qwen3 (2 layers, hidden 64, inter 128). A 13-token prompt is
admitted in chunks of 3 (five chunks, the last holding one real token)
and of 8 (two chunks, the last holding five) into row 0 while row 1
decodes, one shared decode step between chunks, as a scheduler
interleaves them; prefill modes "xla_ar" and "ag_rs" (decode "gemm_ar").
The JAX side is ``DenseLLM(impl="pallas")`` on a 1-device mesh, its
Pallas kernels in interpret mode (its forward jitted once for the
module); weights cross through ``params_from_jax``. Greedy tokens
identical; each chunk's logits within 1e-5 (f32 sums in other orders).
"""

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

TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            vocab_size=96, max_position_embeddings=64)
MAX_SEQ, GEN = 32, 4
_rng = np.random.RandomState(24)
#: The chunked prompt (13 tokens) and row 1's whole-admitted prompt.
PROMPT = _rng.randint(1, TINY["vocab_size"], size=13).tolist()
OTHER = _rng.randint(1, TINY["vocab_size"], size=6).tolist()
MODES = ["xla_ar", "ag_rs"]
CHUNKS = [3, 8]


@pytest.fixture(scope="module")
def models():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jmodel = JaxDense(JaxConfig(dtype=jnp.float32, **TINY), mesh=mesh,
                      axis="tp", impl="pallas")
    jparams = jmodel.init(jax.random.PRNGKey(5))
    jmodel.forward = jax.jit(jmodel.forward,
                             static_argnames=("mode", "remat"))
    model = DenseLLM(ModelConfig(dtype=torch.float32, **TINY), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return jmodel, jparams, model, params


def _interleaved(sess, chunk, decode_row1):
    """Row 1 admitted whole, then PROMPT admitted into row 0 in chunks of
    ``chunk`` with one shared decode step after each chunk that does not
    finish it; then GEN - 1 decode steps. Returns (row 0's tokens, row
    1's tokens, the free rows seen mid-chunk)."""
    row1 = [sess.prefill_into_row(1, OTHER)]
    first = sess.prefill_into_row(0, PROMPT, chunk=chunk)
    free_mid = list(sess.free_rows())
    while first is None:
        row1.append(decode_row1(sess))
        first = sess.prefill_step(0)
    row0 = [first]
    for _ in range(GEN - 1):
        toks = sess.decode_step()
        row0.append(int(toks[0]))
        row1.append(int(toks[1]))
    return row0, row1, free_mid


@pytest.fixture(scope="module")
def jax_runs(models):
    """JAX's interleaved runs, one per (mode, chunk), and its whole
    admission of PROMPT per mode."""
    jmodel, jparams, _, _ = models
    out = {}
    for mode in MODES:
        eng = JaxEngine(jmodel, batch=2, max_seq=MAX_SEQ, prefill_mode=mode,
                        decode_mode="gemm_ar")
        for chunk in CHUNKS:
            out[mode, chunk] = _interleaved(
                eng.stream_session(jparams), chunk,
                lambda s: int(s.decode_step()[1]))
        out[mode, None] = eng.stream_session(jparams).prefill_into_row(
            0, PROMPT)
    return out


def _engine(models, mode, **kw):
    return Engine(models[2], batch=2, max_seq=MAX_SEQ, prefill_mode=mode,
                  decode_mode="gemm_ar", **kw)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mode", MODES)
def test_chunked_admission_matches_jax(models, jax_runs, mode, chunk):
    eng = _engine(models, mode)
    row0, row1, free_mid = _interleaved(
        eng.stream_session(models[3]), chunk,
        lambda s: int(s.decode_step()[1]))
    want0, want1, want_free = jax_runs[mode, chunk]
    assert row0 == want0 and row1 == want1
    # Mid-chunk, row 0 is neither live nor free.
    assert free_mid == want_free == []
    # The chunked first token is the whole admission's.
    assert row0[0] == jax_runs[mode, None]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mode", MODES)
def test_chunk_logits_match_jax(models, mode, chunk):
    """Each chunk's logits from the engines' admit-chunk steps (JAX
    ``_build_admit_chunk``; the port's ``model.forward`` in the engine's
    prefill mode, as ``StreamSession.prefill_step`` runs it) over zeroed
    batch-1 scratch caches of the padded length."""
    jmodel, jparams, model, params = models
    jeng = JaxEngine(jmodel, batch=2, max_seq=MAX_SEQ, prefill_mode=mode,
                     decode_mode="gemm_ar")
    eng = _engine(models, mode)
    lb = -(-len(PROMPT) // chunk) * chunk
    ids = np.asarray([PROMPT + [0] * (lb - len(PROMPT))], np.int64)
    c = model.config
    shape = (1, lb, c.num_key_value_heads, c.head_dim)
    jsmall = [(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
              for _ in range(c.num_hidden_layers)]
    small = [(torch.zeros(shape), torch.zeros(shape))
             for _ in range(c.num_hidden_layers)]
    jstep = jeng._build_admit_chunk()
    for pos in range(0, lb, chunk):
        jl, jsmall = jstep(jparams, jsmall,
                           jnp.asarray(ids[:, pos:pos + chunk], jnp.int32),
                           jnp.int32(pos))
        with torch.no_grad():
            tl, small = eng.model.forward(
                params, torch.from_numpy(ids[:, pos:pos + chunk]), small,
                pos, mode=eng.prefill_mode)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
    for (k, v), (jk, jv) in zip(small, jsmall):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-5)


def test_cancel_prefill_leaves_the_row_admissible(models, jax_runs):
    eng = _engine(models, "xla_ar")
    sess = eng.stream_session(models[3])
    assert sess.prefill_into_row(0, PROMPT, chunk=3) is None
    assert sess.prefill_step(0) is None
    assert sess.free_rows() == [1]
    with pytest.raises(ValueError, match="occupied"):
        sess.prefill_into_row(0, OTHER)
    sess.cancel_prefill(0)
    assert sess.free_rows() == [0, 1] and sess.live == [False, False]
    # The row admits again, whole or chunked, with the JAX first token.
    assert sess.prefill_into_row(0, PROMPT) == jax_runs["xla_ar", None]
    sess.retire_row(0)
    first = sess.prefill_into_row(0, PROMPT, chunk=8)
    while first is None:
        first = sess.prefill_step(0)
    assert first == jax_runs["xla_ar", None]
    assert sess.free_rows() == [1] and sess.live == [True, False]
    sess.cancel_prefill(1)                 # no pending admission: a no-op
    assert sess.free_rows() == [1]


@pytest.fixture(scope="module")
def sp_model():
    cfg = ModelConfig(dtype=torch.float32, **TINY)
    model = DenseLLM(cfg, device="cpu", sp_axis="sp")
    return model, model.init(7)


@pytest.mark.parametrize("kind", ["sp", "paged", "long"])
def test_other_engines_admit_whole_whatever_chunk_says(models, sp_model,
                                                       kind):
    """Mode "sp" (contiguous), a paged engine and a prompt whose padded
    length (two chunks of 8 = 16) passes max_seq admit in one prefill:
    the first token at once, equal to an admission without ``chunk``."""
    if kind == "long":
        model, params = models[2], models[3]
        kw = dict(max_seq=15)
    else:
        model, params = sp_model
        kw = dict(max_seq=MAX_SEQ, prefill_mode="sp", decode_mode="sp",
                  paged=kind == "paged", page_size=4)

    def first(chunk):
        eng = Engine(model, batch=2, **kw)
        sess = eng.stream_session(params)
        tok = sess.prefill_into_row(0, PROMPT, chunk=chunk, gen_budget=GEN)
        assert sess.live[0] and sess.free_rows() == [1]
        return tok

    got = first(8)
    assert isinstance(got, int) and got == first(None)
