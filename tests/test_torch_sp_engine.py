"""The port's mode-"sp" serving (paged and contiguous) against the JAX
package's on the CPU.

* The block allocator: random alloc / admit / ensure / release /
  register traces leave the port's ``PagedKVCacheManager`` with the JAX
  one's tables, free stacks, refcounts and commitments, and the prefix
  caches with the same sha1 block-hash chains.
* The engines: greedy tokens of the port's ``Engine`` (mode "sp",
  ``paged=True`` and contiguous) equal the JAX ``Engine`` over
  ``DenseLLM(impl="pallas", sp_axis="sp")`` on a 1-device ("tp", "sp")
  mesh (flash decode in Pallas interpret mode), on the same f32 weights,
  for ``serve``, ``serve_stream`` with prefix hits and with an
  oversubscribed pool, and through the port's ``ModelServer``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import DenseLLM as JaxDense
from triton_dist_tpu.models import Engine as JaxEngine
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models.kv_cache import (
    PagedKVCacheManager as JaxPaged)
from triton_dist_tpu.models.prefix_cache import PrefixCache as JaxPrefix
from triton_dist_tpu_torch.models import (
    DenseLLM, Engine, ModelConfig, params_from_jax)
from triton_dist_tpu_torch.models.kv_cache import PagedKVCacheManager
from triton_dist_tpu_torch.models.prefix_cache import PrefixCache
from triton_dist_tpu_torch.ops.sp_attention import (
    SpAttentionContext, sp_ag_attention)
from triton_dist_tpu_torch.serving.client import ChatClient
from triton_dist_tpu_torch.serving.server import ModelServer

TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            vocab_size=64, max_position_embeddings=64)
SP = dict(prefill_mode="sp", decode_mode="sp")
PAGED = dict(SP, paged=True, page_size=4)
SQUARE = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]]
PREFIX = [3, 1, 4, 1, 5, 9, 2, 6, 5]        # two full pages of 4 + one
STREAM = [PREFIX + [7], [11, 12, 13], PREFIX + [8, 9], PREFIX,
          PREFIX + [10, 11, 12]]
GEN = 5


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("tp", "sp"))


@pytest.fixture(scope="module")
def models(mesh):
    jmodel = JaxDense(JaxConfig(dtype=jnp.float32, **TINY), mesh=mesh,
                      axis="tp", impl="pallas", sp_axis="sp")
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = DenseLLM(ModelConfig(dtype=torch.float32, **TINY), device="cpu",
                     sp_axis="sp")
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX engines' greedy outputs, computed once for the module."""
    jmodel, jparams, _, _ = models
    paged = JaxEngine(jmodel, batch=2, max_seq=32, **PAGED)
    # Greedy results do not depend on the pool size or the cache layout:
    # the JAX paged engine's serve and stream are the reference of every
    # port engine below, contiguous ones included (the JAX contiguous
    # decode, the einsum kernel, is held against the port's plain flash
    # decode in tests/test_torch_flash_decode.py).
    return {
        "paged_serve": np.asarray(paged.serve(
            jparams, jnp.asarray(SQUARE, jnp.int32), GEN)).tolist(),
        "paged_stream": paged.serve_stream(jparams, STREAM, GEN),
    }


def test_paged_serve_greedy_matches_jax(models, jax_tokens):
    eng = Engine(models[2], batch=2, max_seq=32, **PAGED)
    assert eng.serve(models[3], SQUARE, GEN).tolist() == \
        jax_tokens["paged_serve"]
    assert eng.kv.owned_rows() == [0, 1]


def test_paged_serve_stream_with_prefix_hits_matches_jax(models,
                                                         jax_tokens):
    eng = Engine(models[2], batch=2, max_seq=32, **PAGED)
    assert eng.serve_stream(models[3], STREAM, GEN) == \
        jax_tokens["paged_stream"]
    stats = eng.kv.prefix.stats()
    assert stats["hit_blocks"] > 0
    audit = eng.kv.block_audit()
    assert audit["active"] == 0 and audit["committed"] == 0
    assert audit["free"] + audit["evictable"] == audit["total"]
    # The prefix cache changes no greedy token.
    cold = Engine(models[2], batch=2, max_seq=32, prefix_cache=False,
                  **PAGED)
    assert cold.serve_stream(models[3], STREAM, GEN) == \
        jax_tokens["paged_stream"]
    assert cold.kv.prefix is None


def test_paged_serve_stream_oversubscribed_pool_matches_jax(models,
                                                            jax_tokens):
    """Six 4-token blocks hold one request at a time (each needs up to
    four), so admission waits for retirements and evicts cached blocks."""
    eng = Engine(models[2], batch=2, max_seq=32, kv_slots_per_dev=6,
                 **PAGED)
    assert eng.serve_stream(models[3], STREAM, GEN) == \
        jax_tokens["paged_stream"]
    assert eng.kv.block_audit()["active"] == 0
    with pytest.raises(ValueError, match="never fit"):
        eng.serve_stream(models[3], [list(range(1, 30))], 3)


def test_contiguous_sp_serve_and_stream_match_jax(models, jax_tokens):
    eng = Engine(models[2], batch=2, max_seq=32, **SP)
    assert eng.serve(models[3], SQUARE, GEN).tolist() == \
        jax_tokens["paged_serve"]
    assert eng.serve_stream(models[3], STREAM, GEN) == \
        jax_tokens["paged_stream"]
    chunked = Engine(models[2], batch=2, max_seq=32, prefill_chunk=2, **SP)
    assert chunked.serve(models[3], SQUARE, GEN).tolist() == \
        jax_tokens["paged_serve"]


def test_sp_modes_give_the_default_modes_tokens(models, jax_tokens):
    """Mode "sp" computes the same model as xla_ar / gemm_ar."""
    plain = Engine(DenseLLM(models[2].config, device="cpu"), batch=2,
                   max_seq=32)
    assert plain.serve(models[3], SQUARE, GEN).tolist() == \
        jax_tokens["paged_serve"]


def test_sp_serving_is_non_ragged(models):
    eng = Engine(models[2], batch=2, max_seq=32, **PAGED)
    with pytest.raises(ValueError, match="non-ragged"):
        eng.serve_ragged(models[3], [[1, 2], [3, 4, 5]], GEN)
    with pytest.raises(NotImplementedError, match="Queue A item 11"):
        models[2].forward(models[3], torch.tensor([[1, 2], [3, 4]]),
                          eng.kv.init(), torch.tensor([3, 4]), mode="sp")


@pytest.mark.parametrize("kwargs,match", [
    ({"paged": True}, "sp modes"),
    ({"prefill_mode": "sp"}, "together"),
    ({"prefill_chunk": 4, **PAGED}, "non-paged"),
    ({"page_size": 5, **{k: v for k, v in PAGED.items()
                         if k != "page_size"}}, "pages"),
], ids=["paged-without-sp", "half-sp", "chunk-paged", "page-size"])
def test_sp_engine_options_are_checked(models, kwargs, match):
    with pytest.raises(ValueError, match=match):
        Engine(models[2], batch=2, max_seq=32, **kwargs)


def test_sp_engine_needs_an_sp_model(models):
    with pytest.raises(ValueError, match="sp_axis"):
        Engine(DenseLLM(models[2].config, device="cpu"), batch=2,
               max_seq=32, **SP)


def test_stream_session_paged_verbs(models, jax_tokens):
    eng = Engine(models[2], batch=2, max_seq=32, **PAGED)
    sess = eng.stream_session(models[3])
    assert sess.can_admit(len(STREAM[0]), GEN)
    assert sess.admission_need(len(STREAM[0]), GEN).tolist() == [4]
    first = sess.prefill_into_row(1, STREAM[0], gen_budget=GEN)
    got = [first] + [int(sess.decode_step()[1]) for _ in range(GEN - 1)]
    assert STREAM[0] + got == jax_tokens["paged_stream"][0]
    # Row 0 stayed on the sentinel page: every lane holds slot 16.
    assert (eng.kv._table[0, 0] == eng.kv.slots_per_dev).all()
    hit = sess.prefill_into_row(0, STREAM[2], gen_budget=GEN)
    assert sess.admit_info == {"cached": 8} and isinstance(hit, int)
    sess.close()
    assert eng.kv.block_audit()["active"] == 0
    assert sess.live == [False, False]


def test_sp_attention_refuses_unported_impls():
    """Every impl runs at world 1; a larger world is not ported yet."""
    q = torch.zeros((1, 4, 2, 8))
    ctx = SpAttentionContext(world_size=2)
    for impl in ("pallas", "ag_pallas", "ulysses"):
        assert sp_ag_attention(q, q, q, impl=impl).shape == q.shape
        with pytest.raises(NotImplementedError, match="Queue B item 6"):
            sp_ag_attention(q, q, q, ctx, impl=impl)


@pytest.fixture()
def server(models):
    srv = ModelServer(Engine(models[2], batch=2, max_seq=32, **PAGED),
                      models[3], port=0).start()
    yield srv
    srv.stop()


def test_server_over_paged_sp_engine(server, jax_tokens):
    with ChatClient(server.host, server.port, timeout=60) as client:
        reply = client.generate_ids(SQUARE, GEN)
        assert reply["tokens"] == [r[len(p):] for r, p in
                                   zip(jax_tokens["paged_serve"], SQUARE)]
        reply = client.generate_ids(STREAM, GEN)     # more prompts than rows
        assert reply["tokens"] == [r[len(p):] for r, p in
                                   zip(jax_tokens["paged_stream"], STREAM)]
        reply = client.generate_ids([[1, 2], [3, 4, 5]], GEN)
        assert "non-ragged" in reply["error"] and "tokens" not in reply


# -- the allocator ------------------------------------------------------------
def _state(mgr):
    top = mgr._top.copy()
    return {"table": mgr._table.copy(), "top": top,
            "stack": [mgr._stack[r, :top[r]].tolist()
                      for r in range(len(top))],
            "owned": mgr._owned.copy(), "ref": mgr._ref.copy(),
            "row_blocks": mgr._row_blocks.copy(),
            "committed": mgr._committed.copy(),
            "row_commit": mgr._row_commit.copy(),
            "audit": mgr.block_audit(),
            "prefix": None if mgr.prefix is None else mgr.prefix.stats()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


def _both(jmgr, mgr, op, *args, **kwargs):
    """Apply one call to both managers: the same result or the same
    failure, then the same state."""
    outs = []
    for m in (jmgr, mgr):
        try:
            outs.append(("ok", getattr(m, op)(*args, **kwargs)))
        except (AssertionError, RuntimeError, ValueError):
            outs.append(("raised", None))
    assert outs[0][0] == outs[1][0], (op, args, outs)
    if op == "block_table":
        return outs
    if outs[0][0] == "ok" and not isinstance(outs[0][1], np.ndarray):
        assert outs[0][1] == outs[1][1], (op, args, outs)
    _assert_same(_state(jmgr), _state(mgr))
    return outs


@pytest.mark.parametrize("seed", range(4))
def test_block_allocator_traces_match_jax(mesh, seed):
    rng = np.random.RandomState(seed)
    batch, page, npg = 3, 4, 5
    slots = int(rng.choice([6, 9, 15]))
    jmgr = JaxPaged(1, batch, page, npg, 2, 8, mesh=mesh, axis="sp",
                    dtype=jnp.float32, slots_per_dev=slots)
    mgr = PagedKVCacheManager(1, batch, page, npg, 2, 8,
                              dtype=torch.float32, device="cpu",
                              slots_per_dev=slots)
    # Seq-granular churn first, then the block-granular substrate.
    for _ in range(12):
        op = rng.choice(["alloc_seq", "free_seq", "alloc_many"])
        if op == "alloc_many":
            _both(jmgr, mgr, op, list(rng.choice(batch, 2, replace=False)))
        else:
            _both(jmgr, mgr, op, int(rng.randint(batch)))
    _both(jmgr, mgr, "stream_setup", prefix_cache=bool(seed % 3))
    stems = [[5, 6, 7, 8, 1, 2, 3, 4], [5, 6, 7, 8, 9, 9, 9, 9], [2, 2]]
    live = {}
    for _ in range(60):
        b = int(rng.randint(batch))
        if b in live and rng.rand() < 0.3:
            _both(jmgr, mgr, "release_row", b)
            del live[b]
        elif b in live:
            prompt_len, budget, pos = live[b]
            if pos < prompt_len + budget - 1:
                _both(jmgr, mgr, "ensure_position", b, pos)
                live[b][2] += 1
        else:
            stem = stems[rng.randint(len(stems))]
            prompt = stem + list(rng.randint(1, 9, rng.randint(0, 7)))
            budget = int(rng.randint(1, 6))
            if len(prompt) + budget > page * npg:
                continue
            hashes = mgr.prefix_hashes(prompt)
            assert hashes == jmgr.prefix_hashes(prompt)
            k = mgr.prefix_probe(prompt, hashes=hashes)
            assert k == jmgr.prefix_probe(prompt)
            _both(jmgr, mgr, "can_admit", len(prompt), budget)
            outs = _both(jmgr, mgr, "admit_row", b, prompt,
                         gen_budget=budget, use_hits=k, hashes=hashes)
            if outs[0][0] == "ok":
                _both(jmgr, mgr, "register_prefix", b, prompt,
                      hashes=hashes)
                live[b] = [len(prompt), budget, len(prompt)]
    for b in list(live):
        _both(jmgr, mgr, "release_row", b)
    audit = mgr.block_audit()
    assert audit["active"] == 0 and audit["committed"] == 0
    np.testing.assert_array_equal(np.asarray(jmgr.block_table()),
                                  mgr.block_table().numpy())


def test_prefix_hash_chain_is_the_jax_chain():
    rng = np.random.RandomState(7)
    for page in (1, 4, 16):
        tokens = rng.randint(0, 151936, 70).tolist()
        assert (PrefixCache(1, page).block_hashes(tokens)
                == JaxPrefix(1, page).block_hashes(tokens))
    assert PrefixCache(1, 4).block_hashes([1, 2, 3]) == []


def test_paged_addressing_matches_jax(mesh):
    rng = np.random.RandomState(3)
    table = rng.permutation(12)[:10].reshape(1, 2, 5).astype(np.int32)
    pool = rng.randn(13, 4, 2, 8).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    for off in (0, 6, 19):
        jg, jip = JaxPaged.position_to_slot(jt, off, 4, 13)
        g, ip = PagedKVCacheManager.position_to_slot(tt, off, 4, 13)
        assert np.asarray(jg).tolist() == g.tolist()
        assert int(jip) == int(ip)
    posn = np.arange(20)
    jg, jip = JaxPaged.position_to_slot(jt, jnp.asarray(posn), 4, 13)
    g, ip = PagedKVCacheManager.position_to_slot(tt, torch.from_numpy(posn),
                                                 4, 13)
    assert np.asarray(jg).tolist() == g.tolist()
    assert np.asarray(jip).tolist() == ip.tolist()
    offs = np.array([3, 17], np.int32)
    jg, jip = JaxPaged.position_to_slot_rows(jt, jnp.asarray(offs), 4, 13)
    g, ip = PagedKVCacheManager.position_to_slot_rows(
        tt, torch.from_numpy(offs), 4, 13)
    assert np.asarray(jg).tolist() == g.tolist()
    assert np.asarray(jip).tolist() == ip.tolist()
    want = JaxPaged.gathered_view(jnp.asarray(pool), jt, 1)
    got = PagedKVCacheManager.gathered_view(torch.from_numpy(pool), tt)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_pools_are_separate_tensors():
    mgr = PagedKVCacheManager(2, 2, 4, 3, 2, 8, dtype=torch.float32,
                              device="cpu")
    pools = mgr.init()
    ptrs = {t.data_ptr() for kv in pools for t in kv}
    assert len(ptrs) == 4
    assert pools[0][0].shape == (2 * 3 + 1, 4, 2, 8)   # + the sentinel
