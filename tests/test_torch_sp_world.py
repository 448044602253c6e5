"""Sequence parallelism at world W: the port's flash decode, SP prefill
attention, SP layers, paged allocator and a tiny ``DenseLLM`` in mode
"sp" over W ranks of the sequence axis, against the JAX package's on W
devices of the 8-device CPU mesh (a ("tp", "sp") mesh of shape (1, W)).

* ``combine_peer`` / ``combine_src`` over worlds 1..8.
* ``gqa_fwd_batch_decode`` (JAX variants einsum and tiled in Pallas
  interpret mode, and impl "xla") and ``gqa_fwd_batch_decode_paged``
  (JAX's direct paged kernel) at W = 2, 4, 8: a row at kv_len 1 (every
  rank but the first empty), ragged rows and full rows.
* Every ``sp_ag_attention`` impl at W = 4 (``pallas`` is JAX's fused
  ``_sp_fused_kernel`` in interpret mode), the chunked form's
  ``q_offset`` / ``kv_len`` and a zigzag-reordered sequence.
* Both SP layers at W = 4, the allocator traces and prefix hits of
  ``PagedKVCacheManager(world=4)``, and a tiny f32 ``DenseLLM`` (2
  layers, hidden 64) at sequence world 4: prefill, one chunk at the front
  of a longer cache (t_cache 24: t_cache // W = 6 is not a multiple of
  W, so JAX's live-prefix slice rounds to lcm(6, 4) = 12) and per-row
  decode.

The port's side runs the plain versions on CPU tensors; the CUDA kernels
run on the card (``tests/test_torch_kernels.py``). f32 throughout,
within 1e-5 (atol and rtol: the two sides differ only in summation
order). The engines and the server are ``test_torch_sp_world_engine.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.layers import sp_flash_decode as jlayers
from triton_dist_tpu.models import DenseLLM as JaxDense
from triton_dist_tpu.models import ModelConfig as JaxConfig
from triton_dist_tpu.models.kv_cache import KVCacheManager as JaxKV
from triton_dist_tpu.models.kv_cache import (
    PagedKVCacheManager as JaxPaged)
from triton_dist_tpu.ops import flash_decode as jfd
from triton_dist_tpu.ops import sp_attention as jsp
from triton_dist_tpu_torch.layers import sp_flash_decode as layers
from triton_dist_tpu_torch.models import (
    AutoLLM, DenseLLM, KVCacheManager, ModelConfig, params_from_jax)
from triton_dist_tpu_torch.models.dense import live_prefix
from triton_dist_tpu_torch.models.kv_cache import PagedKVCacheManager
from triton_dist_tpu_torch.ops import flash_decode as fd
from triton_dist_tpu_torch.ops import sp_attention as sp
from triton_dist_tpu_torch.runtime.dist import create_rank_group

TOL = dict(rtol=1e-5, atol=1e-5)
W = 4
HQ, HKV, D = 8, 4, 16


def _mesh(world=W):
    return Mesh(np.array(jax.devices()[:world]).reshape(1, world),
                ("tp", "sp"))


def _group(world=W):
    return create_rank_group(world, "sp", "cpu")


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the combine schedule ---------------------------------------------------
def test_combine_schedule_matches_jax_over_worlds():
    for world in range(1, 9):
        for me in range(world):
            for p in range(1, world):
                assert fd.combine_peer(me, p, world) == int(
                    jfd.combine_peer(me, p, world))
                assert fd.combine_src(me, p, world) == int(
                    jfd.combine_src(me, p, world))
            # A rank pushes to every peer once and waits on every peer once.
            assert sorted(fd.combine_peer(me, p, world)
                          for p in range(1, world)) == sorted(
                set(range(world)) - {me})
            assert sorted(fd.combine_src(me, p, world)
                          for p in range(1, world)) == sorted(
                set(range(world)) - {me})


# -- flash decode -------------------------------------------------------------
B, PAGE = 3, 4


def _decode_inputs(world, seed=0):
    """q, k, v with 2 pages of PAGE positions per rank."""
    t = world * 2 * PAGE
    rng = np.random.RandomState(seed)
    return (rng.randn(B, HQ, D).astype(np.float32),
            rng.randn(B, t, HKV, D).astype(np.float32),
            rng.randn(B, t, HKV, D).astype(np.float32))


def _lens(t):
    return [1, 11, t]           # ranks past 0 empty; ragged; full


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("variant,impl", [("einsum", "pallas"),
                                          ("tiled", "pallas"),
                                          ("auto", "xla")])
def test_world_decode_matches_jax(world, variant, impl):
    q, k, v = _decode_inputs(world, seed=world)
    lens = _lens(k.shape[1])
    jctx = jfd.create_flash_decode_context(_mesh(world), "sp",
                                           variant=variant, t_blk=PAGE)
    want = jfd.gqa_fwd_batch_decode(*map(jnp.asarray, (q, k, v)),
                                    jnp.asarray(lens, jnp.int32), jctx,
                                    impl=impl)
    ctx = fd.create_flash_decode_context(_group(world), variant=variant)
    got = fd.gqa_fwd_batch_decode(*_t(q, k, v), lens, ctx, impl=impl)
    _close(got, want)
    ref = fd.flash_decode_world_reference(*_t(q, k, v), lens, world)
    _close(ref, want)


def _paged(k, v, world, seed=1):
    """Each rank's pages of k/v in a random order in its own pool of
    B * 2 + 1 pages (the last its sentinel): (pool_k, pool_v, table
    (world, B, 2))."""
    rng = np.random.RandomState(seed)
    per = B * 2 + 1
    t_loc = 2 * PAGE
    pool_k = rng.randn(world * per, PAGE, HKV, D).astype(np.float32)
    pool_v = rng.randn(world * per, PAGE, HKV, D).astype(np.float32)
    table = np.zeros((world, B, 2), np.int32)
    for r in range(world):
        slots = rng.permutation(per - 1)[:B * 2].reshape(B, 2)
        table[r] = slots
        pages = k[:, r * t_loc:(r + 1) * t_loc].reshape(B, 2, PAGE, HKV, D)
        pool_k[r * per + slots] = pages
        pool_v[r * per + slots] = v[:, r * t_loc:(r + 1) * t_loc].reshape(
            B, 2, PAGE, HKV, D)
    return pool_k, pool_v, table


@pytest.mark.parametrize("world", [2, 4, 8])
def test_world_paged_decode_matches_jax_direct(world):
    q, k, v = _decode_inputs(world, seed=10 + world)
    lens = _lens(k.shape[1])
    pool_k, pool_v, table = _paged(k, v, world)
    jctx = dataclasses.replace(
        jfd.create_flash_decode_context(_mesh(world), "sp"),
        paged_variant="direct")
    want = jfd.gqa_fwd_batch_decode_paged(
        *map(jnp.asarray, (q, pool_k, pool_v, table)),
        jnp.asarray(lens, jnp.int32), jctx)
    ctx = fd.create_flash_decode_context(_group(world))
    got = fd.gqa_fwd_batch_decode_paged(*_t(q, pool_k, pool_v, table), lens,
                                        ctx)
    _close(got, want)
    # The paged read is the dense world decode of the same positions.
    dense = fd.flash_decode_world_reference(*_t(q, k, v), lens, world)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-6,
                               rtol=0)
    gathered = fd.create_flash_decode_context(_group(world),
                                              paged_variant="gathered")
    np.testing.assert_allclose(
        fd.gqa_fwd_batch_decode_paged(*_t(q, pool_k, pool_v, table), lens,
                                      gathered).numpy(),
        got.numpy(), atol=1e-6, rtol=0)


def test_world_decode_context_and_cpu_calls():
    q, k, v = _t(*_decode_inputs(W))
    lens = _lens(k.shape[1])
    ctx = fd.create_flash_decode_context(_group())
    assert ctx.world_size == W and ctx.state is not None
    assert fd.FlashDecodeContext().world_size == 1
    before = {n: c.total for n, c in fd.launches.items()}
    want = fd.flash_decode_world_reference(q, k, v, lens, W)
    assert torch.equal(fd.gqa_fwd_batch_decode(q, k, v, lens, ctx), want)
    assert {n: c.total for n, c in fd.launches.items()} == before
    # The plain world-1 decode is the world reference at W = 1, and the
    # rank merge moves f32 sums only.
    assert torch.equal(fd.flash_decode_world_reference(q, k, v, lens, 1),
                       fd.flash_decode_reference(q, k, v, lens))
    np.testing.assert_allclose(want.numpy(),
                               fd.flash_decode_reference(q, k, v,
                                                         lens).numpy(),
                               atol=1e-6, rtol=0)
    assert not want[0].isnan().any()       # empty ranks push m = -1e30
    with pytest.raises(ValueError, match="split"):
        fd.gqa_fwd_batch_decode(q, k[:, :-1], v[:, :-1], lens, ctx)
    with pytest.raises(ValueError, match="block table"):
        fd.gqa_fwd_batch_decode_paged(q, k, v, torch.zeros(
            (1, B, 2), dtype=torch.int32), lens, ctx)
    with pytest.raises(ValueError, match="impl"):
        fd.gqa_fwd_batch_decode(q, k, v, lens, ctx, impl="flash")


# -- SP prefill attention -----------------------------------------------------
def _sp_inputs(b, s, seed=0, hq=HQ, hkv=HKV):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, D).astype(np.float32)
                 for h in (hq, hkv, hkv))


@pytest.mark.parametrize("impl,causal", [
    ("ring", True), ("ring", False), ("xla", True), ("ulysses", True),
    ("pallas", True), ("pallas", False)])
def test_every_impl_at_world4_matches_jax(impl, causal):
    q, k, v = _sp_inputs(2, 32, seed=3)
    jctx = jsp.create_sp_attention_context(_mesh(), "sp", causal=causal)
    want = jsp.sp_ag_attention(*map(jnp.asarray, (q, k, v)), jctx,
                               impl=impl)
    ctx = sp.create_sp_attention_context(causal=causal, group=_group())
    _close(sp.sp_ag_attention(*_t(q, k, v), ctx, impl=impl), want)


@pytest.mark.parametrize("t_sub,sq_blk", [(4, 4), (128, 128)])
def test_fused_world4_tile_clamps_match_jax(t_sub, sq_blk):
    """JAX clamps t_sub and sq_blk to each rank's S / W = 8 positions;
    t_sub 4 rounds p at 4-wide tiles."""
    q, k, v = _sp_inputs(1, 32, seed=4)
    jctx = jsp.create_sp_attention_context(_mesh(), "sp")
    want = jsp.sp_ag_attention_fused(*map(jnp.asarray, (q, k, v)), jctx,
                                     sq_blk=sq_blk, t_sub=t_sub)
    ctx = sp.create_sp_attention_context(world_size=W)
    got = sp.sp_ag_attention_fused(*_t(q, k, v), ctx, sq_blk=sq_blk,
                                   t_sub=t_sub)
    _close(got, want)
    assert sp.ring_chunks(3, W, True) == [3, 2, 1, 0]
    assert sp.ring_chunks(0, W, True) == [0]
    assert sp.ring_chunks(1, W, False) == [1, 0, 3, 2]


@pytest.mark.parametrize("impl", ["ring", "xla"])
def test_chunked_prefill_at_world4_matches_jax(impl):
    """A chunk of 8 queries at offset 12 over a 32-position cache with 20
    live positions: ranks past the live prefix hold masked keys only."""
    q = _sp_inputs(1, 8, seed=5)[0]
    _, k, v = _sp_inputs(1, 32, seed=6)
    jctx = jsp.create_sp_attention_context(_mesh(), "sp")
    want = jsp.sp_ag_attention(*map(jnp.asarray, (q, k, v)), jctx,
                               impl=impl, q_offset=12, kv_len=20)
    ctx = sp.create_sp_attention_context(group=_group())
    _close(sp.sp_ag_attention(*_t(q, k, v), ctx, impl=impl, q_offset=12,
                              kv_len=20), want)


@pytest.mark.parametrize("impl", ["ring", "pallas"])
def test_zigzag_sequence_at_world4_matches_jax(impl):
    q, k, v = _sp_inputs(1, 32, seed=7)
    zq, zk, zv = (np.asarray(jsp.zigzag_reorder(jnp.asarray(x), W))
                  for x in (q, k, v))
    jctx = jsp.create_sp_attention_context(_mesh(), "sp")
    want = jsp.zigzag_restore(jsp.sp_ag_attention(
        *map(jnp.asarray, (zq, zk, zv)), jctx, impl=impl), W)
    ctx = sp.create_sp_attention_context(group=_group())
    tq, tk, tv = (sp.zigzag_reorder(x, W) for x in _t(q, k, v))
    assert torch.equal(tq, _t(zq)[0])
    got = sp.zigzag_restore(sp.sp_ag_attention(tq, tk, tv, ctx, impl=impl),
                            W)
    _close(got, want)


def test_world_sp_attention_refuses_what_is_not_ported():
    q = torch.zeros((1, 8, 4, 16))
    ctx = sp.create_sp_attention_context(group=_group())
    assert torch.equal(sp.sp_ag_attention(q, q, q, ctx, impl="ag_pallas"),
                       sp.sp_ag_attention(q, q, q, ctx, impl="xla"))
    two_d = sp.create_sp_attention_context(head_axis="tp", group=_group())
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        sp.sp_ag_attention(q, q, q, two_d)
    with pytest.raises(ValueError, match="split"):
        sp.sp_ag_attention(q[:, :6], q[:, :6], q[:, :6], ctx)
    with pytest.raises(ValueError, match="ulysses"):
        sp.sp_ag_attention(q[:, :, :2], q[:, :, :2], q[:, :, :2], ctx,
                           impl="ulysses")
    with pytest.raises(ValueError, match="disagree"):
        sp.create_sp_attention_context(world_size=2, group=_group())


# -- the layers ---------------------------------------------------------------
def test_sp_flash_decode_layer_at_world4_matches_jax():
    """The sequence-split cache: appends at offsets on several ranks (the
    last clamped into the cache, as dynamic_update_slice clamps), then a
    decode over the first 13 positions of each row."""
    t, rng = 16, np.random.RandomState(8)
    jl = jlayers.SpFlashDecodeLayer(2, t, HKV, D, mesh=_mesh(), axis="sp",
                                    dtype=jnp.float32)
    tl = layers.SpFlashDecodeLayer(2, t, HKV, D, dtype=torch.float32,
                                   group=_group())
    jc, tc = jl.init_cache(), tl.init_cache()
    for off, n in ((0, 5), (5, 8), (14, 3)):
        kn = rng.randn(2, n, HKV, D).astype(np.float32)
        vn = rng.randn(2, n, HKV, D).astype(np.float32)
        jc = jl.append(jc, jnp.asarray(kn), jnp.asarray(vn), off)
        tc = tl.append(tc, *_t(kn, vn), off)
    np.testing.assert_array_equal(np.asarray(jc[0]), tc[0].numpy())
    q = rng.randn(2, HQ, D).astype(np.float32)
    want = jax.jit(lambda q, c: jl(q, c, 13))(jnp.asarray(q), jc)
    _close(tl(_t(q)[0], tc, 13), want)
    with pytest.raises(ValueError, match="split"):
        layers.SpFlashDecodeLayer(2, 18, HKV, D, group=_group())


def test_sp_attention_layer_at_world4_matches_jax():
    q, k, v = _sp_inputs(1, 32, seed=9)
    want = jlayers.SpAttentionLayer(_mesh(), "sp", impl="pallas")(
        *map(jnp.asarray, (q, k, v)))
    layer = layers.SpAttentionLayer("sp", impl="pallas", group=_group())
    assert layer.ctx.world_size == W
    _close(layer(*_t(q, k, v)), want)


# -- the paged allocator at world 4 -------------------------------------------
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


def _both(jmgr, mgr, op, *args, **kwargs):
    """One call on both managers: the same result or the same failure,
    then the same state."""
    outs = []
    for m in (jmgr, mgr):
        try:
            outs.append(("ok", getattr(m, op)(*args, **kwargs)))
        except (AssertionError, RuntimeError, ValueError):
            outs.append(("raised", None))
    assert outs[0][0] == outs[1][0], (op, args, outs)
    if outs[0][0] == "ok" and not isinstance(outs[0][1], np.ndarray):
        assert str(outs[0][1]) == str(outs[1][1]), (op, args, outs)
    ja, ta = _state(jmgr), _state(mgr)
    assert ja.keys() == ta.keys()
    for key in ja:
        if isinstance(ja[key], np.ndarray):
            np.testing.assert_array_equal(ja[key], ta[key], err_msg=key)
        else:
            assert ja[key] == ta[key], key
    return outs


@pytest.mark.parametrize("seed", range(3))
def test_world4_block_allocator_traces_match_jax(seed):
    """Seq-granular churn (alloc_many rolls back on a short device), then
    block-granular admission with prefix hits, growth across the ranks'
    lanes, and release."""
    rng = np.random.RandomState(seed)
    batch, page, npg = 3, 2, 2               # 4 devices x 2 pages of 2
    slots = int(rng.choice([3, 4, 6]))
    jmgr = JaxPaged(1, batch, page, npg, 2, 8, mesh=_mesh(), axis="sp",
                    dtype=jnp.float32, slots_per_dev=slots)
    mgr = PagedKVCacheManager(1, batch, page, npg, 2, 8,
                              dtype=torch.float32, device="cpu",
                              slots_per_dev=slots, world=W)
    assert mgr.world == jmgr.world == W and mgr.max_seq == jmgr.max_seq
    for _ in range(10):
        op = rng.choice(["alloc_seq", "free_seq", "alloc_many"])
        if op == "alloc_many":
            _both(jmgr, mgr, op, list(rng.choice(batch, 2, replace=False)))
        else:
            _both(jmgr, mgr, op, int(rng.randint(batch)))
    _both(jmgr, mgr, "stream_setup", prefix_cache=bool(seed % 2 == 0))
    stems = [[5, 6, 7, 8, 1, 2], [5, 6, 7, 8, 9, 9], [2, 2]]
    live = {}
    for _ in range(50):
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
            prompt = stem + list(rng.randint(1, 9, rng.randint(0, 4)))
            budget = int(rng.randint(1, 5))
            if len(prompt) + budget > mgr.max_seq:
                continue
            hashes = mgr.prefix_hashes(prompt)
            assert hashes == jmgr.prefix_hashes(prompt)
            k = mgr.prefix_probe(prompt, hashes=hashes)
            assert k == jmgr.prefix_probe(prompt)
            _both(jmgr, mgr, "need_per_dev", len(prompt), budget)
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
    if mgr.prefix is not None:
        assert mgr.prefix.stats() == jmgr.prefix.stats()
    assert mgr.block_table().shape == (W, batch, npg)
    np.testing.assert_array_equal(np.asarray(jmgr.block_table()),
                                  mgr.block_table().numpy())


def test_world4_paged_addressing_matches_jax():
    rng = np.random.RandomState(3)
    spd = 7
    table = np.stack([rng.permutation(spd - 1)[:6].reshape(2, 3)
                      for _ in range(W)]).astype(np.int32)
    pool = rng.randn(W * spd, 2, 2, 8).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    for off in (0, 5, 13, 23):
        jg, jip = JaxPaged.position_to_slot(jt, off, 2, spd)
        g, ip = PagedKVCacheManager.position_to_slot(tt, off, 2, spd)
        assert np.asarray(jg).tolist() == g.tolist() and int(jip) == int(ip)
    offs = np.array([3, 17], np.int32)
    jg, jip = JaxPaged.position_to_slot_rows(jt, jnp.asarray(offs), 2, spd)
    g, ip = PagedKVCacheManager.position_to_slot_rows(
        tt, torch.from_numpy(offs), 2, spd)
    assert np.asarray(jg).tolist() == g.tolist()
    assert np.asarray(jip).tolist() == ip.tolist()
    want = JaxPaged.gathered_view(jnp.asarray(pool), jt, W)
    got = PagedKVCacheManager.gathered_view(torch.from_numpy(pool), tt)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_sequence_sharded_cache_at_world4():
    kv = KVCacheManager(2, 2, 24, 2, 8, dtype=torch.float32, device="cpu",
                        seq_shard=True, world=W)
    caches = kv.init()
    assert caches[0][0].shape == (2, 24, 2, 8)
    shards = _group().shard(caches[0][0], 1)
    assert [s.shape[1] for s in shards] == [6] * W
    shards[2].fill_(1.0)                    # a rank's view is the cache
    assert caches[0][0][:, 12:18].eq(1).all() and caches[0][0][:, :12].eq(
        0).all()
    with pytest.raises(ValueError, match="positions"):
        KVCacheManager(1, 1, 10, 2, 8, device="cpu", seq_shard=True,
                       world=W)
    assert [live_prefix(24, n, W) for n in (4, 8, 12, 13, 24)] == [
        12, 12, 12, 24, 24]
    assert live_prefix(24, 5, 1) == 24


# -- the model ----------------------------------------------------------------
TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=HQ, num_key_value_heads=HKV, head_dim=D,
            vocab_size=96, max_position_embeddings=64)
T_CACHE = 24


@pytest.fixture(scope="module")
def models():
    mesh = _mesh()
    jmodel = JaxDense(JaxConfig(dtype=jnp.float32, **TINY), mesh=mesh,
                      axis="tp", impl="pallas", sp_axis="sp")
    jparams = jmodel.init(jax.random.PRNGKey(2))
    model = DenseLLM(ModelConfig(dtype=torch.float32, **TINY), device="cpu",
                     sp_axis="sp", sp_world=W)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             model.config, "cpu")
    # The JAX forward jitted once per shape (its flash decode runs the
    # interpret-mode kernel, slow eagerly).
    def fwd(p, ids, kv, off):
        return jmodel.forward(p, ids, kv, off, mode="sp")
    # A static offset, as the engine's chunked prefill passes it (JAX
    # slices the cache only then); traced per-row offsets for decode.
    jfwd = jax.jit(fwd, static_argnums=3)
    jstep = jax.jit(fwd)
    return mesh, jstep, jparams, jfwd, model, params


def _caches(models, batch=2):
    mesh, _, _, _, model, _ = models
    c = model.config
    jkv = JaxKV(c.num_hidden_layers, batch, T_CACHE, c.num_key_value_heads,
                c.head_dim, mesh=mesh, axis="sp", dtype=jnp.float32,
                seq_shard=True).init()
    kv = KVCacheManager(c.num_hidden_layers, batch, T_CACHE,
                        c.num_key_value_heads, c.head_dim,
                        dtype=torch.float32, device="cpu", seq_shard=True,
                        world=W).init()
    return jkv, kv


def test_world4_model_prefill_chunk_and_decode_match_jax(models):
    """Chunks of 4 at offsets 0 and 4 of a 24-position cache, then per-row
    decode steps at offsets (8, 8) and (9, 8): logits within 1e-5."""
    _, _, jparams, jfwd, model, params = models
    assert model.sp_world == W and model.fd_ctx.world_size == W
    assert model.sp_ctx.world_size == W and model.world == 1
    rng = np.random.RandomState(11)
    ids = rng.randint(1, 96, (2, 8)).astype(np.int32)
    jkv, kv = _caches(models)
    t_ids = torch.from_numpy(ids).long()
    for off in (0, 4):
        want, jkv = jfwd(jparams, jnp.asarray(ids[:, off:off + 4]), jkv,
                         off)
        got, kv = model.forward(params, t_ids[:, off:off + 4], kv, off,
                                mode="sp")
        _close(got, want)
    jstep = models[1]
    for offs in ((8, 8), (9, 8)):
        tok = rng.randint(1, 96, (2, 1)).astype(np.int32)
        want, jkv = jstep(jparams, jnp.asarray(tok), jkv,
                          jnp.asarray(offs, jnp.int32))
        got, kv = model.forward(params, torch.from_numpy(tok).long(), kv,
                                torch.tensor(offs), mode="sp")
        _close(got, want)
    np.testing.assert_allclose(np.asarray(jkv[1][0]), kv[1][0].numpy(),
                               **TOL)


def test_world4_model_whole_prefill_matches_jax(models):
    _, _, jparams, jfwd, model, params = models
    ids = np.random.RandomState(12).randint(1, 96, (2, 16)).astype(np.int32)
    jkv, kv = _caches(models)
    want, jkv = jfwd(jparams, jnp.asarray(ids), jkv, 0)
    got, kv = model.forward(params, torch.from_numpy(ids).long(), kv, 0,
                            mode="sp")
    _close(got, want)
    np.testing.assert_allclose(np.asarray(jkv[0][1]), kv[0][1].numpy(),
                               **TOL)


def test_world4_model_builds_and_refuses_what_is_not_ported(models):
    model = models[4]
    built = AutoLLM.build(model.config, device="cpu", sp_axis="sp",
                          sp_world=W)
    assert isinstance(built, DenseLLM) and built.sp_world == W
    with pytest.raises(ValueError, match="sp_axis"):
        DenseLLM(model.config, device="cpu", sp_world=W)
    two_d = DenseLLM(model.config, device="cpu", world=2, sp_axis="sp",
                     sp_world=2)
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        two_d.forward(models[5], torch.ones((1, 4), dtype=torch.long),
                      _caches(models, 1)[1], 0, mode="sp")
    moe = ModelConfig(dtype=torch.float32, num_experts=4,
                      num_experts_per_tok=2, moe_intermediate_size=32,
                      **TINY)
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        AutoLLM.build(moe, device="cpu", sp_axis="sp", sp_world=W)
    with pytest.raises(ValueError, match="split"):
        model.forward(models[5], torch.ones((1, 6), dtype=torch.long),
                      _caches(models, 1)[1], 0, mode="sp")
