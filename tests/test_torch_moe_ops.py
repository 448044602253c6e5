"""The port's MoE ops against the JAX package's, on the CPU: the router
(``topk_routing``, ties included), ``bincount``, ``sort_by_group``,
``align_tokens_for_tiles``, ``grouped_matmul``, ``grouped_expert_ffn``,
``ag_group_gemm`` (xla / ring / fused), ``moe_reduce_rs`` (ring / xla /
fused) and ``all_gather`` (pallas / xla), each through its plain version
(the CPU path of every wrapper).

The JAX side runs on a 1-device mesh, its Pallas kernels (the fused AG
grouped GEMM, the fused MoE-RS, the full-mesh-push all-gather) in
interpret mode. Inputs come from numpy with fixed seeds. Tolerances:
integer outputs equal; f32 within 1e-5 (sums in other orders); bf16
within one bf16 ulp of the larger value (both sides sum in f32 and round
once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.ops import allgather as jag
from triton_dist_tpu.ops import group_gemm as jgg
from triton_dist_tpu.ops import moe_reduce_rs as jrs
from triton_dist_tpu.ops import moe_utils as jmu
from triton_dist_tpu_torch.ops import allgather as ag
from triton_dist_tpu_torch.ops import group_gemm as gg
from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
from triton_dist_tpu_torch.ops import moe_utils as mu

BF16_ULP_REL = 2.0 ** -7


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


def _rng(seed):
    return np.random.RandomState(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        lim = BF16_ULP_REL * np.maximum(np.abs(got), np.abs(want)) + 1e-6
        assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


def _to(x, dtype):
    """(torch tensor, jnp array) of numpy ``x`` in ``dtype``."""
    t = _t(x).to(getattr(torch, dtype))
    return t, jnp.asarray(x, getattr(jnp, dtype))


def _np(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


# -- routing utilities -----------------------------------------------------------
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("norm", [True, False])
def test_topk_routing_matches_jax(ties, norm):
    rng = _rng(1)
    logits = rng.randn(37, 16).astype(np.float32)
    if ties:
        # Few distinct values: most top-k choices break ties, which
        # lax.top_k gives to the lower index first.
        logits = rng.randint(0, 3, size=(37, 16)).astype(np.float32)
    w, idx = mu.topk_routing(_t(logits), 4, norm)
    jw, jidx = jmu.topk_routing(jnp.asarray(logits), 4, norm)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


def test_bincount_and_sort_by_group_match_jax():
    rng = _rng(2)
    ids = rng.randint(0, 6, size=41).astype(np.int32)   # 5 = the sentinel
    vals = rng.randn(41, 3).astype(np.float32)
    np.testing.assert_array_equal(mu.bincount(_t(ids), 5).numpy(),
                                  np.asarray(jmu.bincount(jnp.asarray(ids),
                                                          5)))
    got = mu.sort_by_group(_t(vals), _t(ids), 5)
    want = jmu.sort_by_group(jnp.asarray(vals), jnp.asarray(ids), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_reduce_matches_jax():
    rng = _rng(3)
    out = rng.randn(9, 3, 8).astype(np.float32)
    w = rng.rand(9, 3).astype(np.float32)
    _close(mu.topk_reduce(_t(out), _t(w)).numpy(),
           np.asarray(jmu.topk_reduce(jnp.asarray(out), jnp.asarray(w))),
           "float32")


@pytest.mark.parametrize("m,e,blk,sentinel", [(50, 4, 8, 0.0),
                                              (64, 8, 16, 0.2),
                                              (7, 5, 4, 0.5)])
def test_align_tokens_for_tiles_matches_jax(m, e, blk, sentinel):
    rng = _rng(m)
    tokens = rng.randn(m, 6).astype(np.float32)
    ids = rng.randint(0, e, size=m)
    ids[rng.rand(m) < sentinel] = e
    ids = ids.astype(np.int32)
    padded, tile_e, dest = gg.align_tokens_for_tiles(_t(tokens), _t(ids), e,
                                                     blk)
    jpad, jtile, jdest = jgg.align_tokens_for_tiles(
        jnp.asarray(tokens), jnp.asarray(ids), e, blk)
    assert tile_e.dtype == dest.dtype == torch.int32
    np.testing.assert_array_equal(tile_e.numpy(), np.asarray(jtile))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    assert padded.shape == jpad.shape
    # Every row but the trash row (where invalid rows collide) is equal.
    np.testing.assert_array_equal(padded.numpy()[:-1], np.asarray(jpad)[:-1])


# -- grouped products ----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topk", [1, 3])
@pytest.mark.parametrize("sentinel", [0.0, 0.3], ids=["", "sentinel"])
def test_grouped_matmul_matches_jax(dtype, topk, sentinel):
    rng = _rng(4 + topk)
    t, k, n, e = 11, 24, 40, 5
    x = rng.randn(t, k).astype(np.float32)
    w = (rng.randn(e, k, n) / np.sqrt(k)).astype(np.float32)
    ids = rng.randint(0, e, size=t * topk)
    ids[rng.rand(t * topk) < sentinel] = e      # JAX: the last expert
    ids = ids.astype(np.int32)
    (tx, jx), (tw, jw) = _to(x, dtype), _to(w, dtype)
    got = gg.grouped_matmul(tx, tw, _t(ids), e, topk=topk)
    want = jgg.grouped_matmul(jnp.repeat(jx, topk, axis=0), jw,
                              jnp.asarray(ids), e)
    assert got.dtype == tx.dtype and got.shape == (t * topk, n)
    _close(_np(got), np.asarray(want.astype(jnp.float32)), dtype)
    both = gg.grouped_matmul_multi(tx, [tw, tw.flip(0)], _t(ids), e, topk)
    assert torch.equal(both[0], got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_expert_ffn_matches_jax(dtype):
    rng = _rng(5)
    t, h, i, e = 16, 8, 12, 3
    x = rng.randn(t, h).astype(np.float32)
    ws = [(rng.randn(e, a, b) / np.sqrt(a)).astype(np.float32)
          for a, b in ((h, i), (h, i), (i, h))]
    ids = np.concatenate([rng.randint(0, e, 12),
                          np.full(4, e)]).astype(np.int32)
    tws = [_to(w, dtype) for w in ws]
    tx, jx = _to(x, dtype)
    got = gg.grouped_expert_ffn(tx, *(a for a, _ in tws), _t(ids), e)
    want = jgg.grouped_expert_ffn(jx, *(b for _, b in tws),
                                  jnp.asarray(ids), e)
    _close(_np(got), np.asarray(want.astype(jnp.float32)), dtype)
    # topk > 1 reads each token row for its pairs, as the repeat would.
    pairs = gg.grouped_expert_ffn(tx[:8], *(a for a, _ in tws), _t(ids), e,
                                  topk=2)
    assert torch.equal(pairs, gg.grouped_expert_ffn(
        tx[:8].repeat_interleave(2, 0), *(a for a, _ in tws), _t(ids), e))


@pytest.mark.parametrize("impl", ["xla", "ring", "fused"])
def test_ag_group_gemm_matches_jax(mesh, impl):
    rng = _rng(6)
    m, k, n, e = 24, 16, 32, 4
    x = rng.randn(m, k).astype(np.float32) / 4
    w = rng.randn(e, k, n).astype(np.float32) / 4
    ids = rng.randint(0, e, m).astype(np.int32)
    ctx = jgg.create_ag_group_gemm_context(mesh, "tp")
    ctx.block_m, ctx.block_n = 8, 32
    want = jgg.ag_group_gemm(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(ids), e, ctx, impl=impl)
    got = gg.ag_group_gemm(_t(x), _t(w), _t(ids), e,
                           gg.create_ag_group_gemm_context(), impl=impl)
    _close(got.numpy(), np.asarray(want), "float32")


@pytest.mark.parametrize("impl", ["ring", "xla", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_reduce_rs_matches_jax(mesh, impl, dtype):
    rng = _rng(7)
    t, i, h, e, topk = 16, 32, 64, 4, 2
    act = rng.randn(t * topk, i).astype(np.float32) / 4
    wd = rng.randn(e, i, h).astype(np.float32) / 4
    ids = rng.randint(0, e, t * topk).astype(np.int32)
    wts = (np.abs(rng.randn(t, topk)) / topk).astype(np.float32)
    ctx = jrs.create_moe_rs_context(mesh, "tp", num_experts=e, topk=topk)
    ctx.block_m, ctx.block_h = 8, 64
    (ta, ja), (tw, jw) = _to(act, dtype), _to(wd, dtype)
    want = jrs.moe_reduce_rs(ja, jw, jnp.asarray(ids), jnp.asarray(wts),
                             ctx, impl=impl)
    got = mrs.moe_reduce_rs(ta, tw, _t(ids), _t(wts),
                            mrs.create_moe_rs_context(num_experts=e,
                                                      topk=topk), impl=impl)
    assert got.dtype == ta.dtype and got.shape == (t, h)
    _close(_np(got), np.asarray(want.astype(jnp.float32)), dtype)


def test_moe_reduce_rs_impls_round_in_their_places():
    """bf16: "ring" rounds each pair before the weighted sum, "fused"
    keeps it f32; both agree with the plain statement of each."""
    rng = _rng(8)
    act = _t(rng.randn(8, 16).astype(np.float32)).bfloat16()
    wd = _t(rng.randn(3, 16, 24).astype(np.float32)).bfloat16()
    ids = _t(rng.randint(0, 3, 8).astype(np.int32))
    wts = _t(rng.rand(4, 2).astype(np.float32))
    ctx = mrs.create_moe_rs_context(num_experts=3, topk=2)
    pair = (act.float()[:, None, :] @ wd.float()[ids.long()])[:, 0]
    for impl, p in (("ring", pair.bfloat16().float()), ("fused", pair)):
        want = (p.reshape(4, 2, 24) * wts[..., None]).sum(1).bfloat16()
        assert torch.equal(mrs.moe_reduce_rs(act, wd, ids, wts, ctx, impl),
                           want)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_all_gather_matches_jax(mesh, impl):
    x = _rng(9).randn(8, 16).astype(np.float32)
    want = jag.all_gather(jnp.asarray(x), jag.create_allgather_context(
        mesh, "tp"), impl=impl)
    got = ag.all_gather(_t(x), ag.create_allgather_context(), impl=impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ag.get_auto_all_gather_method(1, 64) is \
        ag.AllGatherMethod.FULL_MESH_PUSH
    assert jag.get_auto_all_gather_method(1, 64).value == \
        ag.get_auto_all_gather_method(2, 64).value


def test_cpu_calls_take_the_plain_versions_and_are_not_counted():
    x = torch.randn(4, 8)
    w = torch.randn(3, 8, 16)
    ids = torch.tensor([0, 2, 1, 2], dtype=torch.int32)
    counts = (gg.group_gemm_launches.total, mrs.moe_rs_launches.total,
              ag.all_gather_launches.total)
    assert torch.equal(gg.grouped_matmul(x, w, ids, 3),
                       gg.grouped_matmul_reference(x, w, ids, 3))
    ctx = mrs.create_moe_rs_context(num_experts=3, topk=2)
    wts = torch.rand(2, 2)
    assert torch.equal(
        mrs.moe_reduce_rs(x, w[:, :, :8], ids, wts, ctx),
        mrs.moe_reduce_rs_reference(x, w[:, :, :8], ids, wts, 3))
    got = ag.all_gather(x)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
    assert (gg.group_gemm_launches.total, mrs.moe_rs_launches.total,
            ag.all_gather_launches.total) == counts


@pytest.mark.parametrize("call,match", [
    (lambda: gg.ag_group_gemm(torch.ones(2, 4), torch.ones(2, 4, 4),
                              torch.zeros(2, dtype=torch.int32), 2,
                              impl="auto"), "Queue A item 19"),
    (lambda: gg.ag_group_gemm(torch.ones(2, 4), torch.ones(2, 4, 4),
                              torch.zeros(2, dtype=torch.int32), 2,
                              gg.create_ag_group_gemm_context(world_size=2)),
     "Queue B item 10"),
    (lambda: mrs.moe_reduce_rs(torch.ones(4, 4), torch.ones(2, 4, 4),
                               torch.zeros(4, dtype=torch.int32),
                               torch.ones(2, 2),
                               mrs.create_moe_rs_context(num_experts=2),
                               impl="auto"), "Queue A item 19"),
    (lambda: mrs.moe_reduce_rs(torch.ones(4, 4), torch.ones(2, 4, 4),
                               torch.zeros(4, dtype=torch.int32),
                               torch.ones(2, 2),
                               mrs.create_moe_rs_context(num_experts=2,
                                                         world_size=2)),
     "Queue B item 11"),
    (lambda: ag.all_gather(torch.ones(2, 2),
                           ag.create_allgather_context(world_size=2)),
     "Queue B item 8"),
    (lambda: ag.broadcast(torch.ones(2, 2), 0, ag.create_allgather_context(
        world_size=2)), "Queue B item 8"),
    (lambda: ag.get_auto_all_gather_method(4, 64), "Queue B item 8"),
], ids=["ag_group_gemm_auto", "ag_group_gemm_world2", "moe_rs_auto",
        "moe_rs_world2", "all_gather_world2", "broadcast", "auto_world4"])
def test_unported_parts_raise_and_name_their_roadmap_item(call, match):
    with pytest.raises(NotImplementedError, match=match):
        call()
