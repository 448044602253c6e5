"""The all-gather and broadcast at world W: the port's plain versions over
W ranks against the JAX package's Pallas kernels in interpret mode on W
devices of the 8-device CPU mesh (as ``tests/test_collectives.py`` runs
them), on the CPU.

* ``all_gather`` at W = 2, 3, 4 and 8, every method (ring, bidirectional
  ring, full-mesh push), stacked and unstacked, f32 and bf16: bit-equal
  to JAX's kernels (pure data movement), and to the port's impl "xla".
* ``broadcast`` at W = 2, 3, 4 and 8 from the first and the last rank,
  f32 and bf16: bit-equal to JAX's kernel, as is the port's masked psum.
* ``get_auto_all_gather_method`` equal to JAX's for W = 1..8 and sizes
  2^10..2^30 under one spec passed to both; the port's default (the
  one-card H100) picks the push at every W <= 4.
* ``sp_ag_attention(impl="ag_pallas")`` at W = 4 against JAX's (within
  1e-5, f32) and equal to the port's ring / xla impls.

The CUDA kernels run on the card (``tests/test_torch_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.ops import allgather as jag
from triton_dist_tpu.ops import sp_attention as jsp
from triton_dist_tpu.tools import perf_model as jpm
from triton_dist_tpu_torch.ops import allgather as ag
from triton_dist_tpu_torch.ops import sp_attention as sp
from triton_dist_tpu_torch.runtime.dist import create_rank_group
from triton_dist_tpu_torch.tools import perf_model as pm

WORLDS = (2, 3, 4, 8)
METHODS = ("ring_1d", "ring_bidir", "full_mesh_push")
ROWS, COLS = 3, 40


def _mesh(world, axes=("tp",)):
    devs = np.array(jax.devices()[:world])
    return Mesh(devs.reshape((1,) * (len(axes) - 1) + (world,)), axes)


def _inputs(world, dtype, seed=0):
    """(jax array, torch tensor) of the same (W rows, COLS) values."""
    x = (np.random.RandomState(seed).randn(world * ROWS, COLS) * 4
         ).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)


def _bits(a) -> np.ndarray:
    """The bit patterns of a JAX array or torch tensor (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.contiguous().view(torch.int16).numpy()
        return a.contiguous().view(torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_world_matches_jax(world, method, dtype):
    jx, tx = _inputs(world, dtype, seed=world)
    jctx = jag.create_allgather_context(_mesh(world), "tp",
                                        jag.AllGatherMethod(method))
    ctx = ag.create_allgather_context(method=ag.AllGatherMethod(method),
                                      world_size=world)
    want_stacked = jag.all_gather(jx, jctx, impl="pallas", stacked=True)
    want = jag.all_gather(jx, jctx, impl="pallas")
    got_stacked = ag.all_gather(tx, ctx, stacked=True)
    got = ag.all_gather(tx, ctx)
    assert got_stacked.shape == (world, world * ROWS, COLS)
    assert got.shape == (world * ROWS, COLS) and got.dtype == tx.dtype
    np.testing.assert_array_equal(
        _bits(got_stacked).reshape(-1, COLS), _bits(want_stacked))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # impl "xla" is lax.all_gather: the same bits.
    assert torch.equal(ag.all_gather(tx, ctx, impl="xla", stacked=True),
                       got_stacked)
    assert torch.equal(ag.all_gather(tx, ctx, impl="xla"), got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_world_matches_jax(world, dtype):
    jx, tx = _inputs(world, dtype, seed=10 + world)
    jctx = jag.create_allgather_context(_mesh(world), "tp")
    ctx = ag.create_allgather_context(world_size=world)
    for root in (0, world - 1):
        want = jag.broadcast(jx, root, jctx, impl="pallas")
        got = ag.broadcast(tx, root, ctx)
        assert got.shape == (ROWS, COLS)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        # impl "xla", JAX's masked psum, gives the same bits.
        np.testing.assert_array_equal(
            _bits(ag.broadcast(tx, root, ctx, impl="xla")), _bits(want))
    with pytest.raises(ValueError, match="out of range"):
        ag.broadcast(tx, world, ctx)


def test_auto_method_matches_jax_under_one_spec():
    """JAX's choice reads its chip table; both sides get the one-card
    H100 spec explicitly."""
    spec = pm.H100_ONE_CARD
    jspec = jpm.ChipSpec(spec.name, spec.bf16_tflops, spec.hbm_gbps,
                         spec.ici_gbps_per_link, spec.ici_links)
    for world in range(1, 9):
        for log in range(10, 31):
            n = 1 << log
            want = jag.get_auto_all_gather_method(world, n, jspec)
            got = ag.get_auto_all_gather_method(world, n, spec)
            assert got.value == want.value, (world, n)
            assert ag.get_auto_all_gather_method(world, n) is got
            assert pm.estimate_all_gather_time_ms(n, world, spec) == \
                jpm.estimate_all_gather_time_ms(n, world, jspec)
            assert pm.estimate_full_mesh_push_time_ms(n, world, spec) == \
                jpm.estimate_full_mesh_push_time_ms(n, world, jspec)
            if world <= 4:
                assert got is ag.AllGatherMethod.FULL_MESH_PUSH
    assert ag.get_auto_all_gather_method(8, 1 << 30) is \
        ag.AllGatherMethod.RING_BIDIR
    assert ag.get_auto_all_gather_method(8, 1 << 10) is \
        ag.AllGatherMethod.FULL_MESH_PUSH


def test_context_over_a_group_and_cpu_calls_not_counted():
    group = create_rank_group(4, device="cpu")
    ctx = ag.create_allgather_context(group=group)
    assert ctx.world_size == 4 and ctx.state is not None
    with pytest.raises(ValueError, match="disagree"):
        ag.create_allgather_context(world_size=2, group=group)
    x = torch.randn(8, 16)
    counts = (ag.all_gather_launches.total, ag.broadcast_launches.total)
    out = ag.all_gather(x, ctx, stacked=True)
    assert all(torch.equal(out[r], x) for r in range(4))
    assert torch.equal(ag.broadcast(x, 2, ctx), x[4:6])
    assert (ag.all_gather_launches.total,
            ag.broadcast_launches.total) == counts
    with pytest.raises(ValueError, match="split"):
        ag.all_gather(torch.randn(6, 16), ctx)
    with pytest.raises(ValueError, match="broadcast"):
        ag.all_gather(x, ag.create_allgather_context(
            method=ag.AllGatherMethod.BROADCAST, group=group))


def test_world_kernels_refuse_what_they_do_not_take():
    """The world-W launchers check before any build: CUDA only, a group
    of two or more ranks, a method of the all-gather."""
    x = torch.randn(8, 16)
    ctx = ag.create_allgather_context(group=create_rank_group(4,
                                                              device="cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        ag.launch_all_gather_world(x, ctx,
                                   ag.AllGatherMethod.FULL_MESH_PUSH)
    with pytest.raises(ValueError, match="CUDA"):
        ag.launch_broadcast_world(x, 0, ctx)


def test_ag_pallas_at_world4_matches_jax_and_the_other_impls():
    w, hq, hkv, d = 4, 8, 4, 16
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 32, h, d).astype(np.float32)
               for h in (hq, hkv, hkv))
    jctx = jsp.create_sp_attention_context(_mesh(w, ("tp", "sp")), "sp")
    want = jsp.sp_ag_attention(*map(jnp.asarray, (q, k, v)), jctx,
                               impl="ag_pallas")
    ctx = sp.create_sp_attention_context(
        group=create_rank_group(w, "sp", device="cpu"))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = sp.sp_ag_attention(tq, tk, tv, ctx, impl="ag_pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for impl in ("ring", "xla"):
        np.testing.assert_allclose(
            got.numpy(), sp.sp_ag_attention(tq, tk, tv, ctx,
                                            impl=impl).numpy(),
            rtol=1e-5, atol=1e-5, err_msg=impl)
