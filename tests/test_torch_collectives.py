"""The port's world = 1 collectives (triton_dist_tpu_torch.ops.allreduce,
.reduce_scatter and .allgather's broadcast) against the JAX package's on
the CPU.

The same numpy-seeded partials go through the JAX ops on a 1-device
"tp" mesh, with ``impl="pallas"`` (each method's Pallas kernel in
interpret mode) and ``impl="xla"``, and through the port, whose CPU path
is the plain version of its copy kernel. At world = 1 every one of them
is a copy, so the results are equal, bit for bit, in f32 and bf16. The
copy kernel itself runs only on the card (``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.ops import allgather as jag
from triton_dist_tpu.ops import allreduce as jar
from triton_dist_tpu.ops import reduce_scatter as jrs
from triton_dist_tpu_torch.ops import allgather as ag
from triton_dist_tpu_torch.ops import allreduce as ar
from triton_dist_tpu_torch.ops import reduce_scatter as rs

M, N = 8, 128


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


def _partials(dtype, shape=(1, M, N), seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    return jx, tx.to(torch.bfloat16 if dtype == "bf16" else torch.float32)


def assert_equal(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


# impl="xla" is lax.psum / lax.psum_scatter whatever the method.
AR_CASES = ([("pallas", m) for m in ar.AllReduceMethod]
            + [("xla", ar.AllReduceMethod.AUTO)])
RS_CASES = ([("pallas", m) for m in rs.ReduceScatterMethod]
            + [("xla", rs.ReduceScatterMethod.AUTO)])


def _ids(case):
    return f"{case[0]}-{case[1].value}"


@pytest.mark.parametrize("impl,method", AR_CASES, ids=map(_ids, AR_CASES))
@pytest.mark.parametrize("stacked", [False, True], ids=["", "stacked"])
def test_all_reduce_matches_jax(mesh, impl, method, stacked):
    jx, tx = _partials("bf16" if stacked else "f32")
    jctx = jar.create_allreduce_context(mesh, "tp",
                                        jar.AllReduceMethod(method.value))
    want = jar.all_reduce(jx, jctx, impl=impl, stacked=stacked)
    got = ar.all_reduce(tx, ar.create_allreduce_context(method=method),
                        impl=impl, stacked=stacked)
    assert got.dtype == tx.dtype
    assert_equal(got, want)
    if impl == "pallas":
        assert got.data_ptr() != tx.data_ptr()   # a new tensor, as JAX's


def test_all_reduce_method_choice_matches_jax():
    for world in (1, 2):
        for nbytes in (64, 1 << 24):
            assert (ar.get_auto_allreduce_method(world, nbytes).value
                    == jar.get_auto_allreduce_method(world, nbytes).value)
    ctx = ar.create_allreduce_context()
    assert ar.resolve_method(ctx, 4, 64) is ar.AllReduceMethod.ONE_SHOT
    for m in (ar.AllReduceMethod.TWO_SHOT,
              ar.AllReduceMethod.RECURSIVE_DOUBLING):
        assert ar.resolve_method(ar.create_allreduce_context(method=m),
                                 3, 64) is m        # world 1 keeps both


@pytest.mark.parametrize("impl,method", RS_CASES, ids=map(_ids, RS_CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reduce_scatter_matches_jax(mesh, impl, method, dtype):
    jx, tx = _partials(dtype, seed=1)
    jctx = jrs.create_reduce_scatter_context(
        mesh, "tp", jrs.ReduceScatterMethod(method.value))
    want = jrs.reduce_scatter(jx, jctx, impl=impl)
    ctx = rs.create_reduce_scatter_context(method=method)
    assert ctx.resolve_method(64).value == jctx.resolve_method(64).value
    got = rs.reduce_scatter(tx, ctx, impl=impl)
    assert got.dtype == tx.dtype
    assert_equal(got, want)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_broadcast_matches_jax(mesh, impl, dtype):
    jx, tx = _partials(dtype, shape=(M, N), seed=2)
    jctx = jag.create_allgather_context(mesh, "tp")
    want = jag.broadcast(jx, 0, jctx, impl=impl)
    got = ag.broadcast(tx, 0, ag.create_allgather_context(), impl=impl)
    assert got.dtype == tx.dtype
    assert_equal(got, want)


def test_broadcast_root_outside_the_world_raises_as_in_jax(mesh):
    jx, tx = _partials("f32", shape=(M, N))
    for root in (1, -1):
        with pytest.raises(ValueError, match="out of range"):
            jag.broadcast(jx, root, jag.create_allgather_context(mesh, "tp"))
        with pytest.raises(ValueError, match="out of range"):
            ag.broadcast(tx, root)


def test_all_gather_refuses_the_broadcast_method_as_jax_does(mesh):
    with pytest.raises(ValueError, match="broadcast"):
        ag.all_gather(torch.ones(2, 2), ag.create_allgather_context(
            method=ag.AllGatherMethod.BROADCAST))


@pytest.mark.parametrize("call,match", [
    (lambda: ar.all_reduce(torch.ones(2, 4, 4),
                           ar.create_allreduce_context(world_size=2)),
     "Queue B item 7"),
    (lambda: ar.get_auto_allreduce_method(4, 64), "Queue B item 7"),
    (lambda: rs.reduce_scatter(torch.ones(2, 4, 4),
                               rs.create_reduce_scatter_context(
                                   world_size=2)), "Queue B item 9"),
    (lambda: rs.create_reduce_scatter_context(world_size=4).resolve_method(
        64), "Queue B item 9"),
], ids=["all_reduce_world2", "all_reduce_auto_world4",
        "reduce_scatter_world2", "reduce_scatter_auto_world4"])
def test_unported_worlds_raise_and_name_their_roadmap_item(call, match):
    with pytest.raises(NotImplementedError, match=match):
        call()


def test_bad_operands_raise():
    for call in (lambda: ar.all_reduce(torch.ones(4, 4)),
                 lambda: rs.reduce_scatter(torch.ones(2, 4, 4)),
                 lambda: ar.all_reduce(torch.ones(1, 4, 4), impl="ring"),
                 lambda: rs.reduce_scatter(torch.ones(1, 4, 4), impl="ring"),
                 lambda: ag.broadcast(torch.ones(4, 4), impl="ring")):
        with pytest.raises(ValueError):
            call()
