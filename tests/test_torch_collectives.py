"""The port's world = 1 collectives (triton_dist_tpu_torch.ops.allreduce,
.reduce_scatter and .allgather's broadcast) against the JAX package's on
the CPU.

The same numpy-seeded partials go through the JAX ops on a 1-device
"tp" mesh, with ``impl="pallas"`` (each method's Pallas kernel in
interpret mode) and ``impl="xla"``, and through the port, whose CPU path
is the plain version of its copy kernel. At world = 1 every one of them
is a copy, so the results are equal, bit for bit, in f32 and bf16. The
copy kernel itself runs only on the card (``tests/test_torch_kernels.py``).
World W is held to JAX in ``tests/test_torch_collectives_world.py``; here
a world-2 call of each op runs its plain version and AUTO at world 4
picks JAX's method.
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


def _world_cases(jspec):
    """(got, want) pairs at world > 1: the CPU calls against their plain
    versions, AUTO at world 4 against JAX's choice under one spec."""
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 4, 4).astype(
        np.float32)).bfloat16()
    jrs_ctx = jrs.ReduceScatterContext(
        Mesh(np.array(jax.devices()[:4]), ("tp",)), "tp")
    return {
        "all_reduce_world2": lambda: (
            ar.all_reduce(x, ar.create_allreduce_context(world_size=2)),
            ar.all_reduce_world_reference(x, ar.AllReduceMethod.ONE_SHOT)),
        "all_reduce_auto_world4": lambda: (
            ar.get_auto_allreduce_method(4, 64).value,
            jar.get_auto_allreduce_method(4, 64, jspec).value),
        "reduce_scatter_world2": lambda: (
            rs.reduce_scatter(x, rs.create_reduce_scatter_context(
                world_size=2)),
            rs.reduce_scatter_world_reference(
                x, rs.ReduceScatterMethod.ONE_SHOT)),
        "reduce_scatter_auto_world4": lambda: (
            rs.create_reduce_scatter_context(world_size=4).resolve_method(
                64).value,
            jrs_ctx.resolve_method(64).value),
    }


@pytest.mark.parametrize("case", ["all_reduce_world2",
                                  "all_reduce_auto_world4",
                                  "reduce_scatter_world2",
                                  "reduce_scatter_auto_world4"])
def test_world_calls_run_their_plain_versions_and_auto_matches_jax(
        case, monkeypatch):
    from triton_dist_tpu.tools import perf_model as jpm
    from triton_dist_tpu_torch.tools import perf_model as pm
    spec = pm.H100_ONE_CARD
    jspec = jpm.ChipSpec(spec.name, spec.bf16_tflops, spec.hbm_gbps,
                         spec.ici_gbps_per_link, spec.ici_links)
    # JAX's reduce-scatter choice reads its chip table.
    monkeypatch.setattr(jpm, "get_chip_spec", lambda device=None: jspec)
    got, want = _world_cases(jspec)[case]()
    if isinstance(got, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        assert got == want


def test_bad_operands_raise():
    for call in (lambda: ar.all_reduce(torch.ones(4, 4)),
                 lambda: rs.reduce_scatter(torch.ones(2, 4, 4)),
                 lambda: ar.all_reduce(torch.ones(1, 4, 4), impl="ring"),
                 lambda: rs.reduce_scatter(torch.ones(1, 4, 4), impl="ring"),
                 lambda: ag.broadcast(torch.ones(4, 4), impl="ring")):
        with pytest.raises(ValueError):
            call()
