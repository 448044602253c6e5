"""The all-reduce and reduce-scatter at world W: the port's plain versions
over W ranks against the JAX package's Pallas kernels in interpret mode on
W devices of the 8-device CPU mesh, on the CPU.

* ``all_reduce`` (one_shot, two_shot, recursive_doubling, auto) and
  ``reduce_scatter`` (ring, one_shot, auto) at W = 2, 4 and 8, f32 and
  bf16, stacked and not: bit-equal to JAX's kernels, which add in the
  partials' dtype and round after every add in each method's order.
* W = 3, where recursive doubling turns into one-shot, as two-shot does
  when M % 3 != 0, as in JAX.
* ``impl="xla"`` against ``lax.psum`` / ``lax.psum_scatter``: the f32
  sum rounded once; in bf16 the one-shot differs from it, on both sides.
* ``get_auto_allreduce_method``, the reduce-scatter's ``resolve_method``
  (on one chunk's bytes) and the three estimates equal to JAX's under one
  spec for W = 1..8 and sizes 64 B..64 MB.

The partials come from fixed numpy seeds, each rank's at another scale,
so the rounding points matter. The CUDA kernel runs on the card
(``tests/test_torch_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.ops import allreduce as jar
from triton_dist_tpu.ops import reduce_scatter as jrs
from triton_dist_tpu.tools import perf_model as jpm
from triton_dist_tpu_torch.ops import allreduce as ar
from triton_dist_tpu_torch.ops import reduce_scatter as rs
from triton_dist_tpu_torch.runtime.dist import create_rank_group
from triton_dist_tpu_torch.tools import perf_model as pm

M, N = 8, 128


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _partials(world, dtype, m=M, seed=0):
    """(jax array, torch tensor) of the same (W, m, N) partials, rank r's
    scaled by 4^r: the sums' rounding points differ by method."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(world, m, N)
         * 4.0 ** np.arange(world)[:, None, None]).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)


def _bits(a) -> np.ndarray:
    """The bit patterns of a JAX array or torch tensor (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        t = a.contiguous()
        return t.view(torch.int16 if t.element_size() == 2
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _spec_pair():
    spec = pm.H100_ONE_CARD
    return spec, jpm.ChipSpec(spec.name, spec.bf16_tflops, spec.hbm_gbps,
                              spec.ici_gbps_per_link, spec.ici_links)


AR_METHODS = ("one_shot", "two_shot", "recursive_doubling", "auto")
RS_METHODS = ("ring", "one_shot", "auto")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("method", AR_METHODS)
@pytest.mark.parametrize("world", (2, 4, 8))
def test_all_reduce_world_matches_jax(world, method, dtype):
    jx, tx = _partials(world, dtype, seed=world)
    jctx = jar.create_allreduce_context(_mesh(world), "tp",
                                        jar.AllReduceMethod(method))
    ctx = ar.create_allreduce_context(method=ar.AllReduceMethod(method),
                                      world_size=world)
    stacked = dtype == "bf16"
    want = jar.all_reduce(jx, jctx, impl="pallas", stacked=stacked)
    got = ar.all_reduce(tx, ctx, stacked=stacked)
    assert got.dtype == tx.dtype
    assert got.shape == ((world, M, N) if stacked else (M, N))
    np.testing.assert_array_equal(_bits(got).reshape(-1, N),
                                  _bits(want).reshape(-1, N))
    if stacked:                         # every rank's copy is the same
        assert all(torch.equal(got[r], got[0]) for r in range(world))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("method", RS_METHODS)
@pytest.mark.parametrize("world", (2, 4, 8))
def test_reduce_scatter_world_matches_jax(world, method, dtype):
    jx, tx = _partials(world, dtype, seed=10 + world)
    jctx = jrs.create_reduce_scatter_context(
        _mesh(world), "tp", jrs.ReduceScatterMethod(method))
    ctx = rs.create_reduce_scatter_context(
        method=rs.ReduceScatterMethod(method), world_size=world)
    want = jrs.reduce_scatter(jx, jctx, impl="pallas")
    got = rs.reduce_scatter(tx, ctx)
    assert got.shape == (M, N) and got.dtype == tx.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_world3_fix_ups_match_jax(dtype):
    """At W = 3 recursive doubling turns into one-shot, and so does
    two-shot where M % 3 != 0, in JAX and in the port; with M = 6 the
    two-shot runs and the reduce-scatter splits."""
    mesh = _mesh(3)
    for m, method, runs in ((8, "recursive_doubling", "one_shot"),
                            (8, "two_shot", "one_shot"),
                            (6, "two_shot", "two_shot"),
                            (6, "recursive_doubling", "one_shot")):
        jx, tx = _partials(3, dtype, m=m, seed=m)
        ctx = ar.create_allreduce_context(method=ar.AllReduceMethod(method),
                                          world_size=3)
        nbytes = m * N * tx.element_size()
        assert ar.resolve_method(ctx, m, nbytes).value == runs
        want = jar.all_reduce(jx, jar.create_allreduce_context(
            mesh, "tp", jar.AllReduceMethod(method)), impl="pallas")
        got = ar.all_reduce(tx, ctx)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    jx, tx = _partials(3, dtype, m=6, seed=3)
    for method in ("ring", "one_shot"):
        want = jrs.reduce_scatter(jx, jrs.create_reduce_scatter_context(
            mesh, "tp", jrs.ReduceScatterMethod(method)), impl="pallas")
        got = rs.reduce_scatter(tx, rs.create_reduce_scatter_context(
            method=rs.ReduceScatterMethod(method), world_size=3))
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("world", (2, 3, 4, 8))
def test_xla_impls_match_psum(world, dtype):
    m = 6 * world
    jx, tx = _partials(world, dtype, m=m, seed=20 + world)
    mesh = _mesh(world)
    ctx = ar.create_allreduce_context(world_size=world)
    want = jar.all_reduce(jx, jar.create_allreduce_context(mesh, "tp"),
                          impl="xla", stacked=True)
    got = ar.all_reduce(tx, ctx, impl="xla", stacked=True)
    np.testing.assert_array_equal(_bits(got).reshape(-1, N),
                                  _bits(want).reshape(-1, N))
    want = jrs.reduce_scatter(jx, jrs.create_reduce_scatter_context(
        mesh, "tp"), impl="xla")
    got = rs.reduce_scatter(tx, rs.create_reduce_scatter_context(
        world_size=world), impl="xla")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # The f32 sum rounded once, whatever the method.
    once = tx.float().sum(0).to(tx.dtype)
    assert torch.equal(got, once)


def test_bf16_one_shot_rounds_after_every_add_as_jax_does():
    """In bf16 the one-shot (each add rounded) differs from the f32 sum
    rounded once, on both sides and in the same elements."""
    world = 4
    jx, tx = _partials(world, "bf16", seed=7)
    mesh = _mesh(world)
    method = jar.AllReduceMethod.ONE_SHOT
    j_one = _bits(jar.all_reduce(jx, jar.create_allreduce_context(
        mesh, "tp", method), impl="pallas"))
    j_xla = _bits(jar.all_reduce(jx, jar.create_allreduce_context(
        mesh, "tp", method), impl="xla"))
    ctx = ar.create_allreduce_context(method=ar.AllReduceMethod.ONE_SHOT,
                                      world_size=world)
    t_one = _bits(ar.all_reduce(tx, ctx))
    t_xla = _bits(ar.all_reduce(tx, ctx, impl="xla"))
    assert (j_one != j_xla).mean() > 0.1
    np.testing.assert_array_equal(t_one != t_xla, j_one != j_xla)


def test_method_choice_and_estimates_match_jax_under_one_spec(monkeypatch):
    """JAX's reduce-scatter choice reads its chip table; it is handed the
    one-card H100 spec, as the port's default is."""
    spec, jspec = _spec_pair()
    monkeypatch.setattr(jpm, "get_chip_spec", lambda device=None: jspec)
    for world in range(1, 9):
        jctx = jrs.create_reduce_scatter_context(_mesh(world), "tp")
        ctx = rs.create_reduce_scatter_context(world_size=world)
        for log in range(6, 27):
            n = 1 << log
            assert (ar.get_auto_allreduce_method(world, n, spec).value
                    == jar.get_auto_allreduce_method(world, n, jspec).value)
            assert ar.get_auto_allreduce_method(world, n).value == \
                jar.get_auto_allreduce_method(world, n, jspec).value
            assert ctx.resolve_method(n).value == \
                jctx.resolve_method(n).value, (world, n)
            assert pm.estimate_reduce_scatter_time_ms(n, world, spec) == \
                jpm.estimate_reduce_scatter_time_ms(n, world, jspec)
            assert pm.estimate_one_shot_reduce_time_ms(n, world, spec) == \
                jpm.estimate_one_shot_reduce_time_ms(n, world, jspec)
            for method in ("one_shot", "two_shot"):
                assert pm.estimate_all_reduce_time_ms(
                    n, world, spec, method) == \
                    jpm.estimate_all_reduce_time_ms(n, world, jspec, method)
    # Qwen3-8B's TP-world-4 shapes take one-shot (tools.perf_model).
    for nbytes in (4 * 4096 * 2, 512 * 4096 * 2):
        assert ar.get_auto_allreduce_method(4, nbytes) is \
            ar.AllReduceMethod.ONE_SHOT
    assert ar.get_auto_allreduce_method(4, 7 << 20) is \
        ar.AllReduceMethod.TWO_SHOT


def test_reduce_scatter_chooses_on_one_chunk_as_jax_does(monkeypatch):
    """At W = 4 a 3 MB chunk (12 MB partials) is below the ring's
    crossover (3.35 MB): the chunk picks one-shot, the whole buffer would
    pick the ring. The entry passes the chunk, as JAX does."""
    spec, jspec = _spec_pair()
    monkeypatch.setattr(jpm, "get_chip_spec", lambda device=None: jspec)
    ctx = rs.create_reduce_scatter_context(world_size=4)
    chunk = 3 * 10 ** 6
    assert ctx.resolve_method(chunk) is rs.ReduceScatterMethod.ONE_SHOT
    assert ctx.resolve_method(4 * chunk) is rs.ReduceScatterMethod.RING
    jctx = jrs.create_reduce_scatter_context(_mesh(4), "tp")
    assert jctx.resolve_method(chunk).value == "one_shot"
    seen = []
    monkeypatch.setattr(rs.ReduceScatterContext, "resolve_method",
                        lambda self, nbytes, spec=None: seen.append(nbytes)
                        or rs.ReduceScatterMethod.ONE_SHOT)
    rs.reduce_scatter(torch.ones(4, 8, 16), ctx)
    assert seen == [2 * 16 * 4]             # rows * N * itemsize


def test_operand_errors_raise_value_error():
    group = create_rank_group(4, device="cpu")
    x = torch.ones(4, 6, 16)
    with pytest.raises(ValueError, match="split"):   # JAX asserts M % W
        rs.reduce_scatter(x, rs.create_reduce_scatter_context(group=group))
    with pytest.raises(ValueError, match="impl"):
        ar.all_reduce(x, ar.create_allreduce_context(world_size=4),
                      impl="ring")
    with pytest.raises(ValueError, match="impl"):
        rs.reduce_scatter(torch.ones(4, 8, 16),
                          rs.create_reduce_scatter_context(world_size=4),
                          impl="ring")
    with pytest.raises(ValueError, match="disagree"):
        ar.create_allreduce_context(world_size=2, group=group)
    # CUDA without a group of two or more ranks: refused before any build.
    ctx = ar.create_allreduce_context(world_size=4)
    with pytest.raises(ValueError, match="CUDA"):
        rs.launch_reduce_world(x, ctx, "all_reduce", "one_shot")
    with pytest.raises(ValueError, match="group"):
        rs.launch_reduce_world(_on_cuda(x), ctx, "all_reduce", "one_shot")


def _on_cuda(t):
    """A CPU tensor that reports the CUDA device."""
    class CudaView(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)
    return t.as_subclass(CudaView)


def test_contexts_over_a_group_keep_state_and_cpu_calls_count_nothing():
    group = create_rank_group(4, device="cpu")
    actx = ar.create_allreduce_context(group=group, straggler_option=(1, 99))
    rctx = rs.create_reduce_scatter_context(group=group)
    assert actx.world_size == rctx.world_size == 4
    assert actx.state is not None and rctx.state is not None
    x = torch.randn(4, 8, 16)
    counts = (ar.all_reduce_launches.total, rs.reduce_scatter_launches.total)
    # The straggler changes no value.
    assert torch.equal(ar.all_reduce(x, actx), ar.all_reduce(
        x, ar.create_allreduce_context(world_size=4)))
    assert rs.reduce_scatter(x, rctx).shape == (8, 16)
    assert (ar.all_reduce_launches.total,
            rs.reduce_scatter_launches.total) == counts
