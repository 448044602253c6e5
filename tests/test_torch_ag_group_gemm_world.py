"""``ag_group_gemm`` at world W on the CPU: the port's impls "xla", "ring"
and "fused" over W ranks (their plain versions, the CPU path of the entry)
against the JAX package's same impl on W devices of the 8-device CPU mesh,
its fused Pallas kernel ``_ag_group_gemm_kernel`` in interpret mode with
``block_m, block_n = 8, 32`` (as ``tests/test_moe.py`` runs it).

Sizes: M = 16 W rows of K = 64, N = 32 W columns, E = 4 experts; inputs
from numpy with fixed seeds. W = 2, 3, 4 in every impl; W = 8 in "xla"
and "ring" only (JAX's interpret-mode fused kernel at W = 8 runs for
minutes on the CPU). Tolerances: f32 within 1e-5 (sums in other orders); bf16
within one bf16 ulp of the larger value (both sides sum in f32 and round
once). Sentinel ids (``== E``) run through the last expert in the port
and in JAX's "xla" / "ring"; JAX's fused kernel leaves those rows
unspecified, so the fused case compares the valid rows only. The port's
xla and ring bodies agree within 1e-6 (f32): the same function, with K
perhaps blocked differently by the BLAS for another row count.

The CUDA kernel (``csrc/ag_group_gemm.cu``) runs on the card
(``tests/test_torch_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.ops import group_gemm as jgg
from triton_dist_tpu_torch.ops import group_gemm as gg
from triton_dist_tpu_torch.runtime.dist import create_rank_group

K, E = 64, 4
BF16_ULP_REL = 2.0 ** -7
#: (world, impl, dtype) held against JAX's same impl.
CASES = ([(w, "fused", "float32") for w in (2, 3, 4)]
         + [(w, impl, "float32") for impl in ("xla", "ring")
            for w in (2, 3, 4, 8)]
         + [(4, impl, "bfloat16") for impl in ("xla", "ring", "fused")])


def _inputs(world, seed, sentinel=0.0):
    """x (16 W, K), w (E, K, 32 W) and int32 ids, a ``sentinel`` share of
    them set to E."""
    rng = np.random.RandomState(seed)
    m, n = 16 * world, 32 * world
    x = (rng.randn(m, K) / 4).astype(np.float32)
    w = (rng.randn(E, K, n) / 4).astype(np.float32)
    ids = rng.randint(0, E, m).astype(np.int32)
    ids[rng.rand(m) < sentinel] = E
    return x, w, ids


def _jax(x, w, ids, world, impl, dtype):
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    ctx = jgg.create_ag_group_gemm_context(mesh, "tp")
    ctx.block_m, ctx.block_n = 8, 32
    dt = getattr(jnp, dtype)
    xs = jax.device_put(jnp.asarray(x, dt), NamedSharding(mesh, P("tp")))
    ws = jax.device_put(jnp.asarray(w, dt),
                        NamedSharding(mesh, P(None, None, "tp")))
    ids_s = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P("tp")))
    out = jgg.ag_group_gemm(xs, ws, ids_s, E, ctx, impl=impl)
    return np.asarray(out.astype(jnp.float32))


def _port(x, w, ids, world, impl, dtype):
    dt = getattr(torch, dtype)
    ctx = gg.create_ag_group_gemm_context(
        group=create_rank_group(world, device="cpu"))
    out = gg.ag_group_gemm(torch.from_numpy(x).to(dt),
                           torch.from_numpy(w).to(dt),
                           torch.from_numpy(ids), E, ctx, impl=impl)
    assert out.dtype == dt and out.shape == (x.shape[0], w.shape[2])
    return out.float().numpy()


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        lim = BF16_ULP_REL * np.maximum(np.abs(got), np.abs(want)) + 1e-6
        assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


@pytest.mark.parametrize("world,impl,dtype", CASES)
def test_ag_group_gemm_world_matches_jax(world, impl, dtype):
    x, w, ids = _inputs(world, seed=world)
    got = _port(x, w, ids, world, impl, dtype)
    _close(got, _jax(x, w, ids, world, impl, dtype), dtype)


@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_ag_group_gemm_world_sentinel_rows(impl):
    """A quarter of the ids are the sentinel E: JAX's fused kernel leaves
    their rows unspecified, so "fused" is held on the valid rows; "xla"
    runs them through the last expert on both sides."""
    world = 2
    x, w, ids = _inputs(world, seed=11, sentinel=0.25)
    assert (ids == E).any() and (ids < E).any()
    got = _port(x, w, ids, world, impl, "float32")
    want = _jax(x, w, ids, world, impl, "float32")
    rows = ids < E if impl == "fused" else slice(None)
    _close(got[rows], want[rows], "float32")


@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_ag_group_gemm_ring_and_one_shot_bodies_agree(world):
    x, w, ids = _inputs(world, seed=20 + world, sentinel=0.1)
    tx, tw, tids = (torch.from_numpy(a) for a in (x, w, ids))
    one_shot = gg.ag_group_gemm_reference(tx, tw, tids, E, world)
    ring = gg.ag_group_gemm_ring_reference(tx, tw, tids, E, world)
    np.testing.assert_allclose(ring.numpy(), one_shot.numpy(), rtol=1e-6,
                               atol=1e-6)
    # Each rank's columns are the grouped product of every row against its
    # shard: the world-1 entry on that shard.
    n = w.shape[2] // world
    for r in range(world):
        cols = slice(r * n, (r + 1) * n)
        assert torch.equal(one_shot[:, cols], gg.grouped_matmul_reference(
            tx, tw[:, :, cols], tids, E))


def test_ag_group_gemm_world_cpu_paths_take_the_plain_versions():
    """On CPU tensors "fused" is the ring version (the kernel's chunk
    order) and "xla" the one-shot version; no kernel launch is counted. A
    group of one rank is the world-1 entry."""
    world = 4
    x, w, ids = (torch.from_numpy(a) for a in _inputs(world, seed=5))
    ctx = gg.create_ag_group_gemm_context(
        group=create_rank_group(world, device="cpu"))
    before = (gg.ag_group_gemm_launches.total, gg.group_gemm_launches.total)
    assert torch.equal(gg.ag_group_gemm(x, w, ids, E, ctx, impl="fused"),
                       gg.ag_group_gemm_ring_reference(x, w, ids, E, world))
    assert torch.equal(gg.ag_group_gemm(x, w, ids, E, ctx, impl="ring"),
                       gg.ag_group_gemm_ring_reference(x, w, ids, E, world))
    assert torch.equal(gg.ag_group_gemm(x, w, ids, E, ctx, impl="xla"),
                       gg.ag_group_gemm_reference(x, w, ids, E, world))
    assert (gg.ag_group_gemm_launches.total,
            gg.group_gemm_launches.total) == before
    assert ctx.world_size == world and ctx.state is not None
    one = gg.create_ag_group_gemm_context(
        group=create_rank_group(1, device="cpu"))
    assert one.world_size == 1 and one.state is None
    assert torch.equal(gg.ag_group_gemm(x, w, ids, E, one, impl="fused"),
                       gg.grouped_matmul_reference(x, w, ids, E))


@pytest.mark.parametrize("shape,match", [
    (((12, K), (E, K, 64), 12), "split over the ranks"),
    (((16, K), (E, K, 60), 16), "split over the ranks"),
    (((16, K), (E, K, 64), 8), "expert ids"),
    (((16, K), (E, 32, 64), 16), "do not fit"),
], ids=["rows", "columns", "ids", "k"])
def test_ag_group_gemm_world_rejects_bad_operands(shape, match):
    (m, k), w_shape, n_ids = shape
    ctx = gg.create_ag_group_gemm_context(
        group=create_rank_group(8, device="cpu"))
    with pytest.raises(ValueError, match=match):
        gg.ag_group_gemm(torch.ones(m, k), torch.ones(w_shape),
                         torch.zeros(n_ids, dtype=torch.int32), E, ctx,
                         impl="ring")
