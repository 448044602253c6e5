"""``moe_reduce_rs(impl="fused")`` at world W on the CPU: the port's plain
version of the fused kernel's ring (the CPU path of the entry) against
the JAX package's ``moe_reduce_rs(impl="fused")`` on W devices of the
8-device CPU mesh, its Pallas kernel ``_moe_rs_fused_kernel`` in interpret
mode with ``block_m, block_h = 8, 32`` (as ``tests/test_moe.py`` runs it).

Sizes: T = 4 W tokens, top-2, I = 32 W (32 a rank), H = 64, E = 4;
inputs from numpy with fixed seeds, valid ids. W = 2, 3, 4 in f32 and
W = 4 in bf16 against JAX's kernel (each interpret-mode call takes ~20 s
on the CPU here, W = 8 ~40 s, so W = 8 is held to an independent numpy
statement of JAX's ring order instead). Tolerances: f32 within 1e-5
(the f32 sums run in other orders); bf16 within one bf16 ulp of the
larger value per rounding, W roundings (chunk c's partial rounds on each
of the W ranks it passes). In bf16 the
fused ring rounds where impl "ring" does not, and the two differ on both
sides as they do in JAX. Sentinel ids (``== E``) run through the last
expert in the port; JAX's fused kernel drops those pairs, so the
sentinel case holds the port to its own plain statement only.

The CUDA kernel (``csrc/moe_rs_ring.cu``) runs on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase 25)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.ops import moe_reduce_rs as jmrs
from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs

K, H, E = 2, 64, 4
BF16_ULP_REL = 2.0 ** -7
#: (world, dtype) held against JAX's fused kernel.
CASES = [(2, "float32"), (3, "float32"), (4, "float32"), (4, "bfloat16")]


def _inputs(world, seed, sentinel=0.0):
    """act (T k, I), w_down (E, I, H), int32 ids (a ``sentinel`` share set
    to E) and f32 weights (T, k), T = 4 W, I = 32 W."""
    rng = np.random.RandomState(seed)
    t, i = 4 * world, 32 * world
    act = (rng.randn(t * K, i) / 2).astype(np.float32)
    w_down = (rng.randn(E, i, H) * i ** -0.5).astype(np.float32)
    ids = rng.randint(0, E, t * K).astype(np.int32)
    ids[rng.rand(t * K) < sentinel] = E
    wts = rng.rand(t, K).astype(np.float32)
    return act, w_down, ids, wts


@functools.cache
def _jax(world, dtype, impl, seed):
    act, w_down, ids, wts = _inputs(world, seed)
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    ctx = jmrs.create_moe_rs_context(mesh, "tp", num_experts=E, topk=K)
    ctx.block_m, ctx.block_h = 8, 32
    dt = getattr(jnp, dtype)
    out = jmrs.moe_reduce_rs(jnp.asarray(act, dt), jnp.asarray(w_down, dt),
                             jnp.asarray(ids), jnp.asarray(wts), ctx,
                             impl=impl)
    return np.asarray(out.astype(jnp.float32))


def _port(world, dtype, impl, seed):
    dt = getattr(torch, dtype)
    act, w_down, ids, wts = (torch.from_numpy(a)
                             for a in _inputs(world, seed))
    ctx = mrs.create_moe_rs_context(num_experts=E, topk=K, world_size=world)
    out = mrs.moe_reduce_rs(act.to(dt), w_down.to(dt), ids, wts, ctx,
                            impl=impl)
    assert out.dtype == dt and out.shape == (4 * world, H)
    return out.float().numpy()


def _close(got, want, dtype, world):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        lim = (world * BF16_ULP_REL * np.maximum(np.abs(got), np.abs(want))
               + 1e-6)
        assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


@pytest.mark.parametrize("world,dtype", CASES)
def test_moe_reduce_rs_fused_world_matches_jax(world, dtype):
    got = _port(world, dtype, "fused", seed=world)
    _close(got, _jax(world, dtype, "fused", world), dtype, world)


def test_fused_and_ring_round_apart_in_bf16_as_jax_does():
    """bf16 at W = 4: "ring" carries an f32 sum and rounds once, "fused"
    rounds at every hop. The two differ by up to W ulps on both sides,
    and each port impl stays with JAX's same impl."""
    world = 4
    port = {impl: _port(world, "bfloat16", impl, seed=world)
            for impl in ("fused", "ring")}
    jax_ = {impl: _jax(world, "bfloat16", impl, world)
            for impl in ("fused", "ring")}
    assert (port["fused"] != port["ring"]).any()
    assert (jax_["fused"] != jax_["ring"]).any()
    _close(port["ring"], jax_["ring"], "bfloat16", 1)
    _close(port["fused"], jax_["fused"], "bfloat16", world)
    # In f32 the two impls compute one function (sums in other orders).
    np.testing.assert_allclose(_port(world, "float32", "fused", world),
                               _port(world, "float32", "ring", world),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_fused_world_reference_follows_jax_ring_order(world):
    """The plain version against an independent numpy statement of JAX's
    ring (moe_reduce_rs.py:207-222) in bf16: each rank's f32 partial of
    chunk c; the chunk starts on rank c + 1, rounded, and each of the
    next W - 1 ranks adds its own partial in f32 and rounds."""
    act, w_down, ids, wts = _inputs(world, seed=40 + world)
    t, i = wts.shape[0], act.shape[1]
    rows, i_loc = t // world, i // world
    bf = torch.bfloat16
    act_b = torch.from_numpy(act).to(bf)
    wd_b = torch.from_numpy(w_down).to(bf)
    a32, w32 = act_b.float().numpy(), wd_b.float().numpy()
    parts = []
    for r in range(world):
        cols = slice(r * i_loc, (r + 1) * i_loc)
        pair = np.einsum("pi,pih->ph", a32[:, cols].astype(np.float64),
                         w32[ids, cols].astype(np.float64))
        parts.append((pair.reshape(t, K, H) * wts[..., None]).sum(1))

    def rnd(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(bf).float()

    want = np.zeros((t, H), np.float32)
    for c in range(world):
        blk = slice(c * rows, (c + 1) * rows)
        acc = rnd(parts[(c + 1) % world][blk])
        for s in range(2, world + 1):
            acc = rnd(parts[(c + s) % world][blk] + acc.numpy())
        want[blk] = acc.numpy()
    got, mag = mrs.moe_reduce_rs_fused_world_reference(
        act_b, wd_b, torch.from_numpy(ids), torch.from_numpy(wts), E, world,
        magnitude=True)
    assert got.dtype == bf and mag.shape == (t, H)
    # The f64 and f32 partials differ below a bf16 ulp: a rounding may
    # flip, by one ulp of the value it rounds, at each of the W hops.
    lim = BF16_ULP_REL * mag.numpy() + 1e-6
    assert (np.abs(got.float().numpy() - want) <= lim).all()
    assert (mag.numpy() >= np.abs(got.float().numpy()) * 0.99).all()


def test_fused_world_sentinel_pairs_run_through_the_last_expert():
    world = 4
    act, w_down, ids, wts = (torch.from_numpy(a) for a in
                             _inputs(world, seed=9, sentinel=0.25))
    assert (ids == E).any() and (ids < E).any()
    ctx = mrs.create_moe_rs_context(num_experts=E, topk=K, world_size=world)
    got = mrs.moe_reduce_rs(act, w_down, ids, wts, ctx, impl="fused")
    assert torch.equal(got, mrs.moe_reduce_rs_fused_world_reference(
        act, w_down, ids, wts, E, world))
    assert torch.equal(got, mrs.moe_reduce_rs_fused_world_reference(
        act, w_down, ids.clamp(max=E - 1), wts, E, world))


def test_fused_world_cpu_path_launches_nothing_and_keeps_no_state():
    world = 4
    act, w_down, ids, wts = (torch.from_numpy(a)
                             for a in _inputs(world, seed=3))
    ctx = mrs.create_moe_rs_context(num_experts=E, topk=K, world_size=world)
    before = (mrs.moe_rs_ring_launches.total, mrs.moe_rs_launches.total)
    mrs.moe_reduce_rs(act, w_down, ids, wts, ctx, impl="fused")
    assert (mrs.moe_rs_ring_launches.total,
            mrs.moe_rs_launches.total) == before
    assert ctx.state is None


@pytest.mark.parametrize("shape,err,match", [
    (((24, 64), (E, 64, H), 24, (12, K)), ValueError, "split over"),
    (((32, 60), (E, 60, H), 32, (16, K)), ValueError, "split over"),
    (((32, 64), (E, 32, H), 32, (16, K)), ValueError, "do not fit"),
    (((32, 64), (E, 64, H), 30, (16, K)), ValueError, "do not fit"),
    (((32, 64), (E, 64), 32, (16, K)), ValueError, "needs act"),
], ids=["tokens", "width", "w_down", "ids", "rank"])
def test_fused_world_rejects_bad_operands(shape, err, match):
    (tk, i), w_shape, n_ids, w_shape2 = shape
    ctx = mrs.create_moe_rs_context(num_experts=E, topk=K, world_size=8)
    with pytest.raises(err, match=match):
        mrs.moe_reduce_rs(torch.ones(tk, i), torch.ones(w_shape),
                          torch.zeros(n_ids, dtype=torch.int32),
                          torch.ones(w_shape2), ctx, impl="fused")


def test_fused_world_refuses_auto_and_unknown_impls():
    ctx = mrs.create_moe_rs_context(num_experts=E, topk=K, world_size=4)
    args = (torch.ones(32, 64), torch.ones(E, 64, H),
            torch.zeros(32, dtype=torch.int32), torch.ones(16, K), ctx)
    with pytest.raises(NotImplementedError, match="Queue A item 19"):
        mrs.moe_reduce_rs(*args, impl="auto")
    with pytest.raises(ValueError, match="unknown"):
        mrs.moe_reduce_rs(*args, impl="pallas")
