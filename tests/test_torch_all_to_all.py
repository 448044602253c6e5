"""The port's all-to-all, rank group and symmetric memory against the JAX
package's, on the CPU.

* ``fast_all_to_all``: the plain version (what a CPU tensor runs under
  ``impl="pallas"``) against JAX's ``fast_all_to_all(impl="pallas")``, its
  ``_a2a_kernel`` in interpret mode, at W = 2, 4 and 8 over the 8-device
  CPU mesh, capacity 16 with random live counts in [0, 16], f32 and bf16:
  live rows and receive counts exactly equal. ``impl="xla"`` equal too.
* The fp8 wire against JAX's ``fast_all_to_all_fp8``: the dequantized live
  rows bit-equal (both quantize with one f32 division and round to e4m3
  to nearest even).
* The schedule helpers and the chunk choice equal to JAX's over worlds
  1..8 and every position.
* ``symm_tensor``'s shape contract and the rank views of a group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.ops import all_to_all as jax_a2a
from triton_dist_tpu.runtime.symm_mem import symm_tensor as jax_symm_tensor
from triton_dist_tpu_torch.ops import all_to_all as a2a
from triton_dist_tpu_torch.runtime import symm_mem
from triton_dist_tpu_torch.runtime.dist import RankGroup, create_rank_group

CAP, H = 16, 64
WORLDS = [2, 4, 8]


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _inputs(world, seed):
    rng = np.random.RandomState(seed)
    buf = rng.randn(world * world, CAP, H).astype(np.float32)
    # Mixed magnitudes (1e-3 .. 1e3) stress the fp8 path's row scales.
    buf *= 10.0 ** rng.uniform(-3, 3, size=(world * world, CAP, 1))
    counts = rng.randint(0, CAP + 1, size=world * world).astype(np.int32)
    counts[0] = CAP                      # a full slab and an empty one
    counts[-1] = 0
    return buf.astype(np.float32), counts


def _jax_run(fn, world, buf, counts, dtype):
    mesh = _mesh(world)
    ctx = jax_a2a.create_all_to_all_context(mesh, "tp", capacity=CAP)
    sh = NamedSharding(mesh, P("tp"))
    x = jax.device_put(jnp.asarray(buf).astype(dtype), sh)
    c = jax.device_put(jnp.asarray(counts), sh)
    recv, rcounts = fn(x, c, ctx, impl="pallas")
    return (np.asarray(recv.astype(jnp.float32)), np.asarray(rcounts))


@pytest.fixture(scope="module")
def jax_results():
    """JAX's Pallas exchange of each (world, wire) case, computed once."""
    out = {}
    for world in WORLDS:
        buf, counts = _inputs(world, seed=world)
        out[world, "f32"] = _jax_run(jax_a2a.fast_all_to_all, world, buf,
                                     counts, jnp.float32)
        out[world, "bf16"] = _jax_run(jax_a2a.fast_all_to_all, world, buf,
                                      counts, jnp.bfloat16)
        out[world, "fp8"] = _jax_run(jax_a2a.fast_all_to_all_fp8, world, buf,
                                     counts, jnp.bfloat16)
    return out


def _group(world):
    return create_rank_group(world, device="cpu")


def _assert_live_rows_equal(got, got_counts, want, want_counts, world):
    got = got.reshape(world, world, CAP, H)
    want = want.reshape(world, world, CAP, H)
    np.testing.assert_array_equal(got_counts, want_counts)
    rc = want_counts.reshape(world, world)
    for d in range(world):
        for s in range(world):
            n = rc[d, s]
            np.testing.assert_array_equal(got[d, s, :n], want[d, s, :n])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("world", WORLDS)
def test_fast_all_to_all_matches_jax_pallas(jax_results, world, dtype):
    buf, counts = _inputs(world, seed=world)
    x = torch.from_numpy(buf)
    if dtype == "bf16":
        x = x.bfloat16()
    ctx = a2a.create_all_to_all_context(_group(world), capacity=CAP)
    want, want_counts = jax_results[world, dtype]
    for impl in ("pallas", "xla"):
        recv, rcounts = a2a.fast_all_to_all(x, torch.from_numpy(counts), ctx,
                                            impl=impl)
        assert recv.shape == x.shape and recv.dtype == x.dtype
        _assert_live_rows_equal(recv.float().numpy(), rcounts.numpy(), want,
                                want_counts, world)


@pytest.mark.parametrize("world", WORLDS)
def test_fast_all_to_all_fp8_matches_jax_pallas(jax_results, world):
    buf, counts = _inputs(world, seed=world)
    x = torch.from_numpy(buf).bfloat16()
    ctx = a2a.create_all_to_all_context(_group(world), capacity=CAP)
    recv, rcounts = a2a.fast_all_to_all_fp8(x, torch.from_numpy(counts), ctx)
    assert recv.dtype == torch.bfloat16
    want, want_counts = jax_results[world, "fp8"]
    _assert_live_rows_equal(recv.float().numpy(), rcounts.numpy(), want,
                            want_counts, world)


def test_fp8_rows_quantize_as_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(6, 40) * 10.0 ** rng.uniform(-3, 3, (6, 1))).astype(
        np.float32)
    x[2] = 0.0                                   # a zero row: scale 1
    jq, js = jax_a2a.quantize_fp8_rows(jnp.asarray(x))
    q, s = a2a.quantize_fp8_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        q.view(torch.int8).numpy(),
        np.asarray(jax.lax.bitcast_convert_type(jq, jnp.int8)))
    np.testing.assert_array_equal(
        a2a.dequantize_fp8_rows(q, s, torch.float32).numpy(),
        np.asarray(jax_a2a.dequantize_fp8_rows(jq, js, jnp.float32)))


def test_reference_moves_only_live_chunks():
    """Rows of dead chunks keep what ``out`` held; the last live chunk
    moves whole, as the kernel moves it."""
    world, cap, chunk = 2, 16, 8
    send = torch.arange(world * world * cap * 2, dtype=torch.float32
                        ).reshape(world * world, cap, 2)
    counts = torch.tensor([16, 3, 0, 9], dtype=torch.int32)   # [s*W + d]
    out = torch.full_like(send, float("nan"))
    recv, rcounts = a2a.fast_all_to_all_reference(send, counts, world, chunk,
                                                  out=out)
    assert recv is out and rcounts.tolist() == [16, 0, 3, 9]
    r = recv.reshape(world, world, cap, 2)
    s = send.reshape(world, world, cap, 2)
    for d in range(world):
        for src in range(world):
            rows = -(-int(counts[src * world + d]) // chunk) * chunk
            assert torch.equal(r[d, src, :rows], s[src, d, :rows])
            assert torch.isnan(r[d, src, rows:]).all()


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
def test_default_chunk_rows_matches_jax(itemsize):
    for cap in list(range(1, 300)) + [512, 1000, 1024, 4096]:
        assert a2a._default_chunk_rows(cap, itemsize) == \
            jax_a2a._default_chunk_rows(cap, itemsize), cap


@pytest.mark.parametrize("world", range(1, 9))
def test_schedule_helpers_match_jax(world):
    me = np.arange(world)[:, None]
    pos = np.arange(world)[None, :]
    for name in ("a2a_send_peer", "a2a_wait_src"):
        want = np.asarray(getattr(jax_a2a, name)(
            jnp.asarray(me), jnp.asarray(pos), world))
        got = getattr(a2a, name)(torch.from_numpy(me), torch.from_numpy(pos),
                                 world).numpy()
        np.testing.assert_array_equal(got, want)
        for m in range(world):                  # the kernel's int form
            for i in range(world):
                assert getattr(a2a, name)(m, i, world) == want[m, i]
    # Every peer is sent to once and waited on once per rank.
    peers = a2a.a2a_send_peer(me, pos, world)
    srcs = a2a.a2a_wait_src(me, pos, world)
    for m in range(world):
        assert sorted(peers[m].tolist()) == list(range(world))
        assert all(a2a.a2a_send_peer(srcs[m, i], i, world) == m
                   for i in range(world))
    counts = np.arange(0, 4 * world + 40)
    for chunk in (1, 8, 16, 32, 128):
        want = np.asarray(jax_a2a.a2a_live_chunks(jnp.asarray(counts), chunk))
        np.testing.assert_array_equal(
            a2a.a2a_live_chunks(torch.from_numpy(counts), chunk).numpy(), want)


@pytest.mark.parametrize("world", [1, 4])
def test_symm_tensor_shape_contract_matches_jax(world):
    want = jax_symm_tensor((3, 5), jnp.float32, _mesh(world), "tp", fill=2)
    got = symm_mem.symm_tensor((3, 5), torch.float32, _group(world), fill=2)
    assert got.shape == tuple(want.shape) == (world, 3, 5)
    assert got.world == world and got.dtype == torch.float32
    assert all(b.shape == (3, 5) and bool((b == 2).all())
               for b in got.buffers)
    # W separate allocations, addressed through the device table.
    assert len({b.data_ptr() for b in got.buffers}) == world
    assert got.table.tolist() == [b.data_ptr() for b in got.buffers]
    assert symm_mem.local_shard(got, world - 1) is got.buffers[world - 1]
    np.testing.assert_array_equal(
        symm_mem.local_shard(got, 0).numpy(),
        np.asarray(jax.device_get(want))[0])
    like = symm_mem.symm_like(torch.zeros(2, 7, dtype=torch.int64),
                              _group(world))
    assert like.shape == (world, 2, 7) and like.dtype == torch.int64


def test_rank_table_addresses_each_rank_shard():
    x = torch.zeros(4 * 3, 5, dtype=torch.bfloat16)
    table = symm_mem.rank_table(x, 4)
    assert table.tolist() == [x[r * 3].data_ptr() for r in range(4)]
    with pytest.raises(ValueError):
        symm_mem.rank_table(x, 5)


def test_rank_group_shards_are_views():
    g = _group(4)
    x = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    rows, cols = g.shard(x, 0), g.shard(x, 1)
    assert [r.data_ptr() for r in rows] == [x[2 * i].data_ptr()
                                            for i in range(4)]
    assert [c.data_ptr() for c in cols] == [x[0, 2 * i:].data_ptr()
                                            for i in range(4)]
    assert all(s.shape == (2, 8) for s in rows)
    assert g.shard(x, None) == [x] * 4          # replicated: one tensor
    from triton_dist_tpu_torch.layers.common import shard_param
    assert [w.data_ptr() for w in shard_param(x, g, 0)] == \
        [r.data_ptr() for r in rows]
    assert shard_param(x, g, None) == [x] * 4
    assert torch.equal(g.unshard(cols, 1), x)
    # per_rank: once per rank on its views, joined rank-major.
    seen = []
    out = g.per_rank(lambda a, b: (seen.append(a.shape) or a + b.sum(),
                                   a * 0), x, x, in_dims=(0, None),
                     out_dims=(0, 0))
    assert seen == [(2, 8)] * 4
    assert torch.equal(out[0], x + x.sum()) and torch.equal(out[1], 0 * x)
    parts = [torch.full((2,), float(r)) for r in range(4)]
    assert g.psum(parts).tolist() == [6.0, 6.0]
    with pytest.raises(ValueError):
        g.shard(torch.zeros(6, 2), 0)
    with pytest.raises(ValueError):
        RankGroup(world=0, device="cpu")
