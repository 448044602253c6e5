"""The port's flash decode (triton_dist_tpu_torch.ops.flash_decode) against
the JAX package's on the CPU.

The same numpy-seeded f32 inputs go through the JAX
``gqa_fwd_batch_decode`` / ``gqa_fwd_batch_decode_paged`` on a 1-device
("tp", "sp") mesh, with ``impl="pallas"`` (the ``_decode_kernel``
"einsum" variant, the ``_tiled_decode_kernel`` "tiled" variant and the
direct paged kernel, in interpret mode) and ``impl="xla"``, and through
the port's plain versions; they agree within 1e-5 (f32 sums in another
order, and the tiled kernel's online softmax rescales its partial sums).
The CUDA kernels themselves run only on the card
(``tests/test_torch_kernels.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.ops import flash_decode as jfd
from triton_dist_tpu_torch.ops import flash_decode as fd

B, HQ, HKV, D, PAGE, NPG = 3, 8, 2, 16, 8, 6
T = PAGE * NPG
LENS = [0, 17, T]          # an empty row, a ragged row, a full row
ATOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("tp", "sp"))


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, HQ, D).astype(np.float32)
    k = rng.randn(B, T, HKV, D).astype(np.float32)
    v = rng.randn(B, T, HKV, D).astype(np.float32)
    return q, k, v


def _paged(k, v, seed=1):
    """The rows' pages scattered over a 20-page pool in a random order:
    (pool_k, pool_v, table (1, B, NPG))."""
    rng = np.random.RandomState(seed)
    slots = rng.permutation(20)[:B * NPG].reshape(B, NPG).astype(np.int32)
    pool_k = rng.randn(20, PAGE, HKV, D).astype(np.float32)
    pool_v = rng.randn(20, PAGE, HKV, D).astype(np.float32)
    pool_k[slots] = k.reshape(B, NPG, PAGE, HKV, D)
    pool_v[slots] = v.reshape(B, NPG, PAGE, HKV, D)
    return pool_k, pool_v, slots[None]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("variant,impl", [("einsum", "pallas"),
                                          ("tiled", "pallas"),
                                          ("auto", "xla")])
@pytest.mark.parametrize("lens", [LENS, 29], ids=["ragged", "scalar"])
def test_plain_decode_matches_jax(mesh, variant, impl, lens):
    q, k, v = _inputs()
    ctx = jfd.create_flash_decode_context(mesh, "sp", variant=variant,
                                          t_blk=16)
    want = jfd.gqa_fwd_batch_decode(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(lens,
                                                                jnp.int32),
                                    ctx, impl=impl)
    got = fd.flash_decode_reference(*_t(q, k, v), lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    if lens is LENS:
        assert not got[0].any()            # kv_len 0 gives 0, not NaN


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_plain_paged_decode_matches_jax_direct(mesh, impl):
    q, k, v = _inputs(2)
    pool_k, pool_v, table = _paged(k, v)
    ctx = dataclasses.replace(jfd.create_flash_decode_context(mesh, "sp"),
                              paged_variant="direct")
    want = jfd.gqa_fwd_batch_decode_paged(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(table), jnp.asarray(LENS, jnp.int32), ctx, impl=impl)
    got = fd.flash_decode_paged_reference(*_t(q, pool_k, pool_v, table),
                                          LENS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # The paged read equals the dense decode of the same rows.
    dense = fd.flash_decode_reference(*_t(q, k, v), LENS)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split_len,splits", [(16, 3), (32, 2), (64, 1)])
def test_partials_and_combine_compose_to_the_reference(dtype, split_len,
                                                       splits):
    q, k, v = (x.to(dtype) for x in _t(*_inputs(3)))
    a, l, m = fd.flash_decode_partials_reference(q, k, v, LENS, split_len,
                                                 splits)
    assert a.shape == (B, HKV, splits, HQ // HKV, D)
    assert l.shape == m.shape == (B, HKV, splits, HQ // HKV)
    got = fd.flash_decode_combine_reference(a, l, m, dtype)
    want = fd.flash_decode_reference(q, k, v, LENS)
    assert got.dtype == dtype
    # f32: the merge reorders f32 sums. bf16: p rounds to bf16 against
    # each split's own max, so a probability moves by up to 2^-8 of
    # itself and the output by up to 2^-8 of max|v|, plus one rounding.
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8 * 4.5 + 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("split_len,splits", [(16, 3), (64, 1)])
def test_fused_tiled_call_matches_jax_tiled_kernel(mesh, paged, split_len,
                                                   splits):
    """The one-launch tiled call (partial kernel + its merge tail) on the
    CPU: JAX's ``_tiled_decode_kernel`` within 1e-5, and bit-equal to the
    combine of the partials, as the card's fused launch must be."""
    q, k, v = _inputs(4)
    pool_k, pool_v, table = _paged(k, v, seed=5)
    ctx = jfd.create_flash_decode_context(mesh, "sp", variant="tiled",
                                          t_blk=16)
    want = jfd.gqa_fwd_batch_decode(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(LENS,
                                                                jnp.int32),
                                    ctx, impl="pallas")
    kk, vv, tab = (_t(pool_k, pool_v, table[0]) if paged
                   else (*_t(k, v), None))
    before = {n: c.total for n, c in fd.launches.items()}
    got = fd.flash_decode_tiled(_t(q)[0], kk, vv, LENS, split_len, splits,
                                tab)
    assert {n: c.total for n, c in fd.launches.items()} == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    parts = fd.flash_decode_partial(_t(q)[0], kk, vv, LENS, split_len,
                                    splits, tab)
    assert torch.equal(got, fd.flash_decode_combine(*parts, torch.float32))


@pytest.mark.parametrize("fault", [0, 1, 2])
def test_fused_tiled_fault_leaves_one_split_out(fault):
    """The planted fault of the fused call: the merge leaves split
    ``fault`` out, as the partials with that split emptied; rows whose
    live positions reach the split move, the others keep their bits."""
    q, k, v = _t(*_inputs(6))
    good = fd.flash_decode_tiled(q, k, v, LENS, 16, 3)
    bad = fd.flash_decode_tiled(q, k, v, LENS, 16, 3, fault=fault)
    a, l, m = (x.clone() for x in fd.flash_decode_partial(q, k, v, LENS, 16,
                                                          3))
    a[:, :, fault], l[:, :, fault], m[:, :, fault] = 0.0, 0.0, -1e30
    assert torch.equal(bad, fd.flash_decode_combine(a, l, m, torch.float32))
    for row, n in enumerate(LENS):
        assert torch.equal(bad[row], good[row]) == (n <= 16 * fault)
    with pytest.raises(ValueError, match="fault split"):
        fd.flash_decode_tiled(q, k, v, LENS, 16, 3, fault=3)


def test_cpu_wrappers_are_the_plain_versions_and_not_counted():
    q, k, v = _t(*_inputs(4))
    pool_k, pool_v, table = _t(*_paged(k.numpy(), v.numpy()))
    before = {n: c.total for n, c in fd.launches.items()}
    assert torch.equal(fd.flash_decode_single(q, k, v, LENS),
                       fd.flash_decode_reference(q, k, v, LENS))
    parts = fd.flash_decode_partial(q, k, v, LENS, 16, 3)
    for got, want in zip(parts, fd.flash_decode_partials_reference(
            q, k, v, LENS, 16, 3)):
        assert torch.equal(got, want)
    paged = fd.flash_decode_partial(q, pool_k, pool_v, LENS, 16, 3,
                                    table=table[0])
    for got, want in zip(paged, parts):
        assert torch.equal(got, want)
    assert torch.equal(fd.flash_decode_combine(*parts, torch.float32),
                       fd.flash_decode_combine_reference(*parts,
                                                         torch.float32))
    assert torch.equal(fd.flash_decode_tiled(q, k, v, LENS, 16, 3),
                       fd.flash_decode_combine_reference(*parts,
                                                         torch.float32))
    for ctx in (fd.FlashDecodeContext(variant="tiled"),
                fd.FlashDecodeContext(variant="einsum")):
        assert torch.equal(fd.gqa_fwd_batch_decode(q, k, v, LENS, ctx),
                           fd.flash_decode_reference(q, k, v, LENS))
    assert torch.equal(
        fd.gqa_fwd_batch_decode_paged(q, pool_k, pool_v, table, LENS),
        fd.flash_decode_paged_reference(q, pool_k, pool_v, table, LENS))
    assert {n: c.total for n, c in fd.launches.items()} == before


def test_context_rules_match_jax(mesh):
    jctx = jfd.create_flash_decode_context(mesh, "sp")
    ctx = fd.FlashDecodeContext()
    assert ctx.einsum_max_bytes == jctx.einsum_max_bytes == 4 * 2 ** 20
    for n in (1, 4 * 2 ** 20, 4 * 2 ** 20 + 1, 8 * 2 ** 20):
        assert ctx.resolve_variant(n) == jctx.resolve_variant(n)
    assert ctx.paged_variant == "direct"        # the JAX default: gathered
    with pytest.raises(ValueError, match="paged_variant"):
        fd.FlashDecodeContext(paged_variant="bogus")
    with pytest.raises(ValueError, match="variant"):
        fd.FlashDecodeContext(variant="bogus")


def test_port_reads_no_paged_variant_environment(monkeypatch):
    monkeypatch.setenv("TDT_PAGED_VARIANT", "bogus")
    assert fd.FlashDecodeContext().paged_variant == "direct"


@pytest.mark.parametrize("bad", ["shape", "groups", "table"])
def test_wrappers_reject_bad_operands(bad):
    q, k, v = _t(*_inputs())
    table = None
    if bad == "shape":
        v = v[:, :5]
    elif bad == "groups":
        q = q[:, :3]
    else:
        table = torch.zeros((B + 1, NPG), dtype=torch.int32)
    with pytest.raises(ValueError):
        fd.flash_decode_partial(q, k, v, 5, 16, 3, table=table)
