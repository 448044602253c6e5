"""The port's SP prefill attention (triton_dist_tpu_torch.ops.sp_attention)
and SP layers (triton_dist_tpu_torch.layers.sp_flash_decode) against the
JAX package's on the CPU.

The same numpy-seeded inputs go through the JAX functions on a 1-device
("tp", "sp") mesh (the fused ``_sp_fused_kernel``, the all-gather and
flash-decode Pallas kernels in interpret mode) and through the port,
whose CPU path is the plain version of each kernel. Tolerances: f32
within 1e-5 (sums in another order). bf16 within the port's own limit
``sp_attention_tolerance`` (ops/sp_attention.py): one bf16 ulp of the
larger output (``2**-7`` relative: both round the f32 result once) plus
``2**-8 * sum_j (p_j / l) |v_j|`` elementwise, for the probabilities'
own rounding to bf16. The CUDA kernel itself runs only on
the card (``tests/test_torch_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.layers import sp_flash_decode as jlayers
from triton_dist_tpu.ops import sp_attention as jsp
from triton_dist_tpu_torch.layers import sp_flash_decode as layers
from triton_dist_tpu_torch.ops import sp_attention as sp

F32_ATOL = 1e-5
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("tp", "sp"))


def _inputs(b, s, hq, hkv, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32)
                 for h in (hq, hkv, hkv))


def _pair(arrays, dtype):
    """The arrays as JAX and as torch tensors of one dtype (bf16 rounded
    once, the same way on both sides)."""
    _, jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(a, jdt) for a in arrays]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
         for x in j]
    return j, t


def assert_close(got, want, dtype, qkv=None, causal=True):
    """f32 within F32_ATOL; bf16 within the port's prefill tolerance
    (``sp_attention_tolerance`` on the inputs ``qkv``)."""
    assert got.shape == tuple(want.shape)
    want_t = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    assert bool(torch.isfinite(got.float()).all())
    diff = (got.float() - want_t).abs()
    if dtype == "f32":
        assert diff.max().item() <= F32_ATOL, diff.max().item()
        return
    lim = sp.sp_attention_tolerance(got, want_t, *qkv, causal=causal)
    assert bool((diff <= lim).all()), diff.max().item()


# (dtype, causal, B, S, Hq, Hkv, D, sq_blk, t_sub): S = 192 halves the
# default t_sub 128 to 64; S = 48 clamps it to 48, and t_sub = 32 halves
# to 16.
FUSED_CASES = [
    ("f32", True, 2, 192, 8, 2, 16, 128, 128),
    ("f32", False, 1, 48, 2, 2, 32, 32, 32),
    ("f32", True, 2, 48, 4, 4, 16, 128, 128),
    ("f32", False, 1, 192, 8, 2, 32, 64, 64),
    ("bf16", True, 1, 192, 8, 2, 32, 128, 128),
    ("bf16", False, 2, 48, 4, 1, 16, 32, 32),
]


@pytest.mark.parametrize("dtype,causal,b,s,hq,hkv,d,sq_blk,t_sub",
                         FUSED_CASES)
def test_plain_fused_matches_jax_pallas(mesh, dtype, causal, b, s, hq, hkv,
                                        d, sq_blk, t_sub):
    (jq, jk, jv), (q, k, v) = _pair(_inputs(b, s, hq, hkv, d), dtype)
    jctx = jsp.create_sp_attention_context(mesh, "sp", causal=causal)
    want = jsp.sp_ag_attention_fused(jq, jk, jv, jctx, sq_blk=sq_blk,
                                     t_sub=t_sub)
    ctx = sp.create_sp_attention_context(causal=causal)
    got = sp.sp_ag_attention_fused(q, k, v, ctx, sq_blk=sq_blk, t_sub=t_sub)
    assert got.dtype == q.dtype
    assert_close(got, want, dtype, (q, k, v), causal)
    # The functional entry routes impl="pallas" to the same function.
    assert torch.equal(sp.sp_ag_attention(q, k, v, ctx, impl="pallas"),
                       sp.sp_ag_attention_fused(q, k, v, ctx))


def test_clamped_tiles_are_jax_tiles():
    assert [sp._clamp_tile(128, s) for s in (48, 192, 1000, 4096, 7)] == [
        48, 64, 8, 128, 7]


@pytest.mark.parametrize("impl", sp.IMPLS)
@pytest.mark.parametrize("dtype,causal", [("f32", True), ("bf16", False)])
def test_every_impl_matches_jax(mesh, impl, dtype, causal):
    (jq, jk, jv), (q, k, v) = _pair(_inputs(2, 48, 4, 2, 16, seed=3), dtype)
    jctx = jsp.create_sp_attention_context(mesh, "sp", causal=causal)
    want = jsp.sp_ag_attention(jq, jk, jv, jctx, impl=impl)
    got = sp.sp_ag_attention(q, k, v,
                             sp.create_sp_attention_context(causal=causal),
                             impl=impl)
    assert_close(got, want, dtype, (q, k, v), causal)


@pytest.mark.parametrize("impl", ["ring", "xla"])
def test_chunked_prefill_matches_jax(mesh, impl):
    """A chunk of 16 queries at offset 24 over a 48-position cache with
    40 live positions (the ring/xla-only options)."""
    q = _inputs(1, 16, 4, 2, 16, seed=5)[0]
    _, k, v = _inputs(1, 48, 4, 2, 16, seed=6)
    jctx = jsp.create_sp_attention_context(mesh, "sp")
    want = jsp.sp_ag_attention(*map(jnp.asarray, (q, k, v)), jctx,
                               impl=impl, q_offset=24, kv_len=40)
    got = sp.sp_ag_attention(*map(torch.from_numpy, (q, k, v)), impl=impl,
                             q_offset=24, kv_len=40)
    assert_close(got, want, "f32")


@pytest.mark.parametrize("impl", ["pallas", "ag_pallas", "ulysses"])
@pytest.mark.parametrize("chunk", [dict(q_offset=8), dict(kv_len=40),
                                   dict(k_len=64)],
                         ids=["q_offset", "kv_len", "longer_kv"])
def test_fused_impls_refuse_chunked_prefill(impl, chunk):
    q = torch.zeros(1, 48, 4, 16)
    k = torch.zeros(1, chunk.get("k_len", 48), 2, 16)
    opts = {n: x for n, x in chunk.items() if n != "k_len"}
    with pytest.raises(ValueError, match="chunked prefill"):
        sp.sp_ag_attention(q, k, k, impl=impl, **opts)


def test_head_axis_only_with_ring_and_xla():
    q, k, v = map(torch.from_numpy, _inputs(1, 48, 4, 2, 16))
    ctx = sp.create_sp_attention_context(head_axis="tp")
    ring = sp.sp_ag_attention(q, k, v, ctx, impl="ring")
    assert torch.equal(ring, sp.sp_ag_attention(q, k, v, impl="ring"))
    for impl in ("pallas", "ag_pallas", "ulysses"):
        with pytest.raises(ValueError, match="head_axis"):
            sp.sp_ag_attention(q, k, v, ctx, impl=impl)
    with pytest.raises(ValueError, match="unknown"):
        sp.sp_ag_attention(q, k, v, impl="flash")


def test_unported_world_raises_with_roadmap_item():
    q = torch.zeros(1, 48, 4, 16)
    ctx = sp.create_sp_attention_context(world_size=2)
    for call in (lambda: sp.sp_ag_attention(q, q, q, ctx, impl="ring"),
                 lambda: sp.sp_ag_attention_fused(q, q, q, ctx)):
        with pytest.raises(NotImplementedError, match="Queue B item 6"):
            call()


@pytest.mark.parametrize("world", [1, 2, 4])
def test_zigzag_matches_jax(world):
    x = np.arange(2 * 48 * 3, dtype=np.float32).reshape(2, 48, 3)
    got = sp.zigzag_reorder(torch.from_numpy(x), world)
    want = jsp.zigzag_reorder(jnp.asarray(x), world)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = sp.zigzag_restore(got, world)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jsp.zigzag_restore(want, world)))
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        sp.zigzag_reorder(torch.zeros(1, 5), world=2)


# -- layers --------------------------------------------------------------------
@pytest.mark.parametrize("impl,causal", [("pallas", True), ("ring", False)])
def test_sp_attention_layer_matches_jax(mesh, impl, causal):
    q, k, v = _inputs(1, 192, 8, 2, 16, seed=7)
    want = jlayers.SpAttentionLayer(mesh, "sp", causal=causal, impl=impl)(
        *map(jnp.asarray, (q, k, v)))
    layer = layers.SpAttentionLayer(causal=causal, impl=impl)
    assert layer.ctx.causal is causal and layer.impl == impl
    assert layers.SpAttentionLayer().impl == "ring"       # JAX's default
    got = layer(*map(torch.from_numpy, (q, k, v)))
    assert_close(got, want, "f32")


B, T, HQ, HKV, D = 2, 32, 8, 2, 16


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_sp_flash_decode_layer_matches_jax(mesh, impl):
    """init_cache, a prefill-sized append, one-position appends (the last
    at an offset past the end, which JAX clamps) and decode."""
    rng = np.random.RandomState(11)
    jl = jlayers.SpFlashDecodeLayer(B, T, HKV, D, mesh, "sp",
                                    dtype=jnp.float32, impl=impl)
    tl = layers.SpFlashDecodeLayer(B, T, HKV, D, dtype=torch.float32,
                                   impl=impl, device="cpu")
    assert layers.SpFlashDecodeLayer(B, T, HKV, D,
                                     device="cpu").impl == "pallas"
    jc, tc = jl.init_cache(), tl.init_cache()
    assert tc[0].shape == (B, T, HKV, D) and not tc[0].any()
    for n, offset in ((20, 0), (1, 20), (1, 21), (2, 40)):
        kn = rng.randn(B, n, HKV, D).astype(np.float32)
        vn = rng.randn(B, n, HKV, D).astype(np.float32)
        jc = jl.append(jc, jnp.asarray(kn), jnp.asarray(vn), offset)
        ptrs = [c.data_ptr() for c in tc]
        tc = tl.append(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                       offset)
        assert [c.data_ptr() for c in tc] == ptrs           # in place
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The last append (offset 40 > T - 2) landed at T - 2.
    assert tc[0][:, T - 2:].abs().sum() > 0
    q = rng.randn(B, HQ, D).astype(np.float32)
    for kv_len in (22, np.array([5, T], np.int32)):
        want = jl(jnp.asarray(q), jc, jnp.asarray(kv_len))
        got = tl(torch.from_numpy(q), tc, torch.as_tensor(kv_len))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_ATOL, rtol=0)


def test_sp_flash_decode_append_clamps_a_tensor_offset():
    tl = layers.SpFlashDecodeLayer(1, 8, 1, 4, dtype=torch.float32,
                                   device="cpu")
    cache = tl.init_cache()
    new = torch.ones(1, 2, 1, 4)
    for offset, first in ((torch.tensor(-3), 0), (torch.tensor(7), 6),
                          (torch.tensor(3, dtype=torch.int32), 3)):
        ck, _ = tl.append(tl.init_cache(), new, new, offset)
        assert ck[0, first:first + 2].eq(1).all() and ck.sum() == 8
    with pytest.raises(ValueError, match="unknown"):
        layers.SpFlashDecodeLayer(1, 8, 1, 4, impl="ring", device="cpu")
    assert cache[0].device == torch.device("cpu")


def test_layers_need_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        layers.SpFlashDecodeLayer(1, 8, 1, 4)
    layer = layers.SpFlashDecodeLayer(1, 8, 1, 4, device="cpu")
    assert layer.init_cache()[0].device == torch.device("cpu")
