"""The port's gemm_ar (triton_dist_tpu_torch.ops.gemm_reduce_scatter)
against the JAX package's gemm_ar(impl="pallas") on a 1-device mesh (the
Pallas kernel in interpret mode), and the CUDA kernels (gemm_ar and the
three flash-decode kernels of ops.flash_decode) against their plain
versions on the card (marked ``cuda``; skipped without one). The flash
decode's CPU parity tests are in tests/test_torch_flash_decode.py.

Inputs come from numpy with a fixed seed. Tolerances: f32 within 1e-5
relative (plus 1e-6 absolute for entries near zero); bf16 within one bf16
ulp of the larger of the two values (both sides sum in f32 and round
once), plus 1e-6 absolute on the card.

JAX is imported only inside the parity helper, so the card tests run on
a machine without it:

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from triton_dist_tpu_torch.ops import gemm_reduce_scatter as port

SHAPES = [(1, 100, 72), (3, 64, 128), (8, 256, 128), (5, 40, 24)]
BF16_ULP_REL = 2.0 ** -7
F32_SUM_ATOL = 1e-6      # card only: f32 sums in two orders, see below


def _operands(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(m, k).astype(np.float32)
    b = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    return a, b


def _jax_gemm_ar(a, b, dtype_name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from triton_dist_tpu.ops.gemm_reduce_scatter import (
        create_gemm_rs_context, gemm_ar as jax_gemm_ar)
    dtype = getattr(jnp, dtype_name)
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    ctx = create_gemm_rs_context(mesh, "tp")
    out = jax_gemm_ar(jnp.asarray(a, dtype), jnp.asarray(b, dtype), ctx,
                      impl="pallas")
    return np.asarray(out.astype(jnp.float32))


def assert_within_bf16_ulp(got, want, atol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = BF16_ULP_REL * np.maximum(np.abs(got), np.abs(want)) + atol
    assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gemm_ar_f32_matches_jax_pallas(m, k, n):
    a, b = _operands(m, k, n)
    want = _jax_gemm_ar(a, b, "float32")
    got = port.gemm_ar(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gemm_ar_bf16_matches_jax_pallas(m, k, n):
    a, b = _operands(m, k, n, seed=1)
    want = _jax_gemm_ar(a, b, "bfloat16")
    got = port.gemm_ar(torch.from_numpy(a).bfloat16(),
                       torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert_within_bf16_ulp(got.float().numpy(), want)


def test_gemm_ar_cpu_call_is_the_plain_version_and_not_counted():
    a, b = _operands(4, 48, 16, seed=2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = port.launches.total
    assert torch.equal(port.gemm_ar(ta, tb), port.gemm_ar_reference(ta, tb))
    assert port.launches.total == before


@pytest.mark.parametrize("a_shape,b_shape,dtypes", [
    ((4, 8), (9, 16), (torch.float32, torch.float32)),     # K mismatch
    ((4, 8, 1), (8, 16), (torch.float32, torch.float32)),  # not 2-D
    ((4, 8), (8, 16), (torch.float32, torch.bfloat16)),    # mixed dtype
])
def test_gemm_ar_rejects_bad_operands(a_shape, b_shape, dtypes):
    a = torch.zeros(a_shape, dtype=dtypes[0])
    b = torch.zeros(b_shape, dtype=dtypes[1])
    with pytest.raises(ValueError):
        port.gemm_ar(a, b)


@pytest.mark.parametrize("m,k,n", [(0, 8, 4), (3, 8, 0), (3, 0, 4)])
def test_gemm_ar_cpu_empty_dims(m, k, n):
    a, b = torch.ones(m, k), torch.ones(k, n)
    got = port.gemm_ar(a, b)
    assert got.shape == (m, n) and torch.equal(got, torch.zeros(m, n))


def test_launch_count_counts_by_shape():
    count = port.LaunchCount()
    count.add((4096, 4096))
    count.add((12288, 4096))
    count.add((4096, 4096))
    assert count.total == 3
    assert count.by_shape == {(4096, 4096): 2, (12288, 4096): 1}
    count.reset()
    assert count.total == 0 and not count.by_shape


@pytest.fixture()
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    # The plain version is the exact f32 product only without TF32.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (4, 12288, 4096),
                                   (64, 4096, 4096), (3, 100, 72)])
def test_split_k_fills_the_card_within_two_blocks_per_sm(cuda_device, dtype,
                                                         m, k, n):
    p = port.plan(m, n, k, dtype, num_sms=132)
    assert p.splits & (p.splits - 1) == 0      # a power of two
    assert p.tiles * p.splits <= max(p.tiles, 2 * 132)
    assert p.splits == 1 or k // p.splits >= 256
    # Decode shapes at N = 4096 fill at least the 132 SMs once.
    if n == 4096 and (p.tensor_cores or m <= 8):
        assert p.tiles * p.splits >= 132


@pytest.mark.cuda
def test_tensor_core_path_selection(cuda_device):
    bf, f32 = torch.bfloat16, torch.float32
    assert port.plan(4, 32, 64, bf, 132).tensor_cores
    assert not port.plan(4, 30, 64, bf, 132).tensor_cores   # N % 8
    assert not port.plan(4, 32, 60, bf, 132).tensor_cores   # K % 8
    assert not port.plan(4, 32, 64, f32, 132).tensor_cores


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_ar_offset_view_gives_the_same_bits(cuda_device, dtype):
    """The path depends on dtype and shape only: operands that do not
    start on 16 bytes give the bits of aligned copies."""
    a, b = _operands(8, 256, 136, seed=4)
    ta = torch.from_numpy(a).to(cuda_device, dtype)
    tb = torch.from_numpy(b).to(cuda_device, dtype)
    flat_a = torch.empty(ta.numel() + 1, dtype=dtype, device=cuda_device)
    flat_b = torch.empty(tb.numel() + 1, dtype=dtype, device=cuda_device)
    va = flat_a[1:].view_as(ta).copy_(ta)
    vb = flat_b[1:].view_as(tb).copy_(tb)
    assert va.data_ptr() % 16 and vb.data_ptr() % 16
    assert torch.equal(port.gemm_ar(va, vb), port.gemm_ar(ta, tb))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (3, 12288, 4096),
                                   (64, 4096, 4096), (100, 256, 136),
                                   (8, 100, 72)])
def test_gemm_ar_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n):
    a, b = _operands(m, k, n, seed=3)
    ta = torch.from_numpy(a).to(cuda_device, dtype)
    tb = torch.from_numpy(b).to(cuda_device, dtype)
    before = port.launches.total
    got = port.gemm_ar(ta, tb)
    again = port.gemm_ar(ta, tb)
    torch.cuda.synchronize()
    assert port.launches.total == before + 2
    assert torch.equal(got, again)             # no atomics: bit-identical
    want = port.gemm_ar_reference(ta, tb)
    if dtype == torch.bfloat16:
        # On the card both sides sum K <= 12288 unit-scale terms in f32 in
        # different orders, a few 1e-7 apart: more than a bf16 ulp of an
        # output near zero, hence the absolute term (as in chip_smoke.py).
        # The float64 product holds the kernel to the same bound.
        exact = (ta.double() @ tb.double()).cpu().numpy()
        for ref in (want.float().cpu().numpy(), exact):
            assert_within_bf16_ulp(got.float().cpu().numpy(), ref,
                                   atol=F32_SUM_ATOL)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=3e-5)


# -- flash decode (triton_dist_tpu_torch.ops.flash_decode) --------------------
# Qwen3-8B's decode shapes (B = 4, 32 query / 8 KV heads of dim 128) and a
# small odd one. Tolerances (kernel vs plain version on the same inputs):
# f32 within 1e-5 (sums in another order). bf16: the kernel rounds each
# probability to bf16 against its 64-position chunk's running max, the
# plain version against the row's final max, so a probability moves by up
# to 2^-8 of itself and an output by up to 2^-8 * max|v|; both outputs
# then round to bf16 once (one bf16 ulp, 2^-7 of the value).
FD_SHAPES = [(4, 32, 8, 128, 1024), (3, 8, 2, 16, 48)]


def _fd_inputs(b, hq, hkv, d, t, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, hq, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, t, hkv, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, t, hkv, d).astype(np.float32))
    return [x.to(device, dtype) for x in (q, k, v)]


def _fd_assert_close(got, want, v):
    assert got.dtype == want.dtype and got.shape == want.shape
    exact = got.dtype == v.dtype == torch.float32
    got, want = got.float(), want.float()
    if exact:
        lim = torch.full_like(got, 1e-5)
    else:
        lim = (2.0 ** -8 * v.float().abs().max()
               + 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 1e-6)
    assert ((got - want).abs() <= lim).all(), (got - want).abs().max()


def _fd_lens(b, t):
    return [1, 17, 160, t, [min(x, t) for x in (1, 17, 160, 1024, 5)][:b]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", FD_SHAPES, ids=["qwen3_8b", "small"])
def test_flash_decode_kernels_match_plain_on_card(cuda_device, dtype, shape):
    from triton_dist_tpu_torch.ops import flash_decode as fd
    b, hq, hkv, d, t = shape
    q, k, v = _fd_inputs(b, hq, hkv, d, t, dtype, cuda_device)
    p = fd.plan(b, hkv, t, 132)
    for lens in _fd_lens(b, t):
        before = {n: c.total for n, c in fd.launches.items()}
        single = fd.flash_decode_single(q, k, v, lens)
        parts = fd.flash_decode_partial(q, k, v, lens, p.split_len,
                                        p.splits)
        merged = fd.flash_decode_combine(*parts, dtype)
        again = (fd.flash_decode_single(q, k, v, lens),
                 fd.flash_decode_combine(*fd.flash_decode_partial(
                     q, k, v, lens, p.split_len, p.splits), dtype))
        torch.cuda.synchronize()
        assert {n: c.total - before[n] for n, c in fd.launches.items()} == {
            "partial": 2, "combine": 2, "single": 2}
        assert torch.equal(single, again[0])        # no atomics
        assert torch.equal(merged, again[1])
        want = fd.flash_decode_reference(q, k, v, lens)
        _fd_assert_close(single, want, v)
        _fd_assert_close(merged, want, v)
        # The combine kernel against its plain version on the same
        # partials, and the partials against theirs.
        _fd_assert_close(merged, fd.flash_decode_combine_reference(
            *parts, dtype), torch.ones(1))
        ref_parts = fd.flash_decode_partials_reference(q, k, v, lens,
                                                       p.split_len, p.splits)
        _fd_assert_close(fd.flash_decode_combine_reference(*parts, dtype),
                         fd.flash_decode_combine_reference(*ref_parts,
                                                           dtype), v)
        torch.testing.assert_close(parts[2], ref_parts[2], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_paged_kernel_reads_through_the_table(cuda_device,
                                                           dtype):
    from triton_dist_tpu_torch.ops import flash_decode as fd
    b, hq, hkv, d, page, n_pages = 4, 32, 8, 128, 16, 64
    q, k, v = _fd_inputs(b, hq, hkv, d, page * n_pages, dtype, cuda_device,
                         seed=1)
    slots = torch.randperm(b * n_pages + 1,
                           generator=torch.Generator().manual_seed(0))
    table = slots[:b * n_pages].reshape(1, b, n_pages).to(torch.int32)
    pool_k = torch.zeros((b * n_pages + 1, page, hkv, d), dtype=dtype,
                         device=cuda_device)
    pool_v = torch.zeros_like(pool_k)
    idx = table[0].reshape(-1).long().to(cuda_device)
    pool_k[idx] = k.reshape(b * n_pages, page, hkv, d)
    pool_v[idx] = v.reshape(b * n_pages, page, hkv, d)
    table = table.to(cuda_device)
    for lens in _fd_lens(b, page * n_pages):
        got = fd.gqa_fwd_batch_decode_paged(q, pool_k, pool_v, table, lens)
        assert torch.equal(got, fd.gqa_fwd_batch_decode_paged(
            q, pool_k, pool_v, table, lens))
        # Paged and dense addressing of the same rows: the same bits, and
        # so does the "gathered" variant (a contiguous copy, then dense).
        assert torch.equal(got, fd.gqa_fwd_batch_decode(
            q, k, v, lens, fd.FlashDecodeContext(variant="tiled")))
        assert torch.equal(got, fd.gqa_fwd_batch_decode_paged(
            q, pool_k, pool_v, table, lens,
            fd.FlashDecodeContext(paged_variant="gathered")))
        _fd_assert_close(got, fd.flash_decode_paged_reference(
            q, pool_k, pool_v, table, lens), v)
    # A table entry past the pool is clamped into it, never read past it.
    bad = table.clone()
    bad[0, 0, 0] = 1 << 20
    out = fd.gqa_fwd_batch_decode_paged(q, pool_k, pool_v, bad, 16)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
def test_flash_decode_plan_fills_the_card(cuda_device):
    from triton_dist_tpu_torch.ops import flash_decode as fd
    for b, hkv, t in ((4, 8, 1024), (1, 8, 4096), (64, 8, 512), (3, 2, 48)):
        p = fd.plan(b, hkv, t, 132)
        assert p.split_len % 64 == 0
        assert (p.splits - 1) * p.split_len < t <= p.splits * p.split_len
        assert p.splits == 1 or b * hkv * p.splits <= 4 * 132
    assert fd.plan(4, 8, 1024, 132) == fd.Plan(8, 128)
