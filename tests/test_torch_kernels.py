"""The port's gemm_ar (triton_dist_tpu_torch.ops.gemm_reduce_scatter)
against the JAX package's gemm_ar(impl="pallas") on a 1-device mesh (the
Pallas kernel in interpret mode), and the CUDA kernels (gemm_ar, the
three flash-decode kernels of ops.flash_decode, the AG-GEMM, AG-SwiGLU
and GEMM-RS kernels of ops.allgather_gemm / ops.gemm_reduce_scatter, and
the grouped-GEMM, MoE-reduce and all-gather kernels of ops.group_gemm /
ops.moe_reduce_rs / ops.allgather, the flash-prefill kernel of
ops.sp_attention and the copy kernel under each world = 1 collective)
against their plain versions on the card (marked ``cuda``; skipped
without one). The CPU parity tests of
flash decode, of AG-GEMM and of the MoE ops are in
tests/test_torch_flash_decode.py, tests/test_torch_ag_gemm.py and
tests/test_torch_moe_ops.py.

Inputs come from numpy with a fixed seed. Tolerances: f32 within 1e-5
relative (plus 1e-6 absolute for entries near zero); bf16 within one bf16
ulp of the larger of the two values (both sides sum in f32 and round
once), plus 1e-6 absolute on the card. The flash prefill is held to the
port's ``sp_attention_tolerance`` (ops/sp_attention.py), and a run with
one KV tile zeroed must fail it.

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


# -- AG-GEMM, AG-SwiGLU and GEMM-RS (csrc/ag_gemm.cu) ---------------------------
# Qwen3-8B's shapes (prefill M = 512 and decode M = 4: QKV, gate|up, the
# o_proj and down projections) and small odd ones: ragged M, N and K edges,
# widths and K that are not multiples of 8 (the FMA kernel in bf16).
AG_SHAPES = [(512, 4096, (4096, 1024, 1024)), (4, 4096, (4096, 1024, 1024)),
             (4, 4096, (12288, 12288)), (130, 72, (40, 24, 8)),
             (65, 264, (136,)), (7, 100, (72, 30)), (200, 36, (20, 12))]


def _ag_inputs(m, k, widths, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    bs = [torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype(np.float32))
          for n in widths]
    return a.to(device, dtype), [b.to(device, dtype) for b in bs]


def f32_sum_atol(k):
    """Absolute limit for bf16 outputs near zero: each side (the kernel,
    and the plain version through cuBLAS in f32) sums k unit-scale f32
    terms in its own order, and the rounding error of such a blocked sum
    grows like sqrt(k), about 1e-6 * sqrt(k / 1024); 4x that for the gap
    between two such sums. Among the 2M outputs of a prefill product some
    lie near zero, where that gap exceeds a bf16 ulp."""
    return 4e-6 * max(1.0, (k / 1024) ** 0.5)


def _assert_gemm_close(got, want, k):
    """bf16: one bf16 ulp of the larger value plus :func:`f32_sum_atol`
    (both sides sum in f32 in different orders, then round once); f32:
    1e-5 relative and 3e-5 absolute (unit-scale outputs, sums in another
    order)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.bfloat16:
        assert_within_bf16_ulp(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=f32_sum_atol(k))
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,widths", AG_SHAPES)
def test_ag_gemm_kernel_matches_plain_on_card(cuda_device, dtype, m, k,
                                              widths):
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    a, bs = _ag_inputs(m, k, widths, dtype, cuda_device, seed=m + k)
    before = ag.ag_gemm_launches.total
    got = ag.ag_gemm_multi(a, bs)
    again = ag.ag_gemm_multi(a, bs)
    torch.cuda.synchronize()
    assert ag.ag_gemm_launches.total == before + 2     # one launch per call
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for x, want in zip(got, ag.ag_gemm_multi_reference(a, bs)):
        _assert_gemm_close(x, want, k)


def _swiglu_bound(a, wg, wu, bg, bu):
    """|kernel - plain| limit of the fused SwiGLU: the f32 gate g and up u
    of two summation orders differ by ~1e-6 of their unit scale, which
    moves act = silu(g) u by up to that much times (|silu(g)| + 1.1 |u|)
    (|silu'| < 1.1), more than a bf16 ulp of an act near zero: 2^-16 of
    that sum, plus one bf16 ulp (bf16) or 1e-5 (f32) of the value."""
    af = a.float()
    g = af @ wg.float() + (bg.float() if bg is not None else 0)
    u = af @ wu.float() + (bu.float() if bu is not None else 0)
    scale = 2.0 ** -16 * (torch.nn.functional.silu(g).abs() + 1.1 * u.abs())
    return scale + 1e-6, (2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(512, 4096, 12288), (128, 64, 128),
                                   (130, 72, 40), (4, 100, 30)])
@pytest.mark.parametrize("bias", [False, True], ids=["", "bias"])
def test_ag_swiglu_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n,
                                                bias):
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    a, (wg, wu) = _ag_inputs(m, k, (n, n), dtype, cuda_device, seed=n)
    rng = np.random.RandomState(1)
    bg, bu = ((torch.from_numpy(rng.randn(n).astype(np.float32)).to(
        cuda_device, dtype) for _ in range(2)) if bias else (None, None))
    before = ag.ag_swiglu_launches.total
    got = ag.launch_swiglu(a, wg, wu, bg, bu)
    again = ag.launch_swiglu(a, wg, wu, bg, bu)
    torch.cuda.synchronize()
    assert ag.ag_swiglu_launches.total == before + 2
    assert torch.equal(got, again)
    want = ag.ag_swiglu_reference(a, wg, wu, bg, bu)
    atol, rtol = _swiglu_bound(a, wg, wu, bg, bu)
    diff = (got.float() - want.float()).abs()
    lim = atol + rtol * torch.maximum(got.float().abs(), want.float().abs())
    assert (diff <= lim).all(), diff.max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(512, 4096, 4096), (512, 12288, 4096),
                                   (4, 12288, 4096), (100, 256, 136),
                                   (64, 100, 72)])
def test_gemm_rs_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n):
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    a, (b,) = _ag_inputs(m, k, (n,), dtype, cuda_device, seed=k)
    rs, before_ar = port.gemm_rs_launches, port.launches.total
    before = dict(rs.by_shape)
    got = port.gemm_rs(a, b)
    again = port.gemm_rs(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_gemm_close(got, port.gemm_rs_reference(a, b), k)
    # M <= 64: the gemm_ar kernel; above it the AG-GEMM kernel's tiled plan
    # (no split-K). Either way counted once per call under gemm_rs only.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    key = (("decode" if m <= port.DECODE_MAX_M
            else ag.plan("gemm", m, (n,), k, dtype, sms).path), k, (n,))
    assert rs.by_shape[key] == before.get(key, 0) + 2
    assert port.launches.total == before_ar


@pytest.mark.cuda
def test_ag_gemm_plans(cuda_device):
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    bf, f32 = torch.bfloat16, torch.float32
    qkv = (4096, 1024, 1024)
    assert ag.plan("gemm", 512, qkv, 4096, bf, 132) == ag.Plan(
        "prefill", 4 * 48, 1)
    assert ag.plan("gemm", 512, (4096,), 12288, bf, 132) == ag.Plan(
        "prefill", 4 * 32, 1)
    assert ag.plan("swiglu", 512, (12288,), 4096, bf, 132) == ag.Plan(
        "prefill", 4 * 192, 1)
    p = ag.plan("gemm", 4, qkv, 4096, bf, 132)        # decode: split-K
    assert p.path == "decode" and p.tiles == 96 and p.splits == 2
    assert ag.plan("gemm", 64, (12288, 12288), 4096, bf, 132).path == "decode"
    assert ag.plan("gemm", 65, (12288, 12288), 4096, bf, 132).path == "prefill"
    assert ag.plan("gemm", 512, qkv, 4096, f32, 132).path == "fma"
    assert ag.plan("gemm", 512, (4096, 1020), 4096, bf, 132).path == "fma"
    assert ag.plan("swiglu", 4, (30,), 100, bf, 132).path == "fma"


@pytest.mark.cuda
def test_ag_gemm_offset_views_give_the_same_bits(cuda_device):
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    a, bs = _ag_inputs(130, 64, (40, 24), torch.bfloat16, cuda_device)
    flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda_device)
    va = flat[1:].view_as(a).copy_(a)
    assert va.data_ptr() % 16
    assert all(torch.equal(x, y) for x, y in zip(ag.ag_gemm_multi(va, bs),
                                                 ag.ag_gemm_multi(a, bs)))


# -- grouped GEMM, MoE-reduce, all-gather (csrc/group_gemm.cu, moe_rs.cu,
# allgather.cu) ---------------------------------------------------------------
# Qwen3-30B-A3B's shapes (E = 128, top-8, hidden 2048, expert width 768) at
# decode (4 tokens, P = 32 pairs) and prefill (512 tokens, P = 4096), and
# small odd ones: K or N not a multiple of 8 (the FMA kernel in bf16), few
# live experts (most empty), sentinel ids (== E, run through the last
# expert). Tolerances as for AG-GEMM above.
# (tokens, topk, E, K, N, live experts or None for all, sentinel share)
MOE_SHAPES = [(4, 8, 128, 2048, 768, None, 0.0),
              (512, 8, 128, 2048, 768, None, 0.0),
              (512, 8, 128, 768, 2048, 3, 0.0),
              (9, 2, 5, 40, 24, None, 0.25),
              (70, 2, 8, 64, 136, 2, 0.1)]
MOE_IDS = ["decode", "prefill", "few_experts", "odd_sentinel", "sentinel"]


def _moe_inputs(t, topk, e, k, n, live, sentinel, dtype, device, seed=0):
    """Tokens (t, k), two weight stacks (e, k, n) and (t * topk,) int32
    expert ids drawn from ``live`` experts (all if None), a ``sentinel``
    share of them set to e."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(t, k).astype(np.float32))
    ws = [torch.from_numpy((rng.randn(e, k, n) / np.sqrt(k)).astype(
        np.float32)) for _ in range(2)]
    pool = rng.choice(e, size=live or e, replace=False)
    ids = pool[rng.randint(0, len(pool), t * topk)]
    ids[rng.rand(t * topk) < sentinel] = e
    return (x.to(device, dtype), [w.to(device, dtype) for w in ws],
            torch.from_numpy(ids.astype(np.int32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MOE_SHAPES, ids=MOE_IDS)
def test_grouped_gemm_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    from triton_dist_tpu_torch.ops import group_gemm as gg
    t, topk, e, k, n, live, sentinel = shape
    x, ws, ids = _moe_inputs(*shape, dtype, cuda_device, seed=t + k)
    before = gg.group_gemm_launches.total
    got = gg.grouped_matmul_multi(x, ws, ids, e, topk)
    again = gg.grouped_matmul_multi(x, ws, ids, e, topk)
    torch.cuda.synchronize()
    assert gg.group_gemm_launches.total == before + 2    # gate|up: one launch
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for out, w in zip(got, ws):
        _assert_gemm_close(out, gg.grouped_matmul_reference(x, w, ids, e,
                                                            topk), k)
    # One product alone, from the expanded rows (topk = 1), gives the bits
    # of the gathered rows.
    single = gg.grouped_matmul(x.repeat_interleave(topk, 0), ws[1], ids, e)
    assert torch.equal(single, got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MOE_SHAPES, ids=MOE_IDS)
def test_grouped_swiglu_kernel_matches_plain_on_card(cuda_device, dtype,
                                                     shape):
    from triton_dist_tpu_torch.ops import group_gemm as gg
    t, topk, e, k, n, live, sentinel = shape
    x, (wg, wu), ids = _moe_inputs(*shape, dtype, cuda_device, seed=n)
    got = gg.grouped_swiglu(x, wg, wu, ids, e, topk)
    again = gg.grouped_swiglu(x, wg, wu, ids, e, topk)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = gg.grouped_swiglu_reference(x, wg, wu, ids, e, topk)
    # The limit of the fused AG-SwiGLU, on each pair's own expert.
    g, u = (gg.grouped_matmul_reference(x, w, ids, e, topk, torch.float32)
            for w in (wg, wu))
    atol = 2.0 ** -16 * (torch.nn.functional.silu(g).abs() + 1.1 * u.abs())
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    diff = (got.float() - want.float()).abs()
    lim = atol + 1e-6 + rtol * torch.maximum(got.float().abs(),
                                             want.float().abs())
    assert (diff <= lim).all(), diff.max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MOE_SHAPES, ids=MOE_IDS)
@pytest.mark.parametrize("impl", ["ring", "fused"])
def test_moe_reduce_kernel_matches_plain_on_card(cuda_device, dtype, shape,
                                                 impl):
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    t, topk, e, k, n, live, sentinel = shape
    x, (w, _), ids = _moe_inputs(*shape, dtype, cuda_device, seed=k)
    act = x.repeat_interleave(topk, 0).contiguous()
    rng = np.random.RandomState(t)
    wts = torch.from_numpy(rng.dirichlet(np.ones(topk), t).astype(
        np.float32)).to(cuda_device)
    ctx = mrs.create_moe_rs_context(num_experts=e, topk=topk)
    before = mrs.moe_rs_launches.total
    got = mrs.moe_reduce_rs(act, w, ids, wts, ctx, impl=impl)
    again = mrs.moe_reduce_rs(act, w, ids, wts, ctx, impl=impl)
    torch.cuda.synchronize()
    assert mrs.moe_rs_launches.total == before + 2
    assert torch.equal(got, again)
    rounded = impl == "ring"
    want = mrs.moe_reduce_rs_reference(act, w, ids, wts, e, rounded)
    # Each pair's product within one bf16 ulp + f32_sum_atol(k) of the
    # plain one (rounded pairs) or f32 apart by f32_sum_atol(k); the
    # weights sum to one; then one rounding of the output.
    pair = mrs.grouped_matmul_reference(act, w, ids, e).float()
    pair_mag = (pair.abs().reshape(t, topk, -1) * wts[..., None]).sum(1)
    if dtype == torch.bfloat16:
        lim = (2.0 ** -7 * (torch.maximum(got.float().abs(),
                                          want.float().abs())
                            + (pair_mag if rounded else 0))
               + f32_sum_atol(k))
    else:
        lim = 1e-5 * torch.maximum(got.abs(), want.abs()) + 3e-5
    diff = (got.float() - want.float()).abs()
    assert (diff <= lim).all(), diff.max()


@pytest.mark.cuda
def test_grouped_gemm_plans(cuda_device):
    from triton_dist_tpu_torch.ops import group_gemm as gg
    bf, f32 = torch.bfloat16, torch.float32
    # Rows per tile: twice the mean pairs per expert, in [16, 64]; the grid
    # is the worst case ceil(P / m_blk) + min(E, P).
    assert gg.plan(32, 128, 2048, 768, bf) == gg.Plan("mma", 16, 2 + 32)
    assert gg.plan(4096, 128, 2048, 768, bf) == gg.Plan("mma", 64, 64 + 128)
    assert gg.plan(1024, 128, 768, 2048, bf).m_blk == 16
    assert gg.plan(2048, 128, 768, 2048, bf).m_blk == 32
    assert gg.plan(4096, 128, 2048, 768, f32).path == "fma"
    assert gg.plan(32, 128, 2048, 770, bf).path == "fma"
    with pytest.raises(RuntimeError, match="invalid argument"):
        gg.plan(32, 2048, 64, 64, bf)                 # more than 1024 experts


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,dtype", [(4, 2048, torch.bfloat16),
                                             (512, 2048, torch.bfloat16),
                                             (3, 5, torch.float32),
                                             (7, 3, torch.bfloat16)])
def test_all_gather_copy_on_card(cuda_device, rows, cols, dtype):
    from triton_dist_tpu_torch.ops import allgather as ag
    x = torch.randn(rows, cols, device=cuda_device).to(dtype)
    before = ag.all_gather_launches.total
    got = ag.all_gather(x)
    torch.cuda.synchronize()
    assert ag.all_gather_launches.total == before + 1
    assert got.data_ptr() != x.data_ptr() and torch.equal(got, x)
    # A view that starts off 16 bytes takes the byte copy.
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)
    view = flat[1:].view_as(x).copy_(x)
    assert torch.equal(ag.all_gather(view), x)
    assert ag.all_gather(x, impl="xla") is x


# -- slice 5: the flash-prefill kernel and the collectives' copy ---------------
#: (dtype, causal, B, S, Hq, Hkv, D): chip_smoke.py's cases at reduced S —
#: Qwen3-8B's heads (G = 4), Qwen3-30B-A3B's (G = 8), G = 1, an S that is
#: no multiple of the 64-wide tiles, B = 4, D = 64, f32 on the FMA path,
#: and sequences shorter than one tile (S = 1, 7).
SP_SHAPES = [(torch.bfloat16, True, 1, 2048, 32, 8, 128),
             (torch.bfloat16, True, 4, 1024, 32, 8, 128),
             (torch.bfloat16, False, 1, 1000, 32, 8, 128),
             (torch.bfloat16, True, 1, 1000, 32, 4, 128),
             (torch.bfloat16, True, 2, 333, 8, 8, 64),
             (torch.float32, True, 1, 1000, 32, 8, 128),
             (torch.float32, False, 1, 512, 32, 4, 128),
             (torch.float32, True, 1, 100, 4, 4, 64),
             (torch.bfloat16, True, 3, 1, 32, 8, 128),
             (torch.float32, False, 2, 7, 32, 4, 128)]


def zero_middle_tile(x, tile):
    """A copy of k or v (B, S, H, D) with the KV tile that holds position
    S // 2 zeroed: a planted fault, for the deep rows of a causal pass."""
    bad = x.clone()
    first = x.shape[1] // 2 // tile * tile
    bad[:, first:first + tile] = 0
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,b,s,hq,hkv,d", SP_SHAPES)
def test_sp_attention_kernel_matches_plain_on_card(cuda_device, dtype, causal,
                                                   b, s, hq, hkv, d):
    from triton_dist_tpu_torch.ops import sp_attention as sp
    rng = np.random.RandomState(s)
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
               .to(cuda_device, dtype) for h in (hq, hkv, hkv))
    ctx = sp.create_sp_attention_context(causal=causal)
    before = sp.sp_attention_launches.total
    got = sp.sp_ag_attention(q, k, v, ctx, impl="pallas")
    again = sp.sp_ag_attention_fused(q, k, v, ctx)
    torch.cuda.synchronize()
    assert sp.sp_attention_launches.total == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)                  # bit-identical repeat
    ref = sp.sp_attention_fused_reference(q, k, v, causal, t_sub=sp.KV_TILE)
    diff = (got.float() - ref.float()).abs()
    assert bool(torch.isfinite(got.float()).all())
    lim = sp.sp_attention_tolerance(got, ref, q, k, v, causal)
    assert bool((diff <= lim).all()), diff.max().item()
    # The same check refuses a kernel run that lost one KV tile.
    bad = sp.launch_sp_attention(q, zero_middle_tile(k, sp.KV_TILE),
                                 zero_middle_tile(v, sp.KV_TILE), causal)
    assert not bool(((bad.float() - ref.float()).abs() <= lim).all())


@pytest.mark.cuda
def test_sp_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    from triton_dist_tpu_torch.ops import sp_attention as sp
    q = torch.zeros(1, 64, 4, 128, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.zeros(1, 64, 1, 128, device=cuda_device, dtype=torch.bfloat16)
    for args in ((q.float(), kv, kv), (q[..., :96].contiguous(),
                                       kv[..., :96].contiguous(),
                                       kv[..., :96].contiguous()),
                 (q.transpose(1, 2), kv, kv)):
        with pytest.raises(ValueError):
            sp.launch_sp_attention(*args, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,dtype", [(4, 4096, torch.bfloat16),
                                       (512, 4096, torch.bfloat16),
                                       (3, 5, torch.float32)])
def test_collectives_copy_on_card(cuda_device, m, n, dtype):
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.ops import allreduce as ar
    from triton_dist_tpu_torch.ops import reduce_scatter as rs
    x = torch.randn(1, m, n, device=cuda_device).to(dtype)
    key = str(dtype).removeprefix("torch.")
    for method in ar.AllReduceMethod:
        ctx = ar.create_allreduce_context(method=method)
        ran = ar.resolve_method(ctx, m, x[0].numel() * x.element_size())
        before = ar.all_reduce_launches.by_shape[(ran.value, m, n, key)]
        got = ar.all_reduce(x, ctx, stacked=method is ar.AllReduceMethod.AUTO)
        assert ar.all_reduce_launches.by_shape[(ran.value, m, n, key)] == \
            before + 1
        assert got.data_ptr() != x.data_ptr()
        assert torch.equal(got.reshape(m, n), x[0])
    for method in rs.ReduceScatterMethod:
        ctx = rs.create_reduce_scatter_context(method=method)
        ran = ctx.resolve_method(x[0].numel() * x.element_size())
        before = rs.reduce_scatter_launches.by_shape[(ran.value, m, n, key)]
        assert torch.equal(rs.reduce_scatter(x, ctx), x[0])
        assert rs.reduce_scatter_launches.by_shape[(ran.value, m, n, key)] \
            == before + 1
    before = ag.broadcast_launches.total
    got = ag.broadcast(x[0])
    torch.cuda.synchronize()
    assert ag.broadcast_launches.total == before + 1
    assert got.data_ptr() != x.data_ptr() and torch.equal(got, x[0])
    assert ar.all_reduce(x, impl="xla").data_ptr() == x.data_ptr()
