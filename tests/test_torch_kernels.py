"""The port's gemm_ar (triton_dist_tpu_torch.ops.gemm_reduce_scatter)
against the JAX package's gemm_ar(impl="pallas") on a 1-device mesh (the
Pallas kernel in interpret mode), and the CUDA kernels (gemm_ar, the
three flash-decode kernels of ops.flash_decode, the AG-GEMM, AG-SwiGLU
and GEMM-RS kernels of ops.allgather_gemm / ops.gemm_reduce_scatter, and
the grouped-GEMM, MoE-reduce and all-gather kernels of ops.group_gemm /
ops.moe_reduce_rs / ops.allgather, the flash-prefill kernel of
ops.sp_attention and the copy kernel under each world = 1 collective,
at sequence world W the flash-decode exchange and the ring-KV
prefill, and at tensor world W the all-gather and broadcast kernels and
the grouped GEMM and MoE-reduce on strided expert shards) against their
plain versions on the card (marked ``cuda``; skipped
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


#: (K, widths) of every decode product of Qwen3-8B and Qwen3-30B-A3B on
#: the decode body: world 1, and one rank's shard at TP world 4 (the rings
#: plan a shard with the world-1 plan).
DECODE_SHAPES = {
    "8b_qkv": (4096, (4096, 1024, 1024)), "8b_o_proj": (4096, (4096,)),
    "8b_gate_up": (4096, (12288, 12288)), "8b_down": (12288, (4096,)),
    "30b_qkv": (2048, (4096, 512, 512)), "30b_o_proj": (4096, (2048,)),
    "8b_qkv_w4": (4096, (1024, 256, 256)), "8b_o_proj_w4": (1024, (4096,)),
    "8b_gate_up_w4": (4096, (3072, 3072)), "8b_down_w4": (3072, (4096,)),
    "30b_qkv_w4": (2048, (1024, 128, 128)), "30b_o_proj_w4": (1024, (2048,)),
}


def _assert_whole_waves(p, k, sms=132):
    """The tensor-core decode plan's rules: at most 8 splits (a portable
    cluster), each a whole number of 64-deep stages and none empty, no
    workspace, and the busiest SM streaming at most 1.25x the mean share
    of B (items dealt over ``sms`` SMs in whole waves)."""
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    assert p.tensor_cores and p.cols == 64 and p.workspace == 0
    assert 1 <= p.splits <= ag.STREAM_MAX_SPLITS
    assert p.k_per_split % 64 == 0
    assert (p.splits - 1) * p.k_per_split < k <= p.splits * p.k_per_split
    busiest = -(-p.tiles * p.splits // sms) * p.k_per_split
    assert busiest <= 1.25 * p.tiles * k / sms


@pytest.mark.parametrize("name", list(DECODE_SHAPES))
def test_decode_plan_rules_over_every_decode_shape(name):
    """The Python mirror of the decode plan (``stream_plan``) over M = 1..64
    at each Qwen3 decode shape: the rules above, one 64-row tile, and the
    same plan at every M (a function of dtype, shape and SM count)."""
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    k, widths = DECODE_SHAPES[name]
    first = ag.stream_plan(1, widths, k, torch.bfloat16, 132)
    for m in range(1, 65):
        p = ag.stream_plan(m, widths, k, torch.bfloat16, 132)
        assert p.tiles == sum(-(-n // 64) for n in widths)
        _assert_whole_waves(p, k)
        assert p == first


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (4, 12288, 4096),
                                   (64, 4096, 4096), (3, 100, 72)])
def test_decode_plan_fills_the_card_in_whole_waves(dtype, m, k, n):
    """The tensor-core body's plan follows the rules above; the FMA body
    (f32, odd shapes) keeps its split-K rule: powers of two within about
    two blocks per SM, at least 256 K rows a split, and the f32 workspace
    its split reduce needs."""
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    p = ag.stream_plan(m, (n,), k, dtype, 132)
    assert p.tensor_cores == (dtype == torch.bfloat16 and k % 8 == 0)
    if p.tensor_cores:
        _assert_whole_waves(p, k)
        # Qwen3-8B's decode o_proj and down fill at least 0.95 of the SMs.
        assert p.tiles * p.splits >= 0.95 * 132
        return
    assert p.splits & (p.splits - 1) == 0      # a power of two
    assert p.tiles * p.splits <= max(p.tiles, 2 * 132)
    assert p.splits == 1 or k // p.splits >= 256
    assert p.workspace == (p.splits * m * n if p.splits > 1 else 0)
    if n == 4096 and m <= 8:                   # decode shapes fill the card
        assert p.tiles * p.splits >= 132


@pytest.mark.cuda
def test_decode_plan_mirror_is_the_c_plan(cuda_device):
    """``stream_plan`` against csrc/gemm_common.cuh's ``stream_plan``
    (``tdt_gemm_ar_plan``, one product) and csrc/ag_plan.cuh's decode plan
    (``tdt_ag_gemm_plan``, every product of a shape) on this card."""
    import ctypes
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    out = [ctypes.c_int() for _ in range(4)]
    shapes = list(DECODE_SHAPES.values()) + [(100, (72,)), (72, (24, 48)),
                                             (4104, (136, 264, 40))]
    for dtype in (torch.bfloat16, torch.float32):
        for m in (1, 2, 3, 4, 8, 17, 33, 63, 64, 65, 100):
            for k, widths in shapes:
                for n in widths:
                    mirror = ag.stream_plan(m, (n,), k, dtype, sms)
                    p = port.plan(m, n, k, dtype, sms)
                    assert (p.tensor_cores, p.tiles, p.splits, p.k_per_split,
                            p.workspace) == (mirror.tensor_cores,
                                             mirror.tiles, mirror.splits,
                                             mirror.k_per_split,
                                             mirror.workspace)
                if ag.plan("gemm", m, widths, k, dtype, sms).path != "decode":
                    continue
                mirror = ag.stream_plan(m, widths, k, dtype, sms)
                w = list(widths) + [0] * (3 - len(widths))
                assert ag._lib().tdt_ag_gemm_plan(
                    0, m, len(widths), *w, k, sms, 0,
                    *(ctypes.byref(o) for o in out)) == 0
                assert [o.value for o in out] == [
                    1, mirror.tiles, mirror.splits, mirror.k_per_split]


#: Token counts of the decode cases that also count what a call queues.
DECODE_MS = [1, 2, 3, 4, 8, 17, 33, 63, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("m", DECODE_MS)
@pytest.mark.parametrize("op,k,widths", [
    ("gemm_ar", 4096, (4096,)), ("gemm_ar", 12288, (4096,)),
    ("ag_gemm", 4096, (4096, 1024, 1024)), ("ag_gemm", 4096, (12288, 12288))],
    ids=["o_proj", "down", "qkv", "gate_up"])
def test_decode_call_is_one_kernel_on_card(cuda_device, m, op, k, widths):
    """Qwen3-8B's decode products on the tensor-core decode body: within
    the tolerance of ``test_gemm_ar_kernel_matches_plain_on_card`` /
    ``test_ag_gemm_kernel_matches_plain_on_card``, a repeat bit-identical,
    and one call one kernel and nothing else (no split reduce, no
    workspace memset), counted in a captured CUDA graph."""
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    from triton_dist_tpu_torch.tools.queued import queued_work
    a, bs = _ag_inputs(m, k, widths, torch.bfloat16, cuda_device,
                       seed=m + k)
    if op == "gemm_ar":
        def call():
            return [port.gemm_ar(a, bs[0])]
        want = [port.gemm_ar_reference(a, bs[0])]
    else:
        def call():
            return ag.ag_gemm_multi(a, bs)
        want = ag.ag_gemm_multi_reference(a, bs)
    got, again = call(), call()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for x, ref in zip(got, want):
        if op == "gemm_ar":
            exact = (a.double() @ bs[0].double()).cpu().numpy()
            for r in (ref.float().cpu().numpy(), exact):
                assert_within_bf16_ulp(x.float().cpu().numpy(), r,
                                       atol=F32_SUM_ATOL)
        else:
            _assert_gemm_close(x, ref, k)
    assert dict(queued_work(call)) == {"kernel": 1}


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
# Qwen3-8B's decode shapes (B = 4, 32 query / 8 KV heads of dim 128), a
# small odd one, G = 1 at D = 64 and G = 8 at D = 256 (the bf16 body's
# three tile widths), over every type pair (q, cache). Tolerances (kernel
# vs plain version on the same inputs): f32 outputs within 1e-5 (sums in
# another order). bf16: the kernel rounds each probability p_j to bf16
# against its warp's running max, the plain version against the row's
# final max, so p_j moves by up to 2^-8 of itself on each side; both
# outputs then round to bf16 once. The limit is the port's
# ``bf16_attention_limit`` (ops/sp_attention.py): one bf16 ulp of the
# output plus 2^-8 sum_j (p_j / l)|v_j|, the sum taken by the plain decode
# over |v|. A merge that lost one split must fail it.
FD_SHAPES = [(4, 32, 8, 128, 1024), (3, 8, 2, 16, 48), (2, 8, 8, 64, 300),
             (2, 32, 4, 256, 700)]
FD_IDS = ["qwen3_8b", "small", "g1_d64", "g8_d256"]
FD_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
            (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
FD_PAIR_IDS = ["bf16", "f32", "f32_q", "f32_cache"]


def _fd_inputs(b, hq, hkv, d, t, dtype, device, seed=0, kv_dtype=None):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, hq, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, t, hkv, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, t, hkv, d).astype(np.float32))
    kv_dtype = kv_dtype or dtype
    return [q.to(device, dtype)] + [x.to(device, kv_dtype) for x in (k, v)]


def _fd_weight(q, k, v, lens):
    """sum_j (p_j / l)|v_j| per output element: the plain decode in f32
    over |v|."""
    from triton_dist_tpu_torch.ops import flash_decode as fd
    return fd.flash_decode_reference(q.float(), k.float(), v.float().abs(),
                                     lens)


def _fd_close(got, want, weight):
    """Whether a decode output is within the tolerance above."""
    from triton_dist_tpu_torch.ops.sp_attention import bf16_attention_limit
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        lim = torch.full(got.shape, 1e-5, device=got.device)
    else:
        lim = bf16_attention_limit(got, want, weight)
    return bool(((got.float() - want.float()).abs() <= lim).all())


def _fd_assert_close(got, want, weight):
    assert _fd_close(got, want, weight), (got.float() - want.float()).abs(
    ).max()


def _fd_lens(b, t):
    """kv_len 0, 1, a ragged 17, lengths across several 64-position tiles
    (none a multiple of 64 but t), the full cache, and mixed rows."""
    return [0, 1, 17, 160, min(333, t), t,
            [min(x, t) for x in (0, 17, 333, 1024, 5)][:b]]


@pytest.mark.cuda
@pytest.mark.parametrize("pair", FD_PAIRS, ids=FD_PAIR_IDS)
@pytest.mark.parametrize("shape", FD_SHAPES, ids=FD_IDS)
def test_flash_decode_kernels_match_plain_on_card(cuda_device, pair, shape):
    """single, partial, combine and the fused tiled launch against their
    plain versions; the fused launch bit-equal to the standalone combine
    of the partials; every kernel bit-identical on repeat; a merge that
    lost one split (standalone, or the fused launch's planted fault)
    refused."""
    from triton_dist_tpu_torch.ops import flash_decode as fd
    b, hq, hkv, d, t = shape
    dtype, kv_dtype = pair
    q, k, v = _fd_inputs(b, hq, hkv, d, t, dtype, cuda_device,
                         kv_dtype=kv_dtype)
    p = fd.plan(b, hkv, t, 132)
    for lens in _fd_lens(b, t):
        before = {n: c.total for n, c in fd.launches.items()}
        runs = []
        for _ in range(2):
            parts = fd.flash_decode_partial(q, k, v, lens, p.split_len,
                                            p.splits)
            runs.append((fd.flash_decode_single(q, k, v, lens), *parts,
                         fd.flash_decode_combine(*parts, dtype),
                         fd.flash_decode_tiled(q, k, v, lens, p.split_len,
                                               p.splits)))
        torch.cuda.synchronize()
        assert {n: c.total - before[n] for n, c in fd.launches.items()} == {
            "partial": 4, "combine": 2, "single": 2, "world_single": 0,
            "world_tiled": 0}
        for x, y in zip(*runs):                     # no atomics in a sum
            assert torch.equal(x, y)
        single, a, l, m, merged, fused = runs[0]
        assert torch.equal(fused, merged)           # one merge function
        want = fd.flash_decode_reference(q, k, v, lens)
        w = _fd_weight(q, k, v, lens)
        _fd_assert_close(single, want, w)
        _fd_assert_close(fused, want, w)
        # The combine kernel against its plain version on the same
        # partials, and the partials against theirs.
        _fd_assert_close(merged, fd.flash_decode_combine_reference(
            a, l, m, dtype), w)
        ref_parts = fd.flash_decode_partials_reference(q, k, v, lens,
                                                       p.split_len, p.splits)
        _fd_assert_close(fd.flash_decode_combine_reference(a, l, m, dtype),
                         fd.flash_decode_combine_reference(*ref_parts,
                                                           dtype), w)
        torch.testing.assert_close(m, ref_parts[2], rtol=1e-5, atol=1e-5)
        zero = torch.tensor(lens, device=cuda_device) == 0
        assert not fused[zero].float().any()        # kv_len 0 gives 0
        assert not single[zero].float().any()
        # Planted faults: the split that holds the shortest live row's last
        # position left out of the merge, by the standalone combine and by
        # the fused launch; the limit must refuse both.
        live = [n for n in (lens if isinstance(lens, list) else [lens])
                if n > 0]
        if not live:
            continue
        drop = min((min(live) - 1) // p.split_len, p.splits - 1)
        a2, l2, m2 = (x.clone() for x in (a, l, m))
        a2[:, :, drop], l2[:, :, drop], m2[:, :, drop] = 0.0, 0.0, -1e30
        assert not _fd_close(fd.flash_decode_combine(a2, l2, m2, dtype),
                             want, w)
        bad = fd.flash_decode_tiled(q, k, v, lens, p.split_len, p.splits,
                                    fault=drop)
        assert not _fd_close(bad, want, w)
        # The tickets are back at 0: the next call merges as before.
        assert torch.equal(fd.flash_decode_tiled(q, k, v, lens, p.split_len,
                                                 p.splits), fused)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("page", [16, 128], ids=["page16", "page128"])
def test_flash_decode_paged_kernel_reads_through_the_table(cuda_device,
                                                           dtype, page):
    """Pages smaller and larger than the 64-position tile, read through
    the table by the fused launch: the same bits as the dense rows and
    the gathered copy; corrupt table entries clamped into the pool."""
    from triton_dist_tpu_torch.ops import flash_decode as fd
    b, hq, hkv, d, t = 4, 32, 8, 128, 1024
    n_pages = t // page
    q, k, v = _fd_inputs(b, hq, hkv, d, t, dtype, cuda_device, seed=1)
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
    before = fd.launches["partial"].total
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
            q, pool_k, pool_v, table, lens), _fd_weight(q, k, v, lens))
    # One fused launch a call, no standalone combine.
    assert fd.launches["partial"].total - before == 4 * len(
        _fd_lens(b, t))
    # Table entries past the pool, or negative, are clamped into it, never
    # read past it.
    bad = table.clone()
    bad[0, 0, 0] = 1 << 20
    bad[0, 1, 1] = -7
    out = fd.gqa_fwd_batch_decode_paged(q, pool_k, pool_v, bad, t)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out[2:], fd.gqa_fwd_batch_decode(
        q, k, v, t, fd.FlashDecodeContext(variant="tiled"))[2:])


@pytest.mark.cuda
def test_flash_decode_plan_fills_the_card(cuda_device):
    """The most splits of whole 64-position tiles that keep rows x splits
    within one wave of one block an SM."""
    from triton_dist_tpu_torch.ops import flash_decode as fd
    for b, hkv, t in ((4, 8, 1024), (1, 8, 4096), (64, 8, 512), (3, 2, 48),
                      (1, 8, 32800), (4, 8, 8200)):
        p = fd.plan(b, hkv, t, 132)
        assert p.split_len % 64 == 0
        assert (p.splits - 1) * p.split_len < t <= p.splits * p.split_len
        assert p.splits == 1 or b * hkv * p.splits <= 132
    assert fd.plan(4, 8, 1024, 132) == fd.Plan(4, 256)
    assert fd.plan(1, 8, 32800, 132) == fd.Plan(16, 2112)


# -- AG-GEMM, AG-SwiGLU and GEMM-RS (csrc/ag_gemm.cu) ---------------------------
# Qwen3-8B's shapes (prefill M = 512 and decode M = 4: QKV, gate|up, the
# o_proj and down projections) and small odd ones: ragged M, N and K edges,
# widths and K that are not multiples of 8 (the FMA kernel in bf16).
AG_SHAPES = [(512, 4096, (4096, 1024, 1024)), (4, 4096, (4096, 1024, 1024)),
             (4, 4096, (12288, 12288)), (130, 72, (40, 24, 8)),
             (65, 264, (136,)), (7, 100, (72, 30)), (200, 36, (20, 12)),
             # The tensor-core tile's edges: M and K (4104) off its 128 and
             # 64, widths off its 128, three products; M = 2048, 5.8 waves.
             (200, 4104, (136, 264, 40)), (2048, 1024, (4096, 1024, 1024))]


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
                                   (130, 72, 40), (4, 100, 30),
                                   (200, 4104, 136), (2048, 1024, 4096)])
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
                                   (64, 100, 72), (130, 4104, 264),
                                   (2048, 4096, 4096)])
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
    assert p.path == "decode" and p.tiles == 96 and p.splits == 4
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
# expert), and the wgmma body's edges: one expert with exactly 64, 65 and
# 128 rows (its 64-row tiles), one pair, one expert, K = 200 (TMA's fill of
# the last 64-deep slice), N = 200 (a partial 256-wide item) and N = 96 (a
# partial SwiGLU item). Tolerances as for AG-GEMM above.
# (tokens, topk, E, K, N, live experts or None for all, sentinel share)
MOE_SHAPES = [(4, 8, 128, 2048, 768, None, 0.0),
              (512, 8, 128, 2048, 768, None, 0.0),
              (512, 8, 128, 768, 2048, 3, 0.0),
              (9, 2, 5, 40, 24, None, 0.25),
              (70, 2, 8, 64, 136, 2, 0.1),
              (64, 1, 8, 256, 512, 1, 0.0),
              (65, 1, 8, 256, 512, 1, 0.0),
              (64, 2, 8, 256, 512, 1, 0.0),
              (1, 1, 16, 256, 256, None, 0.0),
              (40, 2, 1, 128, 256, None, 0.0),
              (48, 2, 16, 200, 256, None, 0.0),
              (48, 2, 16, 256, 200, None, 0.0),
              (48, 2, 16, 256, 96, None, 0.0)]
MOE_IDS = ["decode", "prefill", "few_experts", "odd_sentinel", "sentinel",
           "rows64", "rows65", "rows128", "one_pair", "one_expert", "k200",
           "n200", "n96"]


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
    # bf16 with K, N and the strides multiples of 8: the wgmma body, 64-row
    # tiles (wgmma's M) and 256-column items at every P, so a row's sum
    # does not depend on P; the worst case of live row tiles is
    # ceil(P / 64) + min(E, P).
    assert gg.plan(32, 128, 2048, 768, bf) == gg.Plan("wgmma", 64, 1 + 32,
                                                      256)
    assert gg.plan(4096, 128, 2048, 768, bf) == gg.Plan("wgmma", 64,
                                                        64 + 128, 256)
    for pairs in (1, 8, 1024, 2048):
        assert gg.plan(pairs, 128, 768, 2048, bf)[:2] == ("wgmma", 64)
    assert gg.plan(32, 128, 2048, 192, bf, (2048, 768, 2048 * 768)).m_blk \
        == 64
    # f32, and bf16 with a width or a stride off 8: the FMA tile, rows per
    # tile twice the mean pairs per expert in [16, 64], 64 columns.
    assert gg.plan(4096, 128, 2048, 768, f32) == gg.Plan("fma", 64,
                                                         64 + 128, 64)
    assert gg.plan(1024, 128, 768, 2048, f32).m_blk == 16
    assert gg.plan(2048, 128, 768, 2048, f32).m_blk == 32
    assert gg.plan(32, 128, 2048, 770, bf).path == "fma"
    assert gg.plan(32, 128, 2048, 768, bf, (2052, 768, 2048 * 768)).path \
        == "fma"
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
#: Qwen3-8B's heads (G = 4), Qwen3-30B-A3B's (G = 8, also at B = 4), G = 1,
#: G = 3 (a q tile of 42 positions, its last two rows dead), G = 200 (heads
#: split into groups of 128), S at and beside the 128-wide KV tiles (127,
#: 128, 129, 4097) and no multiple of them, B = 4, D = 64, f32 on the FMA
#: path, and sequences shorter than one tile (S = 1, 7).
SP_SHAPES = [(torch.bfloat16, True, 1, 2048, 32, 8, 128),
             (torch.bfloat16, True, 4, 1024, 32, 8, 128),
             (torch.bfloat16, False, 1, 1000, 32, 8, 128),
             (torch.bfloat16, True, 1, 1000, 32, 4, 128),
             (torch.bfloat16, True, 2, 333, 8, 8, 64),
             (torch.float32, True, 1, 1000, 32, 8, 128),
             (torch.float32, False, 1, 512, 32, 4, 128),
             (torch.float32, True, 1, 100, 4, 4, 64),
             (torch.bfloat16, True, 3, 1, 32, 8, 128),
             (torch.float32, False, 2, 7, 32, 4, 128),
             (torch.bfloat16, True, 1, 127, 32, 8, 128),
             (torch.bfloat16, True, 1, 128, 32, 8, 128),
             (torch.bfloat16, False, 1, 129, 32, 8, 128),
             (torch.bfloat16, True, 1, 4097, 32, 8, 128),
             (torch.bfloat16, True, 1, 1000, 8, 8, 128),
             (torch.bfloat16, True, 2, 1000, 24, 8, 128),
             (torch.bfloat16, False, 1, 777, 24, 8, 128),
             (torch.bfloat16, True, 4, 1024, 32, 4, 128),
             (torch.bfloat16, True, 1, 1000, 32, 8, 64),
             (torch.bfloat16, True, 1, 100, 200, 1, 64)]


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


# -- slice 6: the expert-parallel all-to-all (csrc/all_to_all.cu) --------------
#: (world, capacity): Qwen3-30B-A3B's decode (cap 8, one chunk) and prefill
#: (cap 1024, chunks of 128) slabs and a two-chunk bf16 slab, at W = 2, 4, 8.
A2A_CASES = [(w, cap) for w in (2, 4, 8) for cap in (8, 16, 1024)]
#: A value the kernel never writes into a dead chunk of the receive buffer.
A2A_CANARY = {torch.bfloat16: float("nan"), torch.float32: float("nan"),
              torch.int8: 127}


def _bits(t):
    """``t``'s bits as integers, so NaN canaries compare equal."""
    return t.view({2: torch.int16, 4: torch.int32, 1: torch.int8}[
        t.element_size()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("world,cap", A2A_CASES)
def test_all_to_all_kernel_matches_plain_on_card(cuda_device, dtype, world,
                                                 cap):
    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    h = 256
    rng = np.random.RandomState(world * cap + h)
    if dtype == torch.int8:
        send = torch.from_numpy(rng.randint(-100, 100, (world * world, cap,
                                                        h)).astype(np.int8))
    else:
        send = torch.from_numpy(rng.randn(world * world, cap, h).astype(
            np.float32)).to(dtype)
    counts = rng.randint(0, cap + 1, world * world).astype(np.int32)
    counts[0], counts[-1] = cap, 0             # a full slab, an empty one
    send = send.to(cuda_device)
    counts = torch.from_numpy(counts).to(cuda_device)
    ctx = a2a.create_all_to_all_context(
        create_rank_group(world, device=cuda_device), capacity=cap)
    chunk = ctx.resolve_chunk(send.element_size())

    def canvas():
        return torch.full_like(send, A2A_CANARY[dtype])

    want, want_counts = a2a.fast_all_to_all_reference(send, counts, world,
                                                      chunk, out=canvas())
    before = a2a.a2a_launches.total
    runs = [a2a.fast_all_to_all(send, counts, ctx, out=canvas())
            for _ in range(3)]                 # three epochs on one state
    torch.cuda.synchronize()
    assert a2a.a2a_launches.total == before + 3
    for got, got_counts in runs:
        # Live chunks bit-equal, dead chunks' canaries intact; the receive
        # counts written by the kernel, a tensor of their own.
        assert torch.equal(_bits(got), _bits(want))
        assert got_counts.dtype == torch.int32
        assert torch.equal(got_counts, want_counts)
        assert got_counts.data_ptr() != counts.data_ptr()
    # A planted fault: one slab's count lowered by a chunk for the kernel
    # only; the same check must refuse it.
    bad = counts.clone()
    bad[0] -= chunk
    got, got_counts = a2a.fast_all_to_all(send, bad, ctx, out=canvas())
    assert not torch.equal(_bits(got), _bits(want))
    assert torch.equal(got_counts, a2a._xla_a2a(bad, world))
    # The fp8 wire: the int8 bytes through the kernel, dequantized rows
    # bit-equal to the same bytes through the plain exchange.
    if dtype == torch.bfloat16:
        got, _ = a2a.fast_all_to_all_fp8(send, counts, ctx)
        q, scale = a2a.quantize_fp8_rows(send)
        wire = q.view(torch.int8)
        moved, _ = a2a.fast_all_to_all_reference(
            wire, counts, world, ctx.resolve_chunk(1))
        ref = a2a.dequantize_fp8_rows(moved.view(torch.float8_e4m3fn),
                                      a2a._xla_a2a(scale, world), dtype)
        live = (torch.arange(cap, device=cuda_device)[None, :]
                < want_counts[:, None])[..., None].expand_as(ref)
        assert torch.equal(_bits(got)[live], _bits(ref)[live])


@pytest.mark.cuda
@pytest.mark.parametrize("world,cap", [(2, 16), (4, 8), (4, 1024)])
def test_all_to_all_reuses_one_out_across_epochs_on_card(cuda_device, world,
                                                         cap):
    """Three calls into one receive buffer, queued with no sync between
    them, each with its own slabs and counts: the buffer ends bit-equal to
    the three plain exchanges in order, canaries intact where no call
    wrote; each call's counts are its own."""
    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    h = 2048
    rng = np.random.RandomState(world + cap)
    ctx = a2a.create_all_to_all_context(
        create_rank_group(world, device=cuda_device), capacity=cap)
    chunk = ctx.resolve_chunk(2)
    calls = []
    for _ in range(3):
        send = torch.from_numpy(rng.randn(world * world, cap, h).astype(
            np.float32)).to(torch.bfloat16).to(cuda_device)
        counts = torch.from_numpy(rng.randint(
            0, cap + 1, world * world).astype(np.int32)).to(cuda_device)
        calls.append((send, counts))
    out = torch.full_like(calls[0][0], float("nan"))
    want = out.clone()
    got_counts = [a2a.fast_all_to_all(s, c, ctx, out=out)[1]
                  for s, c in calls]
    torch.cuda.synchronize()
    for send, counts in calls:
        a2a.fast_all_to_all_reference(send, counts, world, chunk, out=want)
    assert torch.equal(_bits(out), _bits(want))
    for (_, counts), got in zip(calls, got_counts):
        assert torch.equal(got, a2a._xla_a2a(counts, world))


@pytest.mark.cuda
def test_all_to_all_grid_fits_the_card(cuda_device):
    """A block an item while the card keeps that many resident (a copy
    item per 16 KiB piece of every (peer, rank, chunk), a wait item per
    (rank, source)); above, the compact body on whole waves of blocks,
    fewer than the items."""
    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.ops.common import num_sms
    sms = num_sms(cuda_device.index)
    # Qwen3-30B-A3B's decode slabs (one chunk of 8 rows of 4 KiB, two
    # pieces) at W = 2, 4, 8: 2 W^2 copy items and W (W - 1) waits.
    for world in (2, 4, 8):
        items = 2 * world * world + world * (world - 1)
        assert a2a.grid(world, 8, 8, 4096) == (items, False)
    assert a2a.grid(4, 8, 8, 4096) == (44, False)
    # Its prefill slabs (chunks of 128 rows, 32 pieces each): 4108 items
    # at W = 4, 8248 at W = 8.
    for world, cap, items in ((4, 1024, 4108), (8, 512, 8248)):
        blocks, compact = a2a.grid(world, cap, 128, 4096)
        assert compact and blocks % sms == 0 and sms <= blocks < items


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["all_to_all_decode", "all_to_all_prefill",
                                   "full_mesh_push", "ring_1d", "ring_bidir",
                                   "broadcast"])
def test_one_entry_call_queues_one_kernel_on_card(cuda_device, entry):
    """A CUDA graph captured from one call of ``fast_all_to_all``,
    ``launch_all_gather_world`` or ``launch_broadcast_world`` at W = 4 on
    Qwen3-30B-A3B's shapes holds one kernel node and nothing else."""
    from triton_dist_tpu_torch.ops import all_to_all as a2a
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    from triton_dist_tpu_torch.tools.queued import queued_work
    world, h = 4, 2048
    group = create_rank_group(world, device=cuda_device)
    if entry.startswith("all_to_all"):
        cap = 8 if entry.endswith("decode") else 1024
        send = torch.randn(world * world, cap, h,
                           device=cuda_device).to(torch.bfloat16)
        counts = torch.full((world * world,), cap // 2, dtype=torch.int32,
                            device=cuda_device)
        ctx = a2a.create_all_to_all_context(group, capacity=cap)

        def call():
            return a2a.fast_all_to_all(send, counts, ctx)
    else:
        x = torch.randn(512, h, device=cuda_device).to(torch.bfloat16)
        if entry == "broadcast":
            ctx = ag.create_allgather_context(group=group)

            def call():
                return ag.launch_broadcast_world(x, 0, ctx)
        else:
            method = ag.AllGatherMethod(entry)
            ctx = ag.create_allgather_context(method=method, group=group)

            def call():
                return ag.launch_all_gather_world(x, ctx, method)
    call()
    assert dict(queued_work(call)) == {"kernel": 1}
    # The count sees work queued beside the entry: one more kernel.
    extra = (send if entry.startswith("all_to_all") else x).float
    assert queued_work(lambda: (call(), extra()))["kernel"] == 2
    # The state stays sound after the capture: the next call is right.
    if entry.startswith("all_to_all"):
        got, got_counts = call()
        want, want_counts = a2a.fast_all_to_all_reference(
            send, counts, world, ctx.resolve_chunk(2))
        live = (torch.arange(cap, device=cuda_device)[None, :]
                < want_counts[:, None])
        assert torch.equal(got_counts, want_counts)
        assert torch.equal(_bits(got)[live], _bits(want)[live])
    elif entry == "broadcast":
        got = call()
        want = ag.broadcast_reference(x, 0, world)
        assert all(torch.equal(_bits(got[r]), _bits(want))
                   for r in range(world))
    else:
        assert torch.equal(_bits(call()), _bits(
            ag.all_gather_reference(x, world, stacked=True)))


# -- slice 7: the ring kernels (csrc/ag_gemm_ring.cu, csrc/gemm_rs_ring.cu) --
#: (world, M, K, widths, ring_dirs) of the AG ring: Qwen3-8B's prefill QKV
#: and decode gate|up at W = 4, W = 2 / 8, one direction, odd shapes (the
#: FMA tile); bf16 M <= 64 runs the decode body, so Qwen3-8B's decode QKV
#: at M = W and 64, W = 2 and 8, too.
AG_RING_CASES = [(4, 512, 4096, (4096, 1024, 1024), 2),
                 (4, 4, 4096, (12288, 12288), 2),
                 (2, 512, 4096, (4096,), 2), (8, 64, 512, (1024, 256), 2),
                 (4, 512, 4096, (4096, 1024, 1024), 1),
                 (3, 96, 72, (24, 48), 2),
                 (2, 2, 4096, (4096, 1024, 1024), 2),
                 (2, 64, 4096, (4096, 1024, 1024), 2),
                 (8, 8, 4096, (4096, 1024, 1024), 2),
                 (8, 64, 4096, (4096, 1024, 1024), 2),
                 # The tensor-core tile's edges: chunks of 130 rows, K =
                 # 4104 and 1032, shard widths off 128, three products; W =
                 # 8; 512 rows a chunk (a rank's 192 tiles, over two waves).
                 (3, 390, 4104, (264, 120, 24), 2),
                 (8, 1024, 1032, (2048, 512, 512), 2),
                 (4, 2048, 1024, (4096, 1024, 1024), 2)]
#: The AG ring's body for each world-1 plan of one rank's shard.
_AG_RING_BODY = {"decode": "stream", "prefill": "mma", "fma": "fma"}
#: (world, M, K, N, ring_dirs) of the RS / AR ring: Qwen3-8B's o_proj and
#: down at prefill and decode (M <= 64: the decode body; M = 68: the tile),
#: W = 2 / 3 / 8, one direction, odd shapes.
RS_RING_CASES = [(4, 512, 4096, 4096, 2), (4, 512, 12288, 4096, 2),
                 (4, 4, 12288, 4096, 2), (2, 512, 4096, 4096, 2),
                 (3, 384, 12288, 4096, 2), (8, 512, 4096, 4096, 2),
                 (4, 512, 4096, 4096, 1), (3, 6, 96, 40, 2),
                 (3, 390, 4104, 264, 2), (8, 1024, 8256, 4096, 2),
                 (4, 2048, 4096, 4096, 2),
                 (4, 4, 4096, 4096, 2), (8, 8, 4096, 4096, 2),
                 (4, 64, 4096, 4096, 2), (4, 68, 4096, 4096, 2)]
#: GEMM-AR only: M does not split over the ranks (padded to 6; and M = 1,
#: padded to 4, whose one live row the planted fault reaches).
AR_RING_CASES = [(3, 5, 12288, 4096, 2), (4, 1, 4096, 4096, 2)]


def _ring_group(world, device):
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    return create_rank_group(world, device=device)


def _assert_ring_close(got, want, a, b, world):
    """Within the ring's own rounding: W ulps (bf16) or 1e-5 (f32) of the
    sum of the partials' magnitudes, plus W f32_sum_atol(K / W)."""
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs
    parts = rs._ring_partials(a, b, world).float().abs().sum(0)
    rel = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-5
    lim = world * (rel * parts[:got.shape[0]]
                   + f32_sum_atol(a.shape[1] // world))
    assert bool(((got.float() - want.float()).abs() <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world,m,k,widths,dirs", AG_RING_CASES)
def test_ag_ring_kernel_matches_plain_on_card(cuda_device, dtype, world, m,
                                              k, widths, dirs):
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    a, bs = _ag_inputs(m, k, widths, dtype, cuda_device, seed=m + k + world)
    ctx = ag.AllGatherGEMMContext(_ring_group(world, cuda_device), dirs)
    shards = tuple(n // world for n in widths)
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    path = ag.ring_path(dtype, m, k, shards)
    # The body is the world-1 kernel's plan of one rank's shard.
    assert path == _AG_RING_BODY[ag.plan("gemm", m, shards, k, dtype,
                                         sms).path]
    key = (path, world, m, k, shards)
    before, keyed = ag.ag_ring_launches.total, ag.ag_ring_launches.by_shape[key]
    got = ag.ag_gemm_multi(a, bs, ctx.group, ctx=ctx)
    again = ag.ag_gemm_multi(a, bs, ctx.group, ctx=ctx)
    torch.cuda.synchronize()
    assert ag.ag_ring_launches.total == before + 2
    assert ag.ag_ring_launches.by_shape[key] == keyed + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for x, want in zip(got, ag.ag_gemm_multi_ring_reference(a, bs, world,
                                                            dirs)):
        _assert_gemm_close(x, want, k)
    ws = ctx.state.workspace(m * k, dtype)
    assert bool(ws[:, m * k:].isnan().all())       # canaries intact
    size = ag._ring_sizes("gemm", dtype, path, world, m // world, k, shards,
                          sms)
    if size.ws:                              # the decode body's f32 products
        prods = ctx.state.workspace(size.ws, torch.float32, "products")
        assert bool(prods[:, size.ws:].isnan().all())
    if path == "stream":
        # Each rank's columns: the world-1 kernel's decode plan on the
        # gathered A and that rank's column shard, bit for bit.
        for r in range(world):
            cols = [b[:, r * n:(r + 1) * n].contiguous()
                    for b, n in zip(bs, shards)]
            for x, y, n in zip(got, ag.ag_gemm_multi(a, cols), shards):
                assert torch.equal(x[:, r * n:(r + 1) * n], y)
    # A planted fault: rank 0's first push skipped, its signal still set.
    ws.fill_(float("nan"))
    bad = ag.launch_ag_ring("gemm", a, bs, ctx, fault=True)
    assert not all(torch.equal(x, y) for x, y in zip(bad, got))
    if world > 1 and dtype == torch.bfloat16 and m >= 128 * world:
        n = widths[0] // world                     # the world-1 tile's bits
        shard = ag.ag_gemm_multi(a, [bs[0][:, :n].contiguous()])[0]
        assert torch.equal(got[0][:, :n], shard)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world,m,k,n,bias", [
    (4, 512, 4096, 12288, False), (2, 256, 64, 256, True),
    (4, 512, 72, 512, True), (3, 390, 4104, 264, True),
    (8, 1024, 1032, 1024, False), (4, 2048, 1024, 4096, False)])
def test_ag_swiglu_ring_kernel_matches_plain_on_card(cuda_device, dtype,
                                                     world, m, k, n, bias):
    """The fused SwiGLU through the ring (launched directly: in f32 at
    Qwen3-8B's width JAX's rule composes instead)."""
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    a, (wg, wu) = _ag_inputs(m, k, (n, n), dtype, cuda_device, seed=n + k)
    rng = np.random.RandomState(n)
    biases = ([torch.from_numpy(rng.randn(n).astype(np.float32)).to(
        cuda_device, dtype) for _ in range(2)] if bias else [])
    ctx = ag.AllGatherGEMMContext(_ring_group(world, cuda_device))
    before = ag.ag_swiglu_ring_launches.total
    got = ag.launch_ag_ring("swiglu", a, [wg, wu], ctx, biases)[0]
    again = ag.launch_ag_ring("swiglu", a, [wg, wu], ctx, biases)[0]
    torch.cuda.synchronize()
    assert ag.ag_swiglu_ring_launches.total == before + 2
    assert torch.equal(got, again)
    want = ag.ag_swiglu_ring_reference(a, wg, wu, *biases, world=world)
    atol, rtol = _swiglu_bound(a, wg, wu, *(biases or (None, None)))
    diff = (got.float() - want.float()).abs()
    lim = atol + rtol * torch.maximum(got.float().abs(), want.float().abs())
    assert (diff <= lim).all(), diff.max()
    if ag.swiglu_fuses(m // world, k, n // world, a.element_size()):
        entry = ag.ag_swiglu(a, wg, wu, *biases, group=ctx.group, ctx=ctx)
        assert torch.equal(entry, got)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["gemm", "swiglu"])
@pytest.mark.parametrize("world,m,k,widths", [
    (2, 512, 4096, (4096, 1024, 1024)), (3, 390, 4104, (264, 120, 24)),
    (4, 512, 4096, (4096, 1024, 1024)), (8, 1024, 1032, (2048, 512, 512))])
def test_ag_ring_prefill_is_the_world1_kernel_on_each_shard(cuda_device, op,
                                                           world, m, k,
                                                           widths):
    """bf16 at prefill shapes (the tensor-core tile): each rank's columns
    of every AG-GEMM product (the SwiGLU: of its output, gate and up the
    first width) bit-equal to the world-1 kernel on the gathered A and
    that rank's column shard of the weights."""
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    if op == "swiglu":
        widths = (widths[0], widths[0])
    a, bs = _ag_inputs(m, k, widths, torch.bfloat16, cuda_device,
                       seed=world + k)
    ctx = ag.AllGatherGEMMContext(_ring_group(world, cuda_device))
    shards = tuple(n // world for n in widths)
    assert ag.ring_path(torch.bfloat16, m, k, shards[:1] if op == "swiglu"
                        else shards, op) == "mma"
    got = ag.launch_ag_ring(op, a, bs, ctx)
    for r in range(world):
        cols = [b[:, r * n:(r + 1) * n].contiguous()
                for b, n in zip(bs, shards)]
        want = ([ag.launch_swiglu(a, *cols, None, None)] if op == "swiglu"
                else ag.ag_gemm_multi(a, cols))
        for x, y, n in zip(got, want, shards):
            assert torch.equal(x[:, r * n:(r + 1) * n], y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("op,world,m,k,n,dirs", [
    (op,) + case for case in RS_RING_CASES for op in ("gemm_rs", "gemm_ar")]
    + [("gemm_ar",) + case for case in AR_RING_CASES])
def test_rs_ring_kernel_matches_plain_on_card(cuda_device, dtype, world, m,
                                              k, n, dirs, op):
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs
    (a, (b,)) = _ag_inputs(m, k, (n,), dtype, cuda_device, seed=m + n)
    ctx = rs.GEMMReduceScatterContext(_ring_group(world, cuda_device), dirs)
    ar = op == "gemm_ar"
    mp = m + (-m % world)                    # gemm_ar pads M
    ap = torch.cat([a, a.new_zeros((mp - m, k))]) if mp > m else a
    plan = rs.ring_plan(mp, k // world, n, a.element_size(), world, dirs, ar)
    path = rs.ring_path(dtype, mp, k // world, n, plan.split)
    assert (path == "stream") == (mp <= rs.DECODE_MAX_M)
    count = rs.ar_ring_launches if ar else rs.rs_ring_launches
    before = count.total
    entry = getattr(rs, op)(a, b, ctx.group, ctx=ctx)
    if plan.variant == "xla":          # JAX's gemm_ar falls back to psum
        assert count.total == before
        assert torch.equal(entry, getattr(rs, op)(a, b, ctx.group,
                                                  impl="xla"))
    else:
        assert count.total == before + 1
    # The kernel itself at the plan's split (at the psum fallback too).
    key = (path, world, mp // world, k // world, n)
    keyed = count.by_shape[key]
    got = rs.launch_ring(ap, b, ctx, plan.split, ar)
    again = rs.launch_ring(ap, b, ctx, plan.split, ar)
    torch.cuda.synchronize()
    assert count.by_shape[key] == keyed + 2
    assert torch.equal(got, again)
    if ar:                                   # every rank's copy
        assert all(torch.equal(got[0], got[r]) for r in range(world))
        got = got[0, :m]
    if plan.variant != "xla":
        assert torch.equal(entry, got)
    ref = (rs.gemm_ar_ring_reference if ar
           else rs.gemm_rs_ring_reference)(a, b, world, plan.split)
    _assert_ring_close(got, ref, ap, b, world)
    live = (world - 1) * (mp // world) * n
    slabs = ctx.state.workspace(live, dtype)
    assert bool(slabs[:, live:].isnan().all())     # canaries intact
    if path == "stream":                     # the f32 products' workspace
        size = rs._ring_sizes(dtype, path, world, mp // world, k // world, n,
                              plan.split, torch.cuda.get_device_properties(
                                  cuda_device).multi_processor_count)
        ws = ctx.state.workspace(size.ws, torch.float32, "products")
        assert bool(ws[:, size.ws:].isnan().all())
    # A planted fault: the step-0 pushes of chunk 0 (row 0, live at any
    # M) skipped, their signals still set.
    slabs.fill_(float("nan"))
    bad = rs.launch_ring(ap, b, ctx, plan.split, ar, fault=True)
    assert not torch.equal(bad[0, :m] if ar else bad, got)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["gemm_rs", "gemm_ar"])
@pytest.mark.parametrize("k", [4096, 12288])
def test_rs_ring_decode_is_the_ring_over_world1_partials(cuda_device, op, k):
    """At W = 4 in bf16, Qwen3-8B's decode o_proj (K = 4096) and down (K =
    12288): the ring kernel's output bit-equal to the ring's order and
    roundings applied in torch to the world-1 gemm_ar kernel's partial of
    each rank's shard (the decode body runs the world-1 bodies on each
    shard with its split count)."""
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs
    world, m, n = 4, 4, 4096
    (a, (b,)) = _ag_inputs(m, k, (n,), torch.bfloat16, cuda_device, seed=k)
    ctx = rs.GEMMReduceScatterContext(_ring_group(world, cuda_device))
    ar = op == "gemm_ar"
    kl = k // world
    plan = rs.ring_plan(m, kl, n, 2, world, 2, ar)
    assert rs.ring_path(torch.bfloat16, m, kl, n, plan.split) == "stream"
    got = getattr(rs, op)(a, b, ctx.group, ctx=ctx)
    parts = torch.stack([rs.gemm_ar(a[:, r * kl:(r + 1) * kl].contiguous(),
                                    b[r * kl:(r + 1) * kl])
                         for r in range(world)])     # (W, M, N), rounded
    rows = m // world
    parts = parts.reshape(world, world, rows, n)
    chunks = torch.arange(world, device=cuda_device)
    want = torch.empty((world, rows, n), dtype=a.dtype, device=cuda_device)
    for c0, c1, d in ((0, plan.split, 1), (plan.split, n, -1)):
        def part(j):     # rank c + j * d's partial of every chunk c
            return parts[(chunks + j * d) % world, chunks][..., c0:c1]
        acc = part(1)
        for j in list(range(2, world)) + [0]:
            acc = (acc.float() + part(j).float()).to(a.dtype)
        want[..., c0:c1] = acc
    torch.cuda.synchronize()
    assert torch.equal(got, want.reshape(m, n))


@pytest.mark.cuda
@pytest.mark.parametrize("world", range(2, 9))
def test_ag_ring_path_is_the_world1_plan_of_a_shard(cuda_device, world):
    """ring_path against csrc/ag_plan.cuh's make_plan itself (through
    tdt_ag_gemm_plan), over the CPU test's shapes, both ops and dtypes;
    the ring kernel's sizes entry refuses the decode body wherever that
    plan is not the decode plan."""
    import ctypes
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    prods, ws = ctypes.c_int(), ctypes.c_longlong()
    for op in ("gemm", "swiglu"):
        for dtype in (torch.bfloat16, torch.float32):
            for m in sorted({world, 4 * world, 64 - 64 % world, 64 + world,
                             512 - 512 % world}):
                for k, widths in ((4096, (4096, 1024, 1024)),
                                  (4096, (12288, 12288)), (72, (24, 48)),
                                  (100, (64,)), (2048, (4096, 512))):
                    shards = tuple(n // world for n in widths)
                    if op == "swiglu":
                        shards = shards[:1]
                    w1 = ag.plan(op, m, shards, k, dtype, sms).path
                    path = ag.ring_path(dtype, m, k, shards, op)
                    assert path == _AG_RING_BODY[w1]
                    n = list(shards) + [0] * (3 - len(shards))
                    err = ag._ring_lib().tdt_ag_ring_sizes(
                        {"gemm": 0, "swiglu": 1}[op],
                        0 if dtype == torch.bfloat16 else 1,
                        ag.RING_PATHS["stream"], world, m // world, k,
                        len(shards), *n, sms, ctypes.byref(prods),
                        ctypes.byref(ws))
                    assert (err == 0) == (w1 == "decode")


@pytest.mark.cuda
def test_ring_grids_fit_the_card(cuda_device):
    import ctypes
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs
    out = ctypes.c_int()
    for world in (2, 3, 4, 8):
        # The tensor-core tile (path 1) at 128 rows a rank, and the decode
        # body (path 2) at M = W and at the largest multiple of W up to 64.
        for path, m in ((1, 128 * world), (2, world), (2, 64 - 64 % world)):
            assert ag._ring_lib().tdt_ag_ring_grid(
                0, 0, path, world, m, ctypes.byref(out)) == 0
            assert 1 <= out.value and world * out.value <= 132 * 8
        # The tensor-core tile (path 1) and the decode body (path 2) at
        # Qwen3-8B's o_proj, one row a chunk.
        for path, rows in ((1, 128), (2, 1)):
            assert rs._ring_lib().tdt_rs_ring_grid(
                0, path, world, rows, 1024, 4096, ctypes.byref(out)) == 0
            assert 1 <= out.value


# -- sequence world W: the flash-decode exchange and the ring-KV prefill --------------
def _fd_world_weight(q, k, v, lens, world):
    from triton_dist_tpu_torch.ops import flash_decode as fd
    return fd.flash_decode_world_reference(q.float(), k.float(),
                                           v.float().abs(), lens, world)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("heads", [(32, 8, 128), (32, 4, 256)],
                         ids=["qwen3_8b", "g8_d256"])
def test_world_flash_decode_kernel_matches_plain_on_card(cuda_device, dtype,
                                                         world, heads):
    """The world-W kernel in both variants, dense and paged, against the
    plain world-W decode: kv_len 1 (every rank but the first empty),
    ragged rows and a full cache; the W rank outputs bit-equal and equal
    on repeat; a push skipped with its signal still set must fail."""
    from triton_dist_tpu_torch.ops import flash_decode as fd
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    group = create_rank_group(world, "sp", cuda_device)
    (hq, hkv, d), b, t_loc, page = heads, 4, 256, 16
    t = world * t_loc
    q, k, v = _fd_inputs(b, hq, hkv, d, t, dtype, cuda_device, seed=world)
    npg = t_loc // page
    per = b * npg + 1
    rng = np.random.RandomState(world)
    table = np.stack([rng.permutation(per - 1)[:b * npg].reshape(b, npg)
                      for _ in range(world)]).astype(np.int32)
    rows = torch.from_numpy(table.astype(np.int64) + (
        np.arange(world) * per)[:, None, None]).to(cuda_device)
    pool_k = torch.zeros((world * per, page, hkv, d), dtype=dtype,
                         device=cuda_device)
    pool_v = torch.zeros_like(pool_k)
    pool_k[rows.reshape(-1)] = k.reshape(b, world, npg, page, hkv, d
                                         ).transpose(0, 1).reshape(
        -1, page, hkv, d)
    pool_v[rows.reshape(-1)] = v.reshape(b, world, npg, page, hkv, d
                                         ).transpose(0, 1).reshape(
        -1, page, hkv, d)
    table = torch.from_numpy(table).to(cuda_device)
    for lens in ([1] * b, [1, 300, 17, t], [t] * b):
        lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
        want = fd.flash_decode_world_reference(q, k, v, lens, world)
        w = _fd_world_weight(q, k, v, lens, world)
        ctx = fd.create_flash_decode_context(group)
        for variant, tab in (("single", None), ("tiled", None),
                             ("tiled", table)):
            kk, vv = (pool_k, pool_v) if tab is not None else (k, v)
            outs = fd.flash_decode_world(q, kk, vv, lens, ctx, variant, tab)
            again = fd.flash_decode_world(q, kk, vv, lens, ctx, variant, tab)
            torch.cuda.synchronize()
            assert torch.equal(outs, again)
            assert all(torch.equal(outs[0], outs[r]) for r in range(world))
            _fd_assert_close(outs[0], want, w)
    lens = torch.full((b,), t, dtype=torch.int32, device=cuda_device)
    want = fd.flash_decode_world_reference(q, k, v, lens, world)
    w = _fd_world_weight(q, k, v, lens, world)
    for variant in ("single", "tiled"):
        bad = fd.flash_decode_world(q, k, v, lens,
                                    fd.create_flash_decode_context(group),
                                    variant, fault=True)
        torch.cuda.synchronize()
        assert not _fd_close(bad[1], want, w)


#: (world, dtype, S) of the ring prefill's card cases; W = 4 at S = 4000
#: gives each rank 1000 positions, no multiple of the 128-wide KV tiles.
RING_PREFILL_CASES = [(2, torch.bfloat16, 4096), (4, torch.bfloat16, 4096),
                      (3, torch.bfloat16, 3072), (8, torch.bfloat16, 4096),
                      (4, torch.bfloat16, 4000), (2, torch.float32, 512),
                      (4, torch.float32, 512), (3, torch.float32, 384),
                      (8, torch.float32, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("world,dtype,s", RING_PREFILL_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_ring_prefill_kernel_matches_plain_on_card(cuda_device, dtype, s,
                                                   causal, world):
    """The ring-KV prefill at Qwen3-8B's attention width against the
    plain world-W version with KV_TILE-wide tiles, within
    ``sp_attention_tolerance`` and equal on repeat; a forward skipped
    with its signal still set must fail the tolerance."""
    from triton_dist_tpu_torch.ops import sp_attention as sp
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    group = create_rank_group(world, "sp", cuda_device)
    rng = np.random.RandomState(world)
    q, k, v = (torch.from_numpy(rng.randn(1, s, h, 128).astype(np.float32))
               .to(cuda_device, dtype) for h in (32, 8, 8))
    ctx = sp.create_sp_attention_context(causal=causal, group=group)
    got = sp.sp_ag_attention(q, k, v, ctx, impl="pallas")
    again = sp.sp_ag_attention(q, k, v, ctx, impl="pallas")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = sp.sp_attention_fused_reference(q, k, v, causal, sp.KV_TILE,
                                           world)
    lim = sp.sp_attention_tolerance(got, want, q, k, v, causal)
    assert bool(((got.float() - want.float()).abs() <= lim).all())
    bad = sp.launch_sp_ring_attention(
        q, k, v, sp.create_sp_attention_context(causal=causal, group=group),
        fault=True)
    torch.cuda.synchronize()
    assert not bool(((bad.float() - want.float()).abs() <= lim).all())


# -- slice 10: the world-W all-gather and broadcast (csrc/allgather.cu), the
# grouped GEMM and MoE-reduce on strided expert shards -----------------------
def _agw_shapes(world):
    """TPMoE's decode (4 rows) and prefill (512) all-gather at hidden 2048,
    padded to a multiple of the ranks as TPMoE pads them, and chunks of
    5 f32 columns (20 bytes: the byte copies)."""
    return [(-(-4 // world) * world, 2048), (-(-512 // world) * world, 2048),
            (3 * world, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("method", ["full_mesh_push", "ring_1d",
                                    "ring_bidir"])
@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_world_all_gather_kernel_matches_plain_on_card(cuda_device, dtype,
                                                       method, world):
    """Every rank's copy bit-equal to the plain version (into NaN-filled
    buffers: no byte left unwritten), on repeat too; a push (or forward)
    skipped with its signal set leaves NaN, refused."""
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    group = create_rank_group(world, device=cuda_device)
    m_ = ag.AllGatherMethod(method)
    ctx = ag.create_allgather_context(method=m_, group=group)
    for rows, cols in _agw_shapes(world):
        x = torch.randn(rows, cols, device=cuda_device).to(dtype)
        want = ag.all_gather_reference(x, world, stacked=True)
        out = torch.full_like(want, float("nan"))
        before = ag.all_gather_launches.total
        got = ag.launch_all_gather_world(x, ctx, m_, out=out)
        again = ag.all_gather(x, ctx, stacked=True)
        one = ag.all_gather(x, ctx)
        torch.cuda.synchronize()
        assert ag.all_gather_launches.total == before + 3
        assert got is out and torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(again), _bits(want))
        assert torch.equal(_bits(one), _bits(x))
        bad = ag.launch_all_gather_world(
            x, ag.create_allgather_context(method=m_, group=group),
            m_, out=torch.full_like(want, float("nan")), fault=True)
        torch.cuda.synchronize()
        assert bool(bad.isnan().any()) and not torch.equal(bad, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_world_broadcast_kernel_matches_plain_on_card(cuda_device, dtype,
                                                      world):
    from triton_dist_tpu_torch.ops import allgather as ag
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    group = create_rank_group(world, device=cuda_device)
    ctx = ag.create_allgather_context(group=group)
    for rows, cols in _agw_shapes(world):
        x = torch.randn(rows, cols, device=cuda_device).to(dtype)
        for root in (0, world - 1):
            want = ag.broadcast_reference(x, root, world)
            out = torch.full((world, *want.shape), float("nan"),
                             dtype=dtype, device=cuda_device)
            got = ag.launch_broadcast_world(x, root, ctx, out=out)
            one = ag.broadcast(x, root, ctx)
            torch.cuda.synchronize()
            assert all(torch.equal(_bits(got[r]), _bits(want))
                       for r in range(world))
            assert torch.equal(_bits(one), _bits(want))
            bad = ag.launch_broadcast_world(
                x, root, ag.create_allgather_context(group=group),
                out=torch.full_like(out, float("nan")), fault=True)
            torch.cuda.synchronize()
            assert bool(bad.isnan().any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [4, 512], ids=["decode", "prefill"])
def test_grouped_gemm_on_expert_shards_equals_contiguous_on_card(
        cuda_device, dtype, t):
    """TPMoE at W = 4 on Qwen3-30B-A3B's shapes: each rank's column shard
    of gate / up (E, 2048, 192), a strided view, gives the bits of the same
    shard copied contiguous; so does the MoE-reduce on a rank's columns of
    act and row shard of w_down (E, 192, 2048)."""
    from triton_dist_tpu_torch.ops import group_gemm as gg
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    world, topk, e, h, i = 4, 8, 128, 2048, 768
    x, (wg, wd_t), ids = _moe_inputs(t, topk, e, h, i, None, 0.0, dtype,
                                     cuda_device, seed=t)
    wu = wg.flip(0).contiguous()
    wd = wd_t.transpose(1, 2).contiguous()              # (E, I, H)
    act = torch.randn(t * topk, i, device=cuda_device).to(dtype)
    wts = torch.rand(t, topk, device=cuda_device)
    loc = i // world
    for r in range(world):
        cols = slice(r * loc, (r + 1) * loc)
        views = [wg[:, :, cols], wu[:, :, cols]]
        assert not views[0].is_contiguous()
        got = gg.grouped_matmul_multi(x, views, ids, e, topk)
        want = gg.grouped_matmul_multi(x, [v.contiguous() for v in views],
                                       ids, e, topk)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        a_r, wd_r = act[:, cols], wd[:, cols]
        got = mrs.launch_moe_rs(a_r, wd_r, ids, wts, e, True)
        want = mrs.launch_moe_rs(a_r.contiguous(), wd_r.contiguous(), ids,
                                 wts, e, True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    p = gg.plan(t * topk, e, h, loc, torch.bfloat16, (h, i, h * i))
    assert p.path == "wgmma"
    assert gg.plan(t * topk, e, h, loc, torch.bfloat16,
                   (h, i + 1, h * (i + 1))).path == "fma"


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["ring", "xla"])
def test_world_moe_reduce_rs_matches_plain_on_card(cuda_device, impl):
    """moe_reduce_rs at W = 4: one kernel launch a rank on its I-shard,
    each rank's partial within the MoE-reduce limit of its plain version
    (rounded pairs), and the result bit-equal to those partials reduced
    in the impl's order."""
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    world, t, topk, e, i, h = 4, 512, 8, 128, 768, 2048
    x, (w, _), ids = _moe_inputs(t, topk, e, i, h, None, 0.0,
                                 torch.bfloat16, cuda_device, seed=3)
    act = x.repeat_interleave(topk, 0).contiguous()
    wts = torch.rand(t, topk, device=cuda_device)
    group = create_rank_group(world, device=cuda_device)
    ctx = mrs.create_moe_rs_context(num_experts=e, topk=topk,
                                    world_size=world)
    before = mrs.moe_rs_launches.total
    got = mrs.moe_reduce_rs(act, w, ids, wts, ctx, impl=impl)
    torch.cuda.synchronize()
    assert mrs.moe_rs_launches.total == before + world
    loc = i // world
    parts = []
    for r in range(world):
        a_r, w_r = act[:, r * loc:(r + 1) * loc], w[:, r * loc:(r + 1) * loc]
        part = mrs.launch_moe_rs(a_r, w_r, ids, wts, e, True)
        ref = mrs.moe_reduce_rs_reference(a_r, w_r, ids, wts, e)
        pair = mrs.grouped_matmul_reference(a_r, w_r, ids, e).float()
        pair_mag = (pair.abs().reshape(t, topk, -1) * wts[..., None]).sum(1)
        lim = (2.0 ** -7 * (torch.maximum(part.float().abs(),
                                          ref.float().abs()) + pair_mag)
               + f32_sum_atol(loc))
        assert bool(((part.float() - ref.float()).abs() <= lim).all())
        parts.append(part)
    want = (mrs.ring_reduce_scatter(parts) if impl == "ring"
            else group.psum(parts))
    assert torch.equal(got, want)


# -- tensor world W: the ring AG + grouped GEMM (csrc/ag_group_gemm.cu) ---------------
#: (world, M, E, K, N, sentinel share) of ag_group_gemm: Qwen3-30B-A3B's
#: gate at decode (32 rows: 4 tokens x top-8) and prefill (4096) over its
#: 192-wide (W = 4) and 96-wide (W = 8) expert shards, W = 2 and 3, and
#: small shapes: 128-wide shards with few experts, the FMA tile (K and the
#: shard width not multiples of 8) with sentinel ids, and the wgmma body's
#: edges: one expert (E = 1) with exactly 64, 65 and 128 rows a chunk, one
#: row a chunk, K = 200 and a 200-wide shard.
AGG_CASES = [(4, 32, 128, 2048, 768, 0.0), (4, 4096, 128, 2048, 768, 0.0),
             (8, 32, 128, 2048, 768, 0.0), (8, 4096, 128, 2048, 768, 0.0),
             (2, 512, 128, 2048, 768, 0.0), (3, 96, 16, 256, 384, 0.0),
             (4, 72, 5, 36, 80, 0.25), (2, 128, 1, 256, 512, 0.0),
             (2, 130, 1, 256, 512, 0.0), (2, 256, 1, 256, 512, 0.0),
             (2, 2, 8, 256, 256, 0.0), (2, 64, 8, 200, 256, 0.0),
             (2, 64, 8, 256, 400, 0.0)]
AGG_IDS = ["w4_decode", "w4_prefill", "w8_decode", "w8_prefill", "w2",
           "w3_small", "w4_fma_sentinel", "rows64", "rows65", "rows128",
           "one_row", "k200", "n200"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", AGG_CASES, ids=AGG_IDS)
def test_ag_group_gemm_ring_kernel_matches_plain_on_card(cuda_device, dtype,
                                                         case):
    """impl "fused" at world W: one schedule + one cooperative launch a
    call, repeats bit-identical, bit-equal to impls "xla" and "ring" (the
    world-1 kernel once a rank on its strided shard: a row's sum does not
    depend on its tile), within the grouped GEMM's limit of the plain
    version, the workspaces' NaN canaries intact, and a skipped push (its
    signal still set) refused."""
    from triton_dist_tpu_torch.ops import group_gemm as gg
    world, m, e, k, n, sentinel = case
    rng = np.random.RandomState(m + k + world)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
        cuda_device, dtype)
    w = torch.from_numpy((rng.randn(e, k, n) / np.sqrt(k)).astype(
        np.float32)).to(cuda_device, dtype)
    ids = rng.randint(0, e, m)
    ids[rng.rand(m) < sentinel] = e
    ids = torch.from_numpy(ids.astype(np.int32)).to(cuda_device)
    ctx = gg.create_ag_group_gemm_context(group=_ring_group(world,
                                                            cuda_device))
    before = (gg.ag_group_gemm_launches.total, gg.group_gemm_launches.total)
    got = gg.ag_group_gemm(x, w, ids, e, ctx, impl="fused")
    again = gg.ag_group_gemm(x, w, ids, e, ctx, impl="fused")
    torch.cuda.synchronize()
    assert (gg.ag_group_gemm_launches.total,
            gg.group_gemm_launches.total) == (before[0] + 2, before[1])
    assert torch.equal(_bits(got), _bits(again))
    for impl in ("xla", "ring"):
        assert torch.equal(_bits(gg.ag_group_gemm(x, w, ids, e, ctx, impl)),
                           _bits(got))
    assert gg.group_gemm_launches.total == before[1] + 2 * world
    _assert_gemm_close(got, gg.ag_group_gemm_reference(x, w, ids, e, world),
                       k)
    ws = gg.ring_workspace(x, ctx)
    assert bool(ws[:, m * k:].isnan().all())         # canaries intact
    ws.fill_(float("nan"))
    bad = gg.launch_ag_group_gemm(x, w, ids, e, ctx, fault=True)
    torch.cuda.synchronize()
    assert not torch.equal(_bits(bad), _bits(got))


@pytest.mark.cuda
def test_ag_group_gemm_ring_grid_fits_the_card(cuda_device):
    import ctypes
    from triton_dist_tpu_torch.ops import group_gemm as gg
    bpr = ctypes.c_int()
    for world in (2, 3, 4, 8):
        for m, dtype in ((32, 0), (4096, 0), (32, 1)):
            assert gg._agg_lib().tdt_ag_group_gemm_grid(
                world, m // world, 128, 2048, 768, dtype,
                ctypes.byref(bpr)) == 0
            assert 1 <= bpr.value and world * bpr.value <= 132 * 8


# -- tensor world W: the fused MoE-reduce ring (csrc/moe_rs_ring.cu) ----------
#: (world, T, E, I, H, sentinel share) of moe_reduce_rs(impl="fused"):
#: Qwen3-30B-A3B's down projection at decode (T = W tokens, one row a
#: chunk; 6 at W = 3) and prefill (512) over its 192-wide (W = 4) and
#: 96-wide (W = 8) shards, W = 2 and 3, the FMA tile (I / W and H not
#: multiples of 8) with sentinel ids, and the wgmma body's edges: one
#: expert (E = 1, top-2) with exactly 64 and 128 pairs, four pairs, K =
#: I / W = 200 and H = 200 (a partial 256-wide item).
MRR_CASES = [(4, 4, 128, 768, 2048, 0.0), (4, 512, 128, 768, 2048, 0.0),
             (8, 8, 128, 768, 2048, 0.0), (8, 512, 128, 768, 2048, 0.0),
             (2, 512, 128, 768, 2048, 0.0), (3, 6, 128, 768, 2048, 0.0),
             (4, 8, 5, 36, 84, 0.25), (2, 32, 1, 256, 512, 0.0),
             (2, 64, 1, 256, 512, 0.0), (2, 2, 4, 256, 256, 0.0),
             (2, 8, 16, 400, 512, 0.0), (2, 8, 16, 256, 200, 0.0)]
MRR_IDS = ["w4_decode", "w4_prefill", "w8_decode", "w8_prefill", "w2",
           "w3_decode", "w4_fma_sentinel", "rows64", "rows128", "four_pairs",
           "k200", "n200"]


def _assert_moe_ring_close(got, want, mag, i_loc, world):
    """Within the fused ring's own rounding: one ulp (bf16; f32 1e-5) of
    each of the W values that were rounded (``mag``) and of the larger
    result, plus W f32 sums of i_loc terms in two orders."""
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        lim = (BF16_ULP_REL * (torch.maximum(got.float().abs(),
                                             want.float().abs()) + mag)
               + world * f32_sum_atol(i_loc))
    else:
        lim = 1e-5 * mag + world * 3e-5
    assert bool((diff <= lim).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", MRR_CASES, ids=MRR_IDS)
def test_moe_rs_ring_kernel_matches_plain_on_card(cuda_device, dtype, case):
    """impl "fused" at world W: one schedule + one cooperative launch a
    call (no world-1 MoE-reduce launch), repeats bit-identical, within the
    ring's rounding of the plain version, the receive slots' and product
    workspaces' NaN canaries intact, and a skipped push (its signal still
    set) refused."""
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    world, t, e, i, h, sentinel = case
    topk = 8 if e >= 8 else 2
    rng = np.random.RandomState(t + i + world)
    act = torch.from_numpy(rng.randn(t * topk, i).astype(np.float32)).to(
        cuda_device, dtype)
    w = torch.from_numpy((rng.randn(e, i, h) / np.sqrt(i)).astype(
        np.float32)).to(cuda_device, dtype)
    ids = rng.randint(0, e, t * topk)
    ids[rng.rand(t * topk) < sentinel] = e
    ids = torch.from_numpy(ids.astype(np.int32)).to(cuda_device)
    wts = torch.from_numpy(rng.dirichlet(np.ones(topk), t).astype(
        np.float32)).to(cuda_device)
    ctx = mrs.create_moe_rs_context(num_experts=e, topk=topk,
                                    world_size=world)
    before = (mrs.moe_rs_ring_launches.total, mrs.moe_rs_launches.total)
    got = mrs.moe_reduce_rs(act, w, ids, wts, ctx, impl="fused")
    again = mrs.moe_reduce_rs(act, w, ids, wts, ctx, impl="fused")
    torch.cuda.synchronize()
    assert (mrs.moe_rs_ring_launches.total,
            mrs.moe_rs_launches.total) == (before[0] + 2, before[1])
    assert torch.equal(_bits(got), _bits(again))
    want, mag = mrs.moe_reduce_rs_fused_world_reference(
        act, w, ids, wts, e, world, magnitude=True)
    _assert_moe_ring_close(got, want, mag, i // world, world)
    prods, recv = mrs.ring_workspaces(act, w, wts, ctx)
    assert bool(prods[:, t * topk * h:].isnan().all())    # canaries intact
    assert bool(recv[:, (world - 1) * (t // world) * h:].isnan().all())
    recv.fill_(float("nan"))
    bad = mrs.launch_moe_rs_ring(act, w, ids, wts, ctx, fault=True)
    torch.cuda.synchronize()
    assert bool(bad.isnan().any())                        # fault refused


@pytest.mark.cuda
def test_moe_rs_ring_grid_fits_the_card(cuda_device):
    import ctypes
    from triton_dist_tpu_torch.ops import moe_reduce_rs as mrs
    bpr = ctypes.c_int()
    i, h = 768, 2048
    for world in (2, 3, 4, 8):
        for pairs, dtype in ((32, 0), (4096, 0), (32, 1)):
            assert mrs._ring_lib().tdt_moe_rs_ring_grid(
                world, pairs, 128, i // world, h, dtype, i, h, i * h,
                ctypes.byref(bpr)) == 0
            assert 1 <= bpr.value and world * bpr.value <= 132 * 8


# -- slice 13: the world-W reduce-scatter and all-reduce (csrc/reduce_world.cu)
RW_CASES = [("reduce_scatter", "ring"), ("reduce_scatter", "one_shot"),
            ("all_reduce", "one_shot"), ("all_reduce", "two_shot"),
            ("all_reduce", "recursive_doubling")]


def _rw_partials(world, m, n, dtype, device, seed):
    """(W, m, n) partials, rank r's at scale 4^r: the methods' rounding
    points differ."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((world, m, n), generator=gen, device=device)
    scale = 4.0 ** torch.arange(world, device=device, dtype=torch.float32)
    return (x * scale[:, None, None]).to(dtype)


def _rw_plain(x, op, method):
    from triton_dist_tpu_torch.ops import allreduce as ar
    from triton_dist_tpu_torch.ops import reduce_scatter as rs
    if op == "reduce_scatter":
        return rs.reduce_scatter_world_reference(
            x, rs.ReduceScatterMethod(method))
    return ar.all_reduce_world_reference(x, ar.AllReduceMethod(method))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("op,method", RW_CASES)
@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_world_reduce_kernel_matches_plain_on_card(cuda_device, dtype, op,
                                                   method, world):
    """Every output (every rank's copy for the all-reduce), written into
    NaN-filled buffers, bit-equal to the plain version; repeats
    bit-identical; the workspace's canaries (the tail of each row, and a
    one-shot rank's own stage slot) intact; a straggling rank changes no
    bit; a skipped push (its signal set) over a NaN-filled workspace
    shows in the output. Shapes: one row a rank, Qwen3-8B's 4096 wide; 32
    rows a rank; 15-element chunks (the element-by-element path). At
    W = 3 recursive doubling runs one-shot, as JAX's rule says."""
    from triton_dist_tpu_torch.ops import allreduce as ar
    from triton_dist_tpu_torch.ops import reduce_scatter as rs
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    group = create_rank_group(world, device=cuda_device)
    if op == "reduce_scatter":
        ctx = rs.create_reduce_scatter_context(
            method=rs.ReduceScatterMethod(method), group=group)
        entry, count = rs.reduce_scatter, rs.reduce_scatter_launches
    else:
        ctx = ar.create_allreduce_context(
            method=ar.AllReduceMethod(method), group=group)
        entry, count = ar.all_reduce, ar.all_reduce_launches
    if method == "recursive_doubling" and world == 3:
        x = _rw_partials(world, 6, 64, dtype, cuda_device, 0)
        key = ("one_shot", world, 6, 64, str(dtype).removeprefix("torch."))
        before = count.by_shape[key]
        got = entry(x, ctx)
        torch.cuda.synchronize()
        assert count.by_shape[key] == before + 1
        assert torch.equal(_bits(got), _bits(_rw_plain(x, op, "one_shot")))
        return
    kind = rs.KINDS[(op, method)]
    for i, (m, n) in enumerate([(world, 4096), (32 * world, 4096),
                                (3 * world, 5)]):
        x = _rw_partials(world, m, n, dtype, cuda_device, seed=world + i)
        want = _rw_plain(x, op, method)
        shape = (m, n) if op == "reduce_scatter" else (world, m, n)
        out = torch.full(shape, float("nan"), dtype=dtype,
                         device=cuda_device)
        got = rs.launch_reduce_world(x, ctx, op, method, out=out)
        before = count.total
        again = (entry(x, ctx) if op == "reduce_scatter"
                 else entry(x, ctx, stacked=True))
        late = rs.launch_reduce_world(x, ctx, op, method,
                                      straggler=(world - 1, 200_000))
        torch.cuda.synchronize()
        assert count.total == before + 1
        copies = [got] if op == "reduce_scatter" else list(got)
        assert got is out
        assert all(torch.equal(_bits(c), _bits(want)) for c in copies)
        assert torch.equal(_bits(again), _bits(got))
        assert torch.equal(_bits(late), _bits(got))
        ws, _ = rs.world_buffers(x, ctx.state, kind)
        live = rs._lib().tdt_reduce_world_workspace(kind, world, m * n)
        assert bool(ws[:, live:].isnan().all())           # canaries intact
        if method == "one_shot":                          # own stage slots
            unit = live // world
            assert all(bool(ws[r, r * unit:(r + 1) * unit].isnan().all())
                       for r in range(world))
        ws.fill_(float("nan"))
        bad = rs.launch_reduce_world(x, ctx, op, method, fault=True)
        torch.cuda.synchronize()
        assert bool(bad.isnan().any())                    # fault refused


@pytest.mark.cuda
def test_world_reduce_grid_fits_the_card(cuda_device):
    """The launch is one block an item, never more than the card holds at
    once (the cooperative launch fails otherwise)."""
    from triton_dist_tpu_torch.ops import reduce_scatter as rs
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for world in (2, 4, 8):
        for m in (4 * world, 512 * world):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.empty((world, m, 4096), dtype=dtype,
                                device=cuda_device)
                for op, method in RW_CASES:
                    grid, resident = rs.world_grid(x, op, method)
                    assert 1 <= grid <= resident <= 32 * sms


# -- slice 14: the pipeline shift and the KV ship hop (csrc/p2p.cu) ---------
P2P_WORLDS = [2, 3, 4, 8]


def _p2p_deltas(world):
    return (1, -1, world + 1, -(world + 2))


def _p2p_inputs(world, dtype, device, seed):
    """Inputs of the shift at ``world``: Qwen3-8B's decode rows (4 a rank,
    4096 wide) and a small odd block for floats; for bytes a W x 37-byte
    payload (unaligned shards) and a W x 4096-byte one."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.uint8:
        return [torch.randint(0, 255, (world * n,), generator=gen,
                              device=device, dtype=torch.uint8)
                for n in (37, 4096)]
    return [torch.randn((world * rows, cols), generator=gen, device=device
                        ).to(dtype) for rows, cols in ((4, 4096), (3, 5))]


def _p2p_fill(dtype):
    return 255 if dtype == torch.uint8 else float("nan")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.uint8])
@pytest.mark.parametrize("world", P2P_WORLDS)
def test_shift_kernel_matches_plain_on_card(cuda_device, dtype, world):
    """pp_shift(impl="pallas") and symm_ship, and a launch into a
    NaN-filled (0xFF-filled for bytes) buffer, bit-equal to the plain roll
    for delta in {1, -1, W + 1, -(W + 2)}; a repeat bit-identical; one
    launch counted a call, in the entry's own counter; rank 0's first
    piece skipped (its signal still set) shows in the output."""
    from triton_dist_tpu_torch.ops import p2p
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    from triton_dist_tpu_torch.serving import kv_stream as ks
    group = create_rank_group(world, "pp", device=cuda_device)
    ship_group = create_rank_group(world, "tp", device=cuda_device)
    ctx = p2p.create_p2p_context(group)
    for i, x in enumerate(_p2p_inputs(world, dtype, cuda_device, world)):
        for delta in _p2p_deltas(world):
            want = p2p.pp_shift_reference(x, world, delta)
            out = torch.full_like(x, _p2p_fill(dtype))
            before = (p2p.pp_shift_launches.total,
                      ks.symm_ship_launches.total)
            got = p2p.pp_shift(x, ctx, delta=delta)
            again = p2p.pp_shift(x, ctx, delta=delta)
            shipped = ks.symm_ship(x, ship_group, delta=delta)
            into = p2p.launch_shift(x, ctx, delta, p2p.pp_shift_launches,
                                    out=out)
            torch.cuda.synchronize()
            assert (p2p.pp_shift_launches.total - before[0],
                    ks.symm_ship_launches.total - before[1]) == (3, 1)
            assert into is out
            for t in (got, again, shipped, into):
                assert torch.equal(_bits(t), _bits(want)), (i, delta)
            bad = p2p.launch_shift(x, ctx, delta, p2p.pp_shift_launches,
                                   out=torch.full_like(x, _p2p_fill(dtype)),
                                   fault=True)
            torch.cuda.synchronize()
            assert not torch.equal(_bits(bad), _bits(want))    # refused


@pytest.mark.cuda
def test_shift_kernel_at_the_main_path_sizes_on_card(cuda_device):
    """The prefill hop (512 rows of 4096 bf16 a rank) and one Qwen3-8B KV
    block as bytes (36 x 2 x (16, 8, 128) f32 = 4,718,592 bytes) at
    W = 4, bit-equal to the plain roll, with the grid spread over the
    card."""
    from triton_dist_tpu_torch.ops import p2p
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    from triton_dist_tpu_torch.serving import kv_stream as ks
    world = 4
    group = create_rank_group(world, "pp", device=cuda_device)
    ctx = p2p.create_p2p_context(group)
    x = torch.randn((world * 512, 4096), device=cuda_device).bfloat16()
    block = torch.randint(0, 255, (36 * 2 * 16 * 8 * 128 * 4,),
                          device=cuda_device, dtype=torch.uint8)
    for t, ship in ((x, False), (block, True)):
        for delta in (1, -1):
            got = (ks.symm_ship(t, create_rank_group(world, "tp",
                                                     device=cuda_device),
                                delta) if ship
                   else p2p.pp_shift(t, ctx, delta))
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(
                p2p.pp_shift_reference(t, world, delta)))
        grid, resident = p2p.shift_grid(t, world)
        assert grid == resident


@pytest.mark.cuda
def test_shift_grid_fits_the_card(cuda_device):
    """One block an item (W x pieces pushes and as many waits), never more
    than the card holds at once; at the decode hop every push item has a
    block of its own."""
    from triton_dist_tpu_torch.ops import p2p
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for world in P2P_WORLDS:
        for n in (37, 4 * 4096 * 2, 512 * 4096 * 2, 4718592 // 4):
            x = torch.empty((world * n,), dtype=torch.uint8,
                            device=cuda_device)
            grid, resident = p2p.shift_grid(x, world)
            assert 1 <= grid <= resident <= 32 * sms
            pieces = p2p._lib().tdt_shift_signals(n, world)
            assert grid == min(2 * world * pieces, resident)


@pytest.mark.cuda
def test_pipeline_forward_and_comm_op_on_card(cuda_device):
    """pipeline_forward(impl="pallas") launches the shift once a tick and
    equals impl "xla" bit for bit; CommOp sends and receives through one
    launch each."""
    from triton_dist_tpu_torch.layers import p2p as lp
    from triton_dist_tpu_torch.ops import p2p
    from triton_dist_tpu_torch.runtime.dist import create_rank_group
    world = 4
    group = create_rank_group(world, "pp", device=cuda_device)
    x = torch.randn((world * 8, 256), device=cuda_device).bfloat16()

    def stage(i, h):
        return h * 2 + (i + 1)

    before = p2p.pp_shift_launches.total
    got = lp.pipeline_forward(stage, x, group, impl="pallas")
    torch.cuda.synchronize()
    assert p2p.pp_shift_launches.total - before == world
    assert torch.equal(_bits(got), _bits(lp.pipeline_forward(
        stage, x, group, impl="xla")))
    op = lp.CommOp(group=group)
    op.send(x, delta=-1)
    assert torch.equal(_bits(op.recv()), _bits(
        p2p.pp_shift_reference(x, world, -1)))
    assert p2p.pp_shift_launches.total - before == world + 1
