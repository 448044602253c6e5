"""The port's AG-GEMM, AG-SwiGLU and GEMM-RS (triton_dist_tpu_torch.ops.
allgather_gemm, .gemm_reduce_scatter) against the JAX package's on the CPU.

The JAX side runs on a 1-device mesh with impl="pallas", so its Pallas
kernels run in interpret mode, each variant forced through its context
(``dataclasses.replace(ctx, variant=...)``). The port's side on CPU
tensors is its plain versions. Inputs come from numpy with a fixed seed;
f32 within 1e-5 (atol and rtol: the two sides differ only in summation
order), bf16 within one bf16 ulp of the larger value (both sides sum in
f32 and round once), plus 1e-6 absolute for the SwiGLU: gate and up of
unit scale, summed in two orders, differ by ~1e-7, which is more than an
ulp of an activation near zero.

``swiglu_fuses`` is held against JAX's own decision: JAX ``ag_swiglu`` is
traced with ``jax.eval_shape`` on shapes alone, with a spy on
``ag_gemm_multi``, which its composed fallback calls and its fused path
does not; no kernel runs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.ops import allgather_gemm as jag
from triton_dist_tpu.ops import gemm_reduce_scatter as jrs
from triton_dist_tpu_torch.ops import allgather_gemm as ag
from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULP_REL = 2.0 ** -7


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _operands(m, k, widths, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(m, k).astype(np.float32)
    bs = [(rng.randn(k, n) / np.sqrt(k)).astype(np.float32) for n in widths]
    return a, bs


def _assert_bf16_close(got, want, atol=1e-12):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    lim = BF16_ULP_REL * np.maximum(np.abs(got), np.abs(want)) + atol
    assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


@pytest.mark.parametrize("variant", ["vmem", "hbm", "hbm_kt"])
@pytest.mark.parametrize("n_b", [1, 2, 3])
def test_ag_gemm_multi_matches_jax_variants(mesh, variant, n_b):
    widths = (128, 64, 192)[:n_b]
    a, bs = _operands(16, 256, widths, seed=n_b)
    ctx = dataclasses.replace(jag.create_ag_gemm_context(mesh, "tp"),
                              variant=variant)
    want = jag.ag_gemm_multi(jnp.asarray(a), [jnp.asarray(b) for b in bs],
                             ctx, impl="pallas")
    before = ag.ag_gemm_launches.total
    got = ag.ag_gemm_multi(_t(a), [_t(b) for b in bs])
    assert ag.ag_gemm_launches.total == before      # CPU calls do not count
    assert len(got) == n_b
    for g, w, n in zip(got, want, widths):
        assert g.shape == (16, n) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_ag_gemm_bf16_and_single_product_match_jax(mesh):
    a, (b,) = _operands(8, 128, (64,), seed=4)
    ctx = jag.create_ag_gemm_context(mesh, "tp")
    want = jag.ag_gemm(jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16), ctx, impl="pallas")
    got = ag.ag_gemm(_t(a, torch.bfloat16), _t(b, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, _np(want))


@pytest.mark.parametrize("rows,n", [(128, 128), (128, 256), (8, 128)],
                         ids=["fused_n128", "fused_n256", "composed_rows8"])
@pytest.mark.parametrize("bias", [False, True], ids=["", "bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ag_swiglu_matches_jax_on_both_sides_of_the_rule(mesh, rows, n, bias,
                                                         dtype):
    k = 64
    a, (wg, wu) = _operands(rows, k, (n, n), seed=rows + n)
    rng = np.random.RandomState(9)
    bg, bu = (rng.randn(n).astype(np.float32) for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ctx = jag.create_ag_gemm_context(mesh, "tp")
    jb = (dict(b_gate=jnp.asarray(bg, jdt), b_up=jnp.asarray(bu, jdt))
          if bias else {})
    want = jag.ag_swiglu(jnp.asarray(a, jdt), jnp.asarray(wg, jdt),
                         jnp.asarray(wu, jdt), ctx, impl="pallas", **jb)
    tb = (_t(bg, tdt), _t(bu, tdt)) if bias else ()
    got = ag.ag_swiglu(_t(a, tdt), _t(wg, tdt), _t(wu, tdt), *tb)
    assert got.shape == (rows, n) and got.dtype == tdt
    assert ag.swiglu_fuses(rows, k, n, got.element_size()) == (rows == 128)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    else:
        _assert_bf16_close(got, _np(want), atol=1e-6)


def test_fused_and_composed_swiglu_round_differently():
    """Why the rule is kept: in bf16 the composed path rounds gate and up
    before the SwiGLU, the fused one only after it."""
    a, (wg, wu) = _operands(128, 64, (128, 128), seed=3)
    args = [_t(x, torch.bfloat16) for x in (a, wg, wu)]
    fused = ag.ag_swiglu_reference(*args)
    gate, up = ag.ag_gemm_multi_reference(args[0], args[1:])
    composed = torch.nn.functional.silu(gate.float()).bfloat16() * up
    assert torch.equal(ag.ag_swiglu(*args), fused)
    assert not torch.equal(fused, composed)


@pytest.mark.parametrize("variant", ["vmem", "hbm", "hbm_kt"])
@pytest.mark.parametrize("m", [16, 96])
def test_gemm_rs_matches_jax_variants(mesh, variant, m):
    a, (b,) = _operands(m, 256, (128,), seed=m)
    ctx = dataclasses.replace(jrs.create_gemm_rs_context(mesh, "tp"),
                              variant=variant)
    want = jrs.gemm_rs(jnp.asarray(a), jnp.asarray(b), ctx, impl="pallas")
    before = rs.gemm_rs_launches.total
    got = rs.gemm_rs(_t(a), _t(b))
    assert rs.gemm_rs_launches.total == before
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert torch.equal(got, rs.gemm_rs_reference(_t(a), _t(b)))
    assert torch.equal(got, rs.gemm_ar(_t(a), _t(b)))   # one function


def _jax_fuses(mesh, rows, k, n, dtype):
    """JAX's own decision, read off a shape-only trace of ag_swiglu."""
    ctx = jag.create_ag_gemm_context(mesh, "tp")
    calls = []
    orig = jag.ag_gemm_multi

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return orig(*args, **kwargs)

    jag.ag_gemm_multi = spy
    try:
        jax.eval_shape(
            lambda x, g, u: jag.ag_swiglu(x, g, u, ctx, impl="pallas"),
            jax.ShapeDtypeStruct((rows, k), dtype),
            jax.ShapeDtypeStruct((k, n), dtype),
            jax.ShapeDtypeStruct((k, n), dtype))
    finally:
        jag.ag_gemm_multi = orig
    return not calls


@pytest.mark.parametrize("rows,k,n,dtype", [
    # Qwen3-8B: prefill of 4 x 128 tokens fuses, the decode batch does not;
    # a one-prompt 128-token bucket and a 1024-token prefill.
    (512, 4096, 12288, "bfloat16"), (4, 4096, 12288, "bfloat16"),
    (128, 4096, 12288, "bfloat16"), (1024, 4096, 12288, "bfloat16"),
    # Huge K: no tiling fits the budget.
    (128, 65536, 12288, "bfloat16"), (256, 16384, 1024, "float32"),
] + [(r, k, n, d) for r in (8, 128, 192, 256, 384) for k in (64, 4096)
     for n in (96, 128, 640) for d in ("float32", "bfloat16")])
def test_swiglu_fuses_is_the_jax_decision(mesh, rows, k, n, dtype):
    itemsize = 4 if dtype == "float32" else 2
    assert ag.swiglu_fuses(rows, k, n, itemsize) == _jax_fuses(
        mesh, rows, k, n, getattr(jnp, dtype))


def test_swiglu_fuses_at_qwen3_8b_shapes():
    assert ag.swiglu_fuses(512, 4096, 12288, 2)         # prefill fuses
    assert not ag.swiglu_fuses(4, 4096, 12288, 2)       # decode composes


@pytest.mark.parametrize("call", [
    lambda a, b: ag.ag_gemm_multi(a, []),
    lambda a, b: ag.ag_gemm_multi(a, [b] * 4),
    lambda a, b: ag.ag_gemm_multi(a, [b.t()]),
    lambda a, b: ag.ag_gemm_multi(a, [b.double()]),
    lambda a, b: ag.ag_gemm_multi(a, [b[:, :0]]),
    lambda a, b: ag.ag_swiglu(a, b, b[:, :4]),
    lambda a, b: ag.ag_swiglu(a, b, b, b_gate=torch.zeros(6)),
    lambda a, b: ag.ag_swiglu(a, b, b, torch.zeros(5), torch.zeros(5)),
    lambda a, b: rs.gemm_rs(a, b.t()),
    lambda a, b: rs.gemm_rs(a, b.bfloat16()),
], ids=["no_weights", "four_weights", "k_mismatch", "mixed_dtype",
        "zero_width", "gate_up_shapes", "one_bias", "bias_shape",
        "rs_k_mismatch", "rs_mixed_dtype"])
def test_bad_operands_raise(call):
    with pytest.raises(ValueError):
        call(torch.zeros(3, 8), torch.zeros(8, 6))


def test_empty_rows_and_depth_on_cpu():
    outs = ag.ag_gemm_multi(torch.zeros(0, 8), [torch.ones(8, 4)])
    assert outs[0].shape == (0, 4)
    outs = ag.ag_gemm_multi(torch.ones(3, 0), [torch.ones(0, 4)] * 2)
    assert all(torch.equal(o, torch.zeros(3, 4)) for o in outs)
