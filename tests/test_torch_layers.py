"""The port's layers (triton_dist_tpu_torch.layers) against the JAX
package's on the CPU: RMSNorm, rope, the attention core in every offset
form, and TPAttn / TPMLP in modes xla_ar, gemm_ar, ag_rs and xla (the JAX
side on a 1-device mesh with impl="pallas", so gemm_ar and ag_rs run the
Pallas kernels in interpret mode). The MLP runs at M = 128 with inter 128,
where ag_rs takes JAX's fused AG-SwiGLU, and at M = 6, where it composes
AG-GEMM with a plain SwiGLU.

Inputs come from numpy with a fixed seed; f32 throughout, within 1e-5
(atol and rtol): the two sides differ only in summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.layers import common as jcommon
from triton_dist_tpu.layers.tp_attn import (
    TPAttn as JaxAttn, _attention_core as jax_core)
from triton_dist_tpu.layers.tp_mlp import TPMLP as JaxMLP
from triton_dist_tpu_torch.layers import common, tp_attn
from triton_dist_tpu_torch.layers.tp_attn import TPAttn, _attention_core
from triton_dist_tpu_torch.layers.tp_mlp import TPMLP
from triton_dist_tpu_torch.ops import gemm_reduce_scatter

TOL = dict(rtol=1e-5, atol=1e-5)
H, HQ, HKV, D, INTER = 32, 4, 2, 16, 48


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 24).astype(np.float32) * 3
    w = rng.randn(24).astype(np.float32)
    want = np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = common.rms_norm(_t(x), _t(w), 1e-6).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_rms_norm_bf16_upcasts_like_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    want = jcommon.rms_norm(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(w, jnp.bfloat16))
    got = common.rms_norm(_t(x).bfloat16(), _t(w).bfloat16())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_rope_cache_and_apply_rope_match_jax():
    cos_j, sin_j = jcommon.precompute_rope_cache(D, 40, 1e6)
    cos, sin = common.precompute_rope_cache(D, 40, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_j), **TOL)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 3, D).astype(np.float32)
    pos = rng.randint(0, 40, size=(2, 5))
    want = np.asarray(jcommon.apply_rope(jnp.asarray(x), cos_j, sin_j,
                                         jnp.asarray(pos, jnp.int32)))
    got = common.apply_rope(_t(x), cos, sin, _t(pos).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _core_inputs(b, s, t, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, HQ, D).astype(np.float32)
    k = rng.randn(b, s, HKV, D).astype(np.float32)
    v = rng.randn(b, s, HKV, D).astype(np.float32)
    ck = rng.randn(b, t, HKV, D).astype(np.float32)
    cv = rng.randn(b, t, HKV, D).astype(np.float32)
    return q, k, v, ck, cv


def _run_both(q, k, v, ck, cv, offset, kv_start):
    jo, jk, jv = jax_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(offset, jnp.int32),
        jnp.asarray(kv_start, jnp.int32), groups=HQ // HKV)
    tck, tcv = _t(ck), _t(cv)
    off = offset if np.ndim(offset) == 0 else _t(offset).long()
    out = _attention_core(_t(q), _t(k), _t(v), tck, tcv, off,
                          _t(kv_start).long(), groups=HQ // HKV)
    # The port writes the caches in place.
    np.testing.assert_allclose(tck.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(jv), **TOL)
    return out.numpy(), np.asarray(jo)


@pytest.mark.parametrize("case", [
    # (B, S, T, offset, kv_start)
    ("prefill_scalar", 2, 6, 12, 0, [0, 0]),
    ("decode_scalar", 2, 1, 12, 7, [0, 0]),
    ("chunk_at_offset", 2, 3, 12, 4, [0, 0]),
    ("ragged_kv_start", 3, 5, 12, 0, [0, 2, 4]),
    ("decode_per_row", 3, 1, 12, [2, 9, 5], [0, 0, 1]),
    ("burst_per_row", 3, 3, 12, [1, 6, 4], [0, 1, 0]),
    ("burst_past_end_drops", 2, 3, 12, [10, 3], [0, 0]),
    ("decode_row_at_end_drops", 2, 1, 12, [12, 3], [0, 0]),
], ids=lambda c: c[0])
def test_attention_core_matches_jax(case):
    _, b, s, t, offset, kv_start = case
    q, k, v, ck, cv = _core_inputs(b, s, t, seed=b * 31 + s)
    offset = np.asarray(offset, np.int64)
    got, want = _run_both(q, k, v, ck, cv, offset,
                          np.asarray(kv_start, np.int64))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def _jax_attn(impl="pallas"):
    return JaxAttn(H, HQ, HKV, D, mesh=_mesh1(), dtype=jnp.float32,
                   impl=impl)


def _attn_params(seed):
    jattn = _jax_attn()
    jp = jattn.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    # Non-trivial q/k norms, so the test sees them.
    jp["q_norm"] = jnp.asarray(1 + 0.1 * rng.randn(D), jnp.float32)
    jp["k_norm"] = jnp.asarray(1 + 0.1 * rng.randn(D), jnp.float32)
    return jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("mode,offset,s", [
    ("xla_ar", 0, 4), ("gemm_ar", 3, 4), ("gemm_ar", "per_row", 1),
    ("ag_rs", 0, 64), ("ag_rs", 5, 3), ("ag_rs", "per_row", 1),
    ("xla", 0, 64), ("xla", 5, 3), ("xla", "per_row", 1)])
def test_tp_attn_matches_jax(mode, offset, s):
    b, t = 2, 72
    jp, tp = _attn_params(seed=5)
    rng = np.random.RandomState(6)
    x = rng.randn(b * s, H).astype(np.float32)
    if offset == "per_row":
        off = np.asarray([2, 7], np.int64)
        pos = off[:, None]
    else:
        off = offset
        pos = np.tile(np.arange(s) + offset, (b, 1))
    ck = rng.randn(b, t, HKV, D).astype(np.float32)
    cv = rng.randn(b, t, HKV, D).astype(np.float32)
    cos_j, sin_j = jcommon.precompute_rope_cache(D, 80, 1e6)
    jattn = _jax_attn()
    jout, (jk, jv) = jax.jit(
        lambda p, x, pos, rope, cache, off: jattn(p, x, pos, rope, cache,
                                                  off, mode=mode))(
        jp, jnp.asarray(x), jnp.asarray(pos, jnp.int32), (cos_j, sin_j),
        (jnp.asarray(ck), jnp.asarray(cv)), jnp.asarray(off, jnp.int32))
    attn = TPAttn(H, HQ, HKV, D, dtype=torch.float32)
    cache = (_t(ck), _t(cv))
    toff = _t(off).long() if offset == "per_row" else off
    out, cache = attn(tp, _t(x), _t(pos).long(),
                      common.precompute_rope_cache(D, 80, 1e6), cache, toff,
                      mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(cache[0].numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(cache[1].numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("mode", ["xla_ar", "gemm_ar", "ag_rs", "xla"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("m,inter", [(6, INTER), (128, 128)],
                         ids=["composed", "fused"])
def test_tp_mlp_matches_jax(mode, use_bias, m, inter):
    jmlp = JaxMLP(H, inter, mesh=_mesh1(), dtype=jnp.float32, impl="pallas",
                  use_bias=use_bias)
    jp = jmlp.init(jax.random.PRNGKey(7))
    rng = np.random.RandomState(7)
    if use_bias:
        for name in ("b_gate", "b_up", "b_down"):
            jp[name] = jnp.asarray(rng.randn(*jp[name].shape), jnp.float32)
    x = rng.randn(m, H).astype(np.float32)
    want = np.asarray(jmlp(jp, jnp.asarray(x), mode=mode))
    mlp = TPMLP(H, inter, dtype=torch.float32, use_bias=use_bias)
    got = mlp({k: _t(v) for k, v in jp.items()}, _t(x), mode=mode).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("use_bias", [False, True])
def test_tp_mlp_bf16_modes_round_where_jax_rounds(use_bias):
    """bf16 at M = 128 (fused SwiGLU): ag_rs and xla both round the SwiGLU
    once, but ag_rs rounds the down product before its bias and xla after,
    as in JAX. Each mode within one bf16 ulp (plus 1e-6) of JAX's."""
    jmlp = JaxMLP(H, 128, mesh=_mesh1(), dtype=jnp.bfloat16, impl="pallas",
                  use_bias=use_bias)
    jp = jmlp.init(jax.random.PRNGKey(8))
    rng = np.random.RandomState(8)
    if use_bias:
        for name in ("b_gate", "b_up", "b_down"):
            jp[name] = jnp.asarray(rng.randn(*jp[name].shape), jnp.bfloat16)
    x = rng.randn(128, H).astype(np.float32)
    mlp = TPMLP(H, 128, dtype=torch.bfloat16, use_bias=use_bias)
    tp = {k: _t(np.asarray(v.astype(jnp.float32))).bfloat16()
          for k, v in jp.items()}
    for mode in ("ag_rs", "xla"):
        want = np.asarray(jmlp(jp, jnp.asarray(x, jnp.bfloat16),
                               mode=mode).astype(jnp.float32), np.float64)
        got = mlp(tp, _t(x).bfloat16(), mode=mode).float().numpy()
        lim = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6
        assert (np.abs(got - want) <= lim).all(), mode


def test_reference_impl_equals_kernel_path_on_cpu(monkeypatch):
    """On CPU tensors mode gemm_ar's projection is the plain version:
    patching gemm_ar_reference in at the call site changes no bit."""
    _, tp = _attn_params(seed=8)
    rng = np.random.RandomState(8)
    x = _t(rng.randn(2, H).astype(np.float32))
    pos = torch.tensor([[3], [3]])
    rope = common.precompute_rope_cache(D, 32, 1e6)
    attn = TPAttn(H, HQ, HKV, D, dtype=torch.float32)
    outs = []
    for patched in (False, True):
        if patched:
            monkeypatch.setattr(tp_attn, "gemm_ar",
                                gemm_reduce_scatter.gemm_ar_reference)
        cache = (torch.zeros(2, 8, HKV, D), torch.zeros(2, 8, HKV, D))
        outs.append(attn(tp, x, pos, rope, cache, 3, mode="gemm_ar")[0])
    assert torch.equal(outs[0], outs[1])


def test_layers_default_to_the_fused_mode_and_refuse_unknown_ones():
    mlp = TPMLP(H, INTER, dtype=torch.float32)
    attn = TPAttn(H, HQ, HKV, D, dtype=torch.float32)
    assert mlp.fwd_mode == attn.fwd_mode == "ag_rs"      # as in JAX
    params = mlp.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="unknown fwd mode"):
        mlp(params, torch.zeros(2, H), mode="sp")
