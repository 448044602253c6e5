"""The pipeline shift, the KV ship hop and the pipeline layers: the port's
plain versions against the JAX package on W devices of the 8-device CPU
mesh, its Pallas kernels (``_shift_kernel``, ``_ship_kernel``) in
interpret mode, on the CPU.

* ``shift_partners`` equal to JAX's for W = 1..8 and every delta in
  -2W..2W.
* ``pp_shift`` in impls "pallas" and "xla" bit-equal to JAX's at W = 2,
  4, 8, delta in {1, -1, 3, -5}, f32 and bf16, 2-D and 3-D; ``x`` itself
  at world 1.
* ``symm_ship`` bit-equal to JAX's at W = 4 on uint8 payloads: the W
  shards come back rotated, not as they were.
* ``CommOp`` (both impls, the ring-full drop), ``pipeline_forward`` (a
  stage function that depends on the stage index) and
  ``pipeline_schedule`` (m = 1, 4, 11) equal to JAX's; a tiny
  ``DenseLLM`` run as a 2-stage pipeline gives its own ``forward``'s
  logits bit for bit (that forward is held to JAX's by
  tests/test_torch_model.py).
* The KV-stream schedule helpers and the block codec equal to JAX's.
* The ValueErrors: rows or a payload that do not split, a CUDA call
  without a group, an unknown impl.

The CUDA kernel (``csrc/p2p.cu``) runs on the card
(``tests/test_torch_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.layers import p2p as jlp
from triton_dist_tpu.ops import p2p as jp2p
from triton_dist_tpu.serving import kv_stream as jks
from triton_dist_tpu_torch.layers import p2p as lp
from triton_dist_tpu_torch.models import DenseLLM, KVCacheManager, ModelConfig
from triton_dist_tpu_torch.ops import p2p
from triton_dist_tpu_torch.runtime.dist import create_rank_group
from triton_dist_tpu_torch.serving import kv_stream as ks

DELTAS = (1, -1, 3, -5)


def _mesh(world, axis="pp"):
    return Mesh(np.array(jax.devices()[:world]), (axis,))


def _group(world, axis="pp"):
    return create_rank_group(world, axis, device="cpu")


def _pair(shape, dtype, seed):
    """(jax array, torch tensor) of the same values."""
    x = (np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)
    if dtype == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _bits(a) -> np.ndarray:
    """The bit patterns of a JAX array or torch tensor."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.view({4: torch.int32, 1: torch.uint8}[a.element_size()]
                      ).numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 1: np.uint8}[a.dtype.itemsize])


def test_shift_partners_match_jax():
    for world in range(1, 9):
        me = jnp.arange(world, dtype=jnp.int32)
        for delta in range(-2 * world, 2 * world + 1):
            jdst, jsrc = jp2p.shift_partners(me, delta, world)
            got = [p2p.shift_partners(r, delta, world) for r in range(world)]
            assert [d for d, _ in got] == np.asarray(jdst).tolist()
            assert [s for _, s in got] == np.asarray(jsrc).tolist()
            assert all(0 <= d < world and 0 <= s < world for d, s in got)
            assert all(p2p.shift_partners(d, -delta, world)[0] == r
                       for r, (d, _) in enumerate(got))


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("world", [2, 4, 8])
def test_pp_shift_matches_jax(world, delta):
    jctx = jp2p.create_p2p_context(_mesh(world), "pp")
    ctx = p2p.create_p2p_context(_group(world))
    for dtype in ("f32", "bf16"):
        for shape in ((world * 3, 40), (world * 2, 3, 8)):
            jx, tx = _pair(shape, dtype, seed=world * 10 + delta)
            want = jp2p.pp_shift(jx, jctx, delta=delta, impl="pallas")
            if dtype == "f32" and len(shape) == 2:   # JAX's two impls agree
                np.testing.assert_array_equal(_bits(want), _bits(
                    jp2p.pp_shift(jx, jctx, delta=delta, impl="xla")))
            for impl in ("pallas", "xla"):
                got = p2p.pp_shift(tx, ctx, delta=delta, impl=impl)
                assert got.shape == tx.shape and got.dtype == tx.dtype
                np.testing.assert_array_equal(_bits(got), _bits(want))
            roll = np.roll(_bits(tx).reshape(world, -1), delta, 0)
            np.testing.assert_array_equal(_bits(want).reshape(world, -1),
                                          roll)


def test_pp_shift_at_world_one_returns_x():
    x = torch.randn(6, 5)
    for ctx in (None, p2p.create_p2p_context(), p2p.create_p2p_context(
            _group(1))):
        for impl in ("pallas", "xla"):
            assert p2p.pp_shift(x, ctx, delta=3, impl=impl) is x
    assert ks.symm_ship(x) is x and ks.symm_ship(x, _group(1, "tp")) is x
    jx = jnp.asarray(x.numpy())
    assert jp2p.pp_shift(jx, jp2p.create_p2p_context(_mesh(1))) is jx


@pytest.mark.parametrize("nbytes_a_rank", [16, 37])
def test_symm_ship_matches_jax(nbytes_a_rank):
    """JAX's ship hop rotates the W shards of the payload: a 64-byte
    payload at W = 4 comes back as [48..63, 0..15, 16..31, 32..47]."""
    world = 4
    payload = np.random.RandomState(nbytes_a_rank).randint(
        0, 256, world * nbytes_a_rank).astype(np.uint8)
    group = _group(world, "tp")
    for delta in (1, -1, 5, -6):
        want = np.asarray(jks.symm_ship(payload, mesh=_mesh(world, "tp"),
                                        axis="tp", delta=delta))
        got = ks.symm_ship(torch.from_numpy(payload), group, delta=delta)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            want, np.roll(payload.reshape(world, -1), delta, 0).reshape(-1))
    if nbytes_a_rank == 16:
        np.testing.assert_array_equal(
            ks.symm_ship(torch.arange(64, dtype=torch.uint8), group).numpy(),
            np.r_[48:64, 0:48])
    back = ks.symm_ship(ks.symm_ship(torch.from_numpy(payload), group, 1),
                        group, -1)
    np.testing.assert_array_equal(back.numpy(), payload)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_comm_op_matches_jax(impl):
    """Three sends into a ring of two: the first hop is dropped, as JAX
    drops it; the receives come oldest first."""
    world = 4
    jx, tx = _pair((world * 2, 16), "f32", seed=7)
    jop = jlp.CommOp(num_buffers=2, mesh=_mesh(world), axis="pp", impl=impl)
    op = lp.CommOp(num_buffers=2, group=_group(world), axis="pp", impl=impl)
    for delta in (1, -1, 2):
        jop.send(jx, delta=delta)
        op.send(tx, delta=delta)
    for want_delta in (-1, 2):
        want = jop.recv()
        got = op.recv()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(
            _bits(got).reshape(world, -1),
            np.roll(_bits(tx).reshape(world, -1), want_delta, 0))
    with pytest.raises(IndexError):
        op.recv()


def _jax_stage(i, h):
    return h * 2 + (i + 1).astype(h.dtype)


def _port_stage(i, h):
    return h * 2 + (i + 1)


@pytest.mark.parametrize("world,impl", [(4, "xla"), (4, "pallas"),
                                        (8, "xla")])
def test_pipeline_forward_matches_jax(world, impl):
    """Stage i maps h to 2 h + i + 1 (one f32 rounding, the same on both
    sides), so the result shows the order in which a block met the
    stages."""
    jx, tx = _pair((world * 3, 8), "f32", seed=world)
    want = jlp.pipeline_forward(_jax_stage, jx, mesh=_mesh(world),
                                axis="pp", impl=impl)
    got = lp.pipeline_forward(_port_stage, tx, group=_group(world),
                              axis="pp", impl=impl)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    block0 = tx[:3]
    for i in range(world):                 # stages 0..W-1, in that order
        block0 = block0 * 2 + (i + 1)
    np.testing.assert_array_equal(_bits(got[:3]), _bits(block0))


@pytest.mark.parametrize("m", [1, 4, 11])
def test_pipeline_schedule_matches_jax(m):
    """GPipe schedule over W = 4 stages h -> h * s_i + b_i (s_i a power of
    two: exact in f32), equal to JAX's and to the stages applied in
    order."""
    world, rows, f = 4, 3, 16
    rng = np.random.RandomState(m)
    scale = (2.0 ** rng.randint(-2, 3, (world, f))).astype(np.float32)
    bias = rng.randn(world, f).astype(np.float32)
    mb = rng.randn(m, rows, f).astype(np.float32)
    mesh = _mesh(world)
    from jax.sharding import NamedSharding, PartitionSpec as P
    jparams = {"s": jax.device_put(jnp.asarray(scale),
                                   NamedSharding(mesh, P("pp"))),
               "b": jax.device_put(jnp.asarray(bias),
                                   NamedSharding(mesh, P("pp")))}
    want = jlp.pipeline_schedule(lambda p, h: h * p["s"] + p["b"], jparams,
                                 jnp.asarray(mb), mesh=mesh, axis="pp")
    params = {"s": torch.from_numpy(scale), "b": torch.from_numpy(bias)}
    got = lp.pipeline_schedule(lambda p, h: h * p["s"] + p["b"], params,
                               torch.from_numpy(mb), group=_group(world))
    assert got.shape == (m, rows, f)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ref = torch.from_numpy(mb)
    for s in range(world):
        ref = ref * params["s"][s] + params["b"][s]
    np.testing.assert_array_equal(_bits(got), _bits(ref))


TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            vocab_size=96, max_position_embeddings=64)


@pytest.mark.parametrize("mode", ["ag_rs", "xla"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_pipeline_forward_of_dense_llm_equals_its_forward(mode, impl):
    """A tiny 4-layer DenseLLM as a 2-stage pipeline (stage s runs layers
    2s, 2s + 1 through ``decoder_layer`` with fresh caches on every call):
    the final norm and LM head of rank 0's block after the ticks give
    ``forward``'s prefill logits bit for bit."""
    cfg = ModelConfig(dtype=torch.float32, **TINY)
    model = DenseLLM(cfg, device="cpu")
    params = model.init(seed=3)
    b, s, world = 2, 8, 2
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (b, s)))

    def caches(layers):
        return KVCacheManager(layers, b, s, cfg.num_key_value_heads,
                              cfg.head_dim, dtype=cfg.dtype,
                              device="cpu").init()

    want, _ = model.forward(params, ids, caches(cfg.num_hidden_layers), 0,
                            mode=mode)
    per = cfg.num_hidden_layers // world
    pos = torch.arange(s)[None].expand(b, s)

    def stage_fn(stage, h):
        kv = caches(per)
        for i, layer in enumerate(params["layers"][stage * per:
                                                   (stage + 1) * per]):
            h = model.decoder_layer(layer, h, pos, kv[i], 0, mode)
        return h

    x = params["embed"][ids].reshape(b * s, cfg.hidden_size)
    h = lp.pipeline_forward(stage_fn, torch.cat([x, torch.zeros_like(x)]),
                            group=_group(world), impl=impl)
    from triton_dist_tpu_torch.layers.common import rms_norm
    out = rms_norm(h[:b * s], params["final_norm"], cfg.rms_norm_eps)
    got = (out.float() @ params["lm_head_f32"].t()).reshape(want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_kv_stream_schedule_helpers_match_jax():
    for n in range(0, 7):
        for held in range(-2, 9):
            assert ks.needed_blocks(n, held) == jks.needed_blocks(n, held)
            assert ks.ship_schedule(n, held) == jks.ship_schedule(n, held)
    for length in range(0, 70):
        for page in (1, 7, 16):
            assert ks.block_span(length, page) == jks.block_span(length,
                                                                 page)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_block_matches_jax(dtype):
    layers, shape = 3, (4, 2, 8)
    jpages, tpages = [], []
    for i in range(layers):
        jk, tk = _pair(shape, dtype, seed=2 * i)
        jv, tv = _pair(shape, dtype, seed=2 * i + 1)
        jpages.append((np.asarray(jk), np.asarray(jv)))
        tpages.append((tk, tv))
    data = ks.pack_block(tpages)
    assert data == jks.pack_block(jpages)
    assert len(data) == layers * 2 * int(np.prod(shape)) * 4
    back = ks.unpack_block(data, layers, shape)
    jback = jks.unpack_block(data, layers, shape)
    for (k, v), (tk, tv), (jk, jv) in zip(back, tpages, jback):
        assert k.dtype == torch.float32 and tuple(k.shape) == shape
        assert torch.equal(k, tk.float()) and torch.equal(v, tv.float())
        np.testing.assert_array_equal(k.numpy(), jk)
        np.testing.assert_array_equal(v.numpy(), jv)
    for torn in (data[:-1], data + b"\0"):
        with pytest.raises(ValueError, match="kv block payload"):
            ks.unpack_block(torn, layers, shape)
        with pytest.raises(ValueError):
            jks.unpack_block(torn, layers, shape)


def _on_cuda(t):
    """A CPU tensor that reports the CUDA device."""
    class CudaView(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)
    return t.as_subclass(CudaView)


def test_value_errors():
    ctx = p2p.create_p2p_context(_group(4))
    for impl in ("pallas", "xla"):                 # rows that do not split
        with pytest.raises(ValueError, match="split"):
            p2p.pp_shift(torch.zeros(6, 3), ctx, impl=impl)
    with pytest.raises(ValueError, match="impl"):
        p2p.pp_shift(torch.zeros(8, 3), ctx, impl="ring")
    with pytest.raises(ValueError, match="split"):   # a torn payload
        ks.symm_ship(torch.zeros(4 * 37 + 1, dtype=torch.uint8),
                     _group(4, "tp"))
    with pytest.raises(ValueError, match="group"):   # CUDA without a group
        p2p.pp_shift(_on_cuda(torch.zeros(8, 3)),
                     p2p.create_p2p_context(world_size=4))
    with pytest.raises(ValueError, match="disagree"):
        p2p.create_p2p_context(_group(4), world_size=2)
    with pytest.raises(ValueError):
        lp.pipeline_forward(_port_stage, torch.zeros(6, 2), _group(4))
    with pytest.raises(ValueError):                  # JAX's shard_map too
        jp2p.pp_shift(jnp.zeros((6, 3)), jp2p.create_p2p_context(
            _mesh(4)), impl="xla")
