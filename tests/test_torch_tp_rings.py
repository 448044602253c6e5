"""The port's ring plans and plain ring versions (GEMM-RS / GEMM-AR,
AG-GEMM, AG-SwiGLU at world W > 1) against the JAX package's, on the CPU.

* ``ring_hop_counts`` / ``ring_chunk_schedule`` equal JAX's over worlds
  1..8 and dirs 1, 2, for every rank and position.
* ``ring_plan`` (variant, effective directions, split column) equals
  JAX's decision, read off a shape-only ``jax.eval_shape`` trace of
  ``gemm_rs`` / ``gemm_ar`` with spies on the overlap record that
  ``_entry`` emits for the variant it runs; no kernel runs. The sweep has
  Qwen3-8B's o_proj and down shapes at W = 2, 4, 8.
* The plain ring versions against JAX's ``impl="pallas"`` on W devices of
  the 8-device CPU mesh (Pallas interpret mode) at W = 2, 3, 4 and dirs
  1, 2, with N % 256 == 0 so that dirs 2 engages; small vmem budgets
  steer both sides to the "hbm" and "hbm_kt" variants. The port runs its
  entry points on CPU tensors over a ``RankGroup``, which take the plain
  ring versions.

Tolerances: f32 within 1e-5 (atol and rtol; the two sides sum each
partial in another order). bf16: the AG side rounds once per element, so
within one bf16 ulp of the larger value; the RS side rounds each rank's
partial and each running sum, and a partial that sums to a rounding
boundary in f32 may round apart on the two sides and carry its ulp down
the ring, so within W ulps of the sum of the partials' magnitudes
(2^-7 * W * sum_r |p_r| per element)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.ops import allgather_gemm as jag
from triton_dist_tpu.ops import common as jcommon
from triton_dist_tpu.ops import gemm_reduce_scatter as jrs
from triton_dist_tpu.tools import perf_model
from triton_dist_tpu_torch.ops import allgather_gemm as ag
from triton_dist_tpu_torch.ops import common
from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs
from triton_dist_tpu_torch.runtime.dist import create_rank_group

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULP_REL = 2.0 ** -7


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("tp",))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _put(mesh, a, spec, dtype):
    return jax.device_put(jnp.asarray(a, dtype), NamedSharding(mesh, spec))


# -- the schedule helpers ------------------------------------------------------------
@pytest.mark.parametrize("dirs", [1, 2])
def test_ring_schedule_matches_jax(dirs):
    for world in range(1, 9):
        assert common.ring_hop_counts(world, dirs) == \
            jcommon.ring_hop_counts(world, dirs)
        for me in range(world):
            seen = []
            for s in range(world):
                chunk, is_bwd, off = jcommon.ring_chunk_schedule(
                    me, s, world, dirs)
                got = common.ring_chunk_schedule(me, s, world, dirs)
                assert got == (int(chunk), bool(is_bwd), int(off))
                seen.append(got[0])
            assert sorted(seen) == list(range(world))    # every chunk once


def test_ring_dirs_is_checked():
    group = create_rank_group(2, device="cpu")
    for bad in (0, 3):
        with pytest.raises(ValueError, match="ring_dirs"):
            rs.GEMMReduceScatterContext(group, ring_dirs=bad)
        with pytest.raises(ValueError, match="ring_dirs"):
            ag.AllGatherGEMMContext(group, ring_dirs=bad)


# -- the GEMM-RS plan ------------------------------------------------------------------
def _jax_plan(monkeypatch, world, m, k, n, dtype, ag_epilogue, ring_dirs,
              budget):
    """JAX's (variant, dirs, split) for one call, from a shape-only trace."""
    seen = {}

    def cost(cfg, **kw):
        seen["cfg"] = dict(cfg)
        return None

    def overlap(op, c, world=None, dirs=None):
        seen["dirs"] = dirs

    monkeypatch.setattr(perf_model, "estimate_gemm_rs_cost", cost)
    monkeypatch.setattr(jrs, "record_overlap", overlap)
    ctx = dataclasses.replace(jrs.create_gemm_rs_context(_mesh(world), "tp"),
                              ring_dirs=ring_dirs, vmem_budget=budget)
    fn = jrs.gemm_ar if ag_epilogue else jrs.gemm_rs
    jax.eval_shape(lambda a, b: fn(a, b, ctx, impl="pallas"),
                   jax.ShapeDtypeStruct((m, k), dtype),
                   jax.ShapeDtypeStruct((k, n), dtype))
    if "cfg" not in seen:
        return rs.RingPlan("xla", 1, n)
    cfg, dirs = seen["cfg"], seen["dirs"]
    if dirs == 1:
        return rs.RingPlan(cfg["variant"], 1, n)
    if cfg["variant"] == "hbm":
        n_blk = cfg["block_n"]
        return rs.RingPlan("hbm", 2, (n // n_blk // 2) * n_blk)
    return rs.RingPlan(cfg["variant"], 2, n // 2)


QWEN3_8B = [(m, k, 4096) for m in (4, 512) for k in (4096, 12288)]
BUDGET = jcommon.DEFAULT_VMEM_BUDGET
SWEEP = ([(w, m, k, n, "bfloat16", BUDGET) for w in (2, 4, 8)
          for (m, k, n) in QWEN3_8B]
         + [(4, m, k, n, d, b) for (m, k, n) in ((16, 128, 512),
                                                 (16, 128, 1024),
                                                 (32, 512, 384),
                                                 (8, 64, 96))
            for d in ("float32", "bfloat16")
            for b in (BUDGET, 150_000, 40_000, 2_000)])


@pytest.mark.parametrize("world,m,k,n,dtype,budget", SWEEP)
def test_ring_plan_is_the_jax_decision(monkeypatch, world, m, k, n, dtype,
                                       budget):
    itemsize = 4 if dtype == "float32" else 2
    for ag_epilogue in (False, True):
        for ring_dirs in (1, 2):
            if m % world and not ag_epilogue:
                continue
            want = _jax_plan(monkeypatch, world, m, k, n,
                             getattr(jnp, dtype), ag_epilogue, ring_dirs,
                             budget)
            padded = m + (-m % world)
            got = rs.ring_plan(padded, k // world, n, itemsize, world,
                               ring_dirs, ag_epilogue, budget)
            assert got == want, (ag_epilogue, ring_dirs)


def test_ring_plan_at_qwen3_8b_w4():
    # Decode (batch 4, gemm_ar): o_proj fits the vmem kernel, the down
    # projection does not; prefill (4 x 128 tokens): the N-blocked kernel.
    # Every call splits the columns at 2048; none falls back to the psum.
    assert rs.ring_plan(4, 1024, 4096, 2, 4, 2, True) == \
        rs.RingPlan("vmem", 2, 2048)
    assert rs.ring_plan(4, 3072, 4096, 2, 4, 2, True) == \
        rs.RingPlan("hbm", 2, 2048)
    for k_loc in (1024, 3072):
        assert rs.ring_plan(512, k_loc, 4096, 2, 4, 2, False) == \
            rs.RingPlan("hbm", 2, 2048)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world", [2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 4, 5, 63, 64, 65, 512])
def test_ring_path_streams_calls_of_at_most_64_padded_rows(dtype, world, m):
    """The ring kernel's decode body ("stream") exactly when the padded M
    (gemm_ar pads M to a multiple of W) is at most DECODE_MAX_M = 64, the
    world-1 plans' rule, in every dtype and at any K per rank and N; above
    it the tile, tensor cores ("mma") for bf16 with K per rank, N and the
    split multiples of 8, else "fma". It depends on dtype and shape only."""
    assert rs.DECODE_MAX_M == 64
    padded = m + (-m % world)
    for k_loc, n in ((1024, 4096), (3072, 4096), (1001, 40)):
        split = rs.ring_plan(padded, k_loc, n, dtype.itemsize, world, 2,
                             True).split
        tile = ("mma" if dtype == torch.bfloat16 and k_loc % 8 == 0
                and n % 8 == 0 and split % 8 == 0 else "fma")
        want = "stream" if padded <= 64 else tile
        assert rs.ring_path(dtype, padded, k_loc, n, split) == want


@pytest.mark.parametrize("op", ["gemm", "swiglu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world", range(2, 9))
def test_ag_ring_path_streams_where_the_world1_decode_plan_runs(world, dtype,
                                                               op):
    """The AG ring kernel's decode body ("stream") exactly where the
    world-1 kernel's plan on one rank's shard (csrc/ag_plan.cuh make_plan)
    is its decode plan: op "gemm", bf16, K and every shard width multiples
    of 8, M <= 64; elsewhere the tile, "mma" for bf16 with K and the shard
    widths multiples of 8, else "fma". Shape and dtype only. The rule
    stated here is make_plan's; on the card,
    test_ag_ring_path_is_the_world1_plan_of_a_shard holds ring_path to
    make_plan itself over these shapes."""
    assert ag.DECODE_MAX_M == rs.DECODE_MAX_M == 64
    for m in sorted({world, 4 * world, 64 - 64 % world, 64 + world,
                     512 - 512 % world}):
        for k, widths in ((4096, (4096, 1024, 1024)), (4096, (12288, 12288)),
                          (72, (24, 48)), (100, (64,)), (2048, (4096, 512))):
            shards = tuple(n // world for n in widths)
            tc = (dtype == torch.bfloat16 and k % 8 == 0
                  and all(n % 8 == 0 for n in shards))
            decode = tc and op == "gemm" and m <= 64
            want = "stream" if decode else "mma" if tc else "fma"
            assert ag.ring_path(dtype, m, k, shards, op) == want


def _ag_stream_items(world, dirs, bpr, pieces, tiles, splits):
    """A mirror of ``ag_stream_ring_kernel``'s items (csrc/ag_gemm_ring.cu):
    per (rank, block), the list of (position, waits, releases), signals
    named ("chunk", rank, chunk, piece) and ("prod", rank, item). Phase 0
    the own chunk's pieces, phase 1 the ring (hop, direction, piece),
    phase 2 the products (column tile, split), each waiting for every
    chunk, phase 3 (more than one split) the reduce of each column tile;
    each phase dealt round robin, phases 0 and 1 from block 0, phases 2
    and 3 from block ``me * bpr // world``."""
    n_fwd, n_bwd = common.ring_hop_counts(world, dirs)
    hops = max(n_fwd, n_bwd)
    blocks = {}
    for me in range(world):
        every_chunk = [("chunk", me, c, p) for c in range(world)
                       for p in range(pieces)]
        for j in range(bpr):
            items = []
            for p in range(j, pieces, bpr):
                items.append(((0, p), [], [("chunk", me, me, p)]))
            for i in range(j, hops * 2 * pieces, bpr):
                hop, d, p = i // (2 * pieces), (i // pieces) % 2, i % pieces
                if hop >= (n_fwd if d == 0 else n_bwd):
                    continue
                c = (me - hop if d == 0 else me + hop) % world
                peer = (me + 1 if d == 0 else me - 1) % world
                items.append(((1, i), [("chunk", me, c, p)],
                              [("chunk", peer, c, p)]))
            first = (j + bpr - me * bpr // world) % bpr
            for i in range(first, tiles * splits, bpr):
                items.append(((2, i), every_chunk,
                              [("prod", me, i)] if splits > 1 else []))
            if splits > 1:
                for t in range(first, tiles, bpr):
                    items.append(((3, t), [("prod", me, t * splits + z)
                                           for z in range(splits)], []))
            blocks[me, j] = items
    return blocks


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("world", range(2, 9))
def test_ag_stream_ring_item_order_cannot_deadlock(world, dirs):
    """Every wait of the decode body's items has one producer, which comes
    earlier in every block's order (an earlier phase, or an earlier item
    of the same phase), and all blocks resident together run every item
    to its end, with as few as one block a rank."""
    for bpr, pieces, tiles, splits in ((1, 1, 3, 1), (1, 2, 3, 4),
                                       (2, 1, 24, 8), (3, 3, 5, 2),
                                       (7, 1, 96, 2), (132, 1, 24, 8)):
        blocks = _ag_stream_items(world, dirs, bpr, pieces, tiles, splits)
        for me in range(world):               # every item dealt once
            dealt = sorted(pos for j in range(bpr)
                           for pos, _, _ in blocks[me, j])
            assert dealt == sorted(
                [(0, p) for p in range(pieces)]
                + [(1, i) for i in range(max(common.ring_hop_counts(
                    world, dirs)) * 2 * pieces)
                   if i // (2 * pieces) < common.ring_hop_counts(
                       world, dirs)[(i // pieces) % 2]]
                + [(2, i) for i in range(tiles * splits)]
                + ([(3, t) for t in range(tiles)] if splits > 1 else []))
        producer = {}
        for items in blocks.values():
            for pos, _, releases in items:
                for sig in releases:
                    assert sig not in producer           # one writer each
                    producer[sig] = pos
        for items in blocks.values():
            for pos, waits, _ in items:
                for sig in waits:
                    assert producer[sig] < pos
        done, cursor = set(), dict.fromkeys(blocks, 0)
        moved = True
        while moved:
            moved = False
            for key, items in blocks.items():
                while cursor[key] < len(items):
                    _, waits, releases = items[cursor[key]]
                    if not all(w in done for w in waits):
                        break
                    done.update(releases)
                    cursor[key] += 1
                    moved = True
        assert all(cursor[key] == len(items) for key, items in blocks.items())
        assert len(done) == len(producer)


# -- GEMM-RS / GEMM-AR ---------------------------------------------------------------
def _rs_operands(m, k, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, n) / np.sqrt(k)).astype(np.float32))


def _assert_rs_bf16_close(got, want, a, b, world):
    """Within W bf16 ulps of the sum of the partials' magnitudes."""
    parts = np.abs(rs._ring_partials(a.float(), b.float(), world).numpy())
    lim = world * BF16_ULP_REL * parts.sum(0)[:got.shape[0]] + 1e-12
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= lim).all(), diff.max()


RS_CASES = ([(w, d, "float32", BUDGET) for w in (2, 3, 4) for d in (1, 2)]
            + [(4, d, "bfloat16", BUDGET) for d in (1, 2)]
            + [(4, 2, "float32", 150_000), (4, 2, "float32", 2_000)])


@pytest.mark.parametrize("world,dirs,dtype,budget", RS_CASES)
@pytest.mark.parametrize("op", ["gemm_rs", "gemm_ar"])
def test_gemm_rs_ar_ring_reference_matches_jax(world, dirs, dtype, budget,
                                               op):
    m = 4 * world - (1 if op == "gemm_ar" else 0)   # gemm_ar pads M
    a, b = _rs_operands(m, 32 * world, 1024, seed=world * 10 + dirs)
    mesh = _mesh(world)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jctx = dataclasses.replace(jrs.create_gemm_rs_context(mesh, "tp"),
                               ring_dirs=dirs, vmem_budget=budget)
    jfn = jrs.gemm_ar if op == "gemm_ar" else jrs.gemm_rs
    want = _np(jfn(_put(mesh, a, P(None, "tp"), jdt),
                   _put(mesh, b, P("tp"), jdt), jctx, impl="pallas"))
    group = create_rank_group(world, device="cpu")
    ctx = rs.GEMMReduceScatterContext(group, ring_dirs=dirs,
                                      vmem_budget=budget)
    before = rs.rs_ring_launches.total + rs.ar_ring_launches.total
    got = getattr(rs, op)(_t(a, tdt), _t(b, tdt), group, ctx=ctx)
    assert rs.rs_ring_launches.total + rs.ar_ring_launches.total == before
    assert got.shape == (m, 1024) and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        _assert_rs_bf16_close(got, want, _t(a, tdt), _t(b, tdt), world)
    # The plan's split is what the reference ran.
    plan = rs.ring_plan(m + (-m % world), 32, 1024, got.element_size(),
                        world, dirs, op == "gemm_ar", budget)
    if plan.variant != "xla":
        ref = rs.gemm_ar_ring_reference if op == "gemm_ar" else \
            rs.gemm_rs_ring_reference
        assert torch.equal(got, ref(_t(a, tdt), _t(b, tdt), world,
                                    plan.split))


def test_ring_order_is_not_the_psum_order():
    """The ring's roundings differ from a psum's: the reference is the
    yardstick, not RankGroup.psum."""
    a, b = _rs_operands(16, 128, 512, seed=5)
    group = create_rank_group(4, device="cpu")
    ta, tb = _t(a, torch.bfloat16), _t(b, torch.bfloat16)
    ring = rs.gemm_rs(ta, tb, group)
    psum = rs.gemm_rs(ta, tb, group, impl="xla")
    assert not torch.equal(ring, psum)
    # Both directions sum in their own order: dirs 1 and 2 differ too.
    assert not torch.equal(rs.gemm_rs_ring_reference(ta, tb, 4, 512),
                           rs.gemm_rs_ring_reference(ta, tb, 4, 256))


def test_gemm_ar_falls_back_to_the_psum_where_jax_does():
    a, b = _rs_operands(8, 128, 512, seed=6)
    group = create_rank_group(4, device="cpu")
    ctx = rs.GEMMReduceScatterContext(group, vmem_budget=2_000)
    assert rs.ring_plan(8, 32, 512, 4, 4, 2, True, 2_000).variant == "xla"
    got = rs.gemm_ar(_t(a), _t(b), group, ctx=ctx)
    assert torch.equal(got, rs.gemm_ar(_t(a), _t(b), group, impl="xla"))


def test_ring_shapes_are_checked():
    group = create_rank_group(4, device="cpu")
    t = torch.zeros
    with pytest.raises(ValueError, match="rows do not split"):
        rs.gemm_rs(t(6, 8), t(8, 4), group)
    with pytest.raises(ValueError, match="does not split"):
        rs.gemm_ar(t(4, 6), t(6, 4), group)
    with pytest.raises(ValueError, match="rows do not split"):
        ag.ag_gemm_multi(t(6, 8), [t(8, 4)], group)
    with pytest.raises(ValueError, match="do not split"):
        ag.ag_gemm_multi(t(8, 8), [t(8, 6)], group)
    with pytest.raises(ValueError, match="unknown"):
        rs.gemm_rs(t(8, 8), t(8, 4), group, impl="ring")


# -- AG-GEMM / AG-SwiGLU -----------------------------------------------------------------
def _ag_operands(m, k, widths, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(m, k).astype(np.float32)
    return a, [(rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
               for n in widths]


def _assert_bf16_close(got, want, atol=1e-12):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    lim = BF16_ULP_REL * np.maximum(np.abs(got), np.abs(want)) + atol
    assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


AG_CASES = ([(w, d, "float32") for w in (2, 3, 4) for d in (1, 2)]
            + [(4, 2, "bfloat16")])


@pytest.mark.parametrize("world,dirs,dtype", AG_CASES)
def test_ag_gemm_multi_ring_reference_matches_jax(world, dirs, dtype):
    _check_ag_ring_reference(world, dirs, dtype, rows=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dirs", [1, 2])
def test_ag_gemm_multi_ring_reference_matches_jax_one_row_per_rank(dirs,
                                                                   dtype):
    """The decode shape: one row per rank at W = 4 (M = 4, the fused
    engine's decode at batch 4), which JAX's Pallas ring accepts."""
    _check_ag_ring_reference(4, dirs, dtype, rows=1)


def _check_ag_ring_reference(world, dirs, dtype, rows):
    """ag_gemm_multi over a world-W CPU group (the plain ring version)
    against JAX's impl "pallas" in interpret mode on W devices: rows per
    rank, one to three products of shard widths 64, 128, 192, K = 64."""
    n_b = {2: 1, 3: 2, 4: 3}[world]
    widths = tuple(64 * world * (i + 1) for i in range(n_b))
    a, bs = _ag_operands(rows * world, 64, widths, seed=world + dirs)
    mesh = _mesh(world)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jctx = dataclasses.replace(jag.create_ag_gemm_context(mesh, "tp"),
                               ring_dirs=dirs)
    want = jag.ag_gemm_multi(_put(mesh, a, P("tp"), jdt),
                             [_put(mesh, b, P(None, "tp"), jdt) for b in bs],
                             jctx, impl="pallas")
    group = create_rank_group(world, device="cpu")
    ctx = ag.AllGatherGEMMContext(group, ring_dirs=dirs)
    before = ag.ag_ring_launches.total
    got = ag.ag_gemm_multi(_t(a, tdt), [_t(b, tdt) for b in bs], group,
                           ctx=ctx)
    assert ag.ag_ring_launches.total == before
    ref = ag.ag_gemm_multi_reference(_t(a, tdt), [_t(b, tdt) for b in bs])
    for g, w, r in zip(got, want, ref):
        if rows > 1:
            assert torch.equal(g, r)      # the ring order changes nothing
        elif dtype == "float32":
            # One-row chunks take the CPU's matrix-vector product, which
            # sums in another order than the gathered matrix product.
            np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)
        else:
            _assert_bf16_close(g, r.float().numpy())
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
        else:
            _assert_bf16_close(g, _np(w))


@pytest.mark.parametrize("world,dirs,rows,bias,dtype", [
    (2, 1, 128, False, "float32"), (2, 2, 128, True, "float32"),
    (3, 1, 128, True, "float32"), (3, 2, 128, False, "float32"),
    (4, 1, 128, True, "float32"), (4, 2, 128, False, "float32"),
    (4, 2, 8, True, "float32"), (2, 2, 128, False, "bfloat16"),
    (4, 2, 128, True, "bfloat16"), (4, 1, 8, False, "bfloat16")])
def test_ag_swiglu_ring_reference_matches_jax(world, dirs, rows, bias,
                                              dtype):
    k, n = 64, 128 * world
    a, (wg, wu) = _ag_operands(rows * world, k, (n, n), seed=world + rows)
    rng = np.random.RandomState(9)
    bg, bu = (rng.randn(n).astype(np.float32) for _ in range(2))
    mesh = _mesh(world)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jctx = dataclasses.replace(jag.create_ag_gemm_context(mesh, "tp"),
                               ring_dirs=dirs)
    jb = (dict(b_gate=_put(mesh, bg, P("tp"), jdt),
               b_up=_put(mesh, bu, P("tp"), jdt)) if bias else {})
    want = jag.ag_swiglu(_put(mesh, a, P("tp"), jdt),
                         _put(mesh, wg, P(None, "tp"), jdt),
                         _put(mesh, wu, P(None, "tp"), jdt), jctx,
                         impl="pallas", **jb)
    group = create_rank_group(world, device="cpu")
    tb = (_t(bg, tdt), _t(bu, tdt)) if bias else ()
    got = ag.ag_swiglu(_t(a, tdt), _t(wg, tdt), _t(wu, tdt), *tb,
                       group=group,
                       ctx=ag.AllGatherGEMMContext(group, ring_dirs=dirs))
    assert got.shape == (rows * world, n) and got.dtype == tdt
    fuses = ag.swiglu_fuses(rows, k, n // world, got.element_size())
    assert fuses == (rows == 128)
    if fuses:
        assert torch.equal(got, ag.ag_swiglu_ring_reference(
            _t(a, tdt), _t(wg, tdt), _t(wu, tdt), *tb, world=world,
            dirs=dirs))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    else:
        _assert_bf16_close(got, _np(want), atol=1e-6)


def test_world_xla_bodies_of_ag_swiglu_match_jax():
    world, k, n = 4, 64, 512
    a, (wg, wu) = _ag_operands(8 * world, k, (n, n), seed=2)
    mesh = _mesh(world)
    want = jag.ag_swiglu(_put(mesh, a, P("tp"), jnp.float32),
                         _put(mesh, wg, P(None, "tp"), jnp.float32),
                         _put(mesh, wu, P(None, "tp"), jnp.float32),
                         jag.create_ag_gemm_context(mesh, "tp"), impl="xla")
    group = create_rank_group(world, device="cpu")
    got = ag.ag_swiglu(_t(a), _t(wg), _t(wu), group=group, impl="xla")
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
