"""The tensor-core prefill tile of ``csrc/tiles.cuh``: the tile and wave
counts ``chip_smoke.py`` prints beside the prefill kernels' times
(``ops.allgather_gemm.tile_count``, ``tile_waves``) over Qwen3-8B's
prefill shapes at world 1 and per rank of the W = 4 rings, and what the
tile's source is built from."""

import pytest

from triton_dist_tpu_torch.ops import allgather_gemm as ag

QKV, GATE, HIDDEN = (4096, 1024, 1024), 12288, 4096


@pytest.mark.parametrize("op,rows,widths,chunks,tiles", [
    ("gemm", 512, QKV, 1, 192),                 # world-1 QKV: 4 x 48
    ("swiglu", 512, (GATE,), 1, 768),           # 4 x 192 of 64 columns
    ("gemm", 512, (HIDDEN,), 1, 128),           # o_proj and down
    ("gemm", 130, (40, 24, 8), 1, 6),           # ragged rows and widths
    ("gemm", 128, (1024, 256, 256), 4, 48),     # AG ring, a rank at W = 4
    ("swiglu", 128, (GATE // 4,), 4, 192),
    ("gemm", 64, (512, 128, 128), 8, 48),       # W = 8: half-tile chunks
    ("gemm", 128, (2048, 2048), 4, 128),        # GEMM-RS ring, split 2048
    ("gemm", 128, (0, HIDDEN), 4, 128),         # one direction
])
def test_tile_count(op, rows, widths, chunks, tiles):
    assert ag.tile_count(op, rows, widths, chunks) == tiles


@pytest.mark.parametrize("tiles,blocks,waves,idle", [
    (192, 132, 192 / 132, 72 / 132),            # QKV: 60 tiles in wave 2
    (128, 132, 128 / 132, 4 / 132),             # one partial wave
    (768, 132, 768 / 132, 24 / 132),
    (48, 33, 48 / 33, 18 / 33),                 # a rank of the W = 4 ring
    (6, 6, 1.0, 0.0),                           # grid = tiles < SMs
    (264, 132, 2.0, 0.0),
])
def test_tile_waves(tiles, blocks, waves, idle):
    got_waves, got_idle = ag.tile_waves(tiles, blocks)
    assert got_waves == pytest.approx(waves)
    assert got_idle == pytest.approx(idle)


@pytest.mark.parametrize("tiles", range(1, 300, 7))
def test_tile_waves_last_wave_is_the_remainder(tiles):
    waves, idle = ag.tile_waves(tiles, 33)
    full = -(-tiles // 33)
    assert full - 1 < waves <= full
    busy = round((1 - idle) * 33)
    assert 1 <= busy <= 33 and (full - 1) * 33 + busy == tiles


@pytest.mark.parametrize("tiles,blocks", [(0, 4), (4, 0)])
def test_tile_waves_refuses_empty(tiles, blocks):
    with pytest.raises(ValueError):
        ag.tile_waves(tiles, blocks)


def test_prefill_tile_is_wgmma_fed_by_tma_under_every_launcher():
    """``csrc/tiles.cuh``'s tensor-core tile: wgmma on operands that TMA
    brings under mbarriers, no mma.sync, ldmatrix or cp.async left in it;
    the world-1 kernel and both ring kernels run its two halves on TMA
    views passed as ``__grid_constant__`` parameters."""
    import re

    from triton_dist_tpu_torch.ops import _build
    tiles = re.sub(r"//[^\n]*", "",             # the code, not its notes
                   (_build.CSRC_DIR / "tiles.cuh").read_text())
    for needed in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait", "mbarrier.arrive.expect_tx",
                   "setmaxnreg", "cuTensorMapEncodeTiled",
                   "cudaGetDriverEntryPoint", "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert needed in tiles
    for gone in ("mma.sync", "ldmatrix", "cp.async.cg", "mma_tile",
                 "run_tile"):
        assert gone not in tiles
    for name in ("ag_gemm", "ag_gemm_ring", "gemm_rs_ring"):
        text = _build.SOURCES[name].read_text()
        assert "wg_load(" in text and "wg_mma<" in text
        assert "__grid_constant__" in text
        assert "cuTensorMapEncodeTiled" not in text   # views: tiles.cuh's


def test_grouped_body_is_wgmma_fed_by_tma_under_every_launcher():
    """``csrc/group_gemm.cuh``'s tensor-core body: tiles.cuh's wgmma
    consumers (``wg_mma`` over its own stage layout) on B brought by TMA
    and A gathered by the producer's cp.async into the stage ring, its
    ``full`` barrier armed by cp.async's own arrivals; no mma.sync body
    left. The world-1 kernels reach it through ``run_group_product``, the
    two rings run its producer and consumer halves in 384-thread blocks on
    a TMA view passed as a ``__grid_constant__`` parameter."""
    import re

    from triton_dist_tpu_torch.ops import _build
    body = re.sub(r"//[^\n]*", "",
                  (_build.CSRC_DIR / "group_gemm.cuh").read_text())
    assert '#include "tiles.cuh"' in body
    for needed in ("cp.async.mbarrier.arrive.noinc", "wg_mma<", "wg_init(",
                   "tma_load(", "make_view(", "wg_producer_regs",
                   "wg_consumer_regs", "gg_wg_load",
                   "gg_wg_mma", "gg_fma_tile", "kSharedA = true"):
        assert needed in body
    for gone in ("mma_bf16", "ldmatrix", "gg_mma_tile", "group_mma",
                 "gg_mma_smem", "launch_group_mma", "kTcThreads", "kTcBN"):
        assert gone not in body
    for name in ("group_gemm", "moe_rs"):
        assert "run_group_product<" in _build.SOURCES[name].read_text()
    for name in ("ag_group_gemm", "moe_rs_ring"):
        text = _build.SOURCES[name].read_text()
        assert "gg_wg_load<" in text and "gg_wg_mma<" in text
        assert "__grid_constant__ GgViews" in text and "kPfThreads" in text
        assert "cuTensorMapEncodeTiled" not in text   # views: tiles.cuh's


def test_decode_body_is_wgmma_fed_by_tma_under_every_launcher():
    """``csrc/stream.cuh``'s decode body: wgmma with the weight tile as the
    64-row side (the A operand's transpose bit) and the tokens as N = 8 to
    64, B and A brought by TMA under mbarriers, the K splits of a column
    tile one cluster summed through distributed shared memory; the
    ``mma.sync`` body and its per-call workspace are gone. gemm_ar and
    ag_gemm launch it, both rings run its item on TMA views passed as a
    ``__grid_constant__`` parameter, and the wrappers allocate no
    workspace for it."""
    import inspect
    import re

    from triton_dist_tpu_torch.ops import _build
    from triton_dist_tpu_torch.ops import allgather_gemm as ag
    from triton_dist_tpu_torch.ops import gemm_reduce_scatter as rs
    body = re.sub(r"//[^\n]*", "",
                  (_build.CSRC_DIR / "stream.cuh").read_text())
    assert '#include "tiles.cuh"' in body
    for needed in ("wgmma.mma_async", "m64n8k16", "m64n64k16",
                   "p, 1, 1, 1, 0", "tma_load(", "mbar_expect(",
                   "mbar_wait(", "cudaLaunchKernelEx",
                   "cudaLaunchAttributeClusterDimension",
                   "mapa.shared::cluster", "ld.shared::cluster",
                   "barrier.cluster.arrive.release", "stream_item",
                   "griddepcontrol.wait",
                   "cudaLaunchAttributeProgrammaticStreamSerialization"):
        assert needed in body
    for gone in ("mma.sync", "ldmatrix", "cp.async.cg", "atomicAdd"):
        assert gone not in body
    common = (_build.CSRC_DIR / "gemm_common.cuh").read_text()
    for gone in ("stream_mma_block", "stream_mma<", "kTcStages",
                 "stream_smem_bytes"):
        assert gone not in common
    for name in ("gemm_ar", "ag_gemm"):
        assert "run_stream(" in _build.SOURCES[name].read_text()
    for name in ("ag_gemm_ring", "gemm_rs_ring"):
        text = _build.SOURCES[name].read_text()
        assert "stream_item<" in text and "__grid_constant__ TileViews" in text
    assert "torch.empty" not in inspect.getsource(ag.launch_gemm).split(
        "outs = ")[1].split("\n", 1)[1]
    assert "p.workspace" in inspect.getsource(rs._launch_gemm_ar)
