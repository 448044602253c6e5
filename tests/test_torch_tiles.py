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
