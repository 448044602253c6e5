"""The flash-prefill kernel's tiles and deals (``csrc/sp_attention.cu``,
bf16 path): Python mirrors of the q tile of 128 folded rows, of the world-1
persistent deal (longest first) and of the ring kernel's item deal at world
W, with a run of all blocks resident that must reach its end; and what the
source is built from (wgmma on K/V tiles that TMA brings under mbarriers)."""

import re

import pytest

from triton_dist_tpu_torch.ops import _build
from triton_dist_tpu_torch.ops import sp_attention as sp

ROWS = 128                       # kWgRows: folded rows of a q tile


def q_tile(g):
    """(positions, heads, head groups) of a q tile at G query heads per KV
    head (``make_params``): whole positions of all G heads, or for G > 128
    one position of 128 heads a group."""
    qh = min(g, ROWS)
    return ROWS // qh, qh, -(-g // qh)


def kv_tiles(p0, qp, s_loc, diag):
    """``wg_kv_tiles``: KV tiles of a chunk that the tile at position p0
    reads, up to its last query on the causal diagonal."""
    end = min(s_loc, p0 + qp) if diag else s_loc
    return -(-end // sp.KV_TILE)


def wg_item(it, world, b, hkv, g, s_loc):
    """``wg_item``: (rank, b, h, first head, first position) of item it."""
    qp, qh, n_hg = q_tile(g)
    n_pt = -(-s_loc // qp)
    per_rank = b * hkv * n_pt * n_hg
    me = world - 1 - it // per_rank
    rem = it % per_rank
    bh, rem = rem % (b * hkv), rem // (b * hkv)
    return (me, bh // hkv, bh % hkv, rem % n_hg * qh,
            (n_pt - 1 - rem // n_hg) * qp)


def snake(c, grid):
    """``snake``: the item of turn c, rounds of ``grid`` reversed when
    odd."""
    rd = c // grid
    return rd * grid + grid - 1 - c % grid if rd % 2 else c


def block_items(first, grid, items):
    """The items a block takes from turn ``first`` on (``sp_produce`` and
    ``sp_consume``'s loop): turns up to the last whole round, those past
    the items skipped."""
    end = -(-items // grid) * grid
    return [snake(c, grid) for c in range(first, end, grid)
            if snake(c, grid) < items]


def item_tiles(item, world, s_loc, qp, causal):
    """KV tiles of an item over the chunks it consumes (``ring_steps``)."""
    me = item[0]
    steps = me + 1 if causal else world
    return kv_tiles(item[4], qp, s_loc, causal) + (steps - 1) * kv_tiles(
        item[4], qp, s_loc, False)


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 200])
def test_q_tile_holds_whole_positions_of_one_kv_head(g):
    qp, qh, n_hg = q_tile(g)
    assert qp * qh <= ROWS and qh * n_hg >= g
    if g <= ROWS:
        assert (qp, qh, n_hg) == (ROWS // g, g, 1)
        assert ROWS - qp * g < g                # dead rows: fewer than G
    else:
        assert (qp, n_hg) == (1, 2)


@pytest.mark.parametrize("g,s,b,hkv", [(1, 300, 1, 2), (2, 257, 2, 1),
                                       (3, 1000, 1, 8), (4, 4097, 1, 8),
                                       (8, 129, 4, 4), (200, 7, 1, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_world1_deal_covers_every_row_once_longest_first(g, s, b, hkv,
                                                         causal):
    qp, qh, n_hg = q_tile(g)
    n = b * hkv * -(-s // qp) * n_hg
    items = [wg_item(it, 1, b, hkv, g, s) for it in range(n)]
    rows = [(bb, h, h * g + g0 + r % qh, p0 + r // qh)
            for _, bb, h, g0, p0 in items for r in range(qp * qh)
            if p0 + r // qh < s and g0 + r % qh < g]
    assert len(rows) == len(set(rows)) == b * s * hkv * g
    tiles = [item_tiles(i, 1, s, qp, causal) for i in items]
    assert tiles == sorted(tiles, reverse=True)
    for grid in (1, 5, 132):                    # a static deal of blocks
        dealt = [block_items(j, grid, n) for j in range(min(grid, n))]
        assert sorted(i for d in dealt for i in d) == list(range(n))
        # Each round gives every block one item, longest first.
        for d in dealt:
            assert [i // grid for i in d] == list(range(len(d)))


@pytest.mark.parametrize("world", [1, 4])
def test_snake_deal_evens_the_blocks_loads(world):
    """At Qwen3-8B's 32k prefill (G = 4, 8 KV heads) on 132 blocks, the
    snake leaves the busiest block within 0.1 % of the mean KV tiles a
    block, where dealing every round in block order loads it 1.6 % above
    the mean, at world 1 and at W = 4 alike."""
    grid, hkv, g, s = 132, 8, 4, 32768
    s_loc = s // world
    qp = q_tile(g)[0]
    n = world * hkv * s_loc // qp
    tiles = [item_tiles(wg_item(it, world, 1, hkv, g, s_loc), world, s_loc,
                        qp, True) for it in range(n)]
    mean = sum(tiles) / grid
    snaked = max(sum(tiles[i] for i in block_items(j, grid, n))
                 for j in range(grid))
    in_order = max(sum(tiles[j::grid]) for j in range(grid))
    assert snaked < 1.001 * mean and in_order > 1.01 * mean


def ring_blocks(world, b, hkv, g, s_loc, causal, grid):
    """Each block's items in its order, as (index, waits, releases) of
    signals (rank, slot, row, piece): phase 0 and 1 copies (``ring_copy
    _item``), then the compute items, each waiting for the pieces of every
    KV tile it reads (``sp_produce``)."""
    n_pieces = -(-s_loc // sp.RING_PIECE)
    per_tile = sp.KV_TILE // sp.RING_PIECE
    qp, _, n_hg = q_tile(g)
    items = []
    for step in range(world):
        for me in range(world):
            for bb in range(b):
                for pc in range(n_pieces):
                    if step == 0:
                        items.append(((), ((me, me, bb, pc),)))
                    else:
                        cur = (me - step + 1) % world
                        items.append((((me, cur, bb, pc),),
                                      (((me + 1) % world, cur, bb, pc),)))
    n = world * b * hkv * -(-s_loc // qp) * n_hg
    compute = []
    for it in range(n):
        item = wg_item(it, world, b, hkv, g, s_loc)
        me, bb = item[0], item[1]
        waits = set()
        for s in range(me + 1 if causal else world):
            for j in range(kv_tiles(item[4], qp, s_loc, causal and s == 0)):
                waits.update(((me, (me - s) % world, bb, pc) for pc in range(
                    j * per_tile, min((j + 1) * per_tile, n_pieces))))
        compute.append((tuple(waits), ()))
    copies = len(items)
    blocks = {}
    for j in range(grid):
        mine = [(i, *items[i]) for i in range(j, copies, grid)]
        first = (j - copies) % grid           # the block's first turn
        mine += [(copies + i, *compute[i])
                 for i in block_items(first, grid, n)]
        if mine:
            blocks[j] = mine
    return blocks


@pytest.mark.parametrize("world", [2, 3, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_item_order_cannot_deadlock(world, causal):
    """Every item dealt once; every wait's producer comes earlier in every
    block's order; all blocks resident together run every item to its end,
    with as few as one block."""
    for b, hkv, g, s_loc, grid in ((1, 2, 4, 96, 1), (2, 1, 3, 200, 3),
                                   (1, 8, 4, 1024, 132), (1, 1, 8, 64, 7)):
        blocks = ring_blocks(world, b, hkv, g, s_loc, causal, grid)
        dealt = sorted(pos for items in blocks.values()
                       for pos, _, _ in items)
        assert dealt == list(range(len(dealt)))
        n_copies = world * world * b * -(-s_loc // sp.RING_PIECE)
        for items in blocks.values():           # copies before compute
            kinds = [pos >= n_copies for pos, _, _ in items]
            assert kinds == sorted(kinds)
        producer = {}
        for items in blocks.values():
            for pos, _, releases in items:
                for sig in releases:
                    assert sig not in producer           # one writer each
                    producer[sig] = pos
        for items in blocks.values():
            for pos, waits, _ in items:
                for sig in waits:                # a copy, dealt earlier
                    assert producer[sig] < min(pos, n_copies)
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


def test_ring_compute_items_wait_only_for_their_own_rank():
    """A compute item reads its rank's own workspace: each of its waits is
    on a signal of that rank, and every chunk it consumes is JAX's order
    (``ring_chunks``)."""
    world, s_loc = 4, 300
    blocks = ring_blocks(world, 1, 1, 4, s_loc, True, 1)
    copies = world * world * -(-s_loc // sp.RING_PIECE)
    assert [pos for pos, _, _ in blocks[0]] == list(range(len(blocks[0])))
    for pos, waits, _ in blocks[0][copies:]:
        me = wg_item(pos - copies, world, 1, 1, 4, s_loc)[0]
        assert {w[0] for w in waits} == {me}
        assert {w[1] for w in waits} == set(sp.ring_chunks(me, world, True))


def test_flash_prefill_source_is_wgmma_on_tiles_brought_by_tma():
    """The bf16 body: wgmma (S = Q K^T from shared memory, O += P V with P
    in registers) on K/V tiles that TMA brings under mbarriers, no
    mma.sync or ldmatrix left; the ring's compute path acquires the piece
    signals and then orders them before its TMA reads
    (fence.proxy.async); the views are tiles.cuh's."""
    code = re.sub(r"//[^\n]*", "",              # the code, not its notes
                  _build.SOURCES["sp_attention"].read_text())
    tiles = (_build.CSRC_DIR / "tiles.cuh").read_text()
    assert '#include "tiles.cuh"' in code
    for needed in ("wgmma.mma_async", "wgmma_m64n128k16<0>", "wgmma_pv(",
                   "tma_load5(", "tma_load(", "mbar_wait(", "mbar_expect(",
                   "mbar_arrive(", "make_box_view<", "__grid_constant__",
                   "fence_proxy_async()", "tdt_signal_acquire",
                   "cudaLaunchCooperativeKernel"):
        assert needed in code, needed
    for gone in ("mma.sync", "ldmatrix", "mma_bf16", "cuTensorMapEncodeTiled"):
        assert gone not in code, gone
    for ptx in ("cp.async.bulk.tensor.4d", "cp.async.bulk.tensor.5d",
                "fence.proxy.async", "mbarrier.try_wait"):
        assert ptx in tiles
    produce = code[code.index("void sp_produce("):code.index("#define SP_F8")]
    assert produce.index("tdt_signal_acquire") < produce.index(
        "fence_proxy_async()") < produce.index("tma_load5(")
    assert sp.KV_TILE == 128 and sp.KV_TILE % sp.RING_PIECE == 0
