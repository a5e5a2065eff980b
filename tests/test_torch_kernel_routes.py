"""Which kernel a call takes on the card, and how its tiles cover the work:
the route functions of K2 (``ops/cuda_uncertainty.py``), K4
(``ops/cuda_cache_append.py``), K5 (``ops/cuda_flash_prefill.py``) and K6
(``ops/cuda_int4_matmul.py``), K2's row plan and K6's choice of row tile,
which are plain Python; the constants they reckon with against the kernel sources; models of
the kernels' tilings; and the ctypes signatures of ``ops/_build.py`` against
the C entries in ``csrc/*.cu``.

The kernels themselves run only on the card; ``chip_smoke.py`` holds each
against its plain twin there and checks the route every case took.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from dropoutdecoding_tpu_torch.ops import _build
from dropoutdecoding_tpu_torch.ops import cuda_cache_append as k4
from dropoutdecoding_tpu_torch.ops import cuda_decode_attention as k1
from dropoutdecoding_tpu_torch.ops import cuda_flash_prefill as k5
from dropoutdecoding_tpu_torch.ops import cuda_int4_matmul as k6
from dropoutdecoding_tpu_torch.ops import cuda_uncertainty as k2

K6_ROUTES = [  # (label, R, D2, E, g, aligned, route)
    ("7B qkv prefill", 595, 2048, 12288, 128, True, "wgmma"),
    ("7B o prefill", 595, 2048, 4096, 128, True, "wgmma"),
    ("7B gate_up prefill", 595, 2048, 22016, 128, True, "wgmma"),
    ("7B down prefill", 595, 5504, 4096, 128, True, "wgmma"),
    ("int4 head over the visual tokens", 576, 2048, 32064, 128, True, "wgmma"),
    ("batched prefill", 2 * 595, 2048, 4096, 128, True, "wgmma"),
    ("17 rows", 17, 2048, 4096, 128, True, "wgmma"),
    ("narrow model prefill", 73, 128, 768, 128, True, "wgmma"),
    ("ragged E = 130, g = 32", 70, 1376, 130, 32, True, "mma"),
    ("E not a multiple of 16", 595, 2048, 4100, 128, True, "mma"),
    ("g = 64: a step would span two groups", 595, 2048, 4096, 64, True, "mma"),
    ("tiny contraction, g = 16", 40, 16, 64, 16, True, "mma"),
    ("a view off the 16-byte grid", 595, 2048, 4096, 128, False, "mma"),
    ("exact decode, 3 rows", 3, 2048, 22016, 128, True, "tiles"),
    ("greedy decode, 1 row", 1, 5504, 4096, 128, True, "tiles"),
    ("16 rows", 16, 2048, 4096, 128, True, "tiles"),
    ("int4 head, exact decode", 3, 2048, 32064, 128, True, "tiles"),
    ("narrow model decode", 3, 128, 768, 128, True, "tiles"),
    ("ragged decode, g = 32", 3, 1376, 130, 32, True, "mma"),
    ("decode on a view off the 16-byte grid", 3, 2048, 4096, 128, False, "mma"),
]


@pytest.mark.parametrize(
    "R,D2,E,g,aligned,route", [c[1:] for c in K6_ROUTES], ids=[c[0] for c in K6_ROUTES]
)
def test_int4_prefill_route(R, D2, E, g, aligned, route):
    assert k6.prefill_route(R, D2, E, g, aligned) == route


def _constant(source: str, name: str) -> int:
    """``constexpr int <name> = <number>;`` of a kernel source."""
    text = (_build.SRC_DIR / source).read_text()
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", text)
    return int(value)


def test_int4_wgmma_constants_are_the_sources():
    """What the wrapper reckons with is what the kernel is built with: the
    channels per block, the packed rows per step, and a launcher for every
    row tile the wrapper may name (the C entry refuses any other)."""
    assert k6.WGMMA_CHANNELS == _constant("int4_matmul.cu", "kWgChannels")
    assert k6.WGMMA_STEP == _constant("int4_matmul.cu", "kWgGroup")
    text = (_build.SRC_DIR / "int4_matmul.cu").read_text()
    built = re.findall(r"if \(row_tile == (\d+)\) return \(int\)launch_wgmma<(\d+)>", text)
    assert [int(a) for a, _ in built] == [int(b) for _, b in built] == list(k6.WGMMA_ROW_TILES)


@pytest.mark.parametrize(
    "R,D2,E", [c[1:4] for c in K6_ROUTES if c[-1] == "wgmma"],
    ids=[c[0] for c in K6_ROUTES if c[-1] == "wgmma"],
)
def test_int4_wgmma_tiles_cover_the_product_once(R, D2, E):
    """A model of the kernel's grid (ceil(R / rows) row tiles by ceil(E /
    channels) channel tiles, the whole contraction in steps of one group):
    the tiles cover R, E and the contraction exactly once, the last tile of
    each ragged at most; a step lies inside one group of 128; the row tile
    the wrapper hands to the C entry is one the kernel is built for and no
    other of them needs fewer waves-times-rows."""
    rows = k6.wgmma_row_tile(R, E)
    assert rows in k6.WGMMA_ROW_TILES
    channel_tiles = -(-E // k6.WGMMA_CHANNELS)
    for total, tile, n in ((R, rows, -(-R // rows)), (E, k6.WGMMA_CHANNELS, channel_tiles)):
        spans = [(i * tile, min((i + 1) * tile, total)) for i in range(n)]
        assert spans[0][0] == 0 and spans[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(lo < hi for lo, hi in spans)
    assert D2 % k6.WGMMA_STEP == 0 and 128 % k6.WGMMA_STEP == 0

    def cost(rows):
        return -(-(-(-R // rows) * channel_tiles) // 132) * rows

    assert cost(rows) == min(cost(r) for r in k6.WGMMA_ROW_TILES)


def test_int4_wgmma_plan_at_the_7b_shapes():
    """The wave arithmetic at the shapes the prefill runs: 595 rows by 4096
    channels fit one wave of 152-row tiles (128 blocks) against two of
    120-row tiles (160 blocks); gate_up's 172 channel tiles prefer 120."""
    assert k6.wgmma_row_tile(595, 4096) == 152
    assert k6.wgmma_row_tile(595, 12288) == 152
    assert k6.wgmma_row_tile(595, 22016) == 120
    assert -(-32064 // k6.WGMMA_CHANNELS) == 251  # the head ends inside a tile: 250.5


def test_int4_tile_constants_are_the_sources():
    """The whole-tile kernel's tile, box and item, and the row count up to
    which its route runs, are what the wrapper plans with."""
    assert k6.TILE_CHANNELS == _constant("int4_matmul.cu", "kTcChannels")
    assert k6.TILE_ROWS == _constant("int4_matmul.cu", "kTcRows")
    assert k6.TILE_BOXES == _constant("int4_matmul.cu", "kTcBoxes")
    assert k6.SMALL_ROWS == _constant("int4_matmul.cu", "kSmallRows")
    # sixteen consumer warps: a 16-channel group for each of the tile's four, by a box
    assert _constant("int4_matmul.cu", "kTcConsumers") == 32 * (k6.TILE_CHANNELS // 16) * k6.TILE_BOXES


@pytest.mark.parametrize(
    "D2,E,blocks,per_block",
    [(2048, 12288, 132, (8, 4)), (2048, 4096, 64, (4, 4)), (2048, 22016, 132, (12, 8)),
     (5504, 4096, 64, (11, 11)), (2048, 32064, 132, (16, 12)), (128, 768, 12, (1, 1))],
    ids=["qkv", "o", "gate_up", "down", "head", "narrow"],
)
def test_int4_tile_plan_at_the_model_shapes(D2, E, blocks, per_block):
    """One block an SM, or a block a tile where the tiles are fewer; the most
    and the fewest items a block walks (43 boxes of down are 11 items, the
    last of 3 boxes; the head's 501st tile holds 64 of its channels)."""
    assert k6.tile_plan(D2, E)[2] == blocks
    counts = [len(items) for items in k6.tile_walk(D2, E)]
    assert (max(counts), min(counts)) == per_block


# --- K1 / K3: the plan, the walk and the scratch ---------------------------------


def test_decode_attention_constants_are_the_sources():
    assert k1.TILE == _constant("decode_attention.cu", "kTile")
    assert k1.MMA_ROWS == _constant("decode_attention.cu", "kMmaRows")
    assert k1.MMA_HEAD_DIM == _constant("decode_attention.cu", "kMmaD")
    assert k1.MAX_SPLITS == _constant("decode_attention.cu", "kMaxSplits")
    assert k1.MAX_HEAD_DIM == 32 * _constant("decode_attention.cu", "kMaxDPerLane")


DECODE_GEOMETRIES = [(1, 32), (1, 8), (2, 32), (2, 2), (16, 8)]  # (B, KH)


@pytest.mark.parametrize("S", [1, 64, 65, 1152, 3504, 20000])
@pytest.mark.parametrize("B,KH", DECODE_GEOMETRIES)
@pytest.mark.parametrize("tensor_cores", [True, False], ids=["mma", "fma"])
def test_decode_plan_covers_every_tile_once(S, B, KH, tensor_cores):
    """The blocks of a (batch row, kv group) take contiguous runs of tiles
    that cover the cache's capacity once, in split order; no more splits
    than the merge keeps weights for; the grid is a function of the
    capacity alone."""
    per_block, splits = k1.decode_plan(B, KH, S, tensor_cores)
    tiles = -(-S // k1.TILE)
    assert per_block >= 1 and splits == -(-tiles // per_block) and splits <= k1.MAX_SPLITS
    runs = [(sp * per_block, min((sp + 1) * per_block, tiles)) for sp in range(splits)]
    assert runs[0][0] == 0 and runs[-1][1] == tiles
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:])) and all(lo < hi for lo, hi in runs)
    if per_block > 1 and -(-tiles // (per_block - 1)) <= k1.MAX_SPLITS:
        # a shorter run would put more blocks on the card than the plan aims at
        aim = (k1._BLOCKS_PER_SM if tensor_cores else k1._FMA_BLOCKS_PER_SM) * 132
        assert B * KH * tiles > aim * (per_block - 1)


def test_decode_plan_at_the_model_shapes():
    """LLaVA-1.5 (MHA, 1152 slots): two tiles a block, 288 blocks; LLaVA-NeXT
    (8 kv groups, 3504 slots): two tiles a block, 224 blocks; the fp32 FMA
    kernel takes a tile a block."""
    assert k1.decode_plan(1, 32, 1152) == (2, 9)
    assert k1.decode_plan(1, 8, 1152) == (1, 18)
    assert k1.decode_plan(1, 8, 3504) == (2, 28)
    assert k1.decode_plan(2, 32, 1152) == (3, 6)
    assert k1.decode_plan(1, 32, 1152, tensor_cores=False) == (1, 18)


def _live_subtiles(mask, per_block):
    """A model of the tensor-core kernel's walk over one batch row's mask [M,
    S]: the (split, tile of the block, warp) triples whose 16 slots a member
    attends, as the kernel's ``live`` derives them from the staged mask."""
    M, S = mask.shape
    tiles = -(-S // k1.TILE)
    sub = k1.TILE // 4
    live = []
    for split in range(-(-tiles // per_block)):
        for j in range(per_block):
            for warp in range(4):
                s0 = (split * per_block + j) * k1.TILE + warp * sub
                if mask[:, s0:s0 + sub].any():
                    live.append((split, j, warp))
    return live


@pytest.mark.parametrize("S,fill", [(1, 1), (64, 64), (65, 65), (1152, 620), (1152, 768),
                                    (3504, 2947), (3504, 0)])
def test_decode_walk_covers_every_attended_slot_once(rng, S, fill):
    """Every slot some member attends lies in exactly one live sub-tile of
    exactly one block, whatever holes the members' masks have; a sub-tile no
    member attends is not walked; no sub-tile starts past the capacity."""
    M = 3
    mask = (np.arange(S) < fill)[None, :] & (rng.random((M, S)) > 0.4)
    mask[M - 1] = False  # a member that attends only its own token
    per_block, splits = k1.decode_plan(1, 8, S)
    live = _live_subtiles(mask, per_block)
    assert len(set(live)) == len(live)
    covered = np.zeros(S + k1.TILE, dtype=int)
    sub = k1.TILE // 4
    for split, j, warp in live:
        assert split < splits
        s0 = (split * per_block + j) * k1.TILE + warp * sub
        assert s0 < S
        covered[s0:s0 + sub] += 1
    attended = mask.any(0)
    assert (covered[:S][attended] == 1).all() and covered.max(initial=0) <= 1
    assert len(live) == len({s // sub for s in np.flatnonzero(attended)})


def test_decode_scratch_is_kept_by_device_stream_and_geometry():
    """One set of buffers a (device, stream, geometry), made once and handed
    out again (the kernel leaves the counters zero); two geometries, or two
    streams, that may be in flight together never meet in one."""
    k1._scratch.clear()
    a = k1.decode_scratch("cpu", 0, B=1, KH=32, R=3, D=128, splits=9)
    assert a is k1.decode_scratch("cpu", 0, B=1, KH=32, R=3, D=128, splits=9)
    part_m, part_l, part_acc, counters = a
    assert part_m.shape == part_l.shape == (32 * 9 * 3,) and part_acc.shape == (32 * 9 * 3 * 128,)
    assert counters.dtype == torch.int32 and counters.shape == (32,) and not counters.any()
    others = [
        k1.decode_scratch("cpu", 0, B=1, KH=8, R=12, D=128, splits=18),   # another geometry
        k1.decode_scratch("cpu", 0, B=1, KH=32, R=3, D=128, splits=6),    # another plan
        k1.decode_scratch("cpu", 7, B=1, KH=32, R=3, D=128, splits=9),    # another stream
        k1.decode_scratch("meta", 0, B=1, KH=32, R=3, D=128, splits=9),   # another device
    ]
    ptrs = {t.data_ptr() for t in a}
    for other in others:
        assert other is not a
        if other[0].device.type == "cpu":
            assert not ptrs & {t.data_ptr() for t in other}
    # 24 query rows take two tensor-core tiles: two counters a (batch row, kv group)
    assert k1.decode_scratch("cpu", 0, B=2, KH=8, R=24, D=128, splits=18)[3].shape == (32,)
    k1._scratch.clear()


K5_ROUTES = [  # (label, dtype, S, D, route)
    ("NeXT prefill", torch.bfloat16, 2950, 128, "wgmma"),
    ("S = 1024", torch.bfloat16, 1024, 128, "wgmma"),
    ("S = 1025", torch.bfloat16, 1025, 128, "wgmma"),
    ("the longest S", torch.bfloat16, k5.WGMMA_MAX_S, 128, "wgmma"),
    ("past the longest S", torch.bfloat16, k5.WGMMA_MAX_S + 1, 128, "mma"),
    ("D = 64", torch.bfloat16, 2950, 64, "mma"),
    ("D = 32", torch.bfloat16, 1100, 32, "mma"),
    ("D = 16", torch.bfloat16, 1320, 16, "mma"),
    ("fp32 D = 128", torch.float32, 2950, 128, "scalar"),
    ("fp32 D = 16, the narrow NeXT", torch.float32, 1320, 16, "scalar"),
]


@pytest.mark.parametrize(
    "dtype,S,D,route", [c[1:] for c in K5_ROUTES], ids=[c[0] for c in K5_ROUTES]
)
def test_flash_prefill_route(dtype, S, D, route):
    assert k5.prefill_route(dtype, S, D) == route


def test_flash_wgmma_longest_s_is_the_sources():
    """The route's limit on S is the key-tile flags the kernel keeps."""
    tiles, keys = (_constant("flash_prefill.cu", n) for n in ("kWgMaxTiles", "kWgBK"))
    assert k5.WGMMA_MAX_S == tiles * keys
    assert _constant("flash_prefill.cu", "kWgD") == k5.WGMMA_HEAD_DIM


def _flash_wgmma_walk(S: int, tile: int):
    """A model of the wgmma kernel's causal walk, as its source derives it
    from the block index (grid.y = ceil(S / kWgBQ) query tiles; n_tiles = qt
    + 1 key tiles, the last the diagonal): for each block of query rows
    ``[q0, q1)`` the key tiles ``[k0, k1)`` it visits."""
    plan = []
    for q0 in range(0, S, tile):
        q1 = min(q0 + tile, S)
        plan.append((q0, q1, [(k0, min(k0 + tile, S)) for k0 in range(0, q1, tile)]))
    return plan


@pytest.mark.parametrize("S", [1, 128, 129, 1024, 1025, 2950])
def test_flash_wgmma_tiles_cover_the_causal_triangle_once(S):
    """With the source's tile sizes (query rows and keys a tile must agree,
    or the last key tile is not the diagonal), every (query, key <= query)
    pair lies in exactly one (query block, key tile) of the walk."""
    tile = _constant("flash_prefill.cu", "kWgBQ")
    assert tile == _constant("flash_prefill.cu", "kWgBK")
    plan = _flash_wgmma_walk(S, tile)
    assert [q0 for q0, _, _ in plan] == list(range(0, S, tile))
    assert plan[-1][1] == S
    pairs = 0
    for q0, q1, tiles in plan:
        assert 0 < q1 - q0 <= tile
        assert tiles[0][0] == 0 and tiles[-1][1] == q1 and tiles[-1][0] == q0
        assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
        for q in (q0, q1 - 1):  # the block's first and last row see keys 0 .. q
            assert sum(max(0, min(k1, q + 1) - k0) for k0, k1 in tiles) == q + 1
        pairs += sum((q + 1) for q in range(q0, q1))
    assert pairs == S * (S + 1) // 2


# --- K2: the route, the row plan, the copy spans and the candidates ---------------

K2_ROUTES = [  # (label, L, V, k, aligned, route)
    ("LLaVA-1.5", 576, 32064, 5, True, "resident"),
    ("LLaVA-NeXT", 2928, 32064, 10, True, "resident"),
    ("InstructBLIP: rows off the 16-byte grid", 32, 32001, 10, True, "resident"),
    ("a row longer than the ring", 64, 130000, 5, True, "stream"),
    ("no table", 576, 32064, 0, True, "resident"),
    ("the narrow model", 16, 128, 5, True, "resident"),
    ("the longest resident row", 8, 32768, 16, True, "resident"),
    ("one column more", 8, 32769, 5, True, "stream"),
    ("the longest row off the grid", 8, 32763, 5, True, "resident"),
    ("off the grid, the span a chunk too long", 8, 32765, 5, True, "stream"),
    ("a tensor off the 16-byte grid", 576, 32064, 5, False, "stream"),
]


@pytest.mark.parametrize(
    "L,V,k,aligned,route", [c[1:] for c in K2_ROUTES], ids=[c[0] for c in K2_ROUTES]
)
def test_uncertainty_route(L, V, k, aligned, route):
    assert k2.uncertainty_route(L, V, k, aligned) == route


@pytest.mark.parametrize("V,k", [(32064, 17), (8, 9), (32064, -1)])
def test_uncertainty_route_refuses_a_table_it_cannot_make(V, k):
    with pytest.raises(ValueError, match="top_k"):
        k2.uncertainty_route(576, V, k)


def test_uncertainty_constants_are_the_sources():
    """What the wrapper plans and sizes its scratch with is what the kernels
    are built with."""
    src = "uncertainty.cu"
    assert k2.RES_MAX_SPAN == _constant(src, "kResMaxSpan")
    assert k2.RES_MAX_SPAN == _constant(src, "kResThreads") * _constant(src, "kResCols")
    assert k2.MAX_TOP_K == _constant(src, "kMaxTopK")
    assert k2.ROWS_PER_BLOCK == _constant(src, "kRowsPerBlock")
    assert k2.C_PIECES == _constant(src, "kCrossThreads") // 32
    # a row and the next one's first chunks fit the ring; the ring fits a block
    chunk, slots = _constant(src, "kChunk"), _constant(src, "kSlots")
    assert chunk == 4 * _constant(src, "kResThreads")
    assert k2.RES_MAX_SPAN // chunk < slots and slots * chunk * 4 + 8192 <= 232448
    assert k2.MAX_TOP_K <= 16  # the k-th largest of the sixteen warps' maxima


@pytest.mark.parametrize("B", [1, 2, 5, 200])
@pytest.mark.parametrize("L", [1, 32, 576, 577, 2928])
def test_uncertainty_row_plan_covers_every_row_once(B, L):
    """Block g of an image walks rows g, g + G, ...: every row of the image
    once, no block without a row, at most 132 blocks over all images (never
    the card's own count), the blocks' loads within a row of each other."""
    G = k2.row_plan(B, L)
    assert 1 <= G <= L and (B * G <= k2.RES_BLOCKS or G == 1)
    walks = [list(k2.block_rows(g, G, L)) for g in range(G)]
    assert sorted(r for w in walks for r in w) == list(range(L))
    assert all(walks) and max(map(len, walks)) - min(map(len, walks)) <= 1
    # the kernels derive a block's row count as (L - g + G - 1) // G
    assert [len(w) for w in walks] == [(L - g + G - 1) // G for g in range(G)]


def test_uncertainty_row_plan_at_the_model_shapes():
    assert k2.row_plan(1, 576) == 132 and k2.row_plan(1, 2928) == 132
    assert k2.row_plan(2, 576) == 66 and k2.row_plan(1, 32) == 32


@pytest.mark.parametrize("V,rows", [(32064, 5), (32001, 9), (32763, 6), (130, 7), (3, 11)])
def test_uncertainty_copy_spans_hold_each_row(V, rows):
    """A model of ``row_span`` and the producer's copies: each row is copied
    as the 16-byte-aligned span around it, in chunks; every copy starts and
    ends on the 16-byte grid inside the tensor, the floats past the grid's
    last boundary come one by one, and column v of the row lies at float
    shift + v of the span."""
    chunk = _constant("uncertainty.cu", "kChunk")
    total = rows * V
    x = np.arange(total, dtype=np.float32)
    total4 = total & ~3
    for row in range(rows):
        e0 = row * V
        shift = e0 & 3
        a0, span = e0 - shift, (shift + V + 3) & ~3
        chunks = -(-span // chunk)
        assert span <= k2.RES_MAX_SPAN and chunks * chunk >= span
        got = np.full(chunks * chunk, np.nan, dtype=np.float32)
        for c in range(chunks):
            src = a0 + c * chunk
            end = src + min(chunk, span - c * chunk)
            if end > total4:
                for e in range(max(src, total4), total):
                    got[c * chunk + e - src] = x[e]
                end = max(src, total4)
            assert src % 4 == 0 and end % 4 == 0 and end <= total
            got[c * chunk:c * chunk + end - src] = x[src:end]
        np.testing.assert_array_equal(got[shift:shift + V], x[e0:e0 + V])


def _candidates(row, k, threads=512):
    """A model of the resident kernel's top-k threshold for one row: thread t
    of 512 holds columns 2048 c + 4 t .. + 3 of every chunk c; tau is the
    larger of (the largest over the 16 warps of a warp's k-th largest thread
    max) and (the k-th largest of the warps' maxima); the candidates are the
    columns with a logit >= tau."""
    V = row.shape[0]
    padded = np.full(-(-V // (4 * threads)) * 4 * threads, -np.inf, dtype=np.float32)
    padded[:V] = row
    thread_max = padded.reshape(-1, threads, 4).max(axis=(0, 2))
    warps = -np.sort(-thread_max.reshape(16, 32), axis=1)
    tau = max(warps[:, k - 1].max(), -np.sort(-warps[:, 0])[k - 1])
    return np.flatnonzero(row >= tau)


@pytest.mark.parametrize("k", [1, 5, 10, 16])
@pytest.mark.parametrize("V", [32064, 32001, 512, 128])
def test_uncertainty_candidates_hold_the_top_k(rng, V, k):
    """The logits >= tau always include the top-k under (value descending,
    index ascending), ties planted at the threshold included, and for logits
    like a bf16 head's they are few: far under the kernel's buffer, whose
    overflow takes the slow path."""
    cap = _constant("uncertainty.cu", "kCandCap")
    for trial in range(4):
        row = torch.from_numpy(3 * rng.normal(size=V).astype(np.float32)).bfloat16().float().numpy()
        if trial == 1:
            row[[7, V // 2, V - 1]] = row.max()  # the maximum three times
        if trial == 2:
            row[::3] = np.sort(row)[-k]  # thousands of logits tied at the k-th value
        cand = _candidates(row, k)
        order = np.lexsort((np.arange(V), -row))[:k]
        assert set(order) <= set(cand)
        ranked = cand[np.lexsort((cand, -row[cand]))][:k]
        np.testing.assert_array_equal(ranked, order)
        np.testing.assert_array_equal(
            ranked, k2.exact_top_k_ids(torch.from_numpy(row)[None], k)[0].numpy())
        if trial != 2 and V >= 512:
            assert len(cand) <= cap // 2
        if trial == 2 and V >= 32001:
            assert len(cand) > cap  # this row takes the kernel's slow path


# --- K4: the route ------------------------------------------------------------------


@pytest.mark.parametrize(
    "D,aligned,route",
    [(128, True, "row128"), (128, False, "scalar"), (64, True, "scalar"), (96, True, "scalar"),
     (256, True, "scalar")],
)
def test_cache_append_route(D, aligned, route):
    assert k4.append_route(D, aligned) == route


def test_cache_append_constants_are_the_sources():
    assert k4.ROW_HEAD_DIM == _constant("cache_append.cu", "kRowD")
    # a lane holds four values of the row: 32 lanes a head dim of 128
    assert _constant("cache_append.cu", "kRowD") == 4 * 32


# --- the ctypes table against the C entries --------------------------------------

_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}


def _c_entries():
    """{name: [kind of each argument]} of every ``extern "C" int dd_*(...)``
    in the sources; ``dd_error_string`` returns a string and is bound apart."""
    entries = {}
    for src in _build.sources():
        for name, args in re.findall(r'extern "C" int (dd_\w+)\(([^)]*)\)', src.read_text()):
            kinds = []
            for arg in args.split(","):
                arg = " ".join(arg.split())
                if "*" in arg:
                    kinds.append("pointer")
                elif arg.startswith("int "):
                    kinds.append("int")
                elif arg.startswith("float "):
                    kinds.append("float")
                else:
                    raise AssertionError(f"{src.name}: {name}: argument {arg!r}")
            entries[name] = kinds
    return entries


def test_ctypes_signatures_name_every_c_entry():
    assert set(_build._SIGNATURES) == set(_c_entries())


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_ctypes_signature_matches_the_source(name):
    """Same count and kinds of arguments: a pointer bound as an int would be
    cut to 32 bits without any error."""
    assert [_KINDS[t] for t in _build._SIGNATURES[name]] == _c_entries()[name]
