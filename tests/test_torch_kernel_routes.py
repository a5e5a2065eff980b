"""Which kernel a call takes on the card, and how its tiles cover the work:
the route functions of K5 (``ops/cuda_flash_prefill.py``) and K6
(``ops/cuda_int4_matmul.py``) and K6's choice of row tile, which are plain
Python; the constants they reckon with against the kernel sources; models of
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
from dropoutdecoding_tpu_torch.ops import cuda_decode_attention as k1
from dropoutdecoding_tpu_torch.ops import cuda_flash_prefill as k5
from dropoutdecoding_tpu_torch.ops import cuda_int4_matmul as k6

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
