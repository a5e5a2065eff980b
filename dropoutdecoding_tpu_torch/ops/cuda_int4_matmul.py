"""K6 / K6': the Hopper packed-int4 matmul (``csrc/int4_matmul.cu``).

Replaces the TPU kernels ``int4_matmul``
(``dropoutdecoding_tpu/ops/pallas_int4_matmul.py:236``) and
``int4_matmul_layered`` (``:177``): ``y = x @ W`` for a group-wise int4
matrix in the layout of ``utils/quantize.quantize_matrix_int4``,

    y = sum_g s_g * (x_g @ nibbles_g)   over both half-planes,

the fp32 scale of a (group, output channel) applied to the fp32 partial of
that group, the groups summed in fp32.  No dequantized matrix exists at any
point.  The layered form needs no kernel of its own here: a layer of a
stacked [L, D/2, E] weight is a contiguous view (``q4[l]``), and the kernel
reads it in place through its pointer.

Four routes behind one entry, picked here from the call's shape
(``prefill_route``) and handed to the C entry, which refuses a route the
shape cannot take.  bf16 activations run on the tensor cores: up to
``SMALL_ROWS`` rows (the decode forwards: 1 or 3) on the whole-tile kernel,
one persistent block an SM, each taking 64-channel tiles over the whole
contraction through a TMA ring, so that no sum crosses a block and a call
is one launch with no scratch; more rows (the prefill) on the ``wgmma``
kernel.  Both read through tensor maps, which need 16-byte aligned rows and
groups of a multiple of 128; what they do not take (no model of the port: a
ragged check shape) runs a 64-row ``mma.sync`` tile.  fp32 activations run a kernel of fp32 FMAs.  The TPU kernel rounds x to bf16
whatever its dtype; here an fp32 x stays fp32, as in the JAX package's
portable form (``models/llama._mm_int4``), so that the card agrees with
the CPU twin.

``int4_matmul_twin`` is the plain twin.  The wrapper uses it for CPU
tensors; for CUDA tensors it launches the kernel or raises.  ``launches``
counts wrapper calls that launched (each is one kernel launch, but for an
fp32 call whose contraction is split: its combine follows), ``route_launches``
the same by route.
"""
from __future__ import annotations

import torch

from ..utils.quantize import unpack_int4
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
K_STEP = 16  # contraction rows per kernel step; the group size must be a multiple
SMALL_ROWS = 16  # bf16 row count up to which the whole-tile kernel runs
_TILE_E = 128  # output channels per block of the FMA kernel
_FMA_ROWS = 4  # x rows per block of the FMA kernel
_MAX_BLOCK_K = 1024  # packed rows per block of the FMA kernel (its x tile is shared memory)
_MIN_BLOCKS = 528  # four blocks of the FMA kernel for each of 132 SMs
_ROUTES = {"fma": 0, "mma": 1, "wgmma": 2, "tiles": 3}  # as the C entry numbers them
TILE_CHANNELS = 64  # output channels per tile of the whole-tile kernel
TILE_ROWS = 128  # packed rows per box of its walk; the group size must be a multiple
TILE_BOXES = 4  # boxes per item of its ring
WGMMA_ROW_TILES = (120, 152)  # x rows per block the wgmma kernel is built for
WGMMA_CHANNELS = 128  # output channels per block
WGMMA_STEP = 128  # packed rows per step of its walk; the group size must be a multiple
_SMS = 132


def _geometry(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor):
    """(R, D2, E, N, g) of a call, after the checks both the twin and the
    kernel need."""
    if q4.dim() != 2 or s4.dim() != 2:
        raise ValueError(f"q4 and s4 must be 2-D (a layer's view), got {q4.dim()}-D, {s4.dim()}-D")
    D2, E = q4.shape
    N = s4.shape[0]
    D = x.shape[-1]
    if D != 2 * D2 or s4.shape[1] != E or N < 2 or N % 2 or D2 % (N // 2):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, q4 {tuple(q4.shape)}, s4 {tuple(s4.shape)}"
        )
    return x.numel() // D if D else 0, D2, E, N, D2 // (N // 2)


def int4_matmul_twin(x, q4, s4, out_dtype=None) -> torch.Tensor:
    """The plain twin: nibble planes by integer ops; per group an fp32 sum
    of x_g times the plane (the operands' values are exact in fp32), times
    the group's fp32 scale, the groups added in fp32 in the order of the TPU
    kernel's loop; cast to ``out_dtype``.  Any group size that divides
    D/2."""
    R, D2, E, N, g = _geometry(x, q4, s4)
    n2 = N // 2
    lo, hi = unpack_int4(q4)
    xf = x.reshape(R, 2 * D2).float()
    s = s4.float()
    acc = torch.zeros(R, E, dtype=torch.float32, device=x.device)
    for gi in range(n2):
        rows = slice(gi * g, (gi + 1) * g)
        ylo = xf[:, rows] @ lo[rows].float()
        yhi = xf[:, D2 + gi * g: D2 + (gi + 1) * g] @ hi[rows].float()
        acc = acc + ylo * s[gi] + yhi * s[n2 + gi]
    return acc.to(out_dtype or x.dtype).reshape(*x.shape[:-1], E)


def split_plan(R: int, D2: int, E: int) -> tuple[int, int]:
    """(packed rows per block, number of contraction splits) of the FMA
    kernel: enough blocks to fill the card, each block's rows a multiple of
    ``K_STEP`` and at most ``_MAX_BLOCK_K``."""
    tiles = -(-E // _TILE_E) * -(-R // _FMA_ROWS)
    want = max(-(-_MIN_BLOCKS // tiles), -(-D2 // _MAX_BLOCK_K))
    block_k = -(-D2 // min(want, max(1, D2 // 128)))
    block_k = min(-(-block_k // K_STEP) * K_STEP, _MAX_BLOCK_K)
    return block_k, -(-D2 // block_k)


def tile_plan(D2: int, E: int) -> tuple[int, int, int]:
    """(channel tiles, items a tile, blocks) of the whole-tile kernel: a tile
    is ``TILE_CHANNELS`` output channels over the whole contraction, walked
    in items of up to ``TILE_BOXES`` boxes of ``TILE_ROWS`` packed rows; one
    persistent block for each SM (fewer tiles than SMs: a block a tile)
    takes tiles b, b + blocks, ..., so no sum crosses a block."""
    tiles, boxes = -(-E // TILE_CHANNELS), D2 // TILE_ROWS
    return tiles, -(-boxes // TILE_BOXES), min(_SMS, tiles)


def tile_walk(D2: int, E: int) -> list[list[tuple[int, int, int]]]:
    """A model of the kernel's walk: for each block its items in order, each
    as (tile, first box, end box)."""
    tiles, items, blocks = tile_plan(D2, E)
    boxes = D2 // TILE_ROWS
    return [
        [(t, it * TILE_BOXES, min((it + 1) * TILE_BOXES, boxes))
         for t in range(b, tiles, blocks) for it in range(items)]
        for b in range(blocks)
    ]


def prefill_route(R: int, D2: int, E: int, g: int, aligned: bool) -> str:
    """The tensor-core kernel a bf16 call takes.  When TMA can read the
    operands (``aligned``: q4 and s4 start on 16-byte boundaries; E a multiple
    of 16, so that every row of either does) and a step of ``WGMMA_STEP`` packed
    rows lies inside one group: "wgmma" for more than ``SMALL_ROWS`` rows,
    "tiles" for fewer.  Else "mma", the ``mma.sync`` tile."""
    if aligned and E % 16 == 0 and g % WGMMA_STEP == 0:
        return "wgmma" if R > SMALL_ROWS else "tiles"
    return "mma"


def wgmma_row_tile(R: int, E: int) -> int:
    """x rows per block of the wgmma kernel, which tiles the product in
    blocks of that many rows by ``WGMMA_CHANNELS`` output channels, each
    walking the whole contraction.  An SM holds one block, so the blocks run
    in waves of one per SM; of the row tiles the kernel is built for, the one
    whose waves times rows is least wins (595 rows by 4096 channels: 160
    blocks of 120 rows take two waves, 128 of 152 rows one)."""
    channel_tiles = -(-E // WGMMA_CHANNELS)
    return min(WGMMA_ROW_TILES, key=lambda rows: -(-(-(-R // rows) * channel_tiles) // _SMS) * rows)


def int4_matmul(x, q4, s4, out_dtype=None) -> torch.Tensor:
    """K6.  Same contract as ``int4_matmul_twin``.

    Args:
      x: [..., D] activations, bf16 or fp32, contiguous.
      q4: [D/2, E] int8, two nibbles a byte (rows d and d + D/2), contiguous;
        a layer's view of a stacked weight is read in place.
      s4: [N, E] fp32 group scales (group size D / N), contiguous.
      out_dtype: x's dtype (the default) or fp32.
    Returns:
      [..., E] in ``out_dtype``.  On the card the group size must be a
      multiple of ``K_STEP``.
    """
    if x.device.type == "cpu":
        return int4_matmul_twin(x, q4, s4, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    R, D2, E, N, g = _geometry(x, q4, s4)
    out_dtype = out_dtype or x.dtype
    if q4.device != x.device or s4.device != x.device:
        raise ValueError("all operands must be on one device")
    if x.dtype not in _DTYPES or q4.dtype != torch.int8 or s4.dtype != torch.float32:
        raise TypeError(f"unsupported dtypes x {x.dtype}, q4 {q4.dtype}, s4 {s4.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {x.dtype} or float32, got {out_dtype}")
    if not (x.is_contiguous() and q4.is_contiguous() and s4.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if g % K_STEP:
        raise ValueError(f"group size {g} is not a multiple of the kernel's k-step {K_STEP}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    if R < 1 or E < 1:
        raise ValueError(f"empty product: R={R}, E={E}")
    out = torch.empty(*x.shape[:-1], E, dtype=out_dtype, device=x.device)
    route, row_tile = "fma", 0
    if x.dtype == torch.bfloat16:
        route = prefill_route(R, D2, E, g, aligned=(q4.data_ptr() | s4.data_ptr()) % 16 == 0)
    block_k, splits, partial = D2, 1, None
    if route == "wgmma":
        row_tile = wgmma_row_tile(R, E)
    elif route == "tiles":
        splits = tile_plan(D2, E)[2]
    elif route == "fma":
        block_k, splits = split_plan(R, D2, E)
        if splits > 1:
            partial = torch.empty(splits, R, E, dtype=torch.float32, device=x.device)
    err = _build.library().dd_int4_matmul(
        _DTYPES[x.dtype], int(out_dtype == torch.float32),
        x.data_ptr(), q4.data_ptr(), s4.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        R, D2, E, N, block_k, splits, _ROUTES[route], row_tile, _build.stream_of(x),
    )
    _build.check(err, f"int4_matmul kernel ({route})")
    int4_matmul.launches += 1
    int4_matmul.route_launches[route] += 1
    return out


int4_matmul.launches = 0
int4_matmul.route_launches = dict.fromkeys(_ROUTES, 0)


PROBE_MODES = {"kernel": -1, "spans": 0, "tiles": 1}


def stream_probe(x, q4, mode="kernel", width=TILE_CHANNELS, stages=5) -> torch.Tensor:
    """A walk's memory pattern alone, for measurement: blocks and a TMA ring
    over ``q4`` [D/2, E], the consumers neither decoding nor multiplying.
    ``mode`` "kernel" is the whole-tile kernel itself with its own tile,
    boxes, stages and x [R, D] bf16 (R <= ``SMALL_ROWS``) riding the ring.
    "tiles" walks whole tiles of ``width`` channels (64 or 128), block b
    taking tiles b, b + blocks, ...; "spans" cuts the list of (256-channel
    tile, 128-row chunk) pairs into one equal span a block (256 contiguous
    bytes a row); both through ``stages`` stages of 32 KB.  Returns the one
    word a block writes."""
    R, (D2, E) = x.shape[0], q4.shape
    if mode == "spans":
        width = 256
        blocks = min(_SMS, -(-E // width) * (D2 // TILE_ROWS))
    else:
        blocks = min(_SMS, -(-E // (TILE_CHANNELS if mode == "kernel" else width)))
    words = torch.empty(blocks, dtype=torch.float32, device=x.device)
    err = _build.library().dd_int4_stream_probe(
        x.data_ptr(), q4.data_ptr(), words.data_ptr(), R, D2, E, width, stages,
        PROBE_MODES[mode], blocks, _build.stream_of(x),
    )
    _build.check(err, f"int4 stream probe ({mode})")
    return words
