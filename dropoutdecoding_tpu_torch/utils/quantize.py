"""Weight-only int8 and packed int4 quantization for the Llama tower and
the int8 KV-cache quantizer; port of ``dropoutdecoding_tpu/utils/quantize.py``.

An int8 matrix is the dict {"q": int8 [.., D, E], "s": f32 [.., 1, E]}
(symmetric, one scale per output channel).  An int4 matrix is
{"q4": int8 [.., D/2, E], "s4": f32 [.., D/g, E]}: symmetric, one scale per
(group of g contraction rows, output channel), two nibbles a byte.
``models/llama._mm`` dispatches on the leaf, so quantized and dense params
flow through the same tower code.

Outputs are bit-equal to the JAX package's: fp32 true division by the
scale, round half to even (``torch.round``, as ``jnp.round``), a clip to
+-127 (int4: +-7), and ``s = 1`` where the amax is 0.  The w8a8 mode
quantizes activation rows on the fly with the K/V quantizer
(``quantize_activations``).
"""
from __future__ import annotations

import torch

_QUANT_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)


def _quantize(x32: torch.Tensor, amax: torch.Tensor) -> dict:
    # a tensor divisor: for a Python-scalar divisor PyTorch's CUDA kernel
    # multiplies by its reciprocal, which is not the IEEE quotient
    s = torch.where(amax > 0, amax / amax.new_full((), 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_matrix(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8: q = round(w / s), s = amax / 127,
    the amax taken over the contraction axis (-2)."""
    w32 = w.float()
    return _quantize(w32, w32.abs().amax(dim=-2, keepdim=True))


def dequantize_matrix(wq: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (wq["q"].float() * wq["s"].float()).to(dtype)


def quantize_kv(x: torch.Tensor) -> dict:
    """Per-(token, head) symmetric int8 for K/V cache entries: x [..., D] ->
    {"q": int8 [..., D], "s": f32 [..., 1]}."""
    x32 = x.float()
    return _quantize(x32, x32.abs().amax(dim=-1, keepdim=True))


def _concat_leaves(leaves):
    """Concatenate projection leaves along the output axis, keeping the
    leaf kind (dense, or every array of a quantized dict)."""
    if isinstance(leaves[0], dict):
        return {k: torch.cat([leaf[k] for leaf in leaves], dim=-1) for k in leaves[0]}
    return torch.cat(leaves, dim=-1)


def fuse_projections(params: dict) -> dict:
    """Fuse q/k/v into "qkv_proj" and gate/up into "gate_up_proj" along the
    output axis, the single-device layout the JAX CLI uses by default
    (``cli/chair_test.py:146-155``).  ``models/llama`` slices the fused
    output.  Returns ``params`` itself when already fused."""
    layers = dict(params["layers"])
    if "qkv_proj" in layers:
        return params
    layers["qkv_proj"] = _concat_leaves(
        [layers.pop("q_proj"), layers.pop("k_proj"), layers.pop("v_proj")]
    )
    layers["gate_up_proj"] = _concat_leaves([layers.pop("gate_proj"), layers.pop("up_proj")])
    return {**params, "layers": layers}


def int8_column_major(params: dict) -> dict:
    """A Llama parameter dict whose int8 projection leaves hold each layer's
    "q" [D, E] column-major (the stack [L, D, E] stored as [L, E, D]), the
    values unchanged; dense, int4 and the head's leaves as they are.  The
    w8a8 mode's layout: cuBLASLt's int8 product (``torch._int_mm``) takes a
    column-major right operand at 4-6x the speed of a row-major one on the
    H100 (PERF.md, PR 13); the weight-only int8 path reads either."""
    layers = {
        name: {**leaf, "q": leaf["q"].mT.contiguous().mT}
        if isinstance(leaf, dict) and "q" in leaf else leaf
        for name, leaf in params["layers"].items()
    }
    return {**params, "layers": layers}


def _check_llama(params: dict) -> None:
    """The weight tiers quantize a Llama decoder's leaves; the MLA + MoE
    decoder's tree (``models/mla_moe.py``, its experts under "moe") raises."""
    if "moe" in params:
        raise ValueError("an int8 / int4 weight tier is not supported with the MLA + MoE "
                         "decoder (models/mla_moe.py)")


def quantize_llama_params(params: dict) -> dict:
    """Quantize the per-layer projections and ``lm_head`` of a Llama
    parameter dict, as the JAX CLI's ``--quantize int8`` does.  Norms and
    embeddings keep their dtype."""
    _check_llama(params)
    layers = dict(params["layers"])
    for name in _QUANT_NAMES:
        layers[name] = quantize_matrix(layers[name])
    return {**params, "layers": layers, "lm_head": quantize_matrix(params["lm_head"])}



INT4_GROUP = 128  # contraction rows per scale; every 7B in-dim (4096, 11008)
#   is a multiple of 2 * 128, so the two packed halves never straddle a group
INT4_CLIP_GRID = (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7)


def quantize_matrix_int4(
    w: torch.Tensor, group_size: int = INT4_GROUP, clip_grid: tuple = INT4_CLIP_GRID
) -> dict:
    """Symmetric group-wise int4, two values packed per int8 byte.

    Round to nearest with one scale per (group, output channel), picked
    from ``clip_grid`` x amax / 7 by least squared error over the group
    (``clip_grid=(1.0,)`` is plain amax scaling).  Values lie in [-7, 7].

    Packing: byte ``d`` of ``q4`` [.., D/2, E] holds contraction row ``d``
    in its low nibble and row ``d + D/2`` in its high nibble, two's
    complement.  ``s4`` [.., D/group, E] fp32: groups [0, N/2) scale the
    low half, [N/2, N) the high half.
    """
    w32 = w.float()
    D, E = w32.shape[-2:]
    if D % (2 * group_size):
        raise ValueError(f"in-dim {D} not divisible by 2*group ({2 * group_size})")
    lead = w32.shape[:-2]
    n = D // group_size
    wg = w32.reshape(*lead, n, group_size, E)
    amax = wg.abs().amax(dim=-2, keepdim=True)  # [.., n, 1, E]
    one, seven = torch.ones_like(amax), amax.new_full((), 7.0)

    def scale(c):
        # tensor operands: a Python-scalar divisor becomes a reciprocal
        # multiply on CUDA, which is not the IEEE quotient
        return torch.where(amax > 0, amax.new_full((), c) * amax / seven, one)

    best_s = scale(1.0)
    if len(clip_grid) > 1 or clip_grid[0] != 1.0:
        best_err = None
        for c in clip_grid:
            sc = scale(c)
            qc = torch.clamp(torch.round(wg / sc), -7, 7)
            err = ((qc * sc - wg) ** 2).sum(dim=-2, keepdim=True)
            if best_err is None:
                best_s, best_err = sc, err
            else:
                best_s = torch.where(err < best_err, sc, best_s)
                best_err = torch.minimum(err, best_err)
    # pack in int32 and narrow at the end: the shift must not wrap early
    q = torch.clamp(torch.round(wg / best_s), -7, 7).to(torch.int32).reshape(*lead, D, E)
    lo, hi = q[..., : D // 2, :], q[..., D // 2:, :]
    packed = ((hi << 4) | (lo & 0x0F)).to(torch.int8)
    return {"q4": packed, "s4": best_s.reshape(*lead, n, E)}


def unpack_int4(packed: torch.Tensor):
    """Sign-extended (low, high) nibble planes of an int4-packed matrix,
    int8 each; all 16 nibble values decode, -8 included."""
    p = packed.to(torch.int32)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = p >> 4  # arithmetic
    return lo.to(torch.int8), hi.to(torch.int8)


def dequantize_matrix_int4(wq: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    q, s = wq["q4"], wq["s4"]
    D2, E = q.shape[-2:]
    lead = q.shape[:-2]
    n = s.shape[-2]
    lo, hi = unpack_int4(q)
    full = torch.cat([lo, hi], dim=-2).float()
    fg = full.reshape(*lead, n, (2 * D2) // n, E) * s.float()[..., :, None, :]
    return fg.reshape(*lead, 2 * D2, E).to(dtype)


def _fit_group(D: int, group_size: int) -> int:
    """Largest group <= ``group_size``, halving, with D % (2 * group) == 0
    (the packed halves must not straddle a group).  The 7B in-dims take
    g = 128 unchanged; small test towers get finer groups."""
    g = group_size
    while g > 1 and D % (2 * g):
        g //= 2
    if D % (2 * g):
        raise ValueError(f"in-dim {D} has no valid int4 group <= {group_size}")
    return g


def quantize_llama_params_int4(
    params: dict, lm_head: str | None = "int8", group_size: int = INT4_GROUP
) -> dict:
    """The int4 variant of ``quantize_llama_params``, as the JAX CLI's
    ``--quantize int4``: per-layer projections to packed group-wise int4,
    the group fitted to each in-dim (``_fit_group``); norms and embeddings
    keep their dtype.  ``lm_head``: "int8" (the default), "int4", or None
    (kept dense)."""
    _check_llama(params)
    if lm_head not in ("int8", "int4", None):
        raise ValueError(f"lm_head must be 'int8', 'int4' or None, got {lm_head!r}")
    layers = dict(params["layers"])
    for name in _QUANT_NAMES:
        w = layers[name]
        layers[name] = quantize_matrix_int4(w, _fit_group(w.shape[-2], group_size))
    out = {**params, "layers": layers}
    if lm_head is not None:
        w = params["lm_head"]
        out["lm_head"] = (
            quantize_matrix(w) if lm_head == "int8"
            else quantize_matrix_int4(w, _fit_group(w.shape[-2], group_size))
        )
    return out


def quantize_activations(x: torch.Tensor, reduce_amax=None):
    """Per-row (last-axis) symmetric int8 of activations, the "a8" half of
    the w8a8 mode (JAX ``utils/quantize.py:245``): the K/V quantizer's
    scheme, so the two never part.  ``reduce_amax``: applied to the row
    maxima [..., 1] before the scale is taken (under tensor parallelism an
    all-reduce of them, when ``x`` holds a shard of each row).  Returns
    (q int8 [..., D], s f32 [..., 1])."""
    if reduce_amax is None:
        d = quantize_kv(x)
    else:
        x32 = x.float()
        d = _quantize(x32, reduce_amax(x32.abs().amax(dim=-1, keepdim=True)))
    return d["q"], d["s"]
