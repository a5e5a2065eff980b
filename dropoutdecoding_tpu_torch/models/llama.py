"""Llama-family decoder (Vicuna-7B, Mistral-7B) as functions over a parameter
dict; port of ``dropoutdecoding_tpu/models/llama.py``.

- ``prefill``: full-sequence causal forward; returns the final-norm hidden
  states and every layer's K/V to seed the cache.  Its attention is K5
  (``ops/cuda_flash_prefill.py``) at every length.  ``prefill_hidden`` is
  the same forward for callers that read no cache (the probe): it keeps no
  layer's K/V.
- ``prefill_extend``: T new tokens over a cached prefix, dense or in the
  int8 reader layout of ``kv_int8_reader_layout`` (the POPE path's prefix
  cache; ``ops/attention.extend_attention``).
- ``decode_step``: one token for M ensemble members sharing the cache.  Each
  layer's attention reads the layer's view of the cache in place: K1 over a
  dense cache, K3 over an int8 one (``ops/cuda_decode_attention.py``).
  Returns each member's new-token K/V (unquantized) so the engine appends
  only the vote winner's.
- ``decode_step_attn``: one token over B rows that also returns the last
  layer's head-mean attention probabilities (OPERA's penalty reads them).
  Plain torch, as the JAX function is plain XLA: K1 emits no probabilities.

Weights are in the JAX layout: ``x @ W`` with W [in, out], layers stacked
on a leading [L] axis; a projection may be dense, int8 {"q", "s"} or
packed int4 {"q4", "s4"} (``utils/quantize.py``), and q/k/v and gate/up may
be fused into one leaf each (``fuse_projections``).  An int4 projection
runs K6 (``ops/cuda_int4_matmul.py``) on the layer's view of the stacked
weight; no dequantized matrix is made.  Logits are fp32.  With ``w8a8``
(``prefill``, ``prefill_extend``, ``decode_step``) an int8 projection
quantizes its activation rows and multiplies int8 by int8 into int32
sums (``_mm_w8a8``); the head keeps its own path.

Unlike the JAX package, the cache is updated in place: ``cache_seed``,
``cache_write_span`` (the speculative verify's block), ``cache_set_rows``,
``cache_reorder_rows`` (beam search's reorder) and ``cache_copy_slot`` /
``cache_copy_slots`` (the serving layer's placement) write into the
KVCache's tensors.  On an int8 cache ``cache_set_rows`` is
K4 (``ops/cuda_cache_append.py``).

Tensor parallelism: params cut by ``parallel/mesh.shard_*`` carry their
mesh, and every forward here finds it (``mesh_of``).  Each rank then holds
its heads, its MLP columns and its vocabulary block; the collectives sit in
``_forward`` alone, which every entry shares: one all-reduce after o_proj
and one after down_proj (before an int8 leaf's whole-row scale, as GSPMD
orders them), or, for a packed int4 row-parallel leaf kept whole, a gather
of its input instead.  ``lm_head`` gathers the vocabulary blocks into whole
fp32 logits on every rank.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..engine import trace
from ..ops.attention import extend_attention, extend_attention_int8prefix
from ..ops.basic import apply_rope, rms_norm, rotary_embedding
from ..ops.cuda_cache_append import cache_append_int8
from ..ops.cuda_decode_attention import (
    ensemble_decode_attention_fused,
    ensemble_decode_attention_int8kv_fused,
)
from ..ops.cuda_flash_prefill import flash_prefill_attention
from ..ops.cuda_int4_matmul import int4_matmul
from ..parallel.mesh import all_gather, all_reduce, mesh_of
from ..utils.config import LlamaConfig
from ..utils.hf_io import hf_leaf, hf_stacked
from ..utils.quantize import quantize_activations, quantize_kv


class KVCache(NamedTuple):
    """The canonical cache.  Dense: k and v are [L, B, Smax, KH, D] each.
    int8 (the JAX package's leaf layout): k and v are each
    {"q": int8 [L, B, Smax, KH*D], "s": f32 [L, B, KH, Smax]}, the scales
    head-major so that a (row, head)'s scales are contiguous."""

    k: torch.Tensor | dict
    v: torch.Tensor | dict


def params_from_hf(
    cfg: LlamaConfig,
    sd: dict,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
    prefix: str = "",
) -> dict:
    """An HF LlamaForCausalLM (or Mistral) state dict -> the decoder's
    params on ``device`` in ``dtype`` (JAX ``models/llama.py:309``): linear
    weights [out, in] -> [in, out], layers stacked; without an
    ``lm_head.weight`` the head is the tied embedding, transposed."""

    def stack(fmt, transpose=False):
        names = [f"{prefix}model.layers.{i}.{fmt}" for i in range(cfg.num_hidden_layers)]
        return hf_stacked(sd, names, dtype, device, transpose)

    head = prefix + "lm_head.weight"
    if head not in sd:  # tied embeddings
        head = prefix + "model.embed_tokens.weight"
    return {
        "embed_tokens": hf_leaf(sd, prefix + "model.embed_tokens.weight", dtype, device),
        "layers": {
            "input_ln": stack("input_layernorm.weight"),
            "post_attn_ln": stack("post_attention_layernorm.weight"),
            "q_proj": stack("self_attn.q_proj.weight", True),
            "k_proj": stack("self_attn.k_proj.weight", True),
            "v_proj": stack("self_attn.v_proj.weight", True),
            "o_proj": stack("self_attn.o_proj.weight", True),
            "gate_proj": stack("mlp.gate_proj.weight", True),
            "up_proj": stack("mlp.up_proj.weight", True),
            "down_proj": stack("mlp.down_proj.weight", True),
        },
        "norm": hf_leaf(sd, prefix + "model.norm.weight", dtype, device),
        "lm_head": hf_leaf(sd, head, dtype, device, transpose=True),
    }


def local_heads(cfg: LlamaConfig, mesh=None) -> tuple[int, int]:
    """(query heads, KV heads) of this rank: all of them without a mesh,
    the model axis's share under tensor parallelism."""
    H, KH = cfg.num_attention_heads, cfg.num_key_value_heads
    if mesh is None:
        return H, KH
    n = mesh.n_model
    if H % n or KH % n:
        raise ValueError(f"{H} heads / {KH} KV heads do not split over {n} model ranks")
    return H // n, KH // n


def empty_cache(
    cfg: LlamaConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype,
    device: torch.device | str,
    quantized: bool = False,
    tp_mesh=None,
) -> KVCache:
    """Allocate the canonical cache; the int8 layout when ``quantized``,
    with scales 1 so that untouched slots dequantize to 0.  Under
    ``tp_mesh`` it holds this rank's KV heads."""
    L, D = cfg.num_hidden_layers, cfg.head_dim
    KH = local_heads(cfg, tp_mesh)[1]
    if not quantized:
        shape = (L, batch, max_len, KH, D)
        return KVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )

    def leaf():
        return {
            "q": torch.zeros((L, batch, max_len, KH * D), dtype=torch.int8, device=device),
            "s": torch.ones((L, batch, KH, max_len), dtype=torch.float32, device=device),
        }

    return KVCache(leaf(), leaf())


def cache_is_quantized(cache: KVCache) -> bool:
    return isinstance(cache.k, dict)


def _quantize_new(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor):
    """Bring unquantized K/V ([..., KH, D]) into the cache's leaf layout:
    {"q": [..., KH*D] int8, "s": [..., KH, 1] f32} for an int8 cache."""
    if not cache_is_quantized(cache):
        return k_new, v_new

    def flat(d):
        return {"q": d["q"].flatten(-2), "s": d["s"]}

    return flat(quantize_kv(k_new)), flat(quantize_kv(v_new))


def cache_write_span(cache: KVCache, start: int, kv: KVCache) -> KVCache:
    """Write a dense K/V block ([L, B, T, KH, D]) at slots ``start`` ..
    ``start + T - 1``, in place (JAX ``models/llama.py:170``: the
    speculative verify's block append); quantized per (token, head) for an
    int8 cache, so the block is bit-equal to T sequential ``cache_set_rows``
    appends.  Where JAX's ``dynamic_update_slice`` clamps a start past
    ``S - T`` (and so overwrites earlier rows), this raises."""
    T = kv.k.shape[2]
    S = _leaves(cache)[0].shape[2]
    if not 0 <= start <= S - T:
        raise ValueError(f"cache_write_span: slots [{start}, {start + T}) outside a cache of {S}")
    kn, vn = _quantize_new(cache, kv.k, kv.v)
    span = slice(start, start + T)
    for leaf, new in ((cache.k, kn), (cache.v, vn)):
        if isinstance(leaf, dict):
            leaf["q"][:, :, span] = new["q"]
            leaf["s"][..., span] = new["s"][..., 0].transpose(2, 3)  # [L, B, KH, T]
        else:
            leaf[:, :, span] = new
    return cache


def cache_seed(cache: KVCache, kv: KVCache) -> KVCache:
    """Write the prefill K/V ([L, B, S0, KH, D], dense) at slot 0, in place."""
    return cache_write_span(cache, 0, kv)


def cache_set_rows(
    cache: KVCache, cur_len: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor
) -> KVCache:
    """Write each row's new-token K/V ([L, B, KH, D], dense) at slot
    ``cur_len[b]``, in place (the engine's per-step append of the vote
    winner's K/V); on an int8 cache, quantized by K4 in one launch.  A row
    whose slot lies outside the cache is not written, as the JAX package's
    scatter drops it (a server's row past its budget, still stepped until
    harvest, reaches it); no host sync decides which."""
    if cache_is_quantized(cache):
        cache_append_int8(
            cache.k["q"], cache.k["s"], cache.v["q"], cache.v["s"], cur_len,
            k_new.contiguous(), v_new.contiguous(),
        )
        return cache
    S = cache.k.shape[2]
    rows = torch.arange(k_new.shape[1], device=cur_len.device)
    at = cur_len.clamp(0, S - 1)
    inside = ((cur_len >= 0) & (cur_len < S))[None, :, None, None]
    for leaf, new in ((cache.k, k_new), (cache.v, v_new)):
        leaf[:, rows, at] = torch.where(inside, new.to(leaf.dtype), leaf[:, rows, at])
    return cache


def cache_copy_slots(dst: KVCache, src: KVCache, slots) -> KVCache:
    """Copy every row of ``src`` into rows ``slots`` ([B] ids) of ``dst``, in
    place (the serving layer's batched placement, JAX
    ``models/llama.py:252``); both caches dense, or both int8."""
    if cache_is_quantized(dst) != cache_is_quantized(src):
        raise ValueError("cache_copy_slots: one cache is int8 and the other dense")
    slots = torch.as_tensor(slots, dtype=torch.long, device=_leaves(dst)[0].device)
    for d, s in zip(_leaves(dst), _leaves(src)):
        d[:, slots] = s.to(d.dtype)
    return dst


def cache_copy_slot(dst: KVCache, src: KVCache, slot: int, row: int = 0) -> KVCache:
    """Copy row ``row`` of ``src`` into row ``slot`` of ``dst``, in place (the
    serving layer's placement of one request, JAX ``models/llama.py:264``)."""
    if cache_is_quantized(dst) != cache_is_quantized(src):
        raise ValueError("cache_copy_slot: one cache is int8 and the other dense")
    for d, s in zip(_leaves(dst), _leaves(src)):
        d[:, slot].copy_(s[:, row])
    return dst


def _leaves(cache: KVCache) -> list:
    """The cache's tensors: k and v, or their "q" and "s" arrays; every one
    holds its rows on axis 1."""
    return [t for leaf in cache for t in (leaf.values() if isinstance(leaf, dict) else [leaf])]


def cache_map(cache: KVCache, fn) -> KVCache:
    """``fn(leaf, slot_axis)`` over every tensor of the cache: dense leaves
    and int8 "q" hold their slots on axis 2, int8 "s" on axis 3."""
    def one(leaf):
        if isinstance(leaf, dict):
            return {"q": fn(leaf["q"], 2), "s": fn(leaf["s"], 3)}
        return fn(leaf, 2)

    return KVCache(one(cache.k), one(cache.v))


def cache_live(cache: KVCache, n_live: int) -> KVCache:
    """Views of the first ``n_live`` slots of every row: no copy."""
    return cache_map(cache, lambda t, axis: t.narrow(axis, 0, n_live))


def cache_reorder_rows(cache: KVCache, src: np.ndarray, n_live: int) -> None:
    """Row r takes row ``src[r]``'s first ``n_live`` slots, in place (beam
    search's reorder: the JAX package gathers every slot of every row).
    Rows whose source is themselves are not touched, so an identity reorder
    moves nothing; a moved row is one copy a leaf, of whole layer panels,
    and a source that is overwritten too is saved first."""
    moved = [int(r) for r in np.flatnonzero(src != np.arange(len(src)))]
    if not moved:
        return

    def move(t, axis):
        live = t.narrow(axis, 0, n_live)
        saved = {int(src[r]): live[:, src[r]].clone() for r in moved if src[r] in moved}
        for r in moved:
            live[:, r].copy_(saved.get(int(src[r]), live[:, src[r]]))
        return t

    cache_map(cache, move)


def embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def _mm_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ``h @ w`` of two operands in one reduced dtype, fp32 sums.

    A bf16 ``torch.matmul`` rounds its output to bf16; on the card
    ``torch.mm(..., out_dtype=float32)`` keeps the fp32 sums instead, the
    counterpart of the JAX einsum's ``preferred_element_type=float32``.  On
    the CPU, where that overload does not exist, the operands are upcast
    (exact for bf16) at the cost of an fp32 copy of the matrix.
    """
    if w.dtype == torch.float32:
        return h @ w
    flat = h.reshape(-1, h.shape[-1])
    if w.is_cuda:
        y = torch.mm(flat, w, out_dtype=torch.float32)
    else:
        y = flat.float() @ w.float()
    return y.reshape(*h.shape[:-1], w.shape[-1])


def lm_head(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits from operands in the weights' dtype.  A quantized head
    runs in bf16 whatever the activations' dtype, as the JAX package does
    (``models/llama.py:518-529``): int8 with the scale applied to the fp32
    product, int4 through K6 with an fp32 output.  Under tensor parallelism
    each rank computes its vocabulary block and the blocks are gathered, so
    every rank holds the whole logits."""
    return all_gather(_head_block(params["lm_head"], hidden), mesh_of(params))


def _head_block(w, hidden: torch.Tensor) -> torch.Tensor:
    if isinstance(w, dict):
        if "q4" in w:
            x = hidden.to(torch.bfloat16).contiguous()
            return int4_matmul(x, w["q4"], w["s4"], out_dtype=torch.float32)
        y = _mm_f32(hidden.to(torch.bfloat16), w["q"].to(torch.bfloat16))
        return y * w["s"].float()[0]
    return _mm_f32(hidden.to(w.dtype), w)


def _mm(x: torch.Tensor, w, reduce_over=None) -> torch.Tensor:
    """``x @ w`` for dense, int8 {"q", "s"} or packed int4 {"q4", "s4"}
    weights.  int8 multiplies in the activation dtype, rounds to it, then
    applies the per-channel scale in it, as the JAX package does
    (``models/llama.py:375-379``), from a row-major copy whatever the
    leaf's layout (w8a8's is column-major), so that the sums keep their
    order; int4 is K6.  ``reduce_over``: the mesh of a row-parallel
    projection, whose partial sums are all-reduced over the model axis
    before the int8 scale (dot, reduce, scale: GSPMD's order)."""
    if isinstance(w, dict):
        if "q4" in w:
            return int4_matmul(x.contiguous(), w["q4"], w["s4"])
        wq = w["q"].to(x.dtype, memory_format=torch.contiguous_format)
        return all_reduce(x @ wq, reduce_over) * w["s"][0].to(x.dtype)
    return all_reduce(x @ w, reduce_over)


INT_MM_MIN_ROWS = 32  # rows of an int8 product on the card; fewer are zero-padded


def _int_mm(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of int8 [R, D] @ int8 [D, E] (``torch._int_mm``).  On
    the card cuBLASLt refuses 16 rows or fewer (decode has 1-32), so short
    inputs get zero rows, sliced off after: never a float product, whose 24
    bits cannot hold 4096 * 127^2."""
    R = qx.shape[0]
    if qx.is_cuda and R < INT_MM_MIN_ROWS:
        qx = F.pad(qx, (0, 0, 0, INT_MM_MIN_ROWS - R))
        return torch._int_mm(qx, qw)[:R]
    return torch._int_mm(qx, qw)


def _mm_w8a8(x: torch.Tensor, w, reduce_over=None) -> torch.Tensor:
    """``x @ w`` with int8 activations for int8 {"q", "s"} weights (JAX
    ``models/llama.py:538``): the rows quantized per row
    (``quantize_activations``), s8 x s8 -> s32, then ``(y * sx * s)`` in
    fp32, in JAX's order, rounded to x's dtype.  Dense and int4 weights take
    ``_mm`` (int4 is K6, as in JAX).  The product is ``torch._int_mm``: the
    JAX op is plain XLA, not a TPU kernel.  A row-parallel projection
    (``reduce_over``) holds a shard of each row: its scale comes from the
    row max all-reduced over the model axis, and the int32 sums are
    all-reduced before the rescale, as GSPMD reduces a sharded axis."""
    if not isinstance(w, dict) or "q4" in w:
        return _mm(x, w, reduce_over)
    qx, sx = quantize_activations(
        x, None if reduce_over is None else lambda amax: all_reduce(amax, reduce_over, op="max")
    )
    y = _int_mm(qx.reshape(-1, qx.shape[-1]), w["q"]).reshape(*x.shape[:-1], w["q"].shape[-1])
    y = all_reduce(y, reduce_over)
    return (y.float() * sx * w["s"].float()[0]).to(x.dtype)


def _row_parallel(mm, x: torch.Tensor, w, mesh) -> torch.Tensor:
    """A projection back to the residual width (o_proj, down_proj): ``x``
    holds this rank's heads or MLP columns under ``mesh``.  A packed int4
    leaf stays whole (byte d packs rows d and d + D/2, so its rows cannot
    be split): its input is gathered and K6 runs on the whole matrix with
    no reduce; every other leaf multiplies its rows and all-reduces."""
    if mesh is not None and isinstance(w, dict) and "q4" in w:
        return mm(all_gather(x, mesh), w)
    return mm(x, w, mesh)


def _mlp(lp: dict, x: torch.Tensor, mm=_mm, mesh=None) -> torch.Tensor:
    if "gate_up_proj" in lp:
        gate, up = mm(x, lp["gate_up_proj"]).chunk(2, dim=-1)
    else:
        gate, up = mm(x, lp["gate_proj"]), mm(x, lp["up_proj"])
    return _row_parallel(mm, F.silu(gate) * up, lp["down_proj"], mesh)


def _qkv(lp: dict, h: torch.Tensor, H: int, KH: int, Dh: int, mm=_mm):
    """q/k/v projections, from the fused "qkv_proj" leaf when present (one
    matmul, the output sliced at head-aligned offsets)."""
    lead = h.shape[:-1]
    if "qkv_proj" in lp:
        q, k, v = mm(h, lp["qkv_proj"]).split([H * Dh, KH * Dh, KH * Dh], dim=-1)
    else:
        q, k, v = mm(h, lp["q_proj"]), mm(h, lp["k_proj"]), mm(h, lp["v_proj"])
    return q.reshape(*lead, H, Dh), k.reshape(*lead, KH, Dh), v.reshape(*lead, KH, Dh)


def _layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of the stacked params; a quantized leaf indexes each of
    its arrays."""
    return {
        k: {n: a[i] for n, a in v.items()} if isinstance(v, dict) else v[i]
        for k, v in layers.items()
    }


def _forward(params: dict, cfg: LlamaConfig, x: torch.Tensor, cos, sin, attend, keep_kv=True,
             w8a8=False, mesh=None):
    """The decoder's layer loop over activations ``x`` [B, R, D] with rope
    tables ``cos`` / ``sin`` that broadcast against [B, R, heads, Dh];
    ``attend(i, q, k, v)`` is layer ``i``'s attention; ``w8a8`` runs the
    projections through ``_mm_w8a8``.  Returns (final-norm hidden, every
    layer's k and v stacked [L, B, R, KH, Dh]), or with ``keep_kv`` off
    (hidden, None): each layer's K/V is then dropped once its attention has
    read it.  Under ``mesh`` (tensor parallelism) q/k/v hold this rank's
    heads and each layer makes its two all-reduces (``_row_parallel``)."""
    mm = _mm_w8a8 if w8a8 else _mm
    H, KH = local_heads(cfg, mesh)
    Dh = cfg.head_dim
    layers = params["layers"]
    B, R, _ = x.shape
    ks, vs = [], []
    for i in range(layers["input_ln"].shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, h, H, KH, Dh, mm)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attend(i, q, k, v)
        x = x + _row_parallel(mm, attn.reshape(B, R, H * Dh), lp["o_proj"], mesh)
        x = x + _mlp(lp, rms_norm(x, lp["post_attn_ln"], cfg.rms_norm_eps), mm, mesh)
        if keep_kv:
            ks.append(k)
            vs.append(v)
    hidden = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return hidden, (KVCache(torch.stack(ks), torch.stack(vs)) if keep_kv else None)


def _rope_tables(positions: torch.Tensor, cfg: LlamaConfig):
    """cos / sin [B, S, 1, Dh] for positions [B, S]."""
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    return cos[:, :, None, :], sin[:, :, None, :]


def _prefill(params, cfg, inputs_embeds, positions, key_mask, keep_kv, w8a8):
    def attend(i, q, k, v):
        return flash_prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), key_mask, causal=True
        )

    return _forward(params, cfg, inputs_embeds, *_rope_tables(positions, cfg), attend, keep_kv,
                    w8a8, mesh_of(params))


def prefill(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    w8a8: bool = False,
):
    """Full-sequence causal forward.

    Attention runs K5, the flash prefill kernel (``ops/cuda_flash_prefill.py``),
    at every length: LLaVA-1.5's ~600 tokens as LLaVA-NeXT's ~2.9k (the JAX
    package switches to its kernel at 1024 tokens, ``models/llama.py:677-689``,
    a TPU choice).  On the CPU K5's wrapper computes its query-chunked twin.

    Args:
      inputs_embeds: [B, S, D] merged (visual + text) embeddings.
      positions: [B, S] rope positions.
      key_mask: optional [B, S] padding mask (1 = real token).
      w8a8: int8 activations for int8 projections (``_mm_w8a8``).
    Returns:
      (hidden [B, S, D] final-norm output, KVCache of [L, B, S, KH, Dh]).
    """
    return _prefill(params, cfg, inputs_embeds, positions, key_mask, True, w8a8)


def prefill_hidden(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    w8a8: bool = False,
) -> torch.Tensor:
    """``prefill``'s final-norm hidden states [B, S, D] alone, for callers
    that read no cache (the probe): no layer's K/V outlives its attention,
    where ``prefill`` would stack L x B x S x KH x Dh twice (3.1 GB at
    LLaVA-NeXT's 8 x 2.95k tokens in bf16)."""
    return _prefill(params, cfg, inputs_embeds, positions, key_mask, False, w8a8)[0]


def prefill_extend(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    prefix: KVCache,
    w8a8: bool = False,
    prefix_mask: torch.Tensor | None = None,
):
    """Continued causal prefill over a cached prefix (JAX
    ``models/llama.py:728``): T new tokens attend the whole prefix and
    causally themselves, which equals the tail rows of one prefill of
    [prefix + tail] (causal attention factorizes).

    Args:
      inputs_embeds: [B, T, D] tail embeddings.
      positions: [B, T] absolute rope positions (the prefix's real length
        + arange(T)).
      prefix: KVCache with dense leaves [L, Bp, P, KH, Dh], or int8 reader
        leaves ``{"q": [L, Bp, P, KH*Dh], "s": [L, Bp, KH, P]}``
        (``kv_int8_reader_layout``); Bp in {1, B}, Bp = 1 shared by every row
        without a copy.
      prefix_mask: optional [Bp, P] bool, False = a pad slot of the prefix.
      w8a8: int8 activations for int8 projections (``_mm_w8a8``).
    Returns:
      (hidden [B, T, D] final-norm output, the tail's KVCache [L, B, T, KH, Dh]).
    """
    mesh = mesh_of(params)
    KH, Dh = local_heads(cfg, mesh)[1], cfg.head_dim
    pk, pv = prefix
    if cache_is_quantized(prefix):
        Bp, P = pk["q"].shape[1:3]

        def attend(i, q, k, v):
            with trace.span("extend.attention"):
                return extend_attention_int8prefix(
                    q, k, v, pk["q"][i].view(Bp, P, KH, Dh), pk["s"][i],
                    pv["q"][i].view(Bp, P, KH, Dh), pv["s"][i], prefix_mask,
                )
    else:
        def attend(i, q, k, v):
            with trace.span("extend.attention"):
                return extend_attention(q, k, v, pk[i], pv[i], prefix_mask)

    return _forward(params, cfg, inputs_embeds, *_rope_tables(positions, cfg), attend,
                    w8a8=w8a8, mesh=mesh)


def kv_int8_reader_layout(x: torch.Tensor) -> dict:
    """A dense K or V span [..., S, KH, D] quantized per (token, head) into
    the int8 cache's reader layout (JAX ``models/llama.py:136``):
    ``{"q": int8 [..., S, KH*D], "s": f32 [..., KH, S]}`` with head-major
    scales, what ``prefill_extend`` reads as an int8 prefix."""
    d = quantize_kv(x)
    return {"q": d["q"].flatten(-2), "s": d["s"][..., 0].transpose(-1, -2).contiguous()}


def decode_step(
    params: dict,
    cfg: LlamaConfig,
    x: torch.Tensor,
    position: torch.Tensor,
    cache: KVCache,
    key_mask: torch.Tensor,
    tp_mesh=None,
    w8a8: bool = False,
):
    """One-token forward for M ensemble members sharing the cache.

    Args:
      x: [B, M, D] current-token embeddings (the same token for every
        member; members differ only in their key masks).
      position: [B] rope position of the current token.
      cache: KVCache, dense or int8, read only.
      key_mask: [B, M, Smax] bool, True = attend that cache slot.
      tp_mesh: the mesh of TP-sharded params (``parallel/mesh.py``); found
        from the params when not given.  The cache and k/v then hold this
        rank's heads (G = H / KH is unchanged), which K1 / K3 read as they
        read a whole cache.
      w8a8: int8 activations for int8 projections (``_mm_w8a8``): the
        decode rows are B x M.
    Returns:
      (hidden [B, M, D], k_new [L, B, M, KH, Dh], v_new [L, B, M, KH, Dh])
    """
    mesh = tp_mesh if tp_mesh is not None else mesh_of(params)
    B = x.shape[0]
    KH, Dh = local_heads(cfg, mesh)[1], cfg.head_dim
    cos, sin = rotary_embedding(position, Dh, cfg.rope_theta)
    cos, sin = cos[:, None, None, :], sin[:, None, None, :]
    key_mask = key_mask.contiguous()
    if cache_is_quantized(cache):  # K3 on the layer's views of the int8 leaves
        Smax = cache.k["q"].shape[2]

        def attend(i, q, k, v):
            kc, vc = cache.k, cache.v
            return ensemble_decode_attention_int8kv_fused(
                q, kc["q"][i].view(B, Smax, KH, Dh), kc["s"][i],
                vc["q"][i].view(B, Smax, KH, Dh), vc["s"][i], k, v.contiguous(), key_mask,
            )
    else:  # K1 on the layer's views of the dense cache
        def attend(i, q, k, v):
            return ensemble_decode_attention_fused(
                q, cache.k[i], cache.v[i], k, v.contiguous(), key_mask
            )

    hidden, kv = _forward(params, cfg, x, cos, sin, attend, w8a8=w8a8, mesh=mesh)
    return hidden, kv.k, kv.v


def attention_with_probs(q, k_new, v_new, kc, vc, key_mask, ksc=None, vsc=None):
    """One token's attention over a cache and its own key, with the
    probabilities: ``decode_step_attn``'s, plain torch (K1 gives none).

    Args:
      q: [B, H, Dh]; k_new, v_new: [B, KH, Dh] the token's own K/V.
      kc, vc: [B, S, KH, Dh] the cache (int8 values under ``ksc`` / ``vsc``,
        the per-(slot, head) scales [B, KH, S]).
      key_mask: [B, S] bool, True = attend.
    Returns:
      (out [B, H, Dh] in q's dtype, probs [B, KH, G, S] fp32 over the cache
      slots; the own token's share is in the softmax, not in ``probs``).
    """
    B, H, Dh = q.shape
    KH = kc.shape[2]
    dt = q.dtype
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, KH, H // KH, Dh).float()  # head h reads kv head h // G
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kc.float()) * scale
    if ksc is not None:
        scores = scores * ksc[:, :, None, :]
    scores = scores.masked_fill(~key_mask[:, None, None, :], -1e30)
    self_s = torch.einsum("bkgd,bkd->bkg", qg, k_new.float()) * scale
    m = torch.maximum(scores.amax(-1), self_s)
    e = torch.exp(scores - m[..., None])
    e_self = torch.exp(self_s - m)
    denom = e.sum(-1) + e_self
    probs = e / denom[..., None]
    pv = probs.to(dt)
    if vsc is not None:
        pv = pv * vsc[:, :, None, :].to(dt)
    out = torch.einsum("bkgs,bskd->bkgd", pv, vc.to(dt))
    out = out + (e_self / denom).to(dt)[..., None] * v_new[:, :, None, :]
    return out.reshape(B, H, Dh), probs


def decode_step_attn(
    params: dict,
    cfg: LlamaConfig,
    x: torch.Tensor,
    position: torch.Tensor,
    cache: KVCache,
    key_mask: torch.Tensor,
):
    """One-token forward over B rows that also returns the token's
    attention probabilities, OPERA's capture (JAX ``models/llama.py:1088``).

    Plain torch, as the JAX function is plain XLA (``attention_with_probs``):
    fp32 scores of the cache slots and of the token's own key in one
    softmax, k-scales on the scores and v-scales on the probabilities of an
    int8 cache.  Projections go through ``_mm`` (K6 on int4 weights).
    ``params`` is an argument, never captured.

    Args:
      x: [B, D] current-token embeddings (B = beams x attention candidates).
      position: [B] rope position of the current token.
      cache: KVCache, dense [L, B, S, KH, Dh] or int8; read only.  S may be
        a prefix of the allocation (``cache_live``).
      key_mask: [B, S] bool, True = attend that slot.
    Returns:
      (hidden [B, D], k_new [L, B, KH, Dh], v_new [L, B, KH, Dh],
       attn [B, S]): attn is the last layer's head-mean probabilities over
      the cache slots (the self column is in the softmax, not in the row).
      Under tensor parallelism the mean is over every head: each rank's
      sum over its heads, all-reduced, over the global head count.
    """
    mesh = mesh_of(params)
    KH, Dh = local_heads(cfg, mesh)[1], cfg.head_dim
    L = params["layers"]["input_ln"].shape[0]
    cos, sin = rotary_embedding(position, Dh, cfg.rope_theta)
    cos, sin = cos[:, None, None, :], sin[:, None, None, :]
    last = []

    def attend(i, q, k, v):
        if cache_is_quantized(cache):
            kc, vc = (cache.k["q"][i].unflatten(-1, (KH, Dh)),
                      cache.v["q"][i].unflatten(-1, (KH, Dh)))
            scales = cache.k["s"][i], cache.v["s"][i]
        else:
            kc, vc, scales = cache.k[i], cache.v[i], (None, None)
        out, probs = attention_with_probs(q[:, 0], k[:, 0], v[:, 0], kc, vc, key_mask, *scales)
        if i == L - 1:
            if mesh is None:
                last.append(probs.mean(dim=(1, 2)))
            else:
                last.append(all_reduce(probs.sum(dim=(1, 2)), mesh) / cfg.num_attention_heads)
        return out[:, None]

    hidden, kv = _forward(params, cfg, x[:, None], cos, sin, attend, mesh=mesh)
    return hidden[:, 0], kv.k[:, :, 0], kv.v[:, :, 0], last[0]
