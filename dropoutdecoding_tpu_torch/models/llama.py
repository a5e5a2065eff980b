"""Llama-family decoder (Vicuna-7B, Mistral-7B) as functions over a parameter
dict; port of ``dropoutdecoding_tpu/models/llama.py``.

- ``prefill``: full-sequence causal forward; returns the final-norm hidden
  states and every layer's K/V to seed the cache.  From 1024 tokens on its
  attention is K5 (``ops/cuda_flash_prefill.py``).
- ``decode_step``: one token for M ensemble members sharing the cache.  Each
  layer's attention reads the layer's view of the cache in place: K1 over a
  dense cache, K3 over an int8 one (``ops/cuda_decode_attention.py``).
  Returns each member's new-token K/V (unquantized) so the engine appends
  only the vote winner's.

Weights are in the JAX layout: ``x @ W`` with W [in, out], layers stacked
on a leading [L] axis; a projection may be dense, int8 {"q", "s"} or
packed int4 {"q4", "s4"} (``utils/quantize.py``), and q/k/v and gate/up may
be fused into one leaf each (``fuse_projections``).  An int4 projection
runs K6 (``ops/cuda_int4_matmul.py``) on the layer's view of the stacked
weight; no dequantized matrix is made.  Logits are fp32.

Unlike the JAX package, the cache is updated in place: ``cache_seed`` and
``cache_set_rows`` write into the KVCache's tensors and return it.  On an
int8 cache ``cache_set_rows`` is K4 (``ops/cuda_cache_append.py``).

Not ported yet (each raises ``NotImplementedError``): w8a8 projections
(ROADMAP Queue 1 item 12) and tensor parallelism (Queue 1 item 16).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.attention import prefill_attention
from ..ops.basic import apply_rope, rms_norm, rotary_embedding
from ..ops.cuda_cache_append import cache_append_int8
from ..ops.cuda_decode_attention import (
    ensemble_decode_attention_fused,
    ensemble_decode_attention_int8kv_fused,
)
from ..ops.cuda_flash_prefill import flash_prefill_attention
from ..ops.cuda_int4_matmul import int4_matmul
from ..utils.config import LlamaConfig
from ..utils.quantize import quantize_kv

_W8A8 = "w8a8 projections are not ported yet (ROADMAP Queue 1 item 12)"
LONG_PREFILL = 1024  # prefill length from which attention runs K5


class KVCache(NamedTuple):
    """The canonical cache.  Dense: k and v are [L, B, Smax, KH, D] each.
    int8 (the JAX package's leaf layout): k and v are each
    {"q": int8 [L, B, Smax, KH*D], "s": f32 [L, B, KH, Smax]}, the scales
    head-major so that a (row, head)'s scales are contiguous."""

    k: torch.Tensor | dict
    v: torch.Tensor | dict


def empty_cache(
    cfg: LlamaConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype,
    device: torch.device | str,
    quantized: bool = False,
) -> KVCache:
    """Allocate the canonical cache; the int8 layout when ``quantized``,
    with scales 1 so that untouched slots dequantize to 0."""
    L, KH, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
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


def cache_seed(cache: KVCache, kv: KVCache) -> KVCache:
    """Write the prefill K/V ([L, B, S0, KH, D], dense) at slot 0, in place;
    quantized per (token, head) for an int8 cache."""
    S0 = kv.k.shape[2]
    kn, vn = _quantize_new(cache, kv.k, kv.v)
    for leaf, new in ((cache.k, kn), (cache.v, vn)):
        if isinstance(leaf, dict):
            leaf["q"][:, :, :S0] = new["q"]
            leaf["s"][..., :S0] = new["s"][..., 0].transpose(2, 3)  # [L, B, KH, S0]
        else:
            leaf[:, :, :S0] = new
    return cache


def cache_set_rows(
    cache: KVCache, cur_len: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor
) -> KVCache:
    """Write each row's new-token K/V ([L, B, KH, D], dense) at slot
    ``cur_len[b]``, in place (the engine's per-step append of the vote
    winner's K/V); on an int8 cache, quantized by K4 in one launch."""
    if cache_is_quantized(cache):
        cache_append_int8(
            cache.k["q"], cache.k["s"], cache.v["q"], cache.v["s"], cur_len,
            k_new.contiguous(), v_new.contiguous(),
        )
        return cache
    rows = torch.arange(k_new.shape[1], device=cur_len.device)
    cache.k[:, rows, cur_len] = k_new.to(cache.k.dtype)
    cache.v[:, rows, cur_len] = v_new.to(cache.v.dtype)
    return cache


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
    product, int4 through K6 with an fp32 output."""
    w = params["lm_head"]
    if isinstance(w, dict):
        if "q4" in w:
            x = hidden.to(torch.bfloat16).contiguous()
            return int4_matmul(x, w["q4"], w["s4"], out_dtype=torch.float32)
        y = _mm_f32(hidden.to(torch.bfloat16), w["q"].to(torch.bfloat16))
        return y * w["s"].float()[0]
    return _mm_f32(hidden.to(w.dtype), w)


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for dense, int8 {"q", "s"} or packed int4 {"q4", "s4"}
    weights.  int8 multiplies in the activation dtype, rounds to it, then
    applies the per-channel scale in it, as the JAX package does
    (``models/llama.py:375-379``); int4 is K6."""
    if isinstance(w, dict):
        if "q4" in w:
            return int4_matmul(x.contiguous(), w["q4"], w["s4"])
        return (x @ w["q"].to(x.dtype)) * w["s"][0].to(x.dtype)
    return x @ w


def _mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    if "gate_up_proj" in lp:
        gate, up = _mm(x, lp["gate_up_proj"]).chunk(2, dim=-1)
    else:
        gate, up = _mm(x, lp["gate_proj"]), _mm(x, lp["up_proj"])
    return _mm(F.silu(gate) * up, lp["down_proj"])


def _qkv(lp: dict, h: torch.Tensor, H: int, KH: int, Dh: int):
    """q/k/v projections, from the fused "qkv_proj" leaf when present (one
    matmul, the output sliced at head-aligned offsets)."""
    lead = h.shape[:-1]
    if "qkv_proj" in lp:
        q, k, v = _mm(h, lp["qkv_proj"]).split([H * Dh, KH * Dh, KH * Dh], dim=-1)
    else:
        q, k, v = _mm(h, lp["q_proj"]), _mm(h, lp["k_proj"]), _mm(h, lp["v_proj"])
    return q.reshape(*lead, H, Dh), k.reshape(*lead, KH, Dh), v.reshape(*lead, KH, Dh)


def _layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of the stacked params; a quantized leaf indexes each of
    its arrays."""
    return {
        k: {n: a[i] for n, a in v.items()} if isinstance(v, dict) else v[i]
        for k, v in layers.items()
    }


def prefill(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    w8a8: bool = False,
):
    """Full-sequence causal forward.

    Attention is dense below ``LONG_PREFILL`` tokens (LLaVA-1.5's ~600) and
    runs K5, the flash prefill kernel (``ops/cuda_flash_prefill.py``), from
    there on (LLaVA-NeXT's ~2.9k), as the JAX package does
    (``models/llama.py:677-689``); on the CPU K5's wrapper computes its
    query-chunked twin.

    Args:
      inputs_embeds: [B, S, D] merged (visual + text) embeddings.
      positions: [B, S] rope positions.
      key_mask: optional [B, S] padding mask (1 = real token).
    Returns:
      (hidden [B, S, D] final-norm output, KVCache of [L, B, S, KH, Dh]).
    """
    if w8a8:
        raise NotImplementedError(_W8A8)
    B, S, _ = inputs_embeds.shape
    H, KH, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    cos, sin = rotary_embedding(positions, Dh, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    layers = params["layers"]
    x = inputs_embeds
    ks, vs = [], []
    for i in range(layers["input_ln"].shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, h, H, KH, Dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if S >= LONG_PREFILL:
            attn = flash_prefill_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), key_mask, causal=True
            )
        else:
            attn = prefill_attention(q, k, v, causal=True, key_mask=key_mask)
        x = x + _mm(attn.reshape(B, S, H * Dh), lp["o_proj"])
        x = x + _mlp(lp, rms_norm(x, lp["post_attn_ln"], cfg.rms_norm_eps))
        ks.append(k)
        vs.append(v)
    hidden = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return hidden, KVCache(torch.stack(ks), torch.stack(vs))


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
    Returns:
      (hidden [B, M, D], k_new [L, B, M, KH, Dh], v_new [L, B, M, KH, Dh])
    """
    if tp_mesh is not None:
        raise NotImplementedError("tensor parallelism is not ported yet (ROADMAP Queue 1 item 16)")
    if w8a8:
        raise NotImplementedError(_W8A8)
    B, M, _ = x.shape
    H, KH, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    cos, sin = rotary_embedding(position, Dh, cfg.rope_theta)
    cos, sin = cos[:, None, None, :], sin[:, None, None, :]
    key_mask = key_mask.contiguous()
    layers = params["layers"]
    if cache_is_quantized(cache):  # K3 on the layer's views of the int8 leaves
        L, _, Smax, _ = cache.k["q"].shape

        def attend(i, q, k, v):
            kc, vc = cache.k, cache.v
            return ensemble_decode_attention_int8kv_fused(
                q, kc["q"][i].view(B, Smax, KH, Dh), kc["s"][i],
                vc["q"][i].view(B, Smax, KH, Dh), vc["s"][i], k, v, key_mask,
            )
    else:  # K1 on the layer's views of the dense cache
        L = cache.k.shape[0]

        def attend(i, q, k, v):
            return ensemble_decode_attention_fused(q, cache.k[i], cache.v[i], k, v, key_mask)

    ks, vs = [], []
    for i in range(L):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, h, H, KH, Dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        v = v.contiguous()
        attn = attend(i, q, k, v)
        x = x + _mm(attn.reshape(B, M, H * Dh), lp["o_proj"])
        x = x + _mlp(lp, rms_norm(x, lp["post_attn_ln"], cfg.rms_norm_eps))
        ks.append(k)
        vs.append(v)
    hidden = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return hidden, torch.stack(ks), torch.stack(vs)
