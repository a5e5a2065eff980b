"""Llama-family decoder (Llama-7B / Vicuna-7B) as functions over a parameter
dict; port of ``dropoutdecoding_tpu/models/llama.py``, dense bf16/fp32 only.

- ``prefill``: full-sequence causal forward; returns the final-norm hidden
  states and every layer's K/V to seed the cache.
- ``decode_step``: one token for M ensemble members sharing the cache.  Each
  layer's attention is K1 (``ops/cuda_decode_attention.py``), reading the
  layer's view of the cache in place.  Returns each member's new-token K/V
  so the engine appends only the vote winner's.

Weights are in the JAX layout: ``x @ W`` with W [in, out], layers stacked
on a leading [L] axis.  Logits are fp32.

Unlike the JAX package, the cache is updated in place: ``cache_seed`` and
``cache_set_rows`` write into the KVCache's tensors and return it.

Not ported yet (each raises ``NotImplementedError``): int8 and int4
weights, the int8 KV cache (ROADMAP Queue 1 item 12, kernels K3, K4, K6),
w8a8 projections, the fused qkv / gate_up projection leaves, and tensor
parallelism (Queue 1 item 16).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.attention import prefill_attention
from ..ops.basic import apply_rope, rms_norm, rotary_embedding
from ..ops.cuda_decode_attention import ensemble_decode_attention_fused
from ..utils.config import LlamaConfig

_QUANTIZED = "quantized weights (int8 / int4) are not ported yet (ROADMAP Queue 1 item 12)"
_FUSED_LEAVES = "fused qkv / gate_up projection leaves are not ported yet (ROADMAP Queue 1 item 12)"


class KVCache(NamedTuple):
    """Dense canonical cache: k and v are [L, B, Smax, KH, D] each."""

    k: torch.Tensor
    v: torch.Tensor


def empty_cache(
    cfg: LlamaConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype,
    device: torch.device | str,
    quantized: bool = False,
) -> KVCache:
    if quantized:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP Queue 1 item 12, kernels K3/K4)"
        )
    shape = (
        cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim
    )
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def cache_seed(cache: KVCache, kv: KVCache) -> KVCache:
    """Write the prefill K/V ([L, B, S0, KH, D]) at slot 0, in place."""
    S0 = kv.k.shape[2]
    cache.k[:, :, :S0] = kv.k
    cache.v[:, :, :S0] = kv.v
    return cache


def cache_set_rows(
    cache: KVCache, cur_len: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor
) -> KVCache:
    """Write each row's new-token K/V ([L, B, KH, D]) at slot ``cur_len[b]``,
    in place (the engine's per-step append of the vote winner's K/V)."""
    rows = torch.arange(k_new.shape[1], device=cur_len.device)
    cache.k[:, rows, cur_len] = k_new.to(cache.k.dtype)
    cache.v[:, rows, cur_len] = v_new.to(cache.v.dtype)
    return cache


def embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def lm_head(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits from operands in the weights' dtype.

    A bf16 ``torch.matmul`` rounds its output to bf16; on the card
    ``torch.mm(..., out_dtype=float32)`` keeps the fp32 sums instead, the
    counterpart of the JAX einsum's ``preferred_element_type=float32``.  On
    the CPU, where that overload does not exist, the operands are upcast
    (exact for bf16) at the cost of an fp32 copy of the matrix.
    """
    w = params["lm_head"]
    if isinstance(w, dict):
        raise NotImplementedError(_QUANTIZED)
    h = hidden.to(w.dtype)
    if w.dtype == torch.float32:
        return h @ w
    flat = h.reshape(-1, h.shape[-1])
    if w.is_cuda:
        y = torch.mm(flat, w, out_dtype=torch.float32)
    else:
        y = flat.float() @ w.float()
    return y.reshape(*h.shape[:-1], w.shape[-1])


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    if isinstance(w, dict):
        raise NotImplementedError(_QUANTIZED)
    return x @ w


def _mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    if "gate_up_proj" in lp:
        raise NotImplementedError(_FUSED_LEAVES)
    return _mm(F.silu(_mm(x, lp["gate_proj"])) * _mm(x, lp["up_proj"]), lp["down_proj"])


def _qkv(lp: dict, h: torch.Tensor, H: int, KH: int, Dh: int):
    if "qkv_proj" in lp:
        raise NotImplementedError(_FUSED_LEAVES)
    lead = h.shape[:-1]
    return (
        _mm(h, lp["q_proj"]).reshape(*lead, H, Dh),
        _mm(h, lp["k_proj"]).reshape(*lead, KH, Dh),
        _mm(h, lp["v_proj"]).reshape(*lead, KH, Dh),
    )


def _layer(layers: dict, i: int) -> dict:
    return {k: v[i] for k, v in layers.items()}


def prefill(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    w8a8: bool = False,
):
    """Full-sequence causal forward.

    Dense attention at every length: the JAX package switches to a flash
    kernel (K5) at S >= 1024, i.e. LLaVA-NeXT, which is not ported yet.

    Args:
      inputs_embeds: [B, S, D] merged (visual + text) embeddings.
      positions: [B, S] rope positions.
      key_mask: optional [B, S] padding mask (1 = real token).
    Returns:
      (hidden [B, S, D] final-norm output, KVCache of [L, B, S, KH, Dh]).
    """
    if w8a8:
        raise NotImplementedError("w8a8 projections are not ported yet (ROADMAP Queue 1 item 12)")
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
      cache: KVCache of [L, B, Smax, KH, Dh], read only.
      key_mask: [B, M, Smax] bool, True = attend that cache slot.
    Returns:
      (hidden [B, M, D], k_new [L, B, M, KH, Dh], v_new [L, B, M, KH, Dh])
    """
    if tp_mesh is not None:
        raise NotImplementedError("tensor parallelism is not ported yet (ROADMAP Queue 1 item 16)")
    if w8a8:
        raise NotImplementedError("w8a8 projections are not ported yet (ROADMAP Queue 1 item 12)")
    B, M, _ = x.shape
    H, KH, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    cos, sin = rotary_embedding(position, Dh, cfg.rope_theta)
    cos, sin = cos[:, None, None, :], sin[:, None, None, :]
    key_mask = key_mask.contiguous()
    layers = params["layers"]
    ks, vs = [], []
    for i in range(cache.k.shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, h, H, KH, Dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        v = v.contiguous()
        attn = ensemble_decode_attention_fused(
            q, cache.k[i], cache.v[i], k, v, key_mask
        )
        x = x + _mm(attn.reshape(B, M, H * Dh), lp["o_proj"])
        x = x + _mlp(lp, rms_norm(x, lp["post_attn_ln"], cfg.rms_norm_eps))
        ks.append(k)
        vs.append(v)
    hidden = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return hidden, torch.stack(ks), torch.stack(vs)
