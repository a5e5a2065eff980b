"""DeepSeek-V3-style decoder: multi-head latent attention (MLA) and
sigmoid-routed experts (Kimi-VL-A3B's language model), as functions over a
parameter dict with the entry points ``models/llama.py`` gives the engines:
``embed``, ``prefill``, ``prefill_hidden``, ``decode_step``, ``lm_head``,
``empty_cache``, ``cache_seed`` and ``cache_set_rows`` (the winner's
append).  The JAX package has no such decoder; the equations are those of
the published DeepseekV3 modeling code (``MlaMoeConfig``):

- attention: ``q = x Wq`` split [nope 128 | rope 64] a head (no q-LoRA);
  ``[c | k_pe] = x W_kv_a``, ``c = RMSNorm(c)`` (eps 1e-6, the module's
  default); ``[k_nope | v] = c W_kv_b`` a head; RoPE on ``q_pe`` and on the
  one ``k_pe`` every head shares, with the published pairing (the rotary
  dims de-interleaved, then rotated by halves); softmax scale
  ``(nope + rope)^-0.5``; ``o_proj``.
- MLP: the first ``first_k_dense_replace`` layers a SiLU-gated MLP; every
  other layer routes: fp32 router logits, ``s = sigmoid``, the top-k of
  ``s + e_score_correction_bias``, weights ``s[idx] / (sum + 1e-20) *
  routed_scaling_factor``, the chosen experts' SwiGLU outputs summed with
  those weights in fp32, plus the shared experts' MLP.

The cache (``LatentCache``) holds, a layer, a token's normalised latent and
its roped key, ``kv_lora_rank + qk_rope_head_dim`` = 576 values (1,152 bytes
in bf16) against Mistral's 4,096.  The prefill attends in the decompressed
form (k_nope and v from the latent); ``decode_step`` in the absorbed form:
``q_nope W_uk`` makes each head's query 512 + 64 wide against the cache's
rows, one key "head" that the 16 query heads share, and ``W_uv`` maps the
latent output back; each member reads the cache under its own key mask and
its own new row.  Decode attention is plain torch (bmm with fp32 sums).

The routed experts of a decode forward run K7 (``ops/cuda_moe.py``) over
the rows sorted by expert: the routing, the sort and the expert offsets
stay on the device (``route``, ``sort_by_expert``), so the forward has
fixed shapes, reads nothing back and replays from a CUDA graph
(``engine/decode_graphs.py``).  The prefill runs each expert's products
eagerly over its group (one host read of the group sizes a layer), inside a
``prefill.moe`` span.

What this decoder does not run raises ``ValueError``: tensor parallelism,
the int8 / int4 weight tiers, an int8 KV cache, w8a8, LLaVA-NeXT's anyres
engine, speculation, the chunked and prefix-cache prefills, the decode
server and the baselines (VCD, beam search, OPERA).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..engine import trace
from ..ops.attention import prefill_attention
from ..ops.basic import apply_rope, rms_norm, rotary_embedding
from ..ops.cuda_moe import moe_experts
from ..utils.config import MlaMoeConfig
from ..utils.hf_io import hf_leaf
from .llama import _mm_f32

KV_A_NORM_EPS = 1e-6  # DeepseekV3RMSNorm's default, which kv_a_layernorm keeps
ROUTE_EPS = 1e-20  # the published router's denominator guard


class LatentCache(NamedTuple):
    """[L, B, Smax, kv_lora_rank + qk_rope_head_dim]: a slot's normalised
    latent, then its roped key."""

    ckv: torch.Tensor


def unsupported(what: str) -> ValueError:
    return ValueError(f"{what} is not supported with the MLA + MoE decoder (models/mla_moe.py)")


# --- parameters ---------------------------------------------------------------


def _hf_stack(sd, names, dtype, device, transpose=False):
    return torch.stack([hf_leaf(sd, n, dtype, device, transpose) for n in names])


def params_from_hf(cfg: MlaMoeConfig, sd: dict, dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = "cuda", prefix: str = "") -> dict:
    """An HF DeepseekV3ForCausalLM state dict (the published module names:
    ``self_attn.q_proj``, ``kv_a_proj_with_mqa``, ``kv_a_layernorm``,
    ``kv_b_proj``, ``o_proj``, ``mlp.gate.weight``,
    ``mlp.gate.e_score_correction_bias``, ``mlp.experts.{j}.*``,
    ``mlp.shared_experts.*``) -> the decoder's params on ``device``: linear
    weights [out, in] -> [in, out], layers stacked, experts stacked on an
    axis after the layer's; the router's bias in fp32."""
    L, Ld = cfg.num_hidden_layers, cfg.first_k_dense_replace
    base = f"{prefix}model.layers"

    def stack(fmt, layers, transpose=False):
        return _hf_stack(sd, [f"{base}.{i}.{fmt}" for i in layers], dtype, device, transpose)

    def experts(name):
        return torch.stack([
            _hf_stack(sd, [f"{base}.{i}.mlp.experts.{j}.{name}.weight"
                           for j in range(cfg.n_routed_experts)], dtype, device, True)
            for i in range(Ld, L)
        ])

    dense, moe = range(Ld), range(Ld, L)
    head = prefix + "lm_head.weight"
    if head not in sd:  # tied embeddings
        head = prefix + "model.embed_tokens.weight"
    return {
        "embed_tokens": hf_leaf(sd, prefix + "model.embed_tokens.weight", dtype, device),
        "layers": {
            "input_ln": stack("input_layernorm.weight", range(L)),
            "post_attn_ln": stack("post_attention_layernorm.weight", range(L)),
            "q_proj": stack("self_attn.q_proj.weight", range(L), True),
            "kv_a_proj": stack("self_attn.kv_a_proj_with_mqa.weight", range(L), True),
            "kv_a_ln": stack("self_attn.kv_a_layernorm.weight", range(L)),
            "kv_b_proj": stack("self_attn.kv_b_proj.weight", range(L), True),
            "o_proj": stack("self_attn.o_proj.weight", range(L), True),
        },
        "dense": {
            "gate_proj": stack("mlp.gate_proj.weight", dense, True),
            "up_proj": stack("mlp.up_proj.weight", dense, True),
            "down_proj": stack("mlp.down_proj.weight", dense, True),
        },
        "moe": {
            "router": stack("mlp.gate.weight", moe, True),
            "router_bias": _hf_stack(sd, [f"{base}.{i}.mlp.gate.e_score_correction_bias" for i in moe],
                                     torch.float32, device),
            "gate_proj": experts("gate_proj"),
            "up_proj": experts("up_proj"),
            "down_proj": experts("down_proj"),
            "shared_gate_proj": stack("mlp.shared_experts.gate_proj.weight", moe, True),
            "shared_up_proj": stack("mlp.shared_experts.up_proj.weight", moe, True),
            "shared_down_proj": stack("mlp.shared_experts.down_proj.weight", moe, True),
        },
        "norm": hf_leaf(sd, prefix + "model.norm.weight", dtype, device),
        "lm_head": hf_leaf(sd, head, dtype, device, transpose=True),
    }


def check_params(params: dict) -> None:
    """Raises on a tree this decoder cannot run: quantized leaves (the int8 /
    int4 tiers) or a tensor-parallel cut (the engine calls it at
    construction)."""
    from ..parallel.mesh import mesh_of

    if mesh_of(params) is not None:
        raise unsupported("tensor parallelism")
    if isinstance(params["lm_head"], dict) or isinstance(params["layers"]["q_proj"], dict):
        raise unsupported("an int8 / int4 weight tier")


# --- the cache ------------------------------------------------------------------


def empty_cache(cfg: MlaMoeConfig, batch: int, max_len: int, dtype: torch.dtype,
                device: torch.device | str, quantized: bool = False, tp_mesh=None) -> LatentCache:
    """A zero latent cache; ``quantized`` (an int8 KV cache) and ``tp_mesh``
    raise: this decoder has neither."""
    if quantized:
        raise unsupported("an int8 KV cache")
    if tp_mesh is not None:
        raise unsupported("tensor parallelism")
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.latent_dim)
    return LatentCache(torch.zeros(shape, dtype=dtype, device=device))


def cache_seed(cache: LatentCache, kv: LatentCache) -> LatentCache:
    """Write the prefill's rows ([L, B, S0, 576]) at slot 0, in place."""
    S0 = kv.ckv.shape[2]
    if S0 > cache.ckv.shape[2]:
        raise ValueError(f"cache_seed: {S0} rows into a cache of {cache.ckv.shape[2]}")
    cache.ckv[:, :, :S0] = kv.ckv
    return cache


def cache_set_rows(cache: LatentCache, cur_len: torch.Tensor, c_new: torch.Tensor,
                   kpe_new: torch.Tensor) -> LatentCache:
    """Write each row's new latent [L, B, 512] and roped key [L, B, 64] at
    slot ``cur_len[b]``, in place (the vote winner's append); a row whose
    slot lies outside the cache is not written, with no host sync."""
    ckv = cache.ckv
    S = ckv.shape[2]
    rows = torch.arange(c_new.shape[1], device=cur_len.device)
    at = cur_len.clamp(0, S - 1)
    inside = ((cur_len >= 0) & (cur_len < S))[None, :, None]
    new = torch.cat([c_new, kpe_new], dim=-1).to(ckv.dtype)
    ckv[:, rows, at] = torch.where(inside, new, ckv[:, rows, at])
    return cache


# --- the layers -------------------------------------------------------------------


def embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def lm_head(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits of operands in the weights' dtype."""
    return _mm_f32(hidden.to(params["lm_head"].dtype), params["lm_head"])


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b`` (batched) of two reduced-dtype operands with fp32
    sums: ``out_dtype`` on the card, an upcast (exact) on the CPU."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b.float())
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The published ``apply_rotary_pos_emb``: the rotary dims [.., 2i, 2i+1]
    de-interleaved into [evens | odds], then rotated by halves."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    return apply_rope(x, cos, sin)


def _layer(tree: dict, i: int) -> dict:
    return {k: v[i] for k, v in tree.items()}


def _swiglu(x: torch.Tensor, gate, up, down) -> torch.Tensor:
    return (F.silu(x @ gate) * (x @ up)) @ down


def route(cfg: MlaMoeConfig, lp: dict, h: torch.Tensor):
    """(expert ids [N, k], fp32 weights [N, k], fp32 choice scores [N, E])
    of rows ``h`` [N, D]: the published ``noaux_tc`` gate with one group.
    The bias is in the choice scores (sigmoid + bias), which pick the
    experts, and not in the weights."""
    scores = _mm_f32(h, lp["router"]).sigmoid()  # [N, E] fp32
    choice = scores + lp["router_bias"].float()
    idx = torch.topk(choice, cfg.num_experts_per_tok, dim=-1).indices
    w = scores.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + ROUTE_EPS)
    return idx, w * cfg.routed_scaling_factor, choice


def sort_by_expert(idx: torch.Tensor, n_experts: int):
    """(order [N*k], offsets [E + 1] int32) of the flat assignments ``idx``:
    ``order`` lists them expert by expert (stable), and expert e's rows are
    ``order[offsets[e]:offsets[e + 1]]``; fixed shapes, no host read."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    bounds = torch.arange(n_experts + 1, device=idx.device, dtype=flat.dtype)
    return order, torch.searchsorted(flat[order], bounds).to(torch.int32)


def _grouped_eager(xs: torch.Tensor, offsets: torch.Tensor, lp: dict) -> torch.Tensor:
    """The prefill's expert products over rows sorted by expert: each
    expert's group through its SwiGLU in the served dtype, the down
    product's sums kept in fp32; the group sizes read back once.  K7 walks
    a group 32 rows at a time and reads the weights again for each chunk:
    at a prefill's ~1,800 rows an expert it takes about 2.7x this loop's
    time (PERF.md), so the prefill keeps the loop."""
    ys = torch.empty(xs.shape[0], xs.shape[1], dtype=torch.float32, device=xs.device)
    bounds = offsets.tolist()
    for e in range(len(bounds) - 1):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            x = xs[lo:hi]
            h = F.silu(x @ lp["gate_proj"][e]) * (x @ lp["up_proj"][e])
            ys[lo:hi] = _mm_f32(h, lp["down_proj"][e])
    return ys


def _moe(cfg: MlaMoeConfig, lp: dict, h: torch.Tensor, grouped: bool) -> torch.Tensor:
    """A routed layer's MLP of ``h`` [..., D]: the chosen experts' outputs
    weighted and summed in fp32, rounded to the served dtype, plus the shared
    experts (the published order).  ``grouped``: the prefill's eager
    per-expert products; else K7 over the sorted rows."""
    lead, D = h.shape[:-1], h.shape[-1]
    x = h.reshape(-1, D)
    k = cfg.num_experts_per_tok
    idx, w, _ = route(cfg, lp, x)
    order, offsets = sort_by_expert(idx, cfg.n_routed_experts)
    xs = x[order // k]
    if grouped:
        ys = _grouped_eager(xs, offsets, lp)
    else:
        ys = moe_experts(xs, offsets, lp["gate_proj"], lp["up_proj"], lp["down_proj"])
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=order.device))
    y = (ys[inv].view(-1, k, D) * w[..., None]).sum(dim=1).to(h.dtype)
    shared = _swiglu(x, lp["shared_gate_proj"], lp["shared_up_proj"], lp["shared_down_proj"])
    return (y + shared).reshape(*lead, D)


def _mlp(cfg: MlaMoeConfig, params: dict, i: int, h: torch.Tensor, grouped: bool) -> torch.Tensor:
    Ld = cfg.first_k_dense_replace
    if i < Ld:
        lp = _layer(params["dense"], i)
        return _swiglu(h, lp["gate_proj"], lp["up_proj"], lp["down_proj"])
    lp = _layer(params["moe"], i - Ld)
    if not grouped:
        return _moe(cfg, lp, h, False)
    with trace.span("prefill.moe"):
        return _moe(cfg, lp, h, True)


def _latent(cfg: MlaMoeConfig, lp: dict, h: torch.Tensor, cos, sin):
    """(q_nope [.., H, 128], roped q_pe [.., H, 64], the cache row [.., 576]:
    normalised latent and roped k_pe) of normed activations ``h`` [.., D]."""
    H, dn, dr = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (h @ lp["q_proj"]).unflatten(-1, (H, dn + dr))
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c, k_pe = (h @ lp["kv_a_proj"]).split([cfg.kv_lora_rank, dr], dim=-1)
    c = rms_norm(c, lp["kv_a_ln"], KV_A_NORM_EPS)
    q_pe = _rope(q_pe, cos, sin)
    k_pe = _rope(k_pe[..., None, :], cos, sin)[..., 0, :]
    return q_nope, q_pe, torch.cat([c, k_pe], dim=-1)


def _rope_tables(cfg: MlaMoeConfig, positions: torch.Tensor):
    """cos / sin [..., 1, 64] for positions [...]."""
    cos, sin = rotary_embedding(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    return cos[..., None, :], sin[..., None, :]


def _softmax_scale(cfg: MlaMoeConfig) -> float:
    return cfg.qk_head_dim ** -0.5


# --- prefill --------------------------------------------------------------------------


def _prefill(params, cfg: MlaMoeConfig, x, positions, key_mask, keep_kv):
    H, dn, dv = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    B, S, _ = x.shape
    cos, sin = _rope_tables(cfg, positions)
    layers = params["layers"]
    rows = []
    for i in range(cfg.num_hidden_layers):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q_nope, q_pe, row = _latent(cfg, lp, h, cos, sin)
        kv = (row[..., : cfg.kv_lora_rank] @ lp["kv_b_proj"]).unflatten(-1, (H, dn + dv))
        k_nope, v = kv.split([dn, dv], dim=-1)
        k_pe = row[..., None, cfg.kv_lora_rank:].expand(B, S, H, cfg.qk_rope_head_dim)
        # prefill_attention scales by q's width, 192^-0.5: the published scale
        attn = prefill_attention(torch.cat([q_nope, q_pe], -1), torch.cat([k_nope, k_pe], -1), v,
                                 causal=True, key_mask=key_mask)
        x = x + attn.reshape(B, S, H * dv) @ lp["o_proj"]
        x = x + _mlp(cfg, params, i, rms_norm(x, lp["post_attn_ln"], cfg.rms_norm_eps), True)
        if keep_kv:
            rows.append(row)
    hidden = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    trace.count("moe.assignments", B * S * cfg.num_experts_per_tok)
    return hidden, (LatentCache(torch.stack(rows)) if keep_kv else None)


def prefill(params: dict, cfg: MlaMoeConfig, inputs_embeds: torch.Tensor,
            positions: torch.Tensor, key_mask: torch.Tensor | None = None, w8a8: bool = False):
    """Full-sequence causal forward (decompressed attention, the experts
    grouped eagerly).

    Args:
      inputs_embeds: [B, S, D] merged embeddings; positions: [B, S].
      key_mask: optional [B, S] padding mask (1 = real token).
    Returns:
      (hidden [B, S, D] final-norm output, LatentCache [L, B, S, 576]).
    """
    if w8a8:
        raise unsupported("w8a8")
    return _prefill(params, cfg, inputs_embeds, positions, key_mask, True)


def prefill_hidden(params: dict, cfg: MlaMoeConfig, inputs_embeds: torch.Tensor,
                   positions: torch.Tensor, key_mask: torch.Tensor | None = None,
                   w8a8: bool = False) -> torch.Tensor:
    """``prefill``'s hidden states alone (the probe): no layer's rows kept."""
    if w8a8:
        raise unsupported("w8a8")
    return _prefill(params, cfg, inputs_embeds, positions, key_mask, False)[0]


# --- decode ----------------------------------------------------------------------------


def _absorbed_attention(cfg: MlaMoeConfig, lp: dict, q_nope, q_pe, row, ckv, key_mask):
    """One layer's decode attention in the absorbed form.

    Args:
      q_nope [B, M, H, 128], q_pe [B, M, H, 64] (roped); row [B, M, 576] each
      member's own new cache row; ckv [B, Smax, 576] the layer's cache (read
      only); key_mask [B, M, Smax] bool.
    Returns:
      [B, M, H * v_head_dim] in the served dtype.
    """
    B, M, H, dn = q_nope.shape
    R, dv = cfg.kv_lora_rank, cfg.v_head_dim
    Smax = ckv.shape[1]
    w = lp["kv_b_proj"].view(R, H, dn + dv)
    w_uk = w[:, :, :dn].permute(1, 2, 0)  # [H, 128, 512]: head h's k_nope = c @ w_uk[h].T
    w_uv = w[:, :, dn:].permute(1, 0, 2)  # [H, 512, 128]
    qh = q_nope.reshape(B * M, H, dn).transpose(0, 1)  # [H, BM, 128]
    q_lat = _bmm_f32(qh, w_uk).transpose(0, 1).reshape(B, M, H, R).to(q_nope.dtype)
    q = torch.cat([q_lat, q_pe], dim=-1)  # [B, M, H, 576]
    scale = _softmax_scale(cfg)
    s = _bmm_f32(q.reshape(B, M * H, -1), ckv.transpose(1, 2)).view(B, M, H, Smax) * scale
    s = s.masked_fill(~key_mask[:, :, None, :], float("-inf"))
    own = (q.float() * row.float()[:, :, None, :]).sum(dim=-1, keepdim=True) * scale
    p = torch.softmax(torch.cat([s, own], dim=-1), dim=-1)  # [B, M, H, Smax + 1]
    pv = p[..., :Smax].to(ckv.dtype).reshape(B, M * H, Smax)
    out = _bmm_f32(pv, ckv[:, :, :R]).view(B, M, H, R)
    out = out + p[..., Smax:] * row.float()[:, :, None, :R]
    oh = out.to(q_nope.dtype).reshape(B * M, H, R).transpose(0, 1)  # [H, BM, 512]
    o = _bmm_f32(oh, w_uv).transpose(0, 1)  # [BM, H, 128]
    return o.reshape(B, M, H * dv).to(q_nope.dtype)


def decode_step(params: dict, cfg: MlaMoeConfig, x: torch.Tensor, position: torch.Tensor,
                cache: LatentCache, key_mask: torch.Tensor, tp_mesh=None, w8a8: bool = False):
    """One-token forward for M ensemble members sharing the latent cache.

    Args:
      x: [B, M, D] current-token embeddings (the same token for every member).
      position: [B] rope position of the current token.
      cache: LatentCache, read only.
      key_mask: [B, M, Smax] bool, True = attend that cache slot; each member
        attends its own new row besides.
    Returns:
      (hidden [B, M, D], c_new [L, B, M, 512], kpe_new [L, B, M, 64]): each
      member's new latent and roped key, so the engine appends the winner's.
    """
    if tp_mesh is not None:
        raise unsupported("tensor parallelism")
    if w8a8:
        raise unsupported("w8a8")
    cos, sin = _rope_tables(cfg, position[:, None])  # [B, 1, 1, 64]: broadcasts over M
    key_mask = key_mask.contiguous()
    rows = []
    for i in range(cfg.num_hidden_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q_nope, q_pe, row = _latent(cfg, lp, h, cos, sin)
        attn = _absorbed_attention(cfg, lp, q_nope, q_pe, row, cache.ckv[i], key_mask)
        x = x + attn @ lp["o_proj"]
        x = x + _mlp(cfg, params, i, rms_norm(x, lp["post_attn_ln"], cfg.rms_norm_eps), False)
        rows.append(row)
    hidden = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    rows = torch.stack(rows)  # [L, B, M, 576]
    return hidden, rows[..., : cfg.kv_lora_rank], rows[..., cfg.kv_lora_rank:]
