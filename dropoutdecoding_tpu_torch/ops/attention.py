"""Attention for prefill and ensemble decode, in plain PyTorch (port of
``dropoutdecoding_tpu/ops/attention.py``).

- ``prefill_attention``: dense causal attention over the merged (visual +
  text) sequence.  At LLaVA-1.5's S of about 600 the [H, S, S] score tensor
  is small, so this stays plain torch, as it stayed XLA in the JAX package.
- ``chunked_prefill_attention``: the same, query-chunked, for S >= 1024
  (LLaVA-NeXT); the plain twin of K5 (``ops/cuda_flash_prefill.py``).
- ``ensemble_decode_attention``: M members read one shared cache, each with
  its own key mask, plus each member's own new token.  It is the plain twin
  of the CUDA kernel in ``ops/cuda_decode_attention.py``: that wrapper calls
  it for CPU tensors, and ``chip_smoke.py`` holds the kernel against it.
- ``ensemble_decode_attention_int8kv``: the same over an int8 cache with
  per-(token, head) scales; the plain twin of K3.

Operands in a reduced type are upcast to fp32 for the dots, which is what
the JAX package's ``preferred_element_type=float32`` einsums compute (exact
products, fp32 sums); probabilities are rounded to the value dtype before
the PV product, as there.
"""
from __future__ import annotations

import math

import torch

_NEG_INF = -1e30  # large-negative in fp32; avoids NaN from (-inf) - (-inf)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[..., S, KH, D] -> [..., S, KH*n_rep, D]; head h reads group h // n_rep."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


def prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    key_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense multi-head attention.

    Args:
      q: [B, S, H, D]; k, v: [B, S, KH, D] (KH divides H).
      key_mask: optional [B, S] (1 = attend).
    Returns:
      [B, S, H, D] in q's dtype.
    """
    B, S, H, D = q.shape
    n_rep = H // k.shape[2]
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(D))
    if causal:
        idx = torch.arange(S, device=q.device)
        scores = scores.masked_fill(~(idx[None, :] <= idx[:, None]), _NEG_INF)
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask.bool()[:, None, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), vf.float())
    return out.to(q.dtype)


def chunked_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    *,
    causal: bool = True,
    chunk: int = 256,
) -> torch.Tensor:
    """Query-chunked ``prefill_attention``: the scores exist only as a
    [B, H, chunk, S] transient, not [B, H, S, S].  The plain twin of K5
    (``ops/cuda_flash_prefill.py``), and what the JAX package runs for
    S >= 1024 off the TPU.

    A row with no attendable key (every key masked) scores -1e30
    everywhere, so its softmax is uniform over all S keys.

    Args:
      q: [B, S, H, D]; k, v: [B, S, KH, D] (KH divides H).
      key_mask: optional [B, S] (1 = attend).
    Returns:
      [B, S, H, D] in q's dtype.
    """
    B, S, H, D = q.shape
    n_rep = H // k.shape[2]
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep).float()
    scale = 1.0 / math.sqrt(D)
    ki = torch.arange(S, device=q.device)
    km = None if key_mask is None else key_mask.bool()[:, None, None, :]
    out = torch.empty_like(q)
    for c0 in range(0, S, chunk):
        qc = q[:, c0 : c0 + chunk].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale
        ok = km
        if causal:
            qi = c0 + torch.arange(qc.shape[1], device=q.device)
            below = ki[None, :] <= qi[:, None]
            ok = below if ok is None else ok & below
        if ok is not None:
            s = s.masked_fill(~ok, _NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype).float()
        out[:, c0 : c0 + chunk] = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    return out


def ensemble_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    key_mask: torch.Tensor,
) -> torch.Tensor:
    """Single-token decode attention for M ensemble members sharing one cache.

    Member m attends the cache slots where ``key_mask[b, m, s]`` is set,
    plus its own current token, which is always attended.  Masked slots
    score -1e30, so a member whose cache is fully masked still attends its
    own token.

    Args:
      q: [B, M, H, D] current-token queries per member.
      k_cache, v_cache: [B, S, KH, D] canonical cache (shared, read-only).
      k_new, v_new: [B, M, KH, D] members' own current-token K/V.
      key_mask: [B, M, S] bool, True = attend that cache slot.
    Returns:
      [B, M, H, D] in q's dtype.
    """
    B, M, H, D = q.shape
    n_rep = H // k_cache.shape[2]
    kc = repeat_kv(k_cache, n_rep).float()
    vc = repeat_kv(v_cache, n_rep)
    kn = repeat_kv(k_new, n_rep).float()
    vn = repeat_kv(v_new, n_rep)
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    cache_scores = torch.einsum("bmhd,bshd->bmhs", qf, kc) * scale
    cache_scores = cache_scores.masked_fill(
        ~key_mask.bool()[:, :, None, :], _NEG_INF
    )
    self_scores = (qf * kn).sum(-1, keepdim=True) * scale  # [B, M, H, 1]
    probs = torch.softmax(torch.cat([cache_scores, self_scores], dim=-1), dim=-1)
    cache_probs = probs[..., :-1].to(vc.dtype).float()
    self_probs = probs[..., -1:].to(vn.dtype).float()
    out = torch.einsum("bmhs,bshd->bmhd", cache_probs, vc.float())
    out = out + self_probs * vn.float()
    return out.to(q.dtype)


def ensemble_decode_attention_int8kv(
    q: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    key_mask: torch.Tensor,
) -> torch.Tensor:
    """``ensemble_decode_attention`` over an int8 cache (``utils/quantize.
    quantize_kv`` layout); the plain twin of K3 (``ops/
    cuda_decode_attention.py``).

    The per-key scales fold into the scores after the dot, the per-value
    scales into the probabilities before PV, and those probabilities are
    rounded to the activation dtype, as the JAX op does
    (``dropoutdecoding_tpu/ops/attention.py:75``).

    Args:
      q: [B, M, H, D]; kq, vq: [B, S, KH, D] int8; ks, vs: [B, KH, S] f32
      (the cache's stored scale layout); k_new, v_new: [B, M, KH, D]
      (unquantized current token); key_mask: [B, M, S] bool.
    Returns:
      [B, M, H, D] in q's dtype.
    """
    B, M, H, D = q.shape
    n_rep = H // kq.shape[2]
    kc = repeat_kv(kq.to(q.dtype), n_rep).float()
    vc = repeat_kv(vq.to(q.dtype), n_rep)
    ksr = ks.repeat_interleave(n_rep, dim=1)  # [B, H, S]
    vsr = vs.repeat_interleave(n_rep, dim=1)
    kn = repeat_kv(k_new, n_rep).float()
    vn = repeat_kv(v_new, n_rep).float()
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    cache_scores = torch.einsum("bmhd,bshd->bmhs", qf, kc) * scale
    cache_scores = cache_scores * ksr[:, None]
    cache_scores = cache_scores.masked_fill(~key_mask.bool()[:, :, None, :], _NEG_INF)
    self_scores = (qf * kn).sum(-1, keepdim=True) * scale
    probs = torch.softmax(torch.cat([cache_scores, self_scores], dim=-1), dim=-1)
    cache_probs = (probs[..., :-1] * vsr[:, None]).to(vc.dtype).float()
    out = torch.einsum("bmhs,bshd->bmhd", cache_probs, vc.float())
    out = out + probs[..., -1:] * vn
    return out.to(q.dtype)
