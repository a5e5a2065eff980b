"""Attention for prefill and ensemble decode, in plain PyTorch (port of
``dropoutdecoding_tpu/ops/attention.py``).

- ``prefill_attention``: dense attention, causal or not, over a whole
  sequence: the vision towers' and the CLIP text tower's, and Kimi-VL's
  latent-attention prefill (a 192-wide query head, which K5 does not take).
- ``chunked_prefill_attention``: the same, query-chunked; the plain twin of
  K5 (``ops/cuda_flash_prefill.py``), which the Llama prefill runs.
- ``ensemble_decode_attention``: M members read one shared cache, each with
  its own key mask, plus each member's own new token.  It is the plain twin
  of the CUDA kernel in ``ops/cuda_decode_attention.py``: that wrapper calls
  it for CPU tensors, and ``chip_smoke.py`` holds the kernel against it.
- ``ensemble_decode_attention_int8kv``: the same over an int8 cache with
  per-(token, head) scales; the plain twin of K3.
- ``extend_attention``: T new queries over a fully visible prefix of P
  cached keys plus causally over themselves (the prefix cache of the POPE
  path); ``extend_attention_int8prefix``: the same over an int8 prefix.
  Plain torch, as they are plain XLA in the JAX package.

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
    (``ops/cuda_flash_prefill.py``): what the Llama prefill computes on the
    CPU, and what the JAX package runs for S >= 1024 off the TPU.

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


def _extend(qg, sp, k_new, v_new, prefix_mask, prefix_pv):
    """The part ``extend_attention`` and its int8 variant share: the prefix
    scores ``sp`` [B, T, KH, n, P] masked by ``prefix_mask``, the tail's
    causal scores, one fp32 softmax over [P + T], then ``prefix_pv(pp)`` of
    the prefix probabilities plus the tail's PV.  Returns [B, T, H, D] fp32."""
    B, T, KH, n, D = qg.shape
    if prefix_mask is not None:  # [Bp, P]; Bp = 1 broadcasts over B
        sp = sp.masked_fill(~prefix_mask.bool()[:, None, None, None, :], _NEG_INF)
    st = torch.einsum("btknd,bskd->btkns", qg, k_new.float())
    idx = torch.arange(T, device=qg.device)
    st = st.masked_fill(~(idx[None, :] <= idx[:, None])[None, :, None, None, :], _NEG_INF)
    probs = torch.softmax(torch.cat([sp, st], dim=-1) * (1.0 / math.sqrt(D)), dim=-1)
    P = sp.shape[-1]
    pp, pt = probs[..., :P], probs[..., P:]
    out = prefix_pv(pp)
    out = out + torch.einsum("btkns,bskd->btknd", pt.to(v_new.dtype).float(), v_new.float())
    return out.reshape(B, T, KH * n, D)


def _contract(qg, prefix):
    """Scores [B, T, KH, n, P] of the grouped queries against a prefix
    [Bp, P, KH, D] (fp32 operands); Bp = 1 contracts the un-batched prefix,
    so no [B, P, ...] copy is made."""
    if prefix.shape[0] == 1:
        return torch.einsum("btknd,pkd->btknp", qg, prefix[0])
    return torch.einsum("btknd,bpkd->btknp", qg, prefix)


def _apply(probs, prefix):
    """PV of the prefix probabilities [B, T, KH, n, P] over [Bp, P, KH, D]."""
    if prefix.shape[0] == 1:
        return torch.einsum("btknp,pkd->btknd", probs, prefix[0])
    return torch.einsum("btknp,bpkd->btknd", probs, prefix)


def extend_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_prefix: torch.Tensor,
    v_prefix: torch.Tensor,
    prefix_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Continued-prefill attention: T new queries attend a fully visible
    shared prefix plus causally themselves; equal to the tail rows of one
    causal prefill of [prefix + tail] (``dropoutdecoding_tpu/ops/
    attention.py:248``).

    Args:
      q: [B, T, H, D], rope applied at absolute positions.
      k_new, v_new: [B, T, KH, D].
      k_prefix, v_prefix: [Bp, P, KH, D] with Bp in {1, B}; Bp = 1 shares one
        prefix across every row without a copy.
      prefix_mask: optional [Bp, P] bool, False = a pad slot of the prefix
        (LLaVA-NeXT's prefixes are padded past their real length).
    Returns:
      [B, T, H, D] in q's dtype.
    """
    B, T, H, D = q.shape
    KH = k_new.shape[2]
    qg = q.reshape(B, T, KH, H // KH, D).float()
    sp = _contract(qg, k_prefix.float())
    out = _extend(
        qg, sp, k_new, v_new, prefix_mask,
        lambda pp: _apply(pp.to(v_prefix.dtype).float(), v_prefix.float()),
    )
    return out.to(q.dtype)


def extend_attention_int8prefix(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    prefix_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``extend_attention`` over an int8 prefix in the cache's layout
    (``dropoutdecoding_tpu/ops/attention.py:321``): the per-key scales fold
    into the scores after the dot and before the mask, the per-value scales
    into the probabilities before PV, which then run in q's dtype, as K3
    does.

    Args:
      q: [B, T, H, D]; k_new, v_new: [B, T, KH, D] (the unquantized tail);
      kq, vq: [Bp, P, KH, D] int8; ks, vs: [Bp, KH, P] f32 (head-major);
      prefix_mask: optional [Bp, P] bool.
    Returns:
      [B, T, H, D] in q's dtype.
    """
    B, T, H, D = q.shape
    KH = k_new.shape[2]
    qg = q.reshape(B, T, KH, H // KH, D).float()
    sp = _contract(qg, kq.to(q.dtype).float()) * ks[:, None, :, None, :]

    def prefix_pv(pp):
        ppv = (pp * vs[:, None, :, None, :]).to(q.dtype).float()
        return _apply(ppv, vq.to(q.dtype).float())

    return _extend(qg, sp, k_new, v_new, prefix_mask, prefix_pv).to(q.dtype)
