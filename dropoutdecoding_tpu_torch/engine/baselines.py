"""Baseline samplers over the engines' towers: VCD and beam search (port of
``dropoutdecoding_tpu/engine/baselines.py``).

VCD runs the clean and the noised context as rows [0:B] and [B:2B] of one
dense cache, so each step is one decode forward over 2B rows (K1 at M = 1);
the contrastive cutoff comes before HF's warpers, and every row samples
with the same draw, so a batched call is token-equal to serial ones.  The
two prefills' caches are concatenated into the stacked one (a copy of both:
about 1.2 GB at 7B, B = 1).

Beam search follows HF's ``BeamSearchScorer``: the beams of image i are rows
[i*nb, (i+1)*nb) of one cache and each step is one decode forward over
B*nb rows (K1 at M = 1).  The top 2*nb candidates come from the device in
the order ``jax.lax.top_k`` gives them (ties to the lower index); the
per-image candidate scan, the stored hypotheses and the stop test run on
the host over those [B, 2*nb] values, one sync a step.  The cache reorder
copies only the rows whose parent is another row, and only their filled
slots (``llama.cache_reorder_rows``); the JAX package gathers the whole
cache every step.

Both raise on an int8-KV engine, as the JAX functions do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..decoding.vcd import contrastive_logits, diffusion_noise
from ..models import llama as llama_mod
from ..models.llama import KVCache
from ..ops.sampling import sample_token
from ..utils.prng import PhiloxNormal, PhiloxVcdGumbel
from .generate import DONE_CHECK_EVERY, GenerationResult, first_index, require_dense

NEG = -1e9


def stable_top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, equal
    values in index order, as ``jax.lax.top_k`` gives them (``torch.topk``
    promises no order among ties)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def length_norm(seq_len, lp: float) -> np.float32:
    """``seq_len ** lp`` in fp32, as the JAX package divides a score by it."""
    return np.power(np.float32(seq_len), np.float32(lp))


def _dense_only(engine, what: str) -> None:
    require_dense(engine, what)
    if engine.int8_kv:
        raise NotImplementedError(
            f"{what} requires a dense-KV engine (int8_kv=False), as in the JAX package"
        )


def repeat_rows(cache: KVCache, n: int) -> KVCache:
    """Each row of the cache ``n`` times, in row order (a copy)."""
    return llama_mod.cache_map(cache, lambda t, axis: t.repeat_interleave(n, dim=1))


# ---------------------------------------------------------------------------
# VCD
# ---------------------------------------------------------------------------


def noised_pixels(engine, pixels, seed: int = 0) -> torch.Tensor:
    """VCD's noised copy of one image's pixels (a [3, H, W] image or a
    LLaVA-NeXT tile stack) at ``gen.cd_noise_step``: ``engine.cd_noise`` when
    set (tests inject the JAX package's), else Gaussian noise from torch
    Philox at ``seed``, the same for every image of that shape."""
    pixels = torch.as_tensor(pixels, dtype=torch.float32, device=engine.device)
    if engine.cd_noise is not None:
        return engine.cd_noise(pixels)
    noise = PhiloxNormal(seed, engine.device)(pixels.shape)
    return diffusion_noise(noise, pixels, engine.gen.cd_noise_step)


@torch.no_grad()
def vcd_generate(engine, input_ids=None, pixel_values=None, seed: int = 0, states=None):
    """Visual contrastive decoding (JAX ``engine/baselines.py:32``).

    Two prefills, on the clean pixels and on pixels noised at
    ``gen.cd_noise_step``; ``states=(clean, noised)`` for engines whose
    prefill takes other inputs (LLaVA-NeXT).  Every token is sampled from
    the contrastive logits, cut off and then warped (temperature, top-k,
    top-p); the draws are ``engine.cd_gumbel`` when set, else torch Philox
    at ``seed`` (``utils/prng.py`` ``PhiloxVcdGumbel``), one [V] draw a step
    for every row.
    """
    _dense_only(engine, "vcd_generate")
    gen, lm = engine.gen, engine.params.lm
    if states is not None:
        state, state_cd = states
    else:
        pixels = torch.as_tensor(pixel_values, dtype=torch.float32, device=engine.device)
        noised = torch.stack([noised_pixels(engine, p, seed) for p in pixels])
        state = engine.prefill(input_ids, pixel_values)
        state_cd = engine.prefill(input_ids, noised)
    B, T = state.first_token.shape[0], gen.max_new_tokens
    cache = KVCache(*(torch.cat([a, b], dim=1) for a, b in zip(state.cache, state_cd.cache)))
    first_logits = contrastive_logits(state.last_logits, state_cd.last_logits, gen.cd_alpha,
                                      gen.cd_beta)
    cur, state, state_cd = state.cur_len.clone(), None, None  # the two caches may go
    draws = engine.cd_gumbel or PhiloxVcdGumbel(seed, engine.device)

    def draw(step, logits):  # [B, V] -> [B], the same noise for every row
        return sample_token(logits, draws(step, logits.shape[-1]), gen)

    token = draw(0, first_logits)
    tokens = torch.full((B, T), gen.pad_token_id, dtype=torch.long, device=engine.device)
    tokens[:, 0] = token
    done = token == gen.eos_token_id
    slots = torch.arange(cache.k.shape[2], device=engine.device)
    for step in range(1, T):
        if step % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break  # the only host sync in the loop
        x = llama_mod.embed(lm, token)
        x2 = torch.cat([x, x])[:, None]  # [2B, 1, D]: both contexts read the same token
        cur2 = torch.cat([cur, cur])
        mask = (slots[None, :] < cur2[:, None])[:, None]  # [2B, 1, Smax]
        h, k_new, v_new = llama_mod.decode_step(lm, engine.cfg.text, x2, cur2, cache, mask)
        logits2 = llama_mod.lm_head(lm, h)[:, 0]
        nxt = draw(step, contrastive_logits(logits2[:B], logits2[B:], gen.cd_alpha, gen.cd_beta))
        llama_mod.cache_set_rows(cache, cur2, k_new[:, :, 0], v_new[:, :, 0])
        token = torch.where(done, gen.pad_token_id, nxt)
        tokens[:, step] = token
        cur = cur + (~done).long()
        done = done | (token == gen.eos_token_id)
    tokens = tokens.cpu().numpy().astype(np.int32)
    return GenerationResult(tokens=tokens, num_tokens=first_index(tokens, gen.eos_token_id, 1))


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------


class Hypotheses:
    """One image's stored hypotheses (HF ``BeamHypotheses``), on the host:
    tokens [nb, T], fp32 scores (-inf while a slot is free) and the count."""

    def __init__(self, nb: int, T: int, pad: int):
        self.tokens = np.full((nb, T), pad, np.int64)
        self.scores = np.full(nb, -np.inf, np.float32)
        self.count = 0
        self.nb = nb

    def offer(self, tokens: np.ndarray, norm: np.float32, or_rule: bool = True) -> bool:
        """Store ``tokens`` over the worst hypothesis while slots remain or
        when ``norm`` beats it (the OR rule; the AND rule is OPERA's
        finalise); returns whether it was stored."""
        worst = int(np.argmin(self.scores))
        free, better = self.count < self.nb, norm > self.scores[worst]
        if not ((free or better) if or_rule else (free and better)):
            return False
        self.tokens[worst] = tokens
        self.scores[worst] = norm
        return True

    def best(self) -> np.ndarray:
        return self.tokens[int(np.argmax(self.scores))]


def scan_candidates(hyp: Hypotheses, cand_scores, cand_tok, cand_rows, seq_len: int, lp: float,
                    nb: int, eos: int):
    """One image's candidate scan (HF ``BeamSearchScorer.process``, JAX
    ``engine/baselines.py:240-283``) over candidates in score order: an eos
    candidate of rank < nb becomes a stored hypothesis (``cand_rows[r]``, its
    beam's tokens without the eos, normalised by ``seq_len ** lp``), the
    others refill the nb beams.  Returns the ranks of the candidates that
    refill them (-1 where none is left) and their fp32 scores."""
    picked = np.full(nb, -1, np.int64)
    sel_score = np.full(nb, NEG, np.float32)
    nsel = 0
    for r, (s, t) in enumerate(zip(cand_scores, cand_tok)):
        if t == eos:
            if r < nb:
                hyp.offer(cand_rows[r], s / length_norm(seq_len, lp))
                hyp.count = min(hyp.count + 1, nb)
        elif nsel < nb:
            picked[nsel], sel_score[nsel] = r, s
            nsel += 1
    return picked, sel_score


@torch.no_grad()
def beam_generate(
    engine,
    input_ids=None,
    pixel_values=None,
    num_beams: int = 3,
    state=None,
    length_penalty: float = 1.0,
    early_stopping=False,
):
    """Beam search (JAX ``engine/baselines.py:168``), batched: row i of the
    result is token-equal to a B = 1 call on prompt i.  Pass ``state`` for
    engines whose prefill takes other inputs (LLaVA-NeXT).

    HF ``BeamSearchScorer`` semantics with ``length_penalty`` and
    ``early_stopping`` (False: the worst stored hypothesis beats the best
    running beam at the current length; True: nb stored; "never": the best
    running beam normalised at the maximum length when ``length_penalty`` >
    0).  A finished hypothesis is normalised by its generated length, eos
    included; finished images freeze; the finalise offers the running beams
    of images not done with HF's OR rule.  The first expansion takes the
    prompt's top-nb tokens, the JAX package's known departure from HF
    (``engine/baselines.py:202-211``).
    """
    if early_stopping not in (False, True, "never"):
        raise ValueError(
            f"early_stopping must be False, True, or 'never'; got {early_stopping!r}"
        )
    _dense_only(engine, "beam_generate")
    gen, lm, dev = engine.gen, engine.params.lm, engine.device
    if state is None:
        state = engine.prefill(input_ids, pixel_values)
    nb, T, eos, pad, lp = num_beams, gen.max_new_tokens, gen.eos_token_id, gen.pad_token_id, \
        length_penalty
    B = state.first_token.shape[0]
    cache = repeat_rows(state.cache, nb)  # image i owns rows [i*nb, (i+1)*nb)
    top0, tok0 = stable_top_k(torch.log_softmax(state.last_logits, dim=-1), nb)  # [B, nb]
    rows = np.arange(B)[:, None]
    buf = np.full((B, nb, T), pad, np.int64)
    buf[:, :, 0] = tok0.cpu().numpy()
    scores = top0.cpu().numpy()  # running sum-logprob of each beam
    cur = np.repeat(state.cur_len.cpu().numpy(), nb)
    hyps = [Hypotheses(nb, T, pad) for _ in range(B)]
    done = np.zeros(B, bool)
    fin_step = np.full(B, T)
    tok = buf[:, :, 0].copy()  # [B, nb] each beam's last token
    slots = torch.arange(cache.k.shape[2], device=dev)
    step = 1
    while step < T and not done.all():
        cur_dev = torch.as_tensor(cur, device=dev)
        x = llama_mod.embed(lm, torch.as_tensor(tok.reshape(-1), device=dev))[:, None]
        mask = (slots[None, :] < cur_dev[:, None])[:, None]
        h, k_new, v_new = llama_mod.decode_step(lm, engine.cfg.text, x, cur_dev, cache, mask)
        # a frozen row writes at its next slot, which it never attends
        llama_mod.cache_set_rows(cache, cur_dev, k_new[:, :, 0], v_new[:, :, 0])
        logp = torch.log_softmax(llama_mod.lm_head(lm, h)[:, 0], dim=-1)
        V = logp.shape[-1]
        total = (torch.as_tensor(scores, device=dev)[:, :, None] + logp.reshape(B, nb, V))
        cand_scores, cand_idx = stable_top_k(total.reshape(B, nb * V), 2 * nb)
        cand_scores, cand_idx = cand_scores.cpu().numpy(), cand_idx.cpu().numpy()  # the sync
        sel_beam = np.tile(np.arange(nb), (B, 1))  # a finished image keeps its beams,
        sel_tok, sel_score = tok.copy(), scores.copy()  # its tokens and its scores
        for b in np.flatnonzero(~done):
            beam, token = cand_idx[b] // V, cand_idx[b] % V
            # HF normalises by the generated length, eos included: step + 1
            picked, sel_score[b] = scan_candidates(
                hyps[b], cand_scores[b], token, buf[b, beam], step + 1, lp, nb, eos)
            sel_beam[b] = np.where(picked >= 0, beam[picked], 0)
            sel_tok[b] = np.where(picked >= 0, token[picked], pad)
        llama_mod.cache_reorder_rows(cache, (rows * nb + sel_beam).reshape(-1), int(cur.max()) + 1)
        buf = buf[rows, sel_beam]
        buf[~done, :, step] = sel_tok[~done]
        cur = (cur.reshape(B, nb)[rows, sel_beam] + (~done)[:, None]).reshape(-1)
        count = np.array([h.count for h in hyps])
        if early_stopping is True:
            search_done = count >= nb
        else:
            sl = T if early_stopping == "never" and lp > 0.0 else step + 1
            worst = np.array([h.scores.min() for h in hyps])
            search_done = (count >= nb) & (worst >= sel_score.max(axis=1) / length_norm(sl, lp))
        new_done = done | search_done
        fin_step = np.where(done | ~new_done, fin_step, step + 1)
        done, scores, tok, step = new_done, sel_score, sel_tok, step + 1
    # finalise: the running beams of images not done, at each one's exit length
    out = np.empty((B, T), np.int32)
    for b, hyp in enumerate(hyps):
        if not done[b]:
            for i in range(nb):
                if hyp.offer(buf[b, i], scores[b, i] / length_norm(fin_step[b], lp)):
                    hyp.count = min(hyp.count + 1, nb)
        out[b] = hyp.best()
    return GenerationResult(tokens=out, num_tokens=np.maximum(first_index(out, pad), 1))
