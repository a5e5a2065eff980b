"""OPERA: beam search with the over-trust penalty and retrospection (port of
``dropoutdecoding_tpu/engine/opera.py``; ``decoding/opera.py`` has the
math).

One image (B = 1) and nb beams, rows 0..nb-1 of one cache.  Each step takes
every beam's top ``num_attn_candidates`` tokens and scores the nb * nc
candidates in one forward of ``llama.decode_step_attn`` (plain torch; the
candidates read their parents' rows, a gather of the filled slots when nc >
1, the cache itself when nc = 1), which also gives each candidate's
attention row; the penalty ``phi`` of its row lowers its beam score.  The
scan of the top min(2*nb, nb*nc) candidates is HF's ``BeamSearchScorer``
(``engine/baselines.py``'s, on the host); the commit reorders the beams'
rows and writes the chosen candidates' K/V (K4 on an int8 cache).  When the
best beam's summary location has stood for ``threshold`` steps, the search
rolls back to just after it, bans the tokens the beams had there, and
recomputes the logits of the resume position in one nb-row forward;
``max_iters = T * (1 + max_rollbacks)`` bounds the loop.

The JAX package's rules stand as they are, also where they differ from
``beam_generate``'s: a stored hypothesis is normalised by
``prompt_len + step + 1``, and the finalise offers the running beams with
the AND rule (a free slot and a better score).
"""
from __future__ import annotations

import numpy as np
import torch

from ..decoding.opera import attn_log_row, rollback_trigger
from ..models import llama as llama_mod
from .baselines import NEG, Hypotheses, length_norm, repeat_rows, scan_candidates, stable_top_k
from .generate import GenerationResult, first_index, require_dense


def cand_phi(attn_log: torch.Tensor, cand_logrow: torch.Tensor, step: int):
    """The penalty of each candidate (``overtrust_phi`` with the candidate's
    row put at ``step``, over beams x candidates).

    Args:
      attn_log: [nb, T, T] the beams' committed rows.
      cand_logrow: [nb, nc, T] each candidate's row (``attn_log_row``).
    Returns:
      (phi [nb, nc], loc [nb, nc]).
    """
    T = attn_log.shape[1]
    i = torch.arange(T, device=attn_log.device)
    in_range = (i[:, None] > i[None, :]) & (i[:, None] <= step - 1)  # rows c+1 .. step-1
    prefix = torch.where(in_range[None], attn_log, 0.0).sum(dim=1)  # [nb, T]
    colsum = (prefix[:, None, :] + cand_logrow).masked_fill(i >= step, -float("inf"))
    loc = colsum.argmax(dim=-1)
    if step == 0:
        return torch.zeros_like(colsum[..., 0]), loc
    return torch.exp(colsum.gather(-1, loc[..., None])[..., 0]), loc


@torch.no_grad()
def opera_generate(
    engine,
    input_ids=None,
    pixel_values=None,
    state=None,
    num_beams: int = 3,
    scale_factor: float = 50.0,
    threshold: int = 15,
    num_attn_candidates: int = 5,
    penalty_weights: float = 1.0,
    length_penalty: float = 1.0,
    max_rollbacks: int = 8,
    stats: dict | None = None,
):
    """OPERA beam decode of one image (JAX ``engine/opera.py:350``); pass
    ``state`` for engines whose prefill takes other inputs (LLaVA-NeXT).
    The knobs are the reference's generate surface; ``max_rollbacks`` caps
    the retrospections (each position triggers at most once).  ``stats``,
    when given, receives the rollback and iteration counts."""
    require_dense(engine, "OPERA")
    B = state.first_token.shape[0] if state is not None else np.shape(input_ids)[0]
    if B != 1:
        raise ValueError("opera_generate runs one image per call (B=1)")
    if num_attn_candidates < 1:
        raise ValueError("num_attn_candidates must be >= 1")
    if state is None:
        state = engine.prefill(input_ids, pixel_values)
    gen, lm, dev, text = engine.gen, engine.params.lm, engine.device, engine.cfg.text
    nb, nc, T = num_beams, num_attn_candidates, gen.max_new_tokens
    eos, pad, lp = gen.eos_token_id, gen.pad_token_id, length_penalty
    pw = np.float32(penalty_weights)
    cache = repeat_rows(state.cache, nb)
    Smax = (cache.k["q"] if llama_mod.cache_is_quantized(cache) else cache.k).shape[2]
    prompt_len = int(state.cur_len[0])
    win = min(prompt_len, Smax - T)  # the window's first slot (JAX's dynamic_slice clamps it)

    def fwd(cache_rows, tok: torch.Tensor, pos: int):
        """``decode_step_attn`` of one token a row at ``pos`` over the filled
        slots; (logits, k_new, v_new, the attention rows over the window)."""
        rows = tok.shape[0]
        h, k_new, v_new, attn = llama_mod.decode_step_attn(
            lm, text, llama_mod.embed(lm, tok), torch.full((rows,), pos, device=dev),
            cache_rows, torch.ones((rows, pos), dtype=torch.bool, device=dev),
        )
        window = attn.new_zeros((rows, T))  # slots from pos on are masked: 0
        window[:, : max(pos - win, 0)] = attn[:, win:pos][:, :T]
        return llama_mod.lm_head(lm, h), k_new, v_new, window

    buf = np.full((nb, T), pad, np.int64)
    scores = np.zeros(nb, np.float32)
    score_hist = np.zeros((nb, T), np.float32)
    loc_hist = np.full((nb, T), -1, np.int64)
    attn_log = torch.zeros((nb, T, T), dtype=torch.float32, device=dev)
    hyp = Hypotheses(nb, T, pad)
    bans = np.full((T, nb), -1, np.int64)
    rb_count = np.zeros(T, np.int64)
    total_rb = 0
    parent = torch.arange(nb, device=dev).repeat_interleave(nc)

    def step_core(logits_cur, step: int, live: np.ndarray):
        """Candidates, penalty, selection and commit at ``step``; ``live``
        [nb] the beams that may give candidates (beam 0 alone at step 0, HF's
        first expansion).  Returns the chosen candidates' next logits."""
        nonlocal buf, scores, score_hist, loc_hist, attn_log
        cand_logp, cand_tok = stable_top_k(torch.log_softmax(logits_cur, dim=-1), nc)
        flat_tok = cand_tok.reshape(nb * nc)
        pos = prompt_len + step
        cand_cache = llama_mod.cache_live(cache, pos)
        if nc > 1:  # each candidate reads its parent beam's rows
            cand_cache = llama_mod.cache_map(cand_cache, lambda t, axis: t[:, parent])
        logits_next, k_new, v_new, window = fwd(cand_cache, flat_tok, pos)
        logrow = attn_log_row(window, scale_factor, step)  # [nb * nc, T]
        phi, loc = cand_phi(attn_log, logrow.reshape(nb, nc, T), step)
        cand_logp, tok = cand_logp.cpu().numpy(), flat_tok.cpu().numpy()  # the sync
        phi, loc = phi.cpu().numpy(), loc.cpu().numpy().reshape(-1)
        banned = np.isin(tok, bans[step]).reshape(nb, nc) | ~live[:, None]
        cand_logp = np.where(banned, np.float32(NEG), cand_logp)
        cand_scores = (scores[:, None] + cand_logp - pw * phi).reshape(-1)
        top_sc, top_ix = (t.numpy() for t in stable_top_k(torch.from_numpy(cand_scores),
                                                         min(2 * nb, nb * nc)))
        picked, sel_s = scan_candidates(
            hyp, top_sc, tok[top_ix], buf[top_ix // nc], prompt_len + step + 1, lp, nb, eos)
        sel_ix = np.where(picked >= 0, top_ix[picked], 0)
        sel_p = sel_ix // nc  # each chosen candidate's parent beam
        # commit: the beams' rows from their parents, the chosen K/V at pos
        llama_mod.cache_reorder_rows(cache, sel_p, pos)
        ix = torch.as_tensor(sel_ix, device=dev)
        llama_mod.cache_set_rows(cache, torch.full((nb,), pos, device=dev), k_new[:, ix],
                                 v_new[:, ix])
        buf = buf[sel_p]
        buf[:, step] = tok[sel_ix]
        attn_log = attn_log[torch.as_tensor(sel_p, device=dev)]
        attn_log[:, step] = logrow[ix]
        loc_hist = loc_hist[sel_p]
        loc_hist[:, step] = loc[sel_ix]
        scores = sel_s
        score_hist = score_hist[sel_p]
        score_hist[:, step] = sel_s
        return logits_next[ix]

    def maybe_rollback(step: int) -> int:
        """Retrospection on the best beam: the step to go on from, which is
        ``step + 1`` unless the search rolls back."""
        nonlocal scores, total_rb
        trig, loc = rollback_trigger(torch.from_numpy(loc_hist[int(np.argmax(scores))]), step,
                                     threshold)
        s = loc + 1  # regenerate just after the summary token
        if not (trig and 1 <= s <= step and rb_count[s] < 1 and total_rb < max_rollbacks):
            return step + 1
        bans[s] = buf[:, s]
        buf[:, s:] = pad
        attn_log[:, s:] = 0.0
        loc_hist[:, s:] = -1
        scores = score_hist[:, s - 1].copy()
        score_hist[:, s:] = 0.0
        rb_count[s] += 1
        total_rb += 1
        return s

    first = state.last_logits[0].expand(nb, -1)
    logits_cur = step_core(first, 0, np.arange(nb) == 0)
    all_live = np.ones(nb, bool)
    step, iters, done, rolled = 1, 0, False, False
    while step < T and not done and iters < T * (1 + max_rollbacks):
        if rolled:  # the threaded logits are the old branch's: recompute
            prev = torch.as_tensor(buf[:, step - 1], device=dev)
            logits_cur = fwd(llama_mod.cache_live(cache, prompt_len + step - 1), prev,
                             prompt_len + step - 1)[0]
        logits_cur = step_core(logits_cur, step, all_live)
        new_step = maybe_rollback(step)
        rolled = new_step != step + 1
        # HF is_done (early_stopping=False): the worst stored hypothesis beats
        # the best running beam at the current length
        best_running = scores.max() / length_norm(prompt_len + step + 1, lp)
        done = hyp.count >= nb and hyp.scores.min() >= best_running and not rolled
        step, iters = new_step, iters + 1
    # finalise: the running beams at the exit length, by the AND rule
    for i in range(nb):
        if hyp.offer(buf[i], scores[i] / length_norm(prompt_len + step, lp), or_rule=False):
            hyp.count += 1
    if stats is not None:
        stats.update(rollbacks=total_rb, iterations=iters + 1)
    tokens = hyp.best()[None].astype(np.int32)
    return GenerationResult(tokens=tokens, num_tokens=np.maximum(first_index(tokens, pad), 1))
