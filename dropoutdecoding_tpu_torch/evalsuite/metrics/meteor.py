"""[Copy of ``dropoutdecoding_tpu/evalsuite/metrics/meteor.py``, held against it by
tests/test_torch_evalsuite.py: the port imports nothing of the JAX package.]

METEOR-lite: METEOR-1.5 `en -norm` semantics, exact + stem stages.

The reference scores METEOR through pycocoevalcap's bundled
``meteor-1.5.jar`` (reference chair_test/chair_test.py:402-441), which
runs the English task defaults: parameters alpha=0.85, beta=0.2,
gamma=0.6, delta=0.75 and stage weights exact=1.0, stem=0.6,
synonym=0.8, paraphrase=0.6 (METEOR 1.5 release defaults, Denkowski &
Lavie 2014).  Neither the JVM nor the WordNet/paraphrase data exists in
this container, so this port implements the exact and stem stages with
the real 1.5 scoring math:

- stage-weighted matches (exact 1.0, Porter-stem 0.6 — the same Porter
  algorithm METEOR's stem module wraps);
- content/function word weighting: content words weigh ``delta``,
  function words ``1 - delta`` in weighted precision/recall (METEOR
  ships a corpus-derived function-word list; this port uses a standard
  English closed-class list, an approximation);
- Fmean = P*R / (alpha*P + (1-alpha)*R);
- Penalty = gamma * (chunks / matches) ** beta  (raw counts), with the
  jar's special case: a single chunk covering BOTH strings entirely is
  penalty-free (without it, beta=0.2 would cap an identical sentence at
  ~0.6; Meteor scores identical output 1.0);
- corpus score from SUMMED segment statistics, as the jar aggregates,
  not a mean of per-segment scores.

Known divergences from the Java scorer, machine-flagged in result files
(evalcap.METRIC_NOTES): (1) no WordNet-synonym or paraphrase stage —
both only add matches, so lite <= Java on the same inputs; (2) greedy
left-to-right alignment instead of METEOR's beam search (can
over-count chunks slightly); (3) the approximate function-word list.
METEOR-1.0's ranking parameters are (alpha=.9, beta=3,
gamma=.5); its 1.5 fragmentation penalty (beta=0.2) is drastically
harsher on scrambled matches and dominates the numeric difference vs
archived Java scores (docs/METRIC_CALIBRATION.md).
"""
from __future__ import annotations

from functools import lru_cache


# Standard English closed-class (function) words: articles, prepositions,
# conjunctions, pronouns, auxiliaries, common adverbial particles.
# METEOR 1.5's en function.words list is corpus-frequency derived; this
# fixed list approximates it for caption-domain text.
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no neither either
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves yourselves themselves who whom whose which what
and or but nor so yet both whether because although though while if
unless until since when whenever where wherever as than that
in on at by for with about against between into through during before
after above below to from up down of off over under again further
out near behind beside besides beyond within without along across
around past toward towards upon onto inside outside underneath
be am is are was were been being
have has had having do does did doing
will would shall should may might must can could ought
not n't 's 'm 're 've 'll 'd there here then once only very too also
just how why all most more less few many much other another such own
same s t don now
""".split())


@lru_cache(maxsize=1)
def _porter():
    # imported on first use, so that the CLI imports without nltk
    from nltk.stem.porter import PorterStemmer

    return PorterStemmer()


@lru_cache(maxsize=65536)
def _stem(w: str) -> str:
    return _porter().stem(w)


def _align(hyp, ref):
    """Greedy left-to-right alignment: exact stage first, then stem.
    Returns a list of (hyp_idx, ref_idx, stage_weight)."""
    matches = {}  # hyp_idx -> (ref_idx, weight)
    used_ref = set()
    for stage, w in (("exact", 1.0), ("stem", 0.6)):
        for i, hw in enumerate(hyp):
            if i in matches:
                continue
            for j, rw in enumerate(ref):
                if j in used_ref:
                    continue
                ok = hw == rw if stage == "exact" else _stem(hw) == _stem(rw)
                if ok:
                    matches[i] = (j, w)
                    used_ref.add(j)
                    break
    return sorted((i, j, w) for i, (j, w) in matches.items())


def _word_weight(w: str, delta: float) -> float:
    return (1.0 - delta) if w in FUNCTION_WORDS else delta


def _segment_stats(hyp, ref, delta):
    """METEOR sufficient statistics for one (hyp, ref) pair:
    (weighted_match_p, total_weight_hyp, weighted_match_r,
     total_weight_ref, matches, chunks)."""
    pairs = _align(hyp, ref)
    wh = [_word_weight(w, delta) for w in hyp]
    wr = [_word_weight(w, delta) for w in ref]
    tw_h = sum(wh) or 1e-9
    tw_r = sum(wr) or 1e-9
    wm_p = sum(w * wh[i] for i, _, w in pairs)
    wm_r = sum(w * wr[j] for _, j, w in pairs)
    m = len(pairs)
    if m == 0:
        return 0.0, tw_h, 0.0, tw_r, 0, 0
    chunks = 1
    for (i1, j1, _), (i2, j2, _) in zip(pairs, pairs[1:]):
        if not (i2 == i1 + 1 and j2 == j1 + 1):
            chunks += 1
    # the jar's Aligner zeroes the chunk count when ONE chunk covers both
    # strings entirely (identical-modulo-stage sentences carry no word-order
    # penalty); applied here, before stats are summed, as the jar does
    if chunks == 1 and m == len(hyp) == len(ref):
        chunks = 0
    return wm_p, tw_h, wm_r, tw_r, m, chunks


def _score_from_stats(stats, alpha, beta, gamma):
    wm_p, tw_h, wm_r, tw_r, m, chunks = stats
    if m == 0 or wm_p <= 0 or wm_r <= 0:
        return 0.0
    prec = wm_p / tw_h
    rec = wm_r / tw_r
    f_mean = prec * rec / (alpha * prec + (1 - alpha) * rec)
    # chunks == 0 is the penalty-free full-coverage case zeroed in
    # _segment_stats; 0.0**beta == 0.0
    frag = chunks / m
    penalty = gamma * frag**beta
    return f_mean * (1 - penalty)


def meteor_lite(
    hypotheses: dict,
    references: dict,
    alpha: float = 0.85,
    beta: float = 0.2,
    gamma: float = 0.6,
    delta: float = 0.75,
):
    """(corpus_score, {image_id: score}).  Best reference per segment by
    segment score; corpus score recomputed from the summed best-segment
    statistics (the jar's aggregate), not averaged per-image scores."""
    per_image = {}
    agg = [0.0, 0.0, 0.0, 0.0, 0, 0]
    for iid, hyps in hypotheses.items():
        hyp = hyps[0].split()
        best, best_stats = 0.0, (0.0, 1e-9, 0.0, 1e-9, 0, 0)
        for r in references[iid]:
            stats = _segment_stats(hyp, r.split(), delta)
            score = _score_from_stats(stats, alpha, beta, gamma)
            if score >= best:
                best, best_stats = score, stats
        per_image[iid] = best
        for k in range(6):
            agg[k] += best_stats[k]
    corpus = _score_from_stats(tuple(agg), alpha, beta, gamma)
    return corpus, per_image
