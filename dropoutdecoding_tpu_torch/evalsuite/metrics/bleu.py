"""[Copy of ``dropoutdecoding_tpu/evalsuite/metrics/bleu.py``, held against it by
tests/test_torch_evalsuite.py: the port imports nothing of the JAX package.]

BLEU-1..4 reproducing pycocoevalcap's BleuScorer semantics exactly.

The reference scores captions with pycocoevalcap's Bleu (chair_test.py:402
-441 via COCOEvalCap), whose scorer has three load-bearing quirks this
module reproduces bit-for-bit so result files stay comparable with the
archived results/ tree:

- reference length for the brevity penalty is the CLOSEST reference length
  to the hypothesis (ties -> shorter), accumulated per sentence into the
  corpus reflen (``option='closest'``, the Bleu.compute_score default for
  multi-image batches);
- per-sentence scores use the tiny/small smoothing constants
  ``(correct + 1e-15) / (guess + 1e-9)`` on the CUMULATIVE precision
  product — a zero 4-gram match yields ~1e-6-scale Bleu_4, exactly the
  magnitudes seen in the archived per-caption metrics (e.g.
  results/0924origin/..._500_chair_results.json sentences[0].metrics
  Bleu_4 = 5.87e-06);
- the brevity penalty is ``exp(1 - 1/ratio)`` applied when
  ``ratio = (testlen + tiny) / (reflen + small) < 1``.
"""
from __future__ import annotations

import math
from collections import Counter

_SMALL = 1e-9
_TINY = 1e-15


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _closest_reflen(reflens, testlen):
    # min over (|l - testlen|, l): ties resolved toward the shorter ref
    return min((abs(l - testlen), l) for l in reflens)[1]


def bleu_scores(hypotheses: dict, references: dict, max_n: int = 4):
    """Args:
      hypotheses: {id: [hyp_tokens_str]} (single hypothesis per id)
      references: {id: [ref_tokens_str, ...]}
    Returns:
      (corpus [B1..B4], per_image {id: [B1..B4]})
    """
    ids = list(hypotheses.keys())
    total = {
        "testlen": 0,
        "reflen": 0.0,
        "guess": [0] * max_n,
        "correct": [0] * max_n,
    }
    per_image = {}

    for iid in ids:
        hyp = hypotheses[iid][0].split()
        refs = [r.split() for r in references[iid]]
        testlen = len(hyp)
        reflen = _closest_reflen([len(r) for r in refs], testlen) if refs else 0
        guess, correct = [], []
        for n in range(1, max_n + 1):
            h_ngrams = _ngrams(hyp, n)
            max_ref = Counter()
            for r in refs:
                for g, c in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], c)
            correct.append(sum(min(c, max_ref[g]) for g, c in h_ngrams.items()))
            guess.append(max(testlen - n + 1, 0))

        total["testlen"] += testlen
        total["reflen"] += reflen
        for n in range(max_n):
            total["guess"][n] += guess[n]
            total["correct"][n] += correct[n]

        # per-sentence score: cumulative product with tiny/small smoothing
        score = 1.0
        sent = []
        for n in range(max_n):
            score *= (correct[n] + _TINY) / (guess[n] + _SMALL)
            sent.append(score ** (1.0 / (n + 1)))
        ratio = (testlen + _TINY) / (reflen + _SMALL)
        if ratio < 1:
            bp = math.exp(1 - 1 / ratio)
            sent = [s * bp for s in sent]
        per_image[iid] = sent

    corpus = []
    score = 1.0
    for n in range(max_n):
        score *= (total["correct"][n] + _TINY) / (total["guess"][n] + _SMALL)
        corpus.append(score ** (1.0 / (n + 1)))
    ratio = (total["testlen"] + _TINY) / (total["reflen"] + _SMALL)
    if ratio < 1:
        bp = math.exp(1 - 1 / ratio)
        corpus = [s * bp for s in corpus]
    return corpus, per_image
