"""[Copy of ``dropoutdecoding_tpu/evalsuite/metrics/rouge.py``, held against it by
tests/test_torch_evalsuite.py: the port imports nothing of the JAX package.]

ROUGE-L reproducing pycocoevalcap's Rouge exactly: LCS F-measure with
beta=1.2 computed from the MAX precision and MAX recall taken SEPARATELY
across references (pycocoevalcap rouge.py calc_score uses
``prec_max = max(prec); rec_max = max(rec)``, which may come from two
different references — not the best per-reference F)."""
from __future__ import annotations


def _lcs_len(a, b):
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(hypotheses: dict, references: dict, beta: float = 1.2):
    per_image = {}
    for iid, hyps in hypotheses.items():
        hyp = hyps[0].split()
        precs, recs = [], []
        for ref in references[iid]:
            r = ref.split()
            lcs = _lcs_len(hyp, r)
            precs.append(lcs / len(hyp) if hyp else 0.0)
            recs.append(lcs / len(r) if r else 0.0)
        prec_max = max(precs, default=0.0)
        rec_max = max(recs, default=0.0)
        if prec_max != 0 and rec_max != 0:
            per_image[iid] = (
                (1 + beta**2) * prec_max * rec_max
            ) / (rec_max + beta**2 * prec_max)
        else:
            per_image[iid] = 0.0
    corpus = sum(per_image.values()) / max(len(per_image), 1)
    return corpus, per_image
