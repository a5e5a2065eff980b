"""[Copy of ``dropoutdecoding_tpu/evalsuite/metrics/cider.py``, held against it by
tests/test_torch_evalsuite.py: the port imports nothing of the JAX package.]

CIDEr-D scorer (Vedantam et al.): TF-IDF-weighted n-gram cosine
similarity with length gaussian penalty and count clipping.  Pure Python
replacement for pycocoevalcap.cider.

Note: the reference scores COCOEvalCap in 100-caption chunks
(chair_test.py:402-410), which collapses the IDF corpus to 100 images and
drives CIDEr ~ 0 in its archived results; our harness reproduces that
chunking for format parity (see metrics/evalcap.py)."""
from __future__ import annotations

import math
from collections import Counter, defaultdict


def _ngram_counts(tokens, max_n=4):
    out = []
    for n in range(1, max_n + 1):
        out.append(Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)))
    return out


class CiderScorer:
    def __init__(self, max_n: int = 4, sigma: float = 6.0):
        self.max_n = max_n
        self.sigma = sigma

    def compute(self, hypotheses: dict, references: dict):
        """Returns (corpus_score, per_image {id: score})."""
        ids = list(hypotheses.keys())
        # document frequency over reference sets
        doc_freq = [defaultdict(int) for _ in range(self.max_n)]
        ref_counts = {}
        for iid in ids:
            refs = [r.split() for r in references[iid]]
            counts = [_ngram_counts(r, self.max_n) for r in refs]
            ref_counts[iid] = counts
            seen = [set() for _ in range(self.max_n)]
            for c in counts:
                for n in range(self.max_n):
                    seen[n].update(c[n].keys())
            for n in range(self.max_n):
                for g in seen[n]:
                    doc_freq[n][g] += 1
        num_docs = max(len(ids), 1)
        log_docs = math.log(max(num_docs, 1))

        def vec(counts, length):
            v = []
            norm = []
            for n in range(self.max_n):
                vn = {}
                for g, c in counts[n].items():
                    df = math.log(max(doc_freq[n][g], 1.0))
                    vn[g] = c * max(log_docs - df, 0.0)
                v.append(vn)
                norm.append(math.sqrt(sum(x * x for x in vn.values())))
            return v, norm

        per_image = {}
        for iid in ids:
            hyp = hypotheses[iid][0].split()
            h_counts = _ngram_counts(hyp, self.max_n)
            hv, hnorm = vec(h_counts, len(hyp))
            score_n = [0.0] * self.max_n
            for refc, ref_tok in zip(
                ref_counts[iid], [r.split() for r in references[iid]]
            ):
                rv, rnorm = vec(refc, len(ref_tok))
                delta = len(hyp) - len(ref_tok)
                len_pen = math.exp(-(delta**2) / (2 * self.sigma**2))
                for n in range(self.max_n):
                    # CIDEr-D clips hypothesis counts to reference counts
                    dot = sum(
                        min(hv[n].get(g, 0.0), rv[n][g]) * rv[n][g] for g in rv[n]
                    )
                    if hnorm[n] > 0 and rnorm[n] > 0:
                        score_n[n] += len_pen * dot / (hnorm[n] * rnorm[n])
            n_refs = max(len(references[iid]), 1)
            per_image[iid] = 10.0 * sum(s / n_refs for s in score_n) / self.max_n
        corpus = sum(per_image.values()) / max(len(per_image), 1)
        return corpus, per_image
