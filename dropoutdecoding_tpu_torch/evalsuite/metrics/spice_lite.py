"""[Copy of ``dropoutdecoding_tpu/evalsuite/metrics/spice_lite.py``, held against it by
tests/test_torch_evalsuite.py: the port imports nothing of the JAX package.]

SPICE-lite: stemmed content-word proposition F1.

The reference's headline tables lead with SPICE (chair.py:361-376),
computed by pycocoevalcap's Java SPICE (dependency parse -> scene-graph
tuples -> WordNet-matched F1).  No JVM, parser models, or WordNet data
exist in this container, so a faithful port is impossible; this module
fills the column with the closest honest proxy and every output file is
machine-flagged with the mode (metrics/evalcap.METRIC_NOTES).

Proxy: the unigram-object slice of the scene graph.  Hypothesis and
reference captions are reduced to sets of Porter-stemmed content words
(function words out — SPICE's tuples are content-bearing by construction),
and scored with SPICE's F1: tp over the hypothesis set vs the UNION of the
reference sets (SPICE merges reference scene graphs into one).  On the
archived reference runs the Object subcategory dominates All-F, so the
proxy tracks ranking even though absolute values differ from Java SPICE.
"""
from __future__ import annotations

from .meteor import _stem

# Function/stop words: hand-rolled (nltk's stopwords corpus needs a
# download unavailable here).  Covers the closed-class words that appear
# in COCO-style captions.
_FUNCTION_WORDS = frozenset(
    """a an the and or but if then than as of at by for with about against
    between into through during before after above below to from up down in
    out on off over under again further once here there when where why how
    all any both each few more most other some such no nor not only own
    same so too very can will just should now is are was were be been being
    am do does did doing have has had having he she it they them his her
    its their this that these those i you we me him us my your our who whom
    which what there's it's s t don shouldn't isn't aren't wasn't weren't
    while also may might must shall could would""".split()
)


def extract_props(tokens) -> set:
    """Stemmed content-word set of a tokenized (whitespace-split) caption."""
    return {
        _stem(w)
        for w in tokens
        if w not in _FUNCTION_WORDS and any(c.isalpha() for c in w)
    }


def spice_lite(hypotheses: dict, references: dict):
    """Returns (corpus mean F, per_image {id: {"f", "pr", "re", "tp",
    "fp", "fn"}}) — the shape of Java SPICE's per-image "All" record."""
    per_image = {}
    for iid, hyps in hypotheses.items():
        h = extract_props(hyps[0].split())
        r = set()
        for ref in references[iid]:
            r |= extract_props(ref.split())
        tp = len(h & r)
        fp = len(h - r)
        fn = len(r - h)
        pr = tp / (tp + fp) if (tp + fp) else 0.0
        re = tp / (tp + fn) if (tp + fn) else 0.0
        f = 2 * pr * re / (pr + re) if (pr + re) else 0.0
        per_image[iid] = {
            "f": f, "pr": pr, "re": re,
            "tp": float(tp), "fp": float(fp), "fn": float(fn),
        }
    corpus = (
        sum(v["f"] for v in per_image.values()) / len(per_image)
        if per_image
        else 0.0
    )
    return corpus, per_image
