"""[Copy of ``dropoutdecoding_tpu/evalsuite/metrics/evalcap.py``, held against it by
tests/test_torch_evalsuite.py: the port imports nothing of the JAX package.]

COCOEvalCap-equivalent evaluator producing the {overall, imgToEval}
self-critical format the CHAIR pipeline consumes (reference
chair_test.py:394-441).

Replicates the reference's 100-caption chunked scoring — including its
side effect of depressing CIDEr (the IDF corpus shrinks to the chunk;
SURVEY.md §6 'CIDEr ~ 0 artifact') — so result files remain comparable
with the archived results/ tree.

When the GENUINE pycocoevalcap stack is importable (package + a JVM for
the METEOR/SPICE jars), scoring dispatches to it wholesale — same
COCOEvalCap object the reference drives — and ``_metric_notes`` records
``scorer: pycocoevalcap``.  Otherwise the lite ports run, and the SPICE /
METEOR substitutions are machine-flagged: the SPICE column carries the
SPICE-lite proxy (metrics/spice_lite.py) and every overall dict carries
``METRIC_NOTES`` under the ``_metric_notes`` key so downstream consumers
can tell the columns apart from pycocoevalcap values.
"""
from __future__ import annotations

import re
import shutil
from collections import defaultdict

import numpy as np

from .bleu import bleu_scores
from .cider import CiderScorer
from .meteor import meteor_lite
from .rouge import rouge_l
from .spice_lite import spice_lite

METRIC_NOTES = {
    "scorer": "lite-ports",
    "SPICE": (
        "SPICE-lite (stemmed content-word F1 vs union of refs); "
        "Java SPICE unavailable (no JVM).  Calibration vs the "
        "reference's archived Java scores: corpus-level in-band, "
        "per-image Pearson r=0.13 — treat per-image values as a proxy "
        "(docs/METRIC_CALIBRATION.md)"
    ),
    "METEOR": (
        "METEOR-lite: METEOR-1.5 `en norm` semantics (alpha=.85, "
        "beta=.2, gamma=.6, delta=.75, exact+stem stages weighted "
        "1.0/0.6); WordNet synonym/paraphrase stages unavailable "
        "without corpus data (they only add matches: lite <= Java on "
        "equal inputs).  Calibrated vs 28.9k archived Java-scored "
        "captions: archived-regime mean predicted 0.15 vs observed "
        "0.156; per-image Spearman 0.48 across a pseudo-reference "
        "shift (docs/METRIC_CALIBRATION.md)"
    ),
}

# Headline constants from docs/METRIC_CALIBRATION.md (committed study:
# docs/metric_calibration.json; regression: tests/test_metric_calibration
# .py).  first_sentence pseudo-reference mode, n=1080, seed 0.
METEOR_CALIBRATION = {
    "pearson": 0.50, "spearman": 0.48,
    "offset_mean": 0.167, "offset_std": 0.085,
    "java_from_lite": (0.20, 0.091), "residual_std": 0.037,
}
SPICE_CALIBRATION = {
    "pearson": 0.13, "offset_mean": 0.193, "offset_std": 0.131,
}

REAL_METRIC_NOTES = {"scorer": "pycocoevalcap"}


def real_evalcap_class():
    """The genuine ``pycocoevalcap.eval.COCOEvalCap`` when usable, else
    None.  Usable = the package imports AND a JVM is on PATH (the METEOR
    and SPICE scorers spawn ``java`` subprocesses; importability alone is
    not enough).  Probed per call so tests and late installs take effect."""
    try:
        from pycocoevalcap.eval import COCOEvalCap  # type: ignore
    except Exception:
        return None
    if shutil.which("java") is None:
        return None
    return COCOEvalCap

# Contractions PTB splits into two tokens.  The apostrophe of a
# contraction survives pycocoevalcap's punctuation removal (its removal
# list holds standalone quote tokens, not "n't"/"'s"), so it is protected
# with a sentinel while stray quotes are stripped.
_APOS = "\x00"
_CONTRACTION_RULES = (
    (re.compile(r"\bcannot\b"), "can not"),
    (re.compile(r"\bgonna\b"), "gon na"),
    (re.compile(r"\bwanna\b"), "wan na"),
    (re.compile(r"\bgotta\b"), "got ta"),
    (re.compile(r"\blemme\b"), "lem me"),
    (re.compile(r"n't\b"), f" n{_APOS}t"),  # don't->do n't, can't->ca n't
    (re.compile(r"'(s|re|ve|ll|d|m)\b"), rf" {_APOS}\1"),
)
# '.' splits words unless BETWEEN digits (keeps decimals like 1.5)
_DOT = re.compile(r"(?<=\d)\.(?=\d)")
_SEP = re.compile(r"[\"“”‘’!?,;:…\.\(\)\[\]\{\}<>/\\|@#\$%\^&\*\+=~_]|``|''|`")
_DASH = re.compile(r"--+|\s-+|-+\s|^-+|-+$")  # standalone dashes; in-word kept


def ptb_tokenize(caption: str) -> str:
    """PTB-style tokenization matching pycocoevalcap's PTBTokenizer
    post-punctuation-removal output: lowercase; contractions split into
    two tokens with their apostrophe kept (don't -> do n't, dog's ->
    dog 's); in-word hyphens (well-known) and decimal points (1.5) kept;
    all standalone punctuation removed; whitespace collapsed."""
    cap = caption.lower()
    for pat, rep in _CONTRACTION_RULES:
        cap = pat.sub(rep, cap)
    cap = _DOT.sub(_APOS + "dot" + _APOS, cap)  # protect decimals
    cap = _SEP.sub(" ", cap)
    cap = cap.replace("'", " ")  # remaining quotes/possessive-plural marks
    cap = _DASH.sub(" ", cap)
    cap = cap.replace(_APOS + "dot" + _APOS, ".")
    cap = cap.replace(_APOS, "'")
    return " ".join(cap.split())


class CocoCaptionEvaluator:
    """Evaluate generated captions against a Coco caption index."""

    def __init__(self, coco, coco_res):
        self.coco = coco
        self.coco_res = coco_res
        self.params = {"image_id": coco_res.getImgIds()}
        self.eval = {}
        self.evalImgs = []

    def evaluate(self):
        ids = self.params["image_id"]
        hyps = {}
        refs = {}
        for iid in ids:
            hyps[iid] = [ptb_tokenize(self.coco_res.imgToAnns[iid][0]["caption"])]
            refs[iid] = [ptb_tokenize(a["caption"]) for a in self.coco.imgToAnns[iid]]

        bleu_corpus, bleu_img = bleu_scores(hyps, refs)
        cider_corpus, cider_img = CiderScorer().compute(hyps, refs)
        rouge_corpus, rouge_img = rouge_l(hyps, refs)
        meteor_corpus, meteor_img = meteor_lite(hyps, refs)
        spice_corpus, spice_img = spice_lite(hyps, refs)

        self.eval = {
            "Bleu_1": bleu_corpus[0],
            "Bleu_2": bleu_corpus[1],
            "Bleu_3": bleu_corpus[2],
            "Bleu_4": bleu_corpus[3],
            "METEOR": meteor_corpus,
            "ROUGE_L": rouge_corpus,
            "CIDEr": cider_corpus,
            "SPICE": spice_corpus,
            "_metric_notes": dict(METRIC_NOTES),
        }
        self.evalImgs = [
            {
                "image_id": iid,
                "Bleu_1": bleu_img[iid][0],
                "Bleu_2": bleu_img[iid][1],
                "Bleu_3": bleu_img[iid][2],
                "Bleu_4": bleu_img[iid][3],
                "METEOR": meteor_img[iid],
                "ROUGE_L": rouge_img[iid],
                "CIDEr": cider_img[iid],
                "SPICE": spice_img[iid]["f"],
            }
            for iid in ids
        ]


def chunked_self_critical_eval(coco, loaded_json: list, chunk: int = 100) -> dict:
    """The reference's chunked evaluation loop (chair_test.py:402-441):
    score `chunk` captions at a time, mean the chunk-level overall scores,
    and collect per-image dicts (caption attached).

    Prefers the genuine pycocoevalcap COCOEvalCap (exactly what the
    reference drives) whenever its stack is usable; otherwise the lite
    ports run and are flagged in ``_metric_notes``."""
    real_cls = real_evalcap_class()
    all_overall = defaultdict(list)
    img_to_eval = {}
    for start in range(0, len(loaded_json), chunk):
        part = loaded_json[start : start + chunk]
        coco_res = coco.loadRes(part)
        if real_cls is not None:
            ev = real_cls(coco, coco_res)
        else:
            ev = CocoCaptionEvaluator(coco, coco_res)
        ev.params["image_id"] = coco_res.getImgIds()
        ev.evaluate()
        for metric, score in ev.eval.items():
            if metric == "_metric_notes":
                continue
            all_overall[metric].append(score)
        # keyed lookup: the real COCOEvalCap's evalImgs ordering follows
        # its internal imgToEval dict, not getImgIds()
        by_id = {e["image_id"]: e for e in ev.evalImgs}
        for iid in coco_res.getImgIds():
            rec = dict(by_id[iid])
            rec["caption"] = coco_res.imgToAnns[iid][0]["caption"]
            img_to_eval[iid] = rec
    overall = {m: float(np.mean(s)) for m, s in all_overall.items()}
    overall["_metric_notes"] = dict(
        REAL_METRIC_NOTES if real_cls is not None else METRIC_NOTES
    )
    return {"overall": overall, "imgToEval": img_to_eval}
