"""[Copy of ``dropoutdecoding_tpu/evalsuite/throne.py``, held against it by
tests/test_torch_evalsuite.py: the port imports nothing of the JAX package.]

THRONE-style object-hallucination scoring for free-form responses.

The reference references a chair->THRONE converter (README.md:67) but does
not vendor THRONE itself (Kaul et al., CVPR 2024: class-wise
precision/recall of object mentions in free-form text against GT objects).
This implements the THRONE scoring shape over the same object-mention
extractor the CHAIR metric uses (the original THRONE extracts mentions
with an LLM judge; using the deterministic CHAIR extractor keeps the
pipeline self-contained and reproducible — documented divergence).

Metrics per the THRONE formulation:
  per class c:  P_c = TP_c / (TP_c + FP_c),  R_c = TP_c / (TP_c + FN_c)
  F_beta macro-averaged over classes (beta=1 and beta=0.5 reported),
  plus the response-level hallucination rate (any FP in the response).
"""
from __future__ import annotations

from collections import defaultdict

from .chair import ChairEvaluator


def evaluate_throne(
    responses: list,
    gt_objects: dict,
    evaluator: ChairEvaluator | None = None,
) -> dict:
    """Score free-form responses.

    Args:
      responses: [{'image_id', 'response'}] (the chair2throne export
        format, cli/chair2throne.py).
      gt_objects: {image_id: set/list of canonical object names}.
      evaluator: optional preconstructed ChairEvaluator (for its
        caption_to_words pipeline).
    Returns:
      dict with per-class P/R, macro F1 / F0.5, and hallucination rate.
    """
    ev = evaluator or ChairEvaluator(list(gt_objects))
    tp = defaultdict(int)
    fp = defaultdict(int)
    fn = defaultdict(int)
    halluc_responses = 0

    for rec in responses:
        imid = rec["image_id"]
        gt = set(gt_objects.get(imid, ()))
        _, nodes, _, _ = ev.caption_to_words(rec["response"])
        mentioned = set(nodes)
        any_fp = False
        for c in mentioned:
            if c in gt:
                tp[c] += 1
            else:
                fp[c] += 1
                any_fp = True
        for c in gt - mentioned:
            fn[c] += 1
        if any_fp:
            halluc_responses += 1

    classes = sorted(set(tp) | set(fp) | set(fn))
    per_class = {}
    f1s, f05s = [], []
    for c in classes:
        p = tp[c] / (tp[c] + fp[c]) if tp[c] + fp[c] else 0.0
        r = tp[c] / (tp[c] + fn[c]) if tp[c] + fn[c] else 0.0
        per_class[c] = {"precision": p, "recall": r, "tp": tp[c], "fp": fp[c], "fn": fn[c]}

        def fbeta(beta):
            if p + r == 0:
                return 0.0
            b2 = beta * beta
            return (1 + b2) * p * r / (b2 * p + r)

        f1s.append(fbeta(1.0))
        f05s.append(fbeta(0.5))

    n = max(len(responses), 1)
    return {
        "per_class": per_class,
        "macro_f1": sum(f1s) / len(f1s) if f1s else 0.0,
        "macro_f05": sum(f05s) / len(f05s) if f05s else 0.0,
        "hallucination_rate": halluc_responses / n,
        "num_responses": len(responses),
        "num_classes": len(classes),
    }


def evaluate_throne_file(response_path: str, gt_objects: dict) -> dict:
    import json

    with open(response_path) as f:
        responses = [json.loads(line) for line in f if line.strip()]
    return evaluate_throne(responses, gt_objects)
