"""Consistency analyses of the CHAIR results: the LM rank of each
hallucinated word under a blank image, whether an image classifier fires
for a hallucinated object, and a metric's correlation with CHAIRs.

[Copy of ``dropoutdecoding_tpu/evalsuite/consistency.py``, held against it
by tests/test_torch_consistency.py: the port imports nothing of the JAX
package.]  Its producers: ``consistency_producer.py`` (the blank-image
distributions) and ``im_classifier.py`` (the classifier labels).
"""
from __future__ import annotations


def lm_consistency_rank(word_probs: dict, word: str) -> int:
    """Rank (1-based) of `word` in a {word: prob} LM distribution; 0 if
    absent (reference lm_consistency.py computes rank-in-vocab of each
    hallucinated word under a blank-image LM)."""
    ranked = sorted(word_probs.items(), key=lambda kv: kv[1], reverse=True)
    for i, (w, _) in enumerate(ranked, start=1):
        if w == word:
            return i
    return 0


def lm_consistency(cap_dict: dict, lm_distributions: dict) -> dict:
    """Mean LM rank of hallucinated words.

    Args:
      cap_dict: output of ChairEvaluator.compute.
      lm_distributions: {image_id: {position_idx: {word: prob}}}.
    """
    ranks = []
    per_image = {}
    for s in cap_dict["sentences"]:
        dists = lm_distributions.get(s["image_id"], {})
        img_ranks = []
        for (word, _node), idx in zip(
            s["mscoco_hallucinated_words"], s["hallucination_idxs"]
        ):
            if idx in dists:
                img_ranks.append(lm_consistency_rank(dists[idx], word))
        if img_ranks:
            per_image[s["image_id"]] = sum(img_ranks) / len(img_ranks)
            ranks.extend(img_ranks)
    return {
        "mean_rank": sum(ranks) / len(ranks) if ranks else 0.0,
        "per_image": per_image,
    }


def image_consistency(cap_dict: dict, classifier_labels: dict) -> dict:
    """Fraction of hallucinated objects also predicted by an image
    classifier (reference im_consistency.py:24-44).

    Args:
      classifier_labels: {image_id: set(predicted object node words)}.
    """
    consistent = 0
    total = 0
    for s in cap_dict["sentences"]:
        preds = classifier_labels.get(s["image_id"], set())
        for _w, node in s["mscoco_hallucinated_words"]:
            total += 1
            if node in preds:
                consistent += 1
    return {
        "consistency": consistent / total if total else 0.0,
        "hallucinated": total,
    }


def metric_hallucination_correlation(cap_dict: dict, metric: str = "CIDEr") -> float:
    """Pearson correlation between per-caption metric and CHAIRs flag
    (reference misc.py:58-123 predictive-metric helpers)."""
    xs, ys = [], []
    for s in cap_dict["sentences"]:
        xs.append(float(s["metrics"].get(metric, 0.0)))
        ys.append(float(s["metrics"]["CHAIRs"]))
    n = len(xs)
    if n < 2:
        return 0.0
    mx, my = sum(xs) / n, sum(ys) / n
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    vx = sum((x - mx) ** 2 for x in xs)
    vy = sum((y - my) ** 2 for y in ys)
    if vx == 0 or vy == 0:
        return 0.0
    return cov / (vx**0.5 * vy**0.5)
