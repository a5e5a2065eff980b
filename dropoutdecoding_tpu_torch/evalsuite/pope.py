"""POPE (Polling-based Object Probing Evaluation): question building with
random / popular / adversarial negatives, yes/no normalisation and the
confusion-matrix scores.

[Copy of ``dropoutdecoding_tpu/evalsuite/pope.py``, held against it by
tests/test_torch_pope.py: the port imports nothing of the JAX package.  Its
``data/pope/`` is a byte-for-byte copy of that package's, checked by the
same test.]"""
from __future__ import annotations

import json
import os
import random
from collections import defaultdict

TEMPLATE = "Is there a {} in the image?"


def build_questions(
    segment_results: list,
    sample_num: int,
    neg_strategy: str,
    template: str = TEMPLATE,
    seed: int | None = None,
) -> list:
    """Build POPE questions for one negative-sampling strategy.

    Args:
      segment_results: [{'image': filename, 'objects': [names...]}, ...]
      sample_num: positive (and negative) samples per image.
      neg_strategy: 'random' | 'popular' | 'adversarial'.
    Returns:
      list of question dicts {question_id, image, text, label}.

    Mirrors reference utils.py:26-106: per image, alternate a positive
    question for each of the first `sample_num` objects with one negative
    drawn per strategy; a/an article fix per utils.py:12-23.
    """
    rng = random.Random(seed)
    gt_freq = ground_truth_objects(segment_results)
    gt_list = list(gt_freq.keys())
    by_popularity = sorted(gt_freq.items(), key=lambda kv: kv[1], reverse=True)
    co_occur = co_occurrence(segment_results)

    def make_q(qid, image, obj, label):
        text = template.replace("a", "an") if obj[0] in "aeiou" else template
        return {
            "question_id": qid,
            "image": image,
            "text": text.format(obj),
            "label": label,
        }

    questions = []
    qid = 1
    for image in segment_results:
        history = []
        objs = image["objects"]
        for i in range(min(sample_num, len(objs))):
            pos = objs[i]
            history.append(pos)
            questions.append(make_q(qid, image["image"], pos, "yes"))
            qid += 1

            candidates = [o for o in gt_list if o not in history and o not in objs]
            if not candidates:
                # vocabulary exhausted for this image (the reference's
                # unbounded retry loop, utils.py:70-78/93-101, would hang
                # here; real COCO's 80 categories never exhaust)
                continue
            neg = None
            if neg_strategy == "random":
                neg = rng.choice(candidates)
            elif neg_strategy == "popular":
                for cand, _ in by_popularity:
                    if cand in candidates:
                        neg = cand
                        break
            elif neg_strategy == "adversarial":
                for cand in co_occur.get(pos, []):
                    if cand in candidates:
                        neg = cand
                        break
            else:
                raise ValueError(neg_strategy)
            if neg is None:
                neg = rng.choice(candidates)
            history.append(neg)
            questions.append(make_q(qid, image["image"], neg, "no"))
            qid += 1
    return questions


def ground_truth_objects(segment_results: list) -> dict:
    """Object -> frequency (reference utils.py:109-125)."""
    freq = {}
    for image in segment_results:
        for o in image["objects"]:
            freq[o] = freq.get(o, 0) + 1
    return freq


def co_occurrence(segment_results: list) -> dict:
    """Object -> co-occurring objects sorted by count desc
    (reference utils.py:128-155)."""
    co = defaultdict(lambda: defaultdict(int))
    for image in segment_results:
        objs = image["objects"]
        for o in objs:
            for other in objs:
                if other != o:
                    co[o][other] += 1
    return {
        o: [w for w, _ in sorted(d.items(), key=lambda kv: kv[1], reverse=True)]
        for o, d in co.items()
    }


def vendored_question_dir(dataset: str = "coco") -> str:
    """Directory holding the FROZEN canonical POPE question sets shipped
    as package data (data/pope/PROVENANCE.md) — the byte-exact files the
    reference's archived answer sets were scored against, so POPE runs
    reproduce them without any COCO annotations on disk."""
    return os.path.join(os.path.dirname(__file__), "data", "pope", dataset)


def seed_question_dir(question_dir: str, dataset: str = "coco") -> list:
    """Populate ``question_dir`` with the vendored canonical question sets.
    Returns the created file paths."""
    import shutil

    src_dir = vendored_question_dir(dataset)
    os.makedirs(question_dir, exist_ok=True)
    paths = []
    for strategy in ("random", "popular", "adversarial"):
        name = f"{dataset}_pope_{strategy}.json"
        dst = os.path.join(question_dir, name)
        shutil.copyfile(os.path.join(src_dir, name), dst)
        paths.append(dst)
    return paths


def write_questions(questions: list, out_dir: str, dataset: str, strategy: str):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{dataset}_pope_{strategy}.json")
    with open(path, "w") as f:
        for q in questions:
            f.write(json.dumps(q) + "\n")
    return path


def normalize_answer(text: str) -> str:
    """'no' iff the first sentence contains No/not/no as a word
    (reference pope_test.py:92-103)."""
    if "." in text:
        text = text.split(".")[0]
    words = text.replace(",", "").split(" ")
    return "no" if ("No" in words or "not" in words or "no" in words) else "yes"


def score_answers(answers: list, labels: list, number: int | None = None) -> dict:
    """Confusion matrix + Accuracy/Precision/Recall/F1/yes-ratio
    (reference pope_test.py:105-144).

    Args:
      answers: [{'question': .., 'answer': ..}, ...] raw model outputs.
      labels: ['yes'|'no', ...] aligned ground truth.
    """
    if number is not None:
        answers = answers[:number]
        labels = labels[:number]
    preds = [1 if normalize_answer(a["answer"]) == "yes" else 0 for a in answers]
    gold = [0 if l == "no" else 1 for l in labels]

    TP = sum(1 for p, g in zip(preds, gold) if p == 1 and g == 1)
    FP = sum(1 for p, g in zip(preds, gold) if p == 1 and g == 0)
    TN = sum(1 for p, g in zip(preds, gold) if p == 0 and g == 0)
    FN = sum(1 for p, g in zip(preds, gold) if p == 0 and g == 1)

    precision = TP / (TP + FP) if TP + FP else 0.0
    recall = TP / (TP + FN) if TP + FN else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    acc = (TP + TN) / max(TP + TN + FP + FN, 1)
    yes_ratio = sum(preds) / max(len(preds), 1)
    return {
        "TP": TP,
        "FP": FP,
        "TN": TN,
        "FN": FN,
        "accuracy": acc,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "yes_ratio": yes_ratio,
    }


def print_scores(s: dict):
    print("TP\tFP\tTN\tFN\t")
    print(f"{s['TP']}\t{s['FP']}\t{s['TN']}\t{s['FN']}")
    print(f"Accuracy: {s['accuracy']}")
    print(f"Precision: {s['precision']}")
    print(f"Recall: {s['recall']}")
    print(f"F1 score: {s['f1']}")
    print(f"Yes ratio: {s['yes_ratio']}")


def parse_question_file(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
