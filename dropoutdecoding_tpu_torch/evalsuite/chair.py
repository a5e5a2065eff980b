"""[Copy of ``dropoutdecoding_tpu/evalsuite/chair.py``, held against it by
tests/test_torch_evalsuite.py: the port imports nothing of the JAX package.]

CHAIR (Caption Hallucination Assessment with Image Relevance) evaluator.

Behavioral port of reference chair_test/chair_metrics/chair.py (Rohrbach et
al.'s metric): per caption, extract MSCOCO object mentions (tokenize ->
singularize -> double-word merge -> synonym canonicalization) and compare
against ground-truth objects taken from BOTH instance segmentations and the
train+val caption annotations.

  CHAIRs = |captions with >=1 hallucinated object| / |captions|
  CHAIRi = |hallucinated object mentions| / |object mentions|
  (reference chair.py:320-321)

Differences from the reference, by design:
- the synonym table is package data (the reference reads a hard-coded
  absolute path that does not exist in its repo, chair.py:62);
- tokenize/singularize come from evalsuite.text (nltk-punkt- and
  pattern-free);
- annotation loading takes pre-parsed dicts so callers control IO.
"""
from __future__ import annotations

import json
import os
from typing import Iterable

from .text import singularize, word_tokenize

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

# MSCOCO-specific phrase rules (same data the metric is defined with,
# reference chair.py:74-137).
_DOUBLE_WORDS = [
    "motor bike", "motor cycle", "air plane", "traffic light", "street light",
    "traffic signal", "stop light", "fire hydrant", "stop sign",
    "parking meter", "suit case", "sports ball", "baseball bat",
    "baseball glove", "tennis racket", "wine glass", "hot dog", "cell phone",
    "mobile phone", "teddy bear", "hair drier", "potted plant", "bow tie",
    "laptop computer", "stove top oven", "home plate", "train track",
]
_ANIMALS = [
    "bird", "cat", "dog", "horse", "sheep", "cow", "elephant", "bear",
    "zebra", "giraffe", "animal", "cub",
]
_VEHICLES = ["jet", "train"]


def _load_synonyms(path: str | None = None):
    path = path or os.path.join(_DATA_DIR, "synonyms.txt")
    with open(path) as f:
        rows = [line.strip().split(", ") for line in f if line.strip()]
    mscoco_objects = []
    inverse = {}
    for row in rows:
        mscoco_objects.extend(row)
        for w in row:
            inverse[w] = row[0]
    return mscoco_objects, inverse


class ChairEvaluator:
    def __init__(self, image_ids: Iterable[int], synonyms_path: str | None = None):
        self.imid_to_objects = {imid: set() for imid in image_ids}
        self.mscoco_objects, self.inverse_synonym = _load_synonyms(synonyms_path)
        self._object_set = set(self.mscoco_objects)

        dd = {w: w for w in _DOUBLE_WORDS}
        for a in _ANIMALS:
            dd[f"baby {a}"] = a
            dd[f"adult {a}"] = a
        for v in _VEHICLES:
            dd[f"passenger {v}"] = v
        dd["bow tie"] = "tie"
        dd["toilet seat"] = "toilet"
        dd["wine glas"] = "wine glass"
        self.double_word_dict = dd

    # ------------------------------------------------------------------
    def caption_to_words(self, caption: str):
        """caption -> (coco words, canonical node words, token idxs,
        all merged tokens) — reference chair.py:148-188."""
        words = [singularize(w) for w in word_tokenize(caption.lower())]

        merged, idxs = [], []
        i = 0
        while i < len(words):
            idxs.append(i)
            pair = " ".join(words[i : i + 2])
            if pair in self.double_word_dict:
                merged.append(self.double_word_dict[pair])
                i += 2
            else:
                merged.append(words[i])
                i += 1

        # "the seat of the toilet" must not fire for 'chair'
        if "toilet" in merged and "seat" in merged:
            merged = [w for w in merged if w != "seat"]

        kept_idxs = [
            idxs[pos] for pos, w in enumerate(merged) if w in self._object_set
        ]
        kept = [w for w in merged if w in self._object_set]
        nodes = [self.inverse_synonym[w] for w in kept]
        return kept, nodes, kept_idxs, merged

    # ------------------------------------------------------------------
    def add_annotations_from_instances(self, instances: dict):
        """Ground-truth objects from segmentation annotations
        (reference chair.py:190-216)."""
        id_to_name = {c["id"]: c["name"] for c in instances["categories"]}
        for ann in instances["annotations"]:
            imid = ann["image_id"]
            if imid in self.imid_to_objects:
                self.imid_to_objects[imid].add(
                    self.inverse_synonym[id_to_name[ann["category_id"]]]
                )

    def add_annotations_from_captions(self, captions: dict):
        """Ground-truth objects from GT captions (reference chair.py:218-238).
        Note the reference combines train+val annotation files for both
        instance and caption ground truth (chair.py:13-52)."""
        for ann in captions["annotations"]:
            imid = ann["image_id"]
            if imid in self.imid_to_objects:
                _, nodes, _, _ = self.caption_to_words(ann["caption"])
                self.imid_to_objects[imid].update(nodes)

    def load_annotations(self, annotation_dir: str, splits=("val", "train")):
        """Load instances_*2014.json + captions_*2014.json for the given
        splits.  Missing train files degrade gracefully to val-only (the
        reference hard-requires both, chair.py:13-17)."""
        for split in splits:
            ipath = os.path.join(annotation_dir, f"instances_{split}2014.json")
            cpath = os.path.join(annotation_dir, f"captions_{split}2014.json")
            if os.path.exists(ipath):
                with open(ipath) as f:
                    self.add_annotations_from_instances(json.load(f))
            if os.path.exists(cpath):
                with open(cpath) as f:
                    self.add_annotations_from_captions(json.load(f))

    # ------------------------------------------------------------------
    def compute(self, caps: list, overall_metrics: dict | None = None) -> dict:
        """Score generated captions.

        Args:
          caps: iterable of per-image eval dicts with at least
            {'image_id', 'caption'} (plus COCOEvalCap metric keys when
            available — the reference feeds imgToEval values,
            chair.py:248-336).
        Returns the reference's output schema: {'sentences': [...],
        'overall_metrics': {...}}.
        """
        num_caps = 0.0
        num_halluc_caps = 0.0
        halluc_words = 0.0
        coco_words = 0.0
        metric_keys = (
            "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
            "METEOR", "CIDEr", "SPICE", "ROUGE_L",
        )
        out = {"sentences": []}
        for cap_eval in caps:
            caption = cap_eval["caption"]
            imid = cap_eval["image_id"]
            words, nodes, idxs, raw = self.caption_to_words(caption)
            gt = self.imid_to_objects.get(imid, set())
            rec = {
                "image_id": imid,
                "caption": caption,
                "mscoco_hallucinated_words": [],
                "mscoco_gt_words": list(gt),
                "mscoco_generated_words": list(nodes),
                "hallucination_idxs": [],
                "words": raw,
                "metrics": {k: cap_eval.get(k, 0.0) for k in metric_keys},
            }
            coco_words += len(nodes)
            hallucinated = False
            for w, node, idx in zip(words, nodes, idxs):
                if node not in gt:
                    halluc_words += 1
                    rec["mscoco_hallucinated_words"].append((w, node))
                    rec["hallucination_idxs"].append(idx)
                    hallucinated = True
            num_caps += 1
            if hallucinated:
                num_halluc_caps += 1
            rec["metrics"]["CHAIRs"] = int(hallucinated)
            rec["metrics"]["CHAIRi"] = (
                len(rec["mscoco_hallucinated_words"]) / float(len(words))
                if words
                else 0.0
            )
            out["sentences"].append(rec)

        overall = dict(overall_metrics or {})
        for k in metric_keys:
            overall.setdefault(k, 0.0)
        overall["CHAIRs"] = num_halluc_caps / num_caps if num_caps else 0.0
        overall["CHAIRi"] = halluc_words / coco_words if coco_words else 0.0
        out["overall_metrics"] = overall
        return out


def load_generated_captions(cap_file: str):
    """Read the {'overall', 'imgToEval'} self-critical format
    (reference chair.py:339-352)."""
    with open(cap_file) as f:
        data = json.load(f)
    if "imgToEval" not in data:
        raise ValueError(
            "expected a dict with 'imgToEval' (self-critical format)"
        )
    caps = list(data["imgToEval"].values())
    imids = set(c["image_id"] for c in caps)
    return caps, imids, data.get("overall", {})


def metric_table(cap_dict: dict) -> str:
    """5-metric tab table — the first two lines are byte-compatible with
    the reference's results/*.txt files (chair.py:361-376); substituted
    metric columns (SPICE-lite / METEOR-lite) are flagged in comment lines
    below the table."""
    m = cap_dict["overall_metrics"]
    row = "%0.01f\t%0.01f\t%0.01f\t%0.01f\t%0.01f" % (
        m["SPICE"] * 100,
        m["METEOR"] * 100,
        m["CIDEr"] * 100,
        m["CHAIRs"] * 100,
        m["CHAIRi"] * 100,
    )
    table = "SPICE\tMETEOR\tCIDEr\tCHAIRs\tCHAIRi\n" + row
    notes = m.get("_metric_notes") or {}
    for name in sorted(notes):
        table += f"\n# {name}: {notes[name]}"
    return table
