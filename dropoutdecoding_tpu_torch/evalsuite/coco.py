"""[Copy of ``dropoutdecoding_tpu/evalsuite/coco.py``, held against it by
tests/test_torch_evalsuite.py: the port imports nothing of the JAX package.]

Minimal COCO annotation index (replaces pycocotools.coco.COCO for the
operations the harness uses: getImgIds, loadImgs, loadRes, imgToAnns —
reference chair_test.py:45-52, 216-262, 407-422)."""
from __future__ import annotations


import json
from collections import defaultdict


class Coco:
    def __init__(self, annotation_file: str | None = None, dataset: dict | None = None):
        self.dataset = dataset or {}
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
        self._index()

    def _index(self):
        self.imgs = {img["id"]: img for img in self.dataset.get("images", [])}
        self.anns = {}
        self.img_to_anns = defaultdict(list)
        for i, ann in enumerate(self.dataset.get("annotations", [])):
            ann_id = ann.get("id", i)
            self.anns[ann_id] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        self.cats = {c["id"]: c for c in self.dataset.get("categories", [])}

    # pycocotools-compatible surface -----------------------------------
    def getImgIds(self):
        return list(self.imgs.keys())

    def loadImgs(self, ids):
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    @property
    def imgToAnns(self):
        return self.img_to_anns

    def loadRes(self, results: list) -> "Coco":
        """Build a result Coco from [{'image_id':..,'caption':..}, ...]."""
        res = {
            "images": [self.imgs[r["image_id"]] for r in results if r["image_id"] in self.imgs],
            "annotations": [
                {
                    "image_id": r["image_id"],
                    "id": i,
                    "caption": r["caption"],
                }
                for i, r in enumerate(results)
            ],
        }
        return Coco(dataset=res)


def load_coco_data(data_dir: str):
    """(captions Coco, instances dict) — reference chair_test.py:45-52."""
    import os

    with open(os.path.join(data_dir, "annotations/instances_val2014.json")) as f:
        coco_anns = json.load(f)
    coco = Coco(os.path.join(data_dir, "annotations/captions_val2014.json"))
    return coco, coco_anns
