"""[Copy of ``dropoutdecoding_tpu/cli/chair2throne.py``, held against it by
tests/test_torch_evalsuite.py: the port imports nothing of the JAX package.]

CHAIR caption file -> THRONE free-form input export.

The reference README references a utils/chair2throne.py converter that is
missing from its repo (README.md:67; SURVEY.md §2.3).  THRONE (Kaul et
al., CVPR 2024) evaluates free-form responses: its input is a JSONL of
per-image responses.  This recreates the converter from the caption JSONL
the chair harness writes ({'image_id', 'caption'} per line,
chair_test.py:368-372).
"""
from __future__ import annotations

import argparse
import json


def convert(caption_path: str, out_path: str, question: str = "Describe the image."):
    with open(caption_path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    seen = set()
    with open(out_path, "w") as f:
        for rec in records:
            if rec["image_id"] in seen:
                continue
            seen.add(rec["image_id"])
            f.write(
                json.dumps(
                    {
                        "image_id": rec["image_id"],
                        "question": question,
                        "response": rec["caption"],
                    }
                )
                + "\n"
            )
    return len(seen)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("caption_file")
    p.add_argument("out_file")
    p.add_argument("--question", default="Describe the image.")
    a = p.parse_args()
    n = convert(a.caption_file, a.out_file, a.question)
    print(f"wrote {n} responses to {a.out_file}")
