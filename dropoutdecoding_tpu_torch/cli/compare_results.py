"""Diff two CHAIR result JSONs: images hallucinated in run A but clean in
run B (and vice versa with --both); port of
``dropoutdecoding_tpu/cli/compare_results.py``.  Replaces reference
utils/compare.py (which hard-codes its two input paths, compare.py:12-13)."""
from __future__ import annotations

import argparse
import json


def hallucinated_ids(result: dict) -> set:
    return {
        s["image_id"]
        for s in result["sentences"]
        if s["mscoco_hallucinated_words"]
    }


def main(args):
    with open(args.file1) as f:
        r1 = json.load(f)
    with open(args.file2) as f:
        r2 = json.load(f)
    h1, h2 = hallucinated_ids(r1), hallucinated_ids(r2)
    only1 = sorted(h1 - h2)
    print(f"{len(only1)} images hallucinated in {args.file1} but clean in {args.file2}:")
    for i in only1:
        print(" ", i)
    if args.both:
        only2 = sorted(h2 - h1)
        print(f"{len(only2)} images hallucinated in {args.file2} but clean in {args.file1}:")
        for i in only2:
            print(" ", i)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("file1")
    p.add_argument("file2")
    p.add_argument("--both", action="store_true")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
