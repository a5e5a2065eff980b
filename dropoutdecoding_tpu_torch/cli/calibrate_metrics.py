"""Calibrate METEOR-lite / SPICE-lite against archived Java scores; port
of ``dropoutdecoding_tpu/cli/calibrate_metrics.py`` (host only: no model).

Scores the reference's archived Java-scored captions
(``results/*/llava_llava/coco/*_chair_results.json`` — per-image METEOR
and SPICE computed by pycocoevalcap's jars, reference
chair_test/chair_test.py:402-441) with this repo's lite ports and
reports per-image correlation + offset.  See
evalsuite/metrics/calibration.py for the pseudo-reference method and
its caveat; the JAX package's study is committed in
docs/METRIC_CALIBRATION.md.

    python -m dropoutdecoding_tpu_torch.cli.calibrate_metrics \
        --results-root <the reference's results/ tree> \
        --out-json calibration.json --sample-out calibration_sample.json
"""
from __future__ import annotations

import argparse
import json
import random

from ..evalsuite.metrics.calibration import (
    build_pairs,
    calibrate,
    load_archived_runs,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--results-root", required=True)
    ap.add_argument("--per-run", type=int, default=40,
                    help="captions sampled per archived run")
    ap.add_argument("--max-refs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--sample-out", default=None,
                    help="also write a small vendored (caption, refs, "
                         "java-scores) sample for the regression test")
    ap.add_argument("--sample-size", type=int, default=150)
    args = ap.parse_args(argv)

    report = {}
    for mode in ("first_sentence", "full"):
        report[mode] = calibrate(
            args.results_root, per_run=args.per_run,
            max_refs=args.max_refs, seed=args.seed, ref_mode=mode,
        )
        m = report[mode]["METEOR"]
        print(
            f"{mode}: METEOR pearson={m['pearson']} "
            f"spearman={m['spearman']} offset={m['offset_mean']}"
            f"+-{m['offset_std']} (n={m['n']}); "
            f"SPICE pearson={report[mode]['SPICE']['pearson']} "
            f"offset={report[mode]['SPICE']['offset_mean']}"
        )

    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.out_json)

    if args.sample_out:
        runs = load_archived_runs(args.results_root)
        pairs = build_pairs(runs, per_run=args.per_run,
                            max_refs=args.max_refs, seed=args.seed,
                            ref_mode="first_sentence")
        rng = random.Random(args.seed)
        sample = rng.sample(pairs, min(args.sample_size, len(pairs)))
        with open(args.sample_out, "w") as f:
            json.dump(
                {
                    "_provenance": (
                        "captions + per-image Java METEOR/SPICE from the "
                        "reference's archived results tree "
                        "(results/*/llava_llava/coco/*_chair_results.json"
                        "); pseudo-references are first sentences of "
                        "other runs' captions of the same image "
                        "(evalsuite/metrics/calibration.py)"
                    ),
                    "pairs": [
                        {
                            "caption": c,
                            "refs": rs,
                            "java_meteor": jm,
                            "java_spice": js,
                        }
                        for c, rs, jm, js in sample
                    ],
                },
                f,
                indent=1,
            )
        print("wrote", args.sample_out, f"({len(sample)} pairs)")


if __name__ == "__main__":
    main()
