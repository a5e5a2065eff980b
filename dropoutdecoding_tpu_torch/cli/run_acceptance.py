"""One-command real-checkpoint acceptance: smoke, the CHAIR grid, POPE,
and the BASELINE.md band asserts, emitting a signed JSON report; port of
``dropoutdecoding_tpu/cli/run_acceptance.py``.  Every stage runs the port's
CHAIR or POPE CLI in this process, on the card.

The reference has no equivalent (its acceptance evidence is the archived
results/ tree, BASELINE.md); this rig makes "does the rebuild match on
quality" a single invocation once weights + COCO val2014 exist:

    python -m dropoutdecoding_tpu_torch.cli.run_acceptance \
        --model-path /ckpt/llava-1.5-7b --coco-data-dir /data/coco \
        --work-dir ./acceptance

Stages (each an isolated working directory under --work-dir):
  1. smoke    — 8-image greedy caption run (pipeline sanity).
  2. greedy   — N-image --original run -> CHAIRs/CHAIRi.
  3. k3_vote  — N-image K=3 max-vote dropout decoding.
  4. k3_avg   — N-image K=3 average-aggregation variant.
  5. random   — N-image random-mask ablation (uncertainty OFF).
  6. pope     — POPE question set -> accuracy/F1/yes-ratio.

Bands (BASELINE.md "Acceptance band": reference run-to-run noise is
about +-2 CHAIRs / +-0.5 CHAIRi on 500-image samples):
  greedy: CHAIRs in [27, 29], CHAIRi in [7.0, 7.5]
  k3_vote: CHAIRs in [24, 28], CHAIRi in [6.3, 7.3]
  ordering: CHAIRs(random) > CHAIRs(k3_vote)  (the method must beat its
  own no-uncertainty ablation — reference results/notext_sample1_0)

``--no-assert`` reports without failing (e.g. non-500-image dry runs);
``--band-slack`` widens every band edge.  The report is "signed" with a
sha256 over its canonical payload so a pasted report can be checked for
tampering against the captions files it names.
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import sys
from datetime import datetime


BANDS = {
    "greedy": {"CHAIRs": (27.0, 29.0), "CHAIRi": (7.0, 7.5)},
    "k3_vote": {"CHAIRs": (24.0, 28.0), "CHAIRi": (6.3, 7.3)},
}


def _chair_args(ns_extra, *, method, workdir, args):
    """Build a chair_test namespace from its own parser (defaults stay in
    one place) + per-stage overrides."""
    from .chair_test import build_parser

    base = [
        "--method", method,
        "--coco-data-dir", args.coco_data_dir,
        "--model-path", args.model_path,
        "--model", args.model,
        "--image-numbers", str(args.images),
        "--output-dir", os.path.join(workdir, "outputs"),
        "--sample-save-name", os.path.join(workdir, "sample.log"),
    ]
    if args.seed is not None:
        base += ["--seed", str(args.seed)]
    if args.quantize:
        base += ["--quantize", args.quantize]
    if args.int8_kv:
        base += ["--int8-kv", "true"]
    return build_parser().parse_args(base + ns_extra)


def _read_chair_results(workdir, method, model):
    paths = glob.glob(
        os.path.join(
            workdir, "results", method, f"llava_{model}", "coco",
            "*_chair_results.json",
        )
    )
    if not paths:
        return None
    with open(sorted(paths)[-1]) as f:
        d = json.load(f)
    m = d["overall_metrics"]
    return {
        "CHAIRs": 100.0 * m["CHAIRs"],
        "CHAIRi": 100.0 * m["CHAIRi"],
        "n_captions": len(d.get("sentences", [])),
    }


def _run_chair_stage(name, extra, args, report, device):
    from .chair_test import main as chair_main

    workdir = os.path.join(args.work_dir, name)
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    n_images = min(8, args.images) if name == "smoke" else args.images
    stage_args = _chair_args(extra, method=name, workdir=workdir, args=args)
    stage_args.image_numbers = n_images
    t0 = datetime.now()
    try:
        os.chdir(workdir)  # chair_eval writes ./results
        chair_main(stage_args, device=device)
    finally:
        os.chdir(cwd)
    metrics = _read_chair_results(workdir, name, args.model)
    caps = glob.glob(os.path.join(workdir, "outputs", f"{name}*.json"))
    report["stages"][name] = {
        "metrics": metrics,
        "n_images": n_images,
        "captions_file": sorted(caps)[-1] if caps else None,
        "captions_sha256": _sha_file(sorted(caps)[-1]) if caps else None,
        "wall_s": (datetime.now() - t0).total_seconds(),
    }
    print(f"[acceptance] {name}: {metrics}", file=sys.stderr, flush=True)
    return metrics


def _run_pope_stage(args, report, device):
    from .pope_test import build_parser as pope_parser, main as pope_main

    workdir = os.path.join(args.work_dir, "pope")
    os.makedirs(workdir, exist_ok=True)
    pargs = pope_parser().parse_args(
        [
            "--model-path", args.model_path,
            "--coco-data-dir", args.coco_data_dir,
            "--model", {"llava-1.5": "llava"}.get(args.model, args.model),
            "--pope-dir", workdir,
            "--number", str(args.pope_number),
        ]
        + (["--seed", str(args.seed)] if args.seed is not None else [])
        + (["--quantize", args.quantize] if args.quantize else [])
    )
    t0 = datetime.now()
    pope_main(pargs, device=device)
    # collect the scores from the freshest answer file + its snapshot
    from ..evalsuite.pope import score_answers

    scores = {}
    for ans_path in sorted(
        glob.glob(os.path.join(workdir, "answer", "*_ans.json"))
    ):
        meta_path = ans_path.replace("_ans.json", "_ans.meta.json")
        if not os.path.exists(meta_path):
            continue
        with open(meta_path) as f:
            meta = json.load(f)
        strategy = meta["strategy"]
        qfile = os.path.join(
            meta["question_snapshot"], f"coco_pope_{strategy}.json"
        )
        if not os.path.exists(qfile):
            continue
        answers = [json.loads(l) for l in open(ans_path) if l.strip()]
        labels = [
            json.loads(l)["label"] for l in open(qfile) if l.strip()
        ][: len(answers)]
        scores[strategy] = score_answers(answers, labels)
    report["stages"]["pope"] = {
        "scores": scores,
        "wall_s": (datetime.now() - t0).total_seconds(),
    }
    print(f"[acceptance] pope: {list(scores)}", file=sys.stderr, flush=True)
    return scores


def _sha_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _check_bands(report, slack):
    checks = []
    stages = report["stages"]

    def band(stage, metric):
        m = stages.get(stage, {}).get("metrics")
        lo, hi = BANDS[stage][metric]
        lo, hi = lo - slack, hi + slack
        if m is None:
            checks.append({"check": f"{stage}.{metric}", "status": "missing"})
            return
        ok = lo <= m[metric] <= hi
        checks.append(
            {
                "check": f"{stage}.{metric}",
                "value": m[metric],
                "band": [lo, hi],
                "status": "pass" if ok else "FAIL",
            }
        )

    for stage in ("greedy", "k3_vote"):
        for metric in ("CHAIRs", "CHAIRi"):
            band(stage, metric)

    k3 = stages.get("k3_vote", {}).get("metrics")
    rnd = stages.get("random", {}).get("metrics")
    if k3 and rnd:
        ok = rnd["CHAIRs"] > k3["CHAIRs"]
        checks.append(
            {
                "check": "ordering.random_gt_k3",
                "value": [rnd["CHAIRs"], k3["CHAIRs"]],
                "status": "pass" if ok else "FAIL",
            }
        )
    report["checks"] = checks
    return all(c["status"] == "pass" for c in checks)


def main(args, device="cuda"):
    os.makedirs(args.work_dir, exist_ok=True)
    report = {
        "model_path": args.model_path,
        "model": args.model,
        "images": args.images,
        "seed": args.seed,
        "quantize": args.quantize,
        "started": datetime.now().isoformat(timespec="seconds"),
        "stages": {},
    }

    stage_set = set(args.stages.split(","))

    if "smoke" in stage_set:
        _run_chair_stage("smoke", ["--original", "True"], args, report, device)
        s = report["stages"]["smoke"]
        if not s["captions_file"]:
            raise SystemExit("acceptance: smoke stage produced no captions")
    if "greedy" in stage_set:
        _run_chair_stage("greedy", ["--original", "True"], args, report, device)
    if "k3_vote" in stage_set:
        _run_chair_stage("k3_vote", ["--voting-numbers", "3"], args, report, device)
    if "k3_avg" in stage_set:
        _run_chair_stage(
            "k3_avg", ["--voting-numbers", "3", "--avg", "True"], args, report, device
        )
    if "random" in stage_set:
        _run_chair_stage(
            "random",
            ["--voting-numbers", "3", "--use_random", "True"],
            args,
            report,
            device,
        )
    if "pope" in stage_set:
        _run_pope_stage(args, report, device)

    ok = _check_bands(report, args.band_slack)
    report["finished"] = datetime.now().isoformat(timespec="seconds")
    report["verdict"] = "pass" if ok else "FAIL"
    payload = json.dumps(report, sort_keys=True)
    report["signature_sha256"] = hashlib.sha256(
        payload.encode()
    ).hexdigest()
    out = os.path.join(args.work_dir, "acceptance_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"acceptance": report["verdict"], "report": out}))
    if not ok and not args.no_assert:
        raise SystemExit(
            "acceptance FAILED band checks — see " + out
        )
    return report


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model-path", required=True)
    p.add_argument("--coco-data-dir", required=True)
    p.add_argument("--model", default="llava-1.5")
    p.add_argument("--work-dir", default="./acceptance")
    p.add_argument("--images", type=int, default=500,
                   help="CHAIR sample size (bands assume 500)")
    p.add_argument("--pope-number", type=int, default=3000)
    p.add_argument("--seed", type=int, default=24)
    p.add_argument("--quantize", default=None,
                   choices=[None, "int8", "w8a8", "int4"])
    p.add_argument("--int8-kv", action="store_true")
    p.add_argument(
        "--stages",
        default="smoke,greedy,k3_vote,k3_avg,random,pope",
        help="comma list of stages to run",
    )
    p.add_argument("--band-slack", type=float, default=0.0)
    p.add_argument("--no-assert", action="store_true",
                   help="report only; do not exit non-zero on FAIL")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
