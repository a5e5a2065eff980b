"""Experiment-grid launcher (L6); port of
``dropoutdecoding_tpu/cli/run_experiments.py``.  Every job runs the port's
CHAIR CLI, ``python -m dropoutdecoding_tpu_torch.cli.chair_test``, on the
card.

Replaces the reference's SLURM generators (scripts/run_main_experiments.py:
24-86 — one job per method x model x seed; run_ablations.py:19-46 — the
avg x voting_numbers x seed ablation grid).  Default mode runs jobs
locally and sequentially (one GPU host is this framework's unit of
execution); ``--emit-slurm`` writes sbatch files instead for cluster
fan-out, preserving the reference's operational pattern.

Usage:
  python -m dropoutdecoding_tpu_torch.cli.run_experiments \
      --coco-data-dir /data/coco --model-paths llava-1.5=/ckpts/llava \
      --grid main --seeds 0 1 2 [--emit-slurm ./jobs]
"""
from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys

CHAIR_MODULE = "dropoutdecoding_tpu_torch.cli.chair_test"

MAIN_METHODS = {
    # method name -> extra chair_test flags (reference
    # run_main_experiments.py main-experiment grid)
    "greedy": ["--original", "True"],
    "beam-search": ["--original", "True", "--num-beams", "3"],
    "vcd": ["--vcd", "True"],
    "uncertainty-guided": [],
}


def build_jobs(args):
    model_paths = dict(kv.split("=", 1) for kv in args.model_paths)
    jobs = []
    if args.grid == "main":
        for model, path in model_paths.items():
            for method, extra in MAIN_METHODS.items():
                for seed in args.seeds:
                    jobs.append(
                        [
                            sys.executable, "-m",
                            CHAIR_MODULE,
                            "--method", f"{method}_s{seed}",
                            "--model", model,
                            "--model-path", path,
                            "--coco-data-dir", args.coco_data_dir,
                            "--seed", str(seed),
                            "--image-numbers", str(args.image_numbers),
                            "--sample-save-name", f"sample_{model}_{seed}.log",
                        ]
                        + extra
                    )
    elif args.grid == "ablations":
        # reference run_ablations.py: avg x voting_numbers in 1..5 x seed
        for model, path in model_paths.items():
            for avg in ("False", "True"):
                for vn in range(1, 6):
                    for seed in args.seeds:
                        jobs.append(
                            [
                                sys.executable, "-m",
                                CHAIR_MODULE,
                                "--method", f"abl_avg{avg}_vn{vn}_s{seed}",
                                "--model", model,
                                "--model-path", path,
                                "--coco-data-dir", args.coco_data_dir,
                                "--seed", str(seed),
                                "--avg", avg,
                                "--voting-numbers", str(vn),
                                "--image-numbers", str(args.image_numbers),
                                "--sample-save-name", f"sample_{model}_{seed}.log",
                            ]
                        )
    else:
        raise SystemExit(f"unknown grid {args.grid!r}")
    return jobs


def main(args):
    jobs = build_jobs(args)
    print(f"{len(jobs)} jobs in grid {args.grid!r}")
    if args.emit_slurm:
        os.makedirs(args.emit_slurm, exist_ok=True)
        for i, cmd in enumerate(jobs):
            path = os.path.join(args.emit_slurm, f"job_{i:03d}.sbatch")
            with open(path, "w") as f:
                f.write(
                    "#!/bin/bash\n"
                    f"#SBATCH --job-name=dd_{i:03d}\n"
                    "#SBATCH --time=0-12:00:00\n\n"
                    + " ".join(shlex.quote(c) for c in cmd)
                    + "\n"
                )
            print("wrote", path)
        return
    for i, cmd in enumerate(jobs):
        print(f"[{i + 1}/{len(jobs)}]", " ".join(cmd))
        if not args.dry_run:
            subprocess.run(cmd, check=args.stop_on_error)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--coco-data-dir", required=True)
    p.add_argument(
        "--model-paths",
        nargs="+",
        required=True,
        help="model=path pairs, e.g. llava-1.5=/ckpts/llava-1.5-7b-hf",
    )
    p.add_argument("--grid", choices=["main", "ablations"], default="main")
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--image-numbers", type=int, default=500)
    p.add_argument("--emit-slurm", type=str, default=None)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--stop-on-error", action="store_true")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
