"""Calibrate the lite METEOR/SPICE ports against archived Java scores;
port of ``dropoutdecoding_tpu/evalsuite/metrics/calibration.py`` over the
port's own ``meteor``, ``spice_lite`` and ``evalcap`` copies.

The reference scores captions with pycocoevalcap's Java METEOR-1.5 and
SPICE jars (reference chair_test/chair_test.py:402-441).  This package
runs no JVM, so the lite ports (metrics/meteor.py, metrics/spice_lite.py)
fill those columns, with an offset this module quantifies.  The reference's archived results tree IS a
Java-scored corpus: every ``*_chair_results.json`` carries per-image
**Java-computed** METEOR and SPICE values for its captions (format
reference chair_test/chair_metrics/chair.py:339-352), ~28.9k captions
across 62 runs.  This module scores those same captions with the lite
ports and reports correlation + offset against the Java numbers.

Caveat, stated machine-readably in the output: the Java scores were
computed against the 5 COCO ground-truth captions per image, which are
NOT in the archives.  The lite scores
here use **cross-run pseudo-references** — captions of the same image
from OTHER archived runs (deterministic pick).  The reported offset
therefore folds the reference-set shift in with the scorer difference;
the correlation measures whether lite scores RANK captions consistently
with Java scores, which is the operationally relevant property for a
JVM-less environment (comparing methods on the same reference set).
"""
from __future__ import annotations

import json
import math
import os
import random

from .evalcap import ptb_tokenize
from .meteor import meteor_lite
from .spice_lite import spice_lite


def load_archived_runs(results_root: str) -> dict:
    """{run_name: {image_id: {"caption", "METEOR", "SPICE"}}} from every
    ``*_chair_results.json`` under ``results_root`` that carries
    per-sentence Java metrics."""
    runs = {}
    for run_name in sorted(os.listdir(results_root)):
        run_dir = os.path.join(results_root, run_name)
        if not os.path.isdir(run_dir):
            continue
        for dirpath, _, files in os.walk(run_dir):
            for f in sorted(files):
                if not f.endswith("_chair_results.json"):
                    continue
                try:
                    with open(os.path.join(dirpath, f)) as fh:
                        data = json.load(fh)
                except (OSError, json.JSONDecodeError):
                    continue
                sents = data.get("sentences", [])
                if not sents or "metrics" not in sents[0]:
                    continue
                per_img = {}
                for s in sents:
                    m = s.get("metrics", {})
                    spice = m.get("SPICE")
                    spice_f = (
                        spice["All"]["f"]
                        if isinstance(spice, dict) and "All" in spice
                        else None
                    )
                    if m.get("METEOR") is None or spice_f is None:
                        continue
                    if isinstance(spice_f, float) and math.isnan(spice_f):
                        continue
                    per_img[s["image_id"]] = {
                        "caption": s["caption"],
                        "METEOR": float(m["METEOR"]),
                        "SPICE": float(spice_f),
                    }
                if per_img:
                    # one results file per run dir in practice; suffix on
                    # collision (200- and 500-image files can coexist)
                    key = run_name
                    while key in runs:
                        key += "+"
                    runs[key] = per_img
    return runs


def first_sentence(caption: str) -> str:
    """First sentence of a caption — ~15 words, one-aspect summary.  Used
    as the pseudo-reference form: COCO ground-truth captions (what the
    Java scores were computed against) are single short sentences, and
    whole 100+-word cross-run captions as references saturate the lite
    scorers (every run describes the image similarly -> lite ~0.7 with
    near-zero correlation, measured)."""
    cuts = [(caption.index(sep), sep) for sep in (". ", "! ", "? ")
            if sep in caption]
    if cuts:
        pos, sep = min(cuts)
        return caption[:pos] + sep.strip()
    return caption


def build_pairs(runs: dict, per_run: int = 50, max_refs: int = 5,
                seed: int = 0, ref_mode: str = "first_sentence") -> list:
    """(candidate, pseudo_refs, java_meteor, java_spice) tuples.

    Pseudo-references for an image are captions of the SAME image from
    OTHER runs (``ref_mode="first_sentence"`` reduces them to their first
    sentence — see ``first_sentence``), deduplicated by text, capped at
    ``max_refs`` in sorted-run order.  ``per_run`` caps sampled captions
    per run (the O(H*R) METEOR alignment makes full 28.9k-caption sweeps
    CPU-expensive; sampling is deterministic)."""
    by_image = {}
    for run_name, per_img in runs.items():
        for iid, rec in per_img.items():
            by_image.setdefault(iid, []).append((run_name, rec["caption"]))

    rng = random.Random(seed)
    pairs = []
    for run_name, per_img in sorted(runs.items()):
        iids = sorted(per_img)
        if per_run and len(iids) > per_run:
            iids = rng.sample(iids, per_run)
        for iid in iids:
            rec = per_img[iid]
            cand = rec["caption"]
            refs, seen = [], {cand.strip()}
            for other_run, cap in sorted(by_image.get(iid, [])):
                if other_run == run_name or cap.strip() in seen:
                    continue
                seen.add(cap.strip())
                if ref_mode == "first_sentence":
                    cap = first_sentence(cap)
                    if cap.strip() in seen:
                        continue
                    seen.add(cap.strip())
                refs.append(cap)
                if len(refs) >= max_refs:
                    break
            if len(refs) >= 2:
                pairs.append(
                    (cand, refs, rec["METEOR"], rec["SPICE"])
                )
    return pairs


def _pearson(xs, ys):
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sx = math.sqrt(sum((x - mx) ** 2 for x in xs))
    sy = math.sqrt(sum((y - my) ** 2 for y in ys))
    if sx == 0 or sy == 0:
        return 0.0
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / (sx * sy)


def _spearman(xs, ys):
    def ranks(v):
        order = sorted(range(len(v)), key=lambda i: v[i])
        r = [0.0] * len(v)
        i = 0
        while i < len(order):
            j = i
            while j + 1 < len(order) and v[order[j + 1]] == v[order[i]]:
                j += 1
            avg = (i + j) / 2.0
            for k in range(i, j + 1):
                r[order[k]] = avg
            i = j + 1
        return r

    return _pearson(ranks(xs), ranks(ys))


def _stats(lite, java):
    """Correlation + linear map java ~ a*lite + b + residual."""
    n = len(lite)
    pear = _pearson(lite, java)
    spear = _spearman(lite, java)
    ml, mj = sum(lite) / n, sum(java) / n
    var_l = sum((x - ml) ** 2 for x in lite) / n
    cov = sum((x - ml) * (y - mj) for x, y in zip(lite, java)) / n
    slope = cov / var_l if var_l > 0 else 0.0
    intercept = mj - slope * ml
    resid = [y - (slope * x + intercept) for x, y in zip(lite, java)]
    resid_std = math.sqrt(sum(r * r for r in resid) / n)
    offs = [x - y for x, y in zip(lite, java)]
    off_mean = sum(offs) / n
    off_std = math.sqrt(sum((o - off_mean) ** 2 for o in offs) / n)
    return {
        "n": n,
        "pearson": round(pear, 4),
        "spearman": round(spear, 4),
        "lite_mean": round(ml, 4),
        "java_mean": round(mj, 4),
        "offset_mean": round(off_mean, 4),
        "offset_std": round(off_std, 4),
        "java_from_lite_slope": round(slope, 4),
        "java_from_lite_intercept": round(intercept, 4),
        "residual_std": round(resid_std, 4),
    }


def score_pairs(pairs: list) -> dict:
    """Lite METEOR + SPICE for each (candidate, refs) pair vs the Java
    values; returns {"METEOR": stats, "SPICE": stats, "caveat": ...}."""
    hyps, refs = {}, {}
    for i, (cand, rs, _, _) in enumerate(pairs):
        hyps[i] = [ptb_tokenize(cand)]
        refs[i] = [ptb_tokenize(r) for r in rs]
    _, met_img = meteor_lite(hyps, refs)
    _, sp_img = spice_lite(hyps, refs)
    met_lite = [met_img[i] for i in range(len(pairs))]
    sp_lite = [sp_img[i]["f"] for i in range(len(pairs))]
    met_java = [p[2] for p in pairs]
    sp_java = [p[3] for p in pairs]
    return {
        "METEOR": _stats(met_lite, met_java),
        "SPICE": _stats(sp_lite, sp_java),
        "caveat": (
            "pseudo-references are other runs' captions of the same "
            "image, not the COCO ground-truth captions the Java scores "
            "used; offsets fold in that reference-set shift"
        ),
    }


def calibrate(results_root: str, per_run: int = 50, max_refs: int = 5,
              seed: int = 0, ref_mode: str = "first_sentence") -> dict:
    runs = load_archived_runs(results_root)
    pairs = build_pairs(runs, per_run=per_run, max_refs=max_refs, seed=seed,
                        ref_mode=ref_mode)
    out = score_pairs(pairs)
    out["runs"] = len(runs)
    out["per_run_sample"] = per_run
    out["max_refs"] = max_refs
    out["ref_mode"] = ref_mode
    return out
