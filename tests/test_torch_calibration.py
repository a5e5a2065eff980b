"""The port's METEOR / SPICE-lite calibration (``evalsuite/metrics/
calibration.py``, ``cli/calibrate_metrics.py``) against the JAX package's.

Both run the same host arithmetic over their own copies of the lite
scorers, so every number must be equal: ``score_pairs`` on the committed
150-pair sample of archived Java scores, and ``calibrate`` plus the CLI's
printout, report and vendored sample on a synthetic results tree (four
runs of five images sharing ids, captions drawn from the sample, plus a
run without metrics, a NaN SPICE and an unreadable file, which both skip).
"""
import json
import math
import os

import numpy as np
import pytest

from dropoutdecoding_tpu.cli import calibrate_metrics as jcli
from dropoutdecoding_tpu.evalsuite.metrics import calibration as jcal
from dropoutdecoding_tpu_torch.cli import calibrate_metrics as tcli
from dropoutdecoding_tpu_torch.evalsuite.metrics import calibration as tcal

SAMPLE = os.path.join(os.path.dirname(__file__), "data", "metric_calibration_sample.json")


def _pairs():
    with open(SAMPLE) as f:
        data = json.load(f)
    return [(p["caption"], p["refs"], p["java_meteor"], p["java_spice"]) for p in data["pairs"]]


def test_score_pairs_equals_jax_on_the_committed_sample():
    pairs = _pairs()
    got = tcal.score_pairs(pairs)
    assert got == jcal.score_pairs(pairs)
    assert got["METEOR"]["n"] == 150 and got["METEOR"]["pearson"] > 0.3


@pytest.fixture(scope="module")
def results_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("results")
    r = np.random.default_rng(3)
    captions = [p[0] for p in _pairs()]
    for run in range(4):
        d = root / f"run_{run}" / "llava_llava" / "coco"
        d.mkdir(parents=True)
        sents = []
        for iid in range(5):
            spice = float("nan") if (run, iid) == (2, 4) else float(r.random())
            sents.append({
                "image_id": 100 + iid,
                "caption": captions[int(r.integers(len(captions)))],
                "metrics": {"METEOR": float(r.random()), "SPICE": {"All": {"f": spice}}},
            })
        (d / "llava_coco_chair_results.json").write_text(json.dumps({"sentences": sents}))
    bare = root / "run_bare" / "llava_llava" / "coco"
    bare.mkdir(parents=True)
    (bare / "x_chair_results.json").write_text(json.dumps({"sentences": [{"image_id": 1}]}))
    (bare / "y_chair_results.json").write_text("{not json")
    (root / "a_file_not_a_run.txt").write_text("")
    return str(root)


@pytest.mark.parametrize("ref_mode", ["first_sentence", "full"])
def test_calibrate_equals_jax(results_root, ref_mode):
    kw = dict(per_run=3, max_refs=3, seed=1, ref_mode=ref_mode)
    got = tcal.calibrate(results_root, **kw)
    assert got == jcal.calibrate(results_root, **kw)
    assert got["runs"] == 4 and got["METEOR"]["n"] > 0
    assert not any(isinstance(v, float) and math.isnan(v) for v in got["SPICE"].values())


def test_calibrate_metrics_cli_equals_jax(results_root, tmp_path, capsys):
    def run(module, name):
        out = tmp_path / name
        out.mkdir()
        module.main(["--results-root", results_root, "--per-run", "4", "--max-refs", "3",
                     "--out-json", str(out / "report.json"), "--sample-out",
                     str(out / "sample.json"), "--sample-size", "5"])
        return capsys.readouterr().out.replace(str(out), "<out>"), out

    want, jout = run(jcli, "jax")
    got, tout = run(tcli, "port")
    assert got == want and "wrote" in got
    for name in ("report.json", "sample.json"):
        assert json.loads((tout / name).read_text()) == json.loads((jout / name).read_text())
