"""The port's host-side tools against the JAX package's: ``step_gen`` (the
REPL), ``run_experiments`` (the job grids), ``compare_results`` and
``run_acceptance`` (the staged rig and its band checks).

Model-driving tools run a tiny LLaVA on one set of weights in both
packages (``test_torch_chair_cli``'s tiny checkpoint behind
``_TinyProcessor``, JAX's mask draws injected into the port), so their
captions must be equal; the rest is host code and must print, write and
decide exactly what the JAX tool does.
"""
import builtins
import hashlib
import json
import os
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from dropoutdecoding_tpu.cli import chair_test as jcli
from dropoutdecoding_tpu.cli import compare_results as jcmp
from dropoutdecoding_tpu.cli import run_acceptance as jrig
from dropoutdecoding_tpu.cli import run_experiments as jexp
from dropoutdecoding_tpu.cli import step_gen as jstep
from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.cli import chair_test as tcli
from dropoutdecoding_tpu_torch.cli import compare_results as tcmp
from dropoutdecoding_tpu_torch.cli import run_acceptance as trig
from dropoutdecoding_tpu_torch.cli import run_experiments as texp
from dropoutdecoding_tpu_torch.cli import step_gen as tstep
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.evalsuite import pope as teval
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import llava_params_from_numpy
from test_chair_cli_end_to_end import _TinyProcessor, synthetic_coco  # noqa: F401 (fixture)
from test_torch_engine import jax_uniform
from test_torch_serving_tools import one_thread  # noqa: F401 (autouse)
from test_torch_models import tiny_config, tiny_tree

SEED = 0


@pytest.fixture(scope="module")
def weights():
    tree, _ = tiny_tree()
    return jax.tree.map(jnp.asarray, tree), llava_params_from_numpy(tree)


def _gen(C):
    return C.GenerationConfig(max_new_tokens=4, eos_token_id=2, pad_token_id=2)


def _jax_engines(weights):
    """A ``make_engine`` for the JAX CLIs: the tiny LLaVA, greedy under
    ``--original``, else the CLI's ensemble; one engine an arm, so that its
    compiled programs serve every stage that runs the arm."""
    jp, _ = weights
    engines = {}

    def make(args):
        ens, ensemble = jcli.build_ensemble_config(args, args.model), not jcli.str2bool(args.original)
        if (ens, ensemble) not in engines:
            eng = JaxEngine(cfg=tiny_config(jax_config), params=jp, ens=ens, gen=_gen(jax_config),
                            max_len=48, seed=SEED, ensemble=ensemble)
            eng.param_dtype = jnp.float32
            engines[ens, ensemble] = eng
        eng = engines[ens, ensemble]
        eng.gen = _gen(jax_config)  # the POPE CLI sets its own on the engine it gets
        return eng, _TinyProcessor(eng.cfg)

    return make


def _port_engines(weights):
    _, tp = weights

    def make(args, device="cuda"):
        assert device == "cpu"
        eng = LlavaEngine(
            cfg=tiny_config(torch_config), params=tp,
            ens=tcli.build_ensemble_config(args, args.model), gen=_gen(torch_config), max_len=48,
            seed=SEED, ensemble=not tcli.str2bool(args.original), uniform=jax_uniform(SEED),
        )
        return eng, _TinyProcessor(eng.cfg)

    return make


# ---------------------------------------------------------------------------
# step_gen
# ---------------------------------------------------------------------------


def _image(path, seed):
    r = np.random.default_rng(seed)
    Image.fromarray((r.random((40, 52, 3)) * 255).astype(np.uint8), "RGB").save(path, "JPEG")
    return str(path)


def _repl(module, lines, monkeypatch, capsys, **main_kw):
    """``module.main`` over scripted input; returns what it printed, by line."""
    feed = iter(lines)
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(feed))
    module.main(Namespace(model="llava-1.5", model_path="/unused", seed=SEED), **main_kw)
    return capsys.readouterr().out.splitlines()


def test_step_gen_matches_the_jax_repl(tmp_path, monkeypatch, capsys, weights):
    a, b = _image(tmp_path / "a.jpg", 1), _image(tmp_path / "b.jpg", 2)
    lines = ["!uncert", a, "!uncert", "", f"!greedy {b}", "!uncert", str(tmp_path / "none.jpg"),
             "!quit", "never read"]
    monkeypatch.setattr(jcli, "make_engine", _jax_engines(weights))
    want = _repl(jstep, lines, monkeypatch, capsys)
    monkeypatch.setattr(tcli, "make_engine", _port_engines(weights))
    got = _repl(tstep, lines, monkeypatch, capsys, device="cpu")
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        if g.startswith("image-level epis/alea:"):  # fp32 sums in two orders
            np.testing.assert_allclose([float(x) for x in g.split(":")[1].split()],
                                       [float(x) for x in w.split(":")[1].split()],
                                       rtol=1e-5, atol=1e-6)
        elif g.startswith("cannot open:"):
            assert w.startswith("cannot open:")
        else:
            assert g == w
    assert got[0] == "no image yet"
    # !greedy: the greedy engine's own caption
    eng, proc = _port_engines(weights)(Namespace(
        model="llava-1.5", original=True, avg=False, voting_numbers=3, use_random=False),
        device="cpu")
    assert got[5] == tcli.run_engine(eng, proc, "llava-1.5", tcli.PROMPTS["llava-1.5"],
                                     Image.open(b).convert("RGB"))


# ---------------------------------------------------------------------------
# run_experiments
# ---------------------------------------------------------------------------


def _grid_args(module, grid, extra=()):
    return module.build_parser().parse_args(
        ["--coco-data-dir", "/data/coco", "--model-paths", "llava-1.5=/ckpt/a",
         "llava-next=/ckpt/b", "--grid", grid, "--seeds", "0", "3", "--image-numbers", "50",
         *extra])


def _swapped(items):
    """The JAX jobs with the port's CHAIR module in place of the JAX one."""
    return [[texp.CHAIR_MODULE if x == "dropoutdecoding_tpu.cli.chair_test" else x for x in job]
            for job in items]


@pytest.mark.parametrize("grid", ["main", "ablations"])
@pytest.mark.parametrize("what", ["jobs", "slurm", "dry-run"])
def test_run_experiments_matches_jax(tmp_path, capsys, grid, what):
    if what == "jobs":
        want = _swapped(jexp.build_jobs(_grid_args(jexp, grid)))
        got = texp.build_jobs(_grid_args(texp, grid))
        assert got == want and len(got) == (16 if grid == "main" else 40)
    elif what == "slurm":
        for module, d in ((jexp, "jax"), (texp, "port")):
            module.main(_grid_args(module, grid, ["--emit-slurm", str(tmp_path / d)]))
        names = sorted(os.listdir(tmp_path / "jax"))
        assert names == sorted(os.listdir(tmp_path / "port")) and names
        for n in names:
            want = (tmp_path / "jax" / n).read_text().replace(
                "dropoutdecoding_tpu.cli.chair_test", texp.CHAIR_MODULE)
            assert (tmp_path / "port" / n).read_text() == want
    else:
        jexp.main(_grid_args(jexp, grid, ["--dry-run"]))
        want = capsys.readouterr().out.replace(
            "dropoutdecoding_tpu.cli.chair_test", texp.CHAIR_MODULE)
        texp.main(_grid_args(texp, grid, ["--dry-run"]))
        assert capsys.readouterr().out == want


# ---------------------------------------------------------------------------
# compare_results
# ---------------------------------------------------------------------------


def _result(path, hallucinated):
    sents = [{"image_id": i, "caption": "c", "mscoco_hallucinated_words": [["dog", "dog"]] if h else []}
             for i, h in hallucinated.items()]
    path.write_text(json.dumps({"sentences": sents, "overall_metrics": {}}))
    return str(path)


@pytest.mark.parametrize("both", [False, True])
def test_compare_results_prints_what_jax_prints(tmp_path, capsys, both):
    a = _result(tmp_path / "a.json", {5: True, 3: True, 9: False, 12: True, 7: False})
    b = _result(tmp_path / "b.json", {5: False, 3: True, 9: True, 12: False, 7: True})
    argv = [a, b] + (["--both"] if both else [])
    jcmp.main(Namespace(file1=a, file2=b, both=both))
    want = capsys.readouterr().out
    tcmp.main(tcmp.build_parser().parse_args(argv))
    got = capsys.readouterr().out
    lines = got.splitlines()
    assert got == want and "  12" in lines and ("  9" in lines) == both


# ---------------------------------------------------------------------------
# run_acceptance
# ---------------------------------------------------------------------------

PASSING = {"greedy": {"CHAIRs": 27.8, "CHAIRi": 7.2}, "k3_vote": {"CHAIRs": 25.8, "CHAIRi": 6.6},
           "random": {"CHAIRs": 32.0, "CHAIRi": 7.6}}
REPORTS = {
    "pass": PASSING,
    "greedy CHAIRs high": {**PASSING, "greedy": {"CHAIRs": 29.4, "CHAIRi": 7.2}},
    "k3 CHAIRi low": {**PASSING, "k3_vote": {"CHAIRs": 25.8, "CHAIRi": 6.1}},
    "random not above k3": {**PASSING, "random": {"CHAIRs": 25.0, "CHAIRi": 7.6}},
    "random missing": {k: v for k, v in PASSING.items() if k != "random"},
    "greedy missing": {k: v for k, v in PASSING.items() if k != "greedy"},
    "metrics none": {**PASSING, "k3_vote": None},
    "on the edges": {**PASSING, "greedy": {"CHAIRs": 29.0, "CHAIRi": 7.0}},
}


@pytest.mark.parametrize("slack", [0.0, 0.5, 2.5])
@pytest.mark.parametrize("case", list(REPORTS))
def test_check_bands_matches_jax(case, slack):
    def report():
        return {"stages": {k: {"metrics": None if v is None else dict(v)}
                           for k, v in REPORTS[case].items()}}

    want, got = report(), report()
    assert trig._check_bands(got, slack) == jrig._check_bands(want, slack)
    assert got["checks"] == want["checks"]


def _pope_images(coco, number):
    """val2014 images for the first ``number`` vendored POPE questions of
    each strategy, beside the synthetic COCO's."""
    r = np.random.default_rng(0)
    for strategy in ("random", "popular", "adversarial"):
        qs = teval.parse_question_file(
            os.path.join(teval.vendored_question_dir(), f"coco_pope_{strategy}.json"))
        for q in qs[:number]:
            path = coco / "val2014" / q["image"]
            if not path.exists():
                Image.fromarray((r.random((40, 52, 3)) * 255).astype(np.uint8), "RGB").save(
                    path, "JPEG")


def _rig(module, coco, work, **main_kw):
    args = module.build_parser().parse_args([
        "--model-path", "/unused", "--coco-data-dir", str(coco), "--work-dir", str(work),
        "--images", "2", "--pope-number", "2", "--no-assert",
    ])
    report = module.main(args, **main_kw)
    on_disk = json.loads((work / "acceptance_report.json").read_text())
    assert on_disk == report
    return report


def test_acceptance_rig_matches_jax(synthetic_coco, tmp_path, monkeypatch, weights):
    """Every stage (smoke, greedy, k3_vote, k3_avg, random, pope) in both
    rigs over one tiny checkpoint: the same stages, fields, metrics, POPE
    scores, checks and verdict; the port's signature recomputes from its
    report."""
    _pope_images(synthetic_coco, 2)
    monkeypatch.setattr(jcli, "make_engine", _jax_engines(weights))
    monkeypatch.setattr(tcli, "make_engine", _port_engines(weights))
    want = _rig(jrig, synthetic_coco, tmp_path / "jax")
    got = _rig(trig, synthetic_coco, tmp_path / "port", device="cpu")
    assert set(got) == set(want)
    assert list(got["stages"]) == list(want["stages"]) == [
        "smoke", "greedy", "k3_vote", "k3_avg", "random", "pope"]
    for name, stage in want["stages"].items():
        assert set(got["stages"][name]) == set(stage), name
        for key in ("metrics", "n_images", "captions_sha256", "scores"):
            assert got["stages"][name].get(key) == stage.get(key), (name, key)
    assert got["stages"]["pope"]["scores"]  # three strategies scored
    assert got["checks"] == want["checks"] and got["verdict"] == want["verdict"]
    payload = {k: v for k, v in got.items() if k != "signature_sha256"}
    assert hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest() == \
        got["signature_sha256"]
