"""The port's CHAIR CLI (``dropoutdecoding_tpu_torch/cli/chair_test.py``)
against the JAX CLI.

``main`` of each package runs over the synthetic COCO of
``tests/test_chair_cli_end_to_end.py`` with ``make_engine`` swapped for its
own tiny engine on one set of weights (carried across by
``utils/convert.py``; JAX's mask draws injected into the port), behind
that file's ``_TinyProcessor``.  Both must write the same sample log,
caption records, self-critical JSON, CHAIR results and THRONE scores, for
``--original``, the default Dropout Decoding arm and its int8 tier.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from dropoutdecoding_tpu.cli import chair_test as jcli
from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu.utils import quantize as jquant
from dropoutdecoding_tpu_torch.cli import chair_test as tcli
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
from dropoutdecoding_tpu_torch.models import llavanext as tnext
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import (
    llava_params_from_numpy,
    llavanext_params_from_numpy,
)
from test_chair_cli_end_to_end import _TinyProcessor, synthetic_coco  # noqa: F401 (fixture)
from test_torch_engine import jax_uniform
from test_torch_llavanext import narrow_config, narrow_tree
from test_torch_models import tiny_config, tiny_tree

METHOD = "itest"
STEM = "results/itest/llava_{m}/coco/llava_{m}_coco_{what}"


@pytest.fixture(scope="module")
def weights():
    tree, _ = tiny_tree()
    return jax.tree.map(jnp.asarray, tree), llava_params_from_numpy(tree)


def _gen(C):
    return C.GenerationConfig(max_new_tokens=4, eos_token_id=2, pad_token_id=2)


def _jax_make_engine(weights):
    jp, _ = weights

    def make(args):
        params = jp
        if args.quantize == "int8":  # the JAX CLI's maybe_quantize on one device
            params = jp._replace(lm=jquant.fuse_projections(jquant.quantize_llama_params(jp.lm)))
        eng = JaxEngine(
            cfg=tiny_config(jax_config), params=params,
            ens=jcli.build_ensemble_config(args, args.model), gen=_gen(jax_config),
            max_len=48, seed=args.seed, ensemble=not jcli.str2bool(args.original),
            int8_kv=jcli.str2bool(args.int8_kv),
        )
        eng.param_dtype = jnp.float32
        return eng, _TinyProcessor(eng.cfg)

    return make


def _port_make_engine(weights, engines=None):
    _, tp = weights

    def make(args, device="cuda"):
        assert device == "cpu"
        tcli.check_ported(args)
        eng = LlavaEngine(
            cfg=tiny_config(torch_config), params=tcli.maybe_quantize(args, tp),
            ens=tcli.build_ensemble_config(args, args.model), gen=_gen(torch_config),
            max_len=48, seed=args.seed, ensemble=not tcli.str2bool(args.original),
            int8_kv=tcli.str2bool(args.int8_kv), uniform=jax_uniform(args.seed),
        )
        if engines is not None:
            engines.append(eng)
        return eng, _TinyProcessor(eng.cfg)

    return make


def _argv(coco, workdir, extra, n=4):
    return [
        "--method", METHOD,
        "--coco-data-dir", str(coco),
        "--model-path", "/unused",
        "--image-numbers", str(n),
        "--seed", "0",
        "--output-dir", str(workdir / "outputs"),
        "--sample-save-name", str(workdir / "sample.log"),
        "--throne", "True",
    ] + extra


def _run(cli, coco, workdir, extra, monkeypatch, n=4, **main_kw):
    """``cli.main`` in ``workdir``; returns what it wrote, by file, with the
    minute-stamped caption file found by its method prefix."""
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    args = cli.build_parser().parse_args(_argv(coco, workdir, extra, n))
    cli.main(args, **main_kw)
    outputs = workdir / "outputs"
    (captions,) = [f for f in os.listdir(outputs) if f.startswith(METHOD)]
    (throne,) = [f for f in os.listdir(outputs) if f.startswith("throne_")]
    m = args.model
    return {
        "sample.log": (workdir / "sample.log").read_text(),
        "captions": [json.loads(line) for line in open(outputs / captions)],
        "vlm_results": json.load(open(workdir / "vlm_results" / captions)),
        "chair.json": json.load(open(workdir / (STEM.format(m=m, what="num_images_500_chair_results") + ".json"))),
        "chair.txt": open(workdir / (STEM.format(m=m, what="num_images_500_chair_results") + ".txt")).read(),
        "throne export": open(outputs / throne).read(),
        "throne.json": json.load(open(workdir / (STEM.format(m=m, what="throne_results") + ".json"))),
    }


@pytest.mark.parametrize(
    "extra",
    [["--original", "True"], [], ["--quantize", "int8", "--int8-kv", "True"]],
    ids=["original", "dropout-decoding", "dropout-decoding-int8"],
)
def test_main_writes_what_the_jax_main_writes(synthetic_coco, tmp_path, monkeypatch, weights, extra):
    monkeypatch.setattr(jcli, "make_engine", _jax_make_engine(weights))
    ref = _run(jcli, synthetic_coco, tmp_path / "jax", extra, monkeypatch)
    monkeypatch.setattr(tcli, "make_engine", _port_make_engine(weights))
    got = _run(tcli, synthetic_coco, tmp_path / "port", extra, monkeypatch, device="cpu")
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name] == ref[name], name
    assert len(got["captions"]) == 4 and got["chair.txt"].startswith("SPICE\tMETEOR")


def test_the_arms_differ(synthetic_coco, tmp_path, monkeypatch, weights):
    """The parity above is not vacuous: the default arm's captions differ
    from --original's on the tiny model."""
    monkeypatch.setattr(tcli, "make_engine", _port_make_engine(weights))
    runs = [
        _run(tcli, synthetic_coco, tmp_path / name, extra, monkeypatch, device="cpu")["captions"]
        for name, extra in (("greedy", ["--original", "True"]), ("dd", []))
    ]
    assert runs[0] != runs[1]


def test_batched_original_matches_serial(synthetic_coco, tmp_path, monkeypatch, weights):
    """--batch-size 3 over 4 images (one full group, one padded) gives the
    serial loop's captions and files."""
    engines = []
    monkeypatch.setattr(tcli, "make_engine", _port_make_engine(weights, engines))
    serial = _run(tcli, synthetic_coco, tmp_path / "serial", ["--original", "True"], monkeypatch,
                  device="cpu")
    batched = _run(tcli, synthetic_coco, tmp_path / "batched",
                   ["--original", "True", "--batch-size", "3"], monkeypatch, device="cpu")
    assert serial == batched
    assert len(engines) == 2


@pytest.mark.parametrize("extra", [["--original", "True"], []], ids=["original", "dropout-decoding"])
def test_llavanext_caption_equals_engine_generate(synthetic_coco, tmp_path, monkeypatch, extra):
    """--model llava-next on the narrow NeXT: each caption is what the port
    engine's ``generate`` gives on the port's anyres tiles of that image."""
    cfg, params = narrow_config(torch_config), llavanext_params_from_numpy(narrow_tree())
    engines = []

    def make(args, device="cuda"):
        tcli.check_ported(args)
        eng = LlavaNextEngine(
            cfg=cfg, params=params, ens=tcli.build_ensemble_config(args, args.model),
            gen=_gen(torch_config), max_len=tnext.max_image_tokens(cfg) + 16,
            seed=args.seed, ensemble=not tcli.str2bool(args.original),
        )
        engines.append(eng)
        return eng, _TinyProcessor(cfg)

    monkeypatch.setattr(tcli, "make_engine", make)
    out = _run(tcli, synthetic_coco, tmp_path / "next", ["--model", "llava-next"] + extra,
               monkeypatch, n=2, device="cpu")
    (eng,) = engines
    assert eng.ens.mask_accumulate is False and eng.ens.topk == 10  # the NeXT settings
    proc = _TinyProcessor(cfg)
    prep = tcli.next_image_prep(eng)
    for rec in out["captions"]:
        name = f"COCO_val2014_{rec['image_id']:012d}.jpg"
        image = Image.open(synthetic_coco / "val2014" / name).convert("RGB")
        tiles, orig = prep(image)
        result = eng.generate(proc(tcli.PROMPTS["llava-next"])["input_ids"], tiles, orig)
        want = proc.decode(result.tokens[0][: result.num_tokens[0]]).strip()
        assert rec["caption"] == want
    assert len(out["captions"]) == 2


# --- flags ----------------------------------------------------------------------


def _actions(parser):
    return sorted(
        (tuple(a.option_strings), a.dest, repr(a.default), getattr(a.type, "__name__", a.type),
         a.choices and tuple(a.choices), a.required)
        for a in parser._actions
    )


def test_parser_keeps_every_flag_name_and_default():
    assert _actions(tcli.build_parser()) == _actions(jcli.build_parser())
    assert tcli.PROMPTS == jcli.PROMPTS and tcli.ANSWER_SPLIT == jcli.ANSWER_SPLIT
    assert tcli.REFERENCE_SEEDS == jcli.REFERENCE_SEEDS
    for v in (True, False, "True", "false", "0", "no", "None", "", "yes", "1"):
        assert tcli.str2bool(v) == jcli.str2bool(v)


@pytest.mark.parametrize(
    "extra",
    [[], ["--use_random", "True"], ["--avg", "True", "--voting-numbers", "5"],
     ["--mask-policy", "epis_no_overlap"], ["--model", "llava-next"],
     ["--model", "llava-next", "--use_random", "True"]],
)
def test_build_ensemble_config_matches(extra):
    argv = ["--coco-data-dir", "d", "--model-path", "m"] + extra
    targs, jargs = tcli.build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)
    got = tcli.build_ensemble_config(targs, targs.model)
    want = jcli.build_ensemble_config(jargs, jargs.model)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


NOT_PORTED = [
    (["--vcd", "True"], 9),
    (["--num-beams", "3"], 9),
    (["--opera", "True"], 13),
    (["--spec-gamma", "3"], 14),
    (["--do-sample", "True"], 6),
    (["--fused-step", "True"], 6),
    (["--text-logit-mask", "True"], 6),
    (["--quantize", "w8a8"], 12),
    (["--w8a8-decode", "True"], 12),
    (["--consistency", "True"], 15),
    (["--consistency-im", "projection"], 15),
    (["--model", "instructblip"], 11),
]


@pytest.mark.parametrize("extra,item", NOT_PORTED, ids=[" ".join(e) for e, _ in NOT_PORTED])
def test_not_ported_flag_raises_before_any_work(tmp_path, monkeypatch, extra, item):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli, "load_processor", lambda path: pytest.fail("tokenizer read"))
    args = tcli.build_parser().parse_args(_argv(tmp_path / "coco", tmp_path, extra))
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}\\)"):
        tcli.main(args, device="cpu")
    assert os.listdir(tmp_path) == []  # nothing sampled, read or written


def test_int8_prefix_cache_raises():
    args = tcli.build_parser().parse_args(["--coco-data-dir", "d", "--model-path", "m"])
    args.int8_prefix_cache = True  # the JAX make_engine reads it; the parser has no flag
    with pytest.raises(NotImplementedError, match="item 12"):
        tcli.build_engine(args, "cpu")


@pytest.fixture
def fake_load(monkeypatch, weights):
    """``llava.load`` and ``load_processor`` replaced by the tiny model and
    _TinyProcessor; returns the calls made to ``load``."""
    from dropoutdecoding_tpu_torch.models import llava as llava_mod

    _, tp = weights
    cfg = tiny_config(torch_config)
    calls = []
    monkeypatch.setattr(
        llava_mod, "load", lambda *a: calls.append(a) or (cfg, tp)
    )
    monkeypatch.setattr(tcli, "load_processor", lambda path: _TinyProcessor(cfg))
    return calls


def _make(extra):
    args = tcli.build_parser().parse_args(["--coco-data-dir", "d", "--model-path", "/ckpt"] + extra)
    return tcli.make_engine(args, device="cpu")


def test_make_engine_flag_plumbing(fake_load):
    """The CLI -> engine wiring the main tests bypass with their own
    ``make_engine``: quantization, fusion, the int8 cache, the arm, the seed,
    the cache capacity and the tokenizer's eos."""
    eng, proc = _make([])
    assert fake_load == [("/ckpt", torch.bfloat16, "cpu", True)]
    layers = eng.params.lm["layers"]
    assert isinstance(layers["qkv_proj"], torch.Tensor) and "q_proj" not in layers  # fused
    assert eng.ensemble and not eng.int8_kv and eng.seed == 24
    assert eng.max_len == 16 + 64 + 512 and eng.gen.max_new_tokens == 512
    assert eng.gen.eos_token_id == eng.gen.pad_token_id == proc.tokenizer.eos_token_id
    assert eng.ens.mask_policy == "epis" and eng.ens.mask_accumulate and eng.ens.topk == 5

    eng, _ = _make(["--quantize", "int8", "--int8-kv", "True", "--original", "True", "--seed", "7"])
    assert set(eng.params.lm["layers"]["qkv_proj"]) == {"q", "s"}
    assert set(eng.params.lm["lm_head"]) == {"q", "s"}
    assert eng.int8_kv and not eng.ensemble and eng.seed == 7

    eng, _ = _make(["--fuse-proj", "False", "--use_random", "True"])
    assert isinstance(eng.params.lm["layers"]["q_proj"], torch.Tensor)
    assert eng.ens.mask_policy == "random_image"


def test_make_engine_int4(fake_load):
    eng, _ = _make(["--quantize", "int4"])
    assert set(eng.params.lm["layers"]["gate_up_proj"]) == {"q4", "s4"}
    assert set(eng.params.lm["lm_head"]) == {"q", "s"}  # int8 head


def test_mask_policy_the_port_lacks_raises_at_construction(fake_load):
    with pytest.raises(NotImplementedError):
        _make(["--mask-policy", "epis_kl"])


def test_emit_caption_matches_the_jax_emit(tmp_path, capsys):
    """The record written for a caption with the answer marker, whitespace
    and an 'unk' sentence, as the JAX main's ``emit`` writes it."""
    text = "USER: <image>\nDescribe. ASSISTANT:  A dog. An unknown thing. A chair "
    path = tmp_path / "c.jsonl"
    tcli.emit_caption(str(path), "llava-1.5", "COCO_val2014_000000000042.jpg", text)
    tcli.emit_caption(str(path), "llava-next", "COCO_val2014_000000000007.jpg", "[/INST] a cat.")
    recs = [json.loads(line) for line in open(path)]
    assert recs == [
        {"image_id": 42, "caption": "A dog. A chair"},
        {"image_id": 7, "caption": "a cat."},
    ]


def test_stage_timer_and_profile_trace(tmp_path):
    """``engine/trace.py``: the timer's report has the JAX timer's shape,
    and ``profile_trace`` writes a torch.profiler trace only when given a
    directory (what ``--profile-dir`` passes)."""
    from dropoutdecoding_tpu.engine.trace import StageTimer as JaxTimer
    from dropoutdecoding_tpu_torch.engine.trace import StageTimer, profile_trace

    timers = (StageTimer(), JaxTimer())
    for t in timers:
        for name in ("prefill", "decode", "decode"):
            with t.stage(name, sync=torch.ones(2)):
                pass
    got, want = (t.report() for t in timers)
    assert {k: v["count"] for k, v in got.items()} == {k: v["count"] for k, v in want.items()}
    assert all(set(v) == {"total_s", "count", "mean_s"} for v in got.values())
    timers[0].dump(str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json"))["decode"]["count"] == 2
    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(4) @ torch.ones(4)
    assert json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
