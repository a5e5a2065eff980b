"""The port's CHAIR CLI (``dropoutdecoding_tpu_torch/cli/chair_test.py``)
against the JAX CLI.

``main`` of each package runs over the synthetic COCO of
``tests/test_chair_cli_end_to_end.py`` with ``make_engine`` swapped for its
own tiny engine on one set of weights (carried across by
``utils/convert.py``; JAX's mask draws injected into the port), behind
that file's ``_TinyProcessor``.  Both must write the same sample log,
caption records, self-critical JSON, CHAIR results and THRONE scores, for
``--original``, the default Dropout Decoding arm, its int8 tier, the
fused arm with sampling and the text mask (all three of JAX's streams
injected), and the baselines: VCD (JAX's noised pixels and draws injected),
beam search and OPERA, serial and batched.
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
from dropoutdecoding_tpu_torch.decoding import masks as tmasks
from dropoutdecoding_tpu_torch.engine import baselines as tbase
from dropoutdecoding_tpu_torch.engine import opera as topera
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
from dropoutdecoding_tpu_torch.models import llavanext as tnext
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import (
    llava_params_from_numpy,
    llavanext_params_from_numpy,
)
from test_chair_cli_end_to_end import _TinyProcessor, synthetic_coco  # noqa: F401 (fixture)
from test_torch_baselines import jax_cd_gumbel, jax_cd_noise
from test_torch_engine import jax_gumbel, jax_text_uniform, jax_uniform
from test_torch_llavanext import narrow_config, narrow_tree
from test_torch_models import tiny_config, tiny_tree

METHOD = "itest"
STEM = "results/itest/llava_{m}/coco/llava_{m}_coco_{what}"


@pytest.fixture(scope="module")
def weights():
    tree, _ = tiny_tree()
    return jax.tree.map(jnp.asarray, tree), llava_params_from_numpy(tree)


def _gen(C, args=None):
    """The tiny engines' generation config, with the CLI's sampling, beam
    and VCD knobs (the JAX ``make_engine``'s rules)."""
    knobs = {} if args is None else dict(
        do_sample=jcli.str2bool(args.do_sample), temperature=args.temperature,
        top_p=args.top_p, top_k=args.top_k, num_beams=_beams(args),
        length_penalty=args.length_penalty, use_cd=jcli.str2bool(args.vcd),
        early_stopping="never" if args.early_stopping == "never"
        else jcli.str2bool(args.early_stopping),
    )
    return C.GenerationConfig(max_new_tokens=4, eos_token_id=2, pad_token_id=2, **knobs)


def _beams(args):
    return args.num_beams if args.num_beams is not None else (3 if jcli.str2bool(args.opera) else 1)


def _arm(args):
    """(ensemble, the OPERA knobs or None) of the JAX ``make_engine``."""
    opera = jcli.str2bool(args.opera)
    knobs = dict(
        num_beams=_beams(args), scale_factor=args.scale_factor, threshold=args.threshold,
        num_attn_candidates=args.num_attn_candidates, penalty_weights=args.penalty_weights,
        length_penalty=args.length_penalty,
    ) if opera else None
    return not (jcli.str2bool(args.original) or jcli.str2bool(args.vcd) or opera), knobs


def _jax_make_engine(weights):
    jp, _ = weights

    def make(args):
        params = jp
        if args.quantize == "int8":  # the JAX CLI's maybe_quantize on one device
            params = jp._replace(lm=jquant.fuse_projections(jquant.quantize_llama_params(jp.lm)))
        ensemble, opera = _arm(args)
        eng = JaxEngine(
            cfg=tiny_config(jax_config), params=params,
            ens=jcli.build_ensemble_config(args, args.model), gen=_gen(jax_config, args),
            max_len=48, seed=args.seed, ensemble=ensemble,
            int8_kv=jcli.str2bool(args.int8_kv),
            text_logits_mask=jcli.str2bool(args.text_logit_mask),
        )
        eng.param_dtype = jnp.float32
        if opera is not None:
            eng._opera = opera
        return eng, _TinyProcessor(eng.cfg)

    return make


def _port_make_engine(weights, engines=None):
    _, tp = weights

    def make(args, device="cuda"):
        assert device == "cpu"
        tcli.check_ported(args)
        ensemble, opera = _arm(args)
        eng = LlavaEngine(
            cfg=tiny_config(torch_config), params=tcli.maybe_quantize(args, tp),
            ens=tcli.build_ensemble_config(args, args.model), gen=_gen(torch_config, args),
            max_len=48, seed=args.seed, ensemble=ensemble,
            int8_kv=tcli.str2bool(args.int8_kv), uniform=jax_uniform(args.seed),
            text_logits_mask=tcli.str2bool(args.text_logit_mask),
            # the JAX engine draws its text uniforms at max_len rounded up to 32
            text_uniform=jax_text_uniform(args.seed, length=64), gumbel=jax_gumbel(args.seed),
            cd_noise=jax_cd_noise(), cd_gumbel=jax_cd_gumbel(),
        )
        if opera is not None:
            assert opera == tcli.opera_knobs(args, tcli.beam_count(args))
            eng._opera = opera
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
    [["--original", "True"], [], ["--quantize", "int8", "--int8-kv", "True"],
     ["--fused-step", "True", "--do-sample", "True", "--temperature", "0.7", "--top-p", "0.9",
      "--top-k", "5", "--text-logit-mask", "True", "--mask-policy", "epis_kl"],
     ["--vcd", "True"], ["--vcd", "True", "--batch-size", "2"],
     ["--original", "True", "--num-beams", "3"],
     ["--original", "True", "--num-beams", "3", "--batch-size", "3", "--length-penalty", "2.0",
      "--early-stopping", "never"],
     ["--opera", "True"], ["--opera", "True", "--num_attn_candidates", "2", "--threshold", "2"]],
    ids=["original", "dropout-decoding", "dropout-decoding-int8", "fused-sampled-text-mask-epis_kl",
         "vcd", "vcd-batched", "beam", "beam-batched-knobs", "opera", "opera-fan-out-rollback"],
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


def _next_direct(eng, arm, ids, tiles, orig):
    """The engine call each arm of the CLI makes on one LLaVA-NeXT image."""
    if arm == "vcd":
        noised = tbase.noised_pixels(eng, tiles)
        return tbase.vcd_generate(eng, states=(eng.prefill(ids, tiles, orig),
                                               eng.prefill(ids, noised, orig)))
    if arm == "beam":
        return tbase.beam_generate(eng, state=eng.prefill(ids, tiles, orig), num_beams=3)
    if arm == "opera":
        return topera.opera_generate(eng, state=eng.prefill(ids, tiles, orig), num_beams=3,
                                     scale_factor=5.0, threshold=15, num_attn_candidates=1)
    return eng.generate(ids, tiles, orig)


NEXT_ARMS = {"original": ["--original", "True"], "dropout-decoding": [], "vcd": ["--vcd", "True"],
             "beam": ["--original", "True", "--num-beams", "3"], "opera": ["--opera", "True"]}


@pytest.mark.parametrize("arm", list(NEXT_ARMS))
def test_llavanext_caption_equals_engine_generate(synthetic_coco, tmp_path, monkeypatch, arm):
    """--model llava-next on the narrow NeXT: each caption is what the port
    engine gives on the port's anyres tiles of that image, through the
    arm's own call (VCD's noised tiles, beam search's and OPERA's state)."""
    cfg, params = narrow_config(torch_config), llavanext_params_from_numpy(narrow_tree())
    engines = []
    extra = NEXT_ARMS[arm]

    def make(args, device="cuda"):
        tcli.check_ported(args)
        ensemble, opera = _arm(args)
        eng = LlavaNextEngine(
            cfg=cfg, params=params, ens=tcli.build_ensemble_config(args, args.model),
            gen=_gen(torch_config, args), max_len=tnext.max_image_tokens(cfg) + 16,
            seed=args.seed, ensemble=ensemble, cd_noise=jax_cd_noise(), cd_gumbel=jax_cd_gumbel(),
        )
        if opera is not None:
            eng._opera = opera
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
        result = _next_direct(eng, arm, proc(tcli.PROMPTS["llava-next"])["input_ids"], tiles, orig)
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
     ["--model", "llava-next", "--use_random", "True"], ["--fused-step", "True"],
     ["--mask-policy", "epis_kl", "--model", "llava-next"]],
)
def test_build_ensemble_config_matches(extra):
    argv = ["--coco-data-dir", "d", "--model-path", "m"] + extra
    targs, jargs = tcli.build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)
    got = tcli.build_ensemble_config(targs, targs.model)
    want = jcli.build_ensemble_config(jargs, jargs.model)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


NOT_PORTED = [
    (["--spec-gamma", "3"], 14),
    (["--quantize", "w8a8"], 12),
    (["--w8a8-decode", "True"], 12),
    (["--consistency", "True"], 15),
    (["--consistency-im", "projection"], 15),
]


@pytest.mark.parametrize("extra,item", NOT_PORTED, ids=[" ".join(e) for e, _ in NOT_PORTED])
def test_not_ported_flag_raises_before_any_work(tmp_path, monkeypatch, extra, item):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli, "load_processor", lambda path: pytest.fail("tokenizer read"))
    args = tcli.build_parser().parse_args(_argv(tmp_path / "coco", tmp_path, extra))
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}\\)"):
        tcli.main(args, device="cpu")
    assert os.listdir(tmp_path) == []  # nothing sampled, read or written


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


def test_int8_prefix_cache_reaches_the_engine(fake_load):
    """The field the POPE CLI's ``--int8-prefix-cache`` sets (the CHAIR
    parser has no such flag; JAX's ``make_engine`` reads it with a
    default)."""
    args = tcli.build_parser().parse_args(["--coco-data-dir", "d", "--model-path", "/ckpt"])
    assert not tcli.build_engine(args, "cpu").int8_prefix_cache
    args.int8_prefix_cache = True
    assert tcli.build_engine(args, "cpu").int8_prefix_cache


@pytest.mark.parametrize("extra", [[], ["--int8-prefix-cache", "True", "--quantize", "int8",
                                        "--original", "True", "--seed", "3"]])
def test_make_engine_takes_the_pope_clis_arguments(fake_load, extra):
    """``make_engine`` on the reduced arguments the POPE CLI builds (the JAX
    POPE CLI's field set), the fields it lacks at their defaults."""
    from dropoutdecoding_tpu_torch.cli import pope_test

    args = pope_test.build_parser().parse_args(
        ["--model-path", "/ckpt", "--coco-data-dir", "d"] + extra)
    eng, _ = tcli.make_engine(pope_test.engine_args(args, "llava-1.5"), device="cpu")
    assert eng.int8_prefix_cache == bool(extra) and eng.ensemble != bool(extra)
    assert eng.seed == (3 if extra else 24) and not eng.int8_kv and not eng.gen.do_sample
    assert isinstance(eng.params.lm["lm_head"], dict) == bool(extra)  # --quantize int8
    assert eng.ens.mask_policy == "epis" and not eng.ens.fused_step


def test_make_engine_int4(fake_load):
    eng, _ = _make(["--quantize", "int4"])
    assert set(eng.params.lm["layers"]["gate_up_proj"]) == {"q4", "s4"}
    assert set(eng.params.lm["lm_head"]) == {"q", "s"}  # int8 head


FLAGS = [  # (argv, the engine's value it sets, the value)
    (["--do-sample", "True"], lambda e: e.gen.do_sample, True),
    (["--temperature", "0.7"], lambda e: e.gen.temperature, 0.7),
    (["--top-p", "0.9"], lambda e: e.gen.top_p, 0.9),
    (["--top-k", "5"], lambda e: e.gen.top_k, 5),
    (["--fused-step", "True"], lambda e: e.ens.fused_step, True),
    (["--text-logit-mask", "True"], lambda e: (e.text_logits_mask, e.text_policy), (True, "logits")),
]


@pytest.mark.parametrize("extra,read,want", FLAGS, ids=[e[0] for e, _, _ in FLAGS])
def test_decoding_flags_reach_the_engine(fake_load, extra, read, want):
    """Each flag sets its engine field; without it the field keeps the
    default arm's value."""
    assert read(_make(extra)[0]) == want
    assert read(_make([])[0]) != want


@pytest.mark.parametrize("policy", tmasks.POLICIES)
def test_every_mask_policy_builds_an_engine(fake_load, policy):
    eng, _ = _make(["--mask-policy", policy])
    assert eng.ens.mask_policy == policy and eng.ensemble


def test_do_sample_with_beams_exits_as_the_jax_cli(tmp_path, monkeypatch):
    """--do-sample with --num-beams 3 exits before any work, with the JAX
    CLI's message."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli, "load_processor", lambda path: pytest.fail("tokenizer read"))
    argv = _argv(tmp_path / "coco", tmp_path, ["--do-sample", "True", "--num-beams", "3"])
    with pytest.raises(SystemExit, match="beam-sample"):
        jcli.make_engine(jcli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit, match="beam-sample"):
        tcli.main(tcli.build_parser().parse_args(argv), device="cpu")
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize(
    "extra,message",
    [(["--opera", "True", "--batch-size", "2"], "one image per program"),
     (["--opera", "True", "--original", "True"], "excludes --original/--vcd"),
     (["--opera", "True", "--vcd", "True"], "excludes --original/--vcd")],
    ids=["batched", "with-original", "with-vcd"],
)
def test_opera_guards_exit_as_the_jax_cli(tmp_path, monkeypatch, extra, message):
    """--opera with a batch, --original or --vcd exits before any image is
    read, with the JAX CLI's message (which reads the tokenizer first)."""
    from dropoutdecoding_tpu.utils import processor as jproc

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli, "load_processor", lambda path: pytest.fail("tokenizer read"))
    monkeypatch.setattr(jproc.VlmProcessor, "from_checkpoint",
                        classmethod(lambda cls, path: _TinyProcessor(tiny_config(jax_config))))
    argv = _argv(tmp_path / "coco", tmp_path, extra)
    with pytest.raises(SystemExit, match=message):
        jcli.make_engine(jcli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit, match=message):
        tcli.main(tcli.build_parser().parse_args(argv), device="cpu")
    assert os.listdir(tmp_path) == []


def test_baseline_flags_reach_the_engine(fake_load):
    """The beam, VCD and OPERA flags set the engine's fields as the JAX
    ``make_engine`` sets them."""
    eng, _ = _make(["--num-beams", "4", "--length-penalty", "2.0", "--early-stopping", "never"])
    assert (eng.gen.num_beams, eng.gen.length_penalty, eng.gen.early_stopping) == (4, 2.0, "never")
    assert eng.ensemble and not hasattr(eng, "_opera")  # beams alone keep Dropout Decoding
    eng, _ = _make(["--vcd", "True", "--early-stopping", "true"])
    assert eng.gen.use_cd and not eng.ensemble and eng.gen.early_stopping is True
    eng, _ = _make(["--opera", "True", "--scale_factor", "7", "--num-attn-candidates", "2"])
    assert not eng.ensemble and eng.gen.num_beams == 3
    assert eng._opera == dict(num_beams=3, scale_factor=7.0, threshold=15, num_attn_candidates=2,
                              penalty_weights=1.0, length_penalty=1.0)


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
