"""CHAIR captioning harness of the port: the flags, prompts, sampling,
JSONL output, chunked eval and results tree of
``dropoutdecoding_tpu/cli/chair_test.py``, over the port's engines.

Usage:
  python -m dropoutdecoding_tpu_torch.cli.chair_test \\
      --method mymethod --coco-data-dir /data/coco \\
      --model-path /ckpts/llava-1.5-7b-hf --model llava-1.5

It runs on the first CUDA device; ``main(args, device="cpu")`` runs it on
the CPU (the kernels' plain twins).  The parser is the JAX CLI's, flag for
flag.  Every Dropout Decoding arm runs: exact and fused mode
(``--fused-step``), every ``--mask-policy``, sampling (``--do-sample`` with
``--temperature`` / ``--top-p`` / ``--top-k``) and the text mask
(``--text-logit-mask``); so do the paper's baselines: greedy
(``--original``), beam search (``--original --num-beams N`` with
``--length-penalty`` / ``--early-stopping``), VCD (``--vcd``) and OPERA
(``--opera``, one image at a time), each serial and, but OPERA, batched;
on all three models (``--model llava-1.5``, ``llava-next`` and
``instructblip``, whose Q-Former reads the instruction through
``qformer_ids_for``).  Flags whose engine is not ported yet raise
``NotImplementedError`` naming their ROADMAP Queue 1 item when the engine
is built, before any image is read (``NOT_PORTED``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from datetime import datetime
from random import sample, seed

import torch

from ..evalsuite.chair import ChairEvaluator, load_generated_captions, metric_table
from ..evalsuite.coco import load_coco_data
from ..utils.config import EnsembleConfig, GenerationConfig

PROMPTS = {
    "llava-1.5": "USER: <image>\nDescribe the image. ASSISTANT:",
    "instructblip": "Describe the image.",
    "llava-next": "[INST] <image>\nDescribe the image. [/INST]",
}

ANSWER_SPLIT = {
    "llava-1.5": "ASSISTANT:",
    "instructblip": None,
    "llava-next": "[/INST]",
}

REFERENCE_SEEDS = {"llava-1.5": 24, "instructblip": 5217, "llava-next": 506}


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() not in ("false", "0", "no", "none", "")


# (flag, whether args ask for it, ROADMAP Queue 1 item that ports its engine)
NOT_PORTED = (
    ("--spec-gamma", lambda a: bool(getattr(a, "spec_gamma", None)), 14),
    ("--quantize w8a8", lambda a: getattr(a, "quantize", None) == "w8a8", 12),
    ("--w8a8-decode", lambda a: str2bool(getattr(a, "w8a8_decode", False)), 12),
    ("--consistency", lambda a: str2bool(getattr(a, "consistency", False)), 15),
    ("--consistency-im", lambda a: bool(getattr(a, "consistency_im", None)), 15),
)


def beam_count(args) -> int:
    """The JAX CLI's beam count: --opera defaults to 3 beams (the
    reference's OPERA arm)."""
    if args.num_beams is not None:
        return args.num_beams
    return 3 if str2bool(args.opera) else 1


def check_ported(args) -> None:
    """Exit, as the JAX CLI does, on ``--do-sample`` with beams and on
    ``--opera`` with ``--original``, ``--vcd`` or a batch; then raise
    ``NotImplementedError`` for the first flag in ``args`` whose engine the
    port does not have yet."""
    if str2bool(getattr(args, "do_sample", False)) and beam_count(args) > 1:
        raise SystemExit(
            "--do-sample with --num-beams > 1 (beam-sample) is not "
            "implemented; drop one of the two flags."
        )
    if str2bool(args.opera):
        if str2bool(args.original) or str2bool(args.vcd):
            raise SystemExit("--opera excludes --original/--vcd")
        if (getattr(args, "batch_size", 1) or 1) > 1:
            raise SystemExit(
                "--opera rollback makes per-image steps diverge; it runs "
                "one image per program (drop --batch-size)"
            )
    for flag, asked, item in NOT_PORTED:
        if asked(args):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP Queue 1 item {item})")


def build_ensemble_config(args, model: str) -> EnsembleConfig:
    """CLI flags -> EnsembleConfig (the JAX CLI's rules, per model)."""
    probs = EnsembleConfig.voting_probs_for(args.voting_numbers)
    if model == "llava-1.5":
        policy, accumulate, topk = "epis", True, 5
    elif model == "instructblip":
        policy, accumulate, topk = "epis_quantile", False, 10
    else:  # llava-next
        policy, accumulate, topk = "epis", False, 10
    use_random = str2bool(args.use_random)
    if use_random:
        # llava-next switches to epis_no_overlap; the ablation for
        # llava-1.5 is the uncertainty-free random mask
        policy = "epis_no_overlap" if model == "llava-next" else "random_image"
    if getattr(args, "mask_policy", None):
        policy = args.mask_policy  # explicit override (e.g. epis_kl)
    return EnsembleConfig(
        voting_probs=probs,
        use_avg=str2bool(args.avg),
        use_random=use_random,
        mask_policy=policy,
        mask_accumulate=accumulate,
        topk=topk,
        fused_step=str2bool(getattr(args, "fused_step", False)),
    )


def maybe_quantize(args, params):
    """``--quantize`` int8 / int4 on the LM tower, then (``--fuse-proj``,
    on by default) q/k/v and gate/up fused into one leaf each: a layout
    change with identical outputs, the JAX CLI's single-device default."""
    from ..utils.quantize import (
        fuse_projections,
        quantize_llama_params,
        quantize_llama_params_int4,
    )

    lm = params.lm
    mode = getattr(args, "quantize", None)
    if mode == "int8":
        lm = quantize_llama_params(lm)
    elif mode == "int4":
        lm = quantize_llama_params_int4(lm)
    if str2bool(getattr(args, "fuse_proj", True)):
        lm = fuse_projections(lm)
    return params._replace(lm=lm)


def load_processor(model_path: str):
    """The checkpoint's tokenizer and image preprocessor (the half of
    ``make_engine`` that needs the tokenizer files)."""
    from ..utils.processor import VlmProcessor

    return VlmProcessor.from_checkpoint(model_path)


def build_engine(args, device="cuda", eos_token_id: int = 2, cache: bool = True):
    """The engine ``args`` ask for, on ``device``, from the checkpoint at
    ``args.model_path`` (the half of ``make_engine`` that needs only the
    weights; ``eos_token_id`` is the tokenizer's, 2 for LLaVA's Llama and
    Mistral tokenizers).  ``cache`` keeps the converted weights between
    runs (``utils/cache.py``)."""
    check_ported(args)
    model = args.model
    use_opera = str2bool(args.opera)
    es = getattr(args, "early_stopping", "false")
    gen = GenerationConfig(
        max_new_tokens=512,
        eos_token_id=eos_token_id,
        pad_token_id=eos_token_id,
        num_beams=beam_count(args),
        length_penalty=getattr(args, "length_penalty", 1.0),
        early_stopping="never" if str(es).lower() == "never" else str2bool(es),
        do_sample=str2bool(getattr(args, "do_sample", False)),
        temperature=getattr(args, "temperature", 1.0),
        top_p=getattr(args, "top_p", 1.0),
        top_k=getattr(args, "top_k", None),
        use_cd=str2bool(args.vcd),
    )
    common = dict(
        ens=build_ensemble_config(args, model),
        gen=gen,
        ensemble=not (str2bool(args.original) or str2bool(args.vcd) or use_opera),
        seed=args.seed if args.seed is not None else REFERENCE_SEEDS[model],
        text_logits_mask=str2bool(getattr(args, "text_logit_mask", False)),
        int8_kv=str2bool(getattr(args, "int8_kv", False)),
        int8_prefix_cache=str2bool(getattr(args, "int8_prefix_cache", False)),
    )
    if model == "llava-1.5":
        from ..engine.generate import LlavaEngine
        from ..models import llava as llava_mod

        cfg, params = llava_mod.load(args.model_path, torch.bfloat16, device, cache)
        engine = LlavaEngine(
            cfg=cfg,
            params=maybe_quantize(args, params),
            max_len=cfg.vision.num_patches + 64 + 512,
            **common,
        )
    elif model == "instructblip":
        from ..engine.instructblip_engine import InstructBlipEngine
        from ..models import instructblip as ib_mod

        cfg, params = ib_mod.load(args.model_path, torch.bfloat16, device, cache)
        engine = InstructBlipEngine(
            cfg=cfg,
            params=maybe_quantize(args, params),
            max_len=cfg.num_query_tokens + 64 + 512,
            **common,
        )
    elif model == "llava-next":
        from ..engine.llavanext_engine import LlavaNextEngine
        from ..models import llavanext as next_mod

        cfg, params = next_mod.load(args.model_path, torch.bfloat16, device, cache)
        engine = LlavaNextEngine(
            cfg=cfg,
            params=maybe_quantize(args, params),
            max_len=next_mod.max_image_tokens(cfg) + 64 + 512,
            **common,
        )
    else:
        raise SystemExit(f"unknown model {model!r}")
    if use_opera:
        engine._opera = opera_knobs(args, gen.num_beams)
    return engine


def opera_knobs(args, num_beams: int) -> dict:
    """``opera_generate``'s keywords from the flags: the reference's OPERA
    arm runs scale 5, threshold 15, one attention candidate and penalty
    weight 1 over 3 beams (the parser's defaults)."""
    return dict(
        num_beams=num_beams,
        scale_factor=getattr(args, "scale_factor", 5.0),
        threshold=int(getattr(args, "threshold", 15)),
        num_attn_candidates=int(getattr(args, "num_attn_candidates", 1)),
        penalty_weights=getattr(args, "penalty_weights", 1.0),
        length_penalty=getattr(args, "length_penalty", 1.0),
    )


def make_engine(args, device="cuda"):
    """(engine, processor) for ``args``: the JAX CLI's ``make_engine`` for
    the arms the port has."""
    check_ported(args)  # before the tokenizer files are read
    processor = load_processor(args.model_path)
    engine = build_engine(args, device, eos_token_id=processor.tokenizer.eos_token_id)
    return engine, processor


def next_image_prep(engine):
    """Cached anyres tile preprocessor for a LlavaNextEngine (one per
    engine)."""
    if not hasattr(engine, "_next_prep_cache"):
        from ..utils.processor import LlavaNextImagePreprocessor

        engine._next_prep_cache = LlavaNextImagePreprocessor(
            [list(p) for p in engine.cfg.image_grid_pinpoints],
            tile_size=engine.cfg.vision.image_size,
        )
    return engine._next_prep_cache


def qformer_ids_for(processor, prompt, enc):
    """InstructBLIP's Q-Former instruction ids [1, T]: the processor's
    ``qformer_ids``, else the LM ids ``enc`` holds (the JAX CLI's fallback;
    ids past the Q-Former's vocabulary then raise in the engine)."""
    return processor.qformer_ids(prompt) if hasattr(processor, "qformer_ids") else enc["input_ids"]


def generate_arm(engine, model, input_ids, *images):
    """The arm ``engine`` was built for, over a batch of prompts: VCD, OPERA
    (one image), beam search (``--original`` with beams) or the engine's own
    ``generate``.  ``images``: LLaVA-1.5's pixels, LLaVA-NeXT's tile stack
    and size (lists of them for a batch), or InstructBLIP's pixels and
    Q-Former ids; VCD noises the pixels (the ViT's input) per image, as the
    JAX CLI does."""
    from ..engine import baselines

    gen, opera = engine.gen, getattr(engine, "_opera", None)
    if gen.use_cd:
        if model == "llava-1.5":
            return baselines.vcd_generate(engine, input_ids, *images)
        pixels, rest = images[0], images[1:]
        if isinstance(pixels, list):  # LLaVA-NeXT rows: a tile stack each
            noised = [baselines.noised_pixels(engine, t) for t in pixels]
        elif model == "llava-next":  # one image's tile stack
            noised = baselines.noised_pixels(engine, pixels)
        else:  # InstructBLIP: [B, 3, H, W], an image a row
            noised = torch.stack([baselines.noised_pixels(engine, p) for p in pixels])
        return baselines.vcd_generate(engine, states=(
            engine.prefill(input_ids, pixels, *rest), engine.prefill(input_ids, noised, *rest)))
    if opera is not None:
        from ..engine.opera import opera_generate

        return opera_generate(engine, state=engine.prefill(input_ids, *images), **opera)
    if not engine.ensemble and gen.num_beams > 1:
        return baselines.beam_generate(
            engine, state=engine.prefill(input_ids, *images), num_beams=gen.num_beams,
            length_penalty=gen.length_penalty, early_stopping=gen.early_stopping,
        )
    return engine.generate(input_ids, *images)


def run_engine(engine, processor, model, prompt, image):
    """One caption: model-specific input prep, ``generate_arm``, detokenize."""
    if model == "llava-next":
        tiles, orig = next_image_prep(engine)(image)
        result = generate_arm(engine, model, processor(prompt)["input_ids"], tiles, orig)
    elif model == "instructblip":
        inputs = processor(prompt, image)
        result = generate_arm(engine, model, inputs["input_ids"], inputs["pixel_values"],
                              qformer_ids_for(processor, prompt, inputs))
    else:
        inputs = processor(prompt, image)
        result = generate_arm(engine, model, inputs["input_ids"], inputs["pixel_values"])
    return processor.decode(result.tokens[0][: result.num_tokens[0]])


def emit_caption(captions_path: str, model: str, img_file: str, text: str) -> None:
    """Append one caption record to the JSONL: the answer after the
    model's split marker, stripped, with every sentence containing 'unk'
    dropped (the reference's filter)."""
    img_id = int(img_file.split(".jpg")[0][-6:])
    split = ANSWER_SPLIT[model]
    if split and split in text:
        text = text.split(split, 1)[-1]
    text = text.strip()
    text = ".".join(s for s in text.split(".") if "unk" not in s)
    print(text)
    with open(captions_path, "a") as f:
        json.dump({"image_id": img_id, "caption": text}, f)
        f.write("\n")


def chair_eval(
    chair_input_path,
    model_type,
    num_images,
    output_dir,
    dataset_name,
    data_dir,
    metric,
    verbosity=False,
):
    """Post-pass CHAIR scoring + results tree (the JAX CLI's layout and
    file naming)."""
    model_name = "llava"
    out_dir = os.path.join(output_dir, metric, f"{model_name}_{model_type}", dataset_name)
    os.makedirs(out_dir, exist_ok=True)

    caps, imids, overall = load_generated_captions(chair_input_path)
    evaluator = ChairEvaluator(imids)
    evaluator.load_annotations(os.path.join(data_dir, "annotations"))
    cap_dict = evaluator.compute(caps, overall)

    stem = f"{model_name}_{model_type}_{dataset_name}_num_images_{num_images}_chair_results"
    with open(os.path.join(out_dir, stem + ".json"), "w") as f:
        json.dump(cap_dict, f, indent=4)
    table = metric_table(cap_dict)
    print(table)
    with open(os.path.join(out_dir, stem + ".txt"), "w") as f:
        f.write(table)
    if verbosity:
        print(f"\nCHAIR results saved to {os.path.join(out_dir, stem + '.txt')}.")

    import numpy as np

    per_img = cap_dict["sentences"]
    n = max(len(per_img), 1)
    meteor = sum(s["metrics"]["METEOR"] for s in per_img) / n
    log_cider = sum(
        max(np.log10(max(s["metrics"]["CIDEr"], 1e-20)) + 20, 0) for s in per_img
    ) / n
    chairs = sum(s["metrics"]["CHAIRs"] for s in per_img) / n
    objects = sum(len(s["mscoco_generated_words"]) for s in per_img)
    halluc = sum(len(s["hallucination_idxs"]) for s in per_img)
    bleu = sum(
        (s["metrics"]["Bleu_1"] + s["metrics"]["Bleu_2"] + s["metrics"]["Bleu_3"] + s["metrics"]["Bleu_4"]) / 4
        for s in per_img
    ) / n
    print("meteor: ", meteor)
    print("log_cider: ", log_cider)
    print("chairs: ", chairs)
    print("chairi: ", halluc / max(objects, 1))
    print("bleu: ", bleu)
    print("hallucinate_sum: ", halluc)


def _progress(done: int, total: int, what: str = "captioned") -> None:
    print(f"{what} {done}/{total}", file=sys.stderr)


def main(args, device="cuda"):
    from PIL import Image

    from ..engine.trace import StageTimer, profile_trace
    from ..evalsuite.metrics.evalcap import chunked_self_critical_eval

    engine, processor = make_engine(args, device=device)
    model = args.model

    coco, _ = load_coco_data(args.coco_data_dir)
    img_ids = coco.getImgIds()

    # --- sample persistence ---
    if args.use_prev_sample is not None:
        with open(args.sample_save_name) as f:
            sampled = [int(line.strip()) for line in f]
        print(f"Loaded {len(sampled)} image IDs from {args.sample_save_name}")
    else:
        if args.seed is not None:
            seed(args.seed)
        sampled = sample(img_ids, args.image_numbers)
        with open(args.sample_save_name, "w") as f:
            f.writelines(f"{i}\n" for i in sampled)
        print(f"Sampled {args.image_numbers} image IDs -> {args.sample_save_name}")

    img_files = [coco.loadImgs(i)[0]["file_name"] for i in sampled]
    paths = [os.path.join(args.coco_data_dir, "val2014", f) for f in img_files]

    os.makedirs(args.output_dir, exist_ok=True)
    filename = args.method + datetime.now().strftime("%m%d%H%M") + ".json"
    captions_path = os.path.join(args.output_dir, filename)

    def load(path):
        return Image.open(path).convert("RGB")

    timer = StageTimer()
    batch = max(getattr(args, "batch_size", 1) or 1, 1)
    if batch > 1:
        # batched path: dropout decoding, --original, beam search and VCD
        # run over ``batch`` images (identical prompts, so identical merged
        # lengths); LLaVA-NeXT rows carry their own tile stacks and sizes,
        # InstructBLIP rows their Q-Former ids
        import numpy as np

        for start in range(0, len(img_files), batch):
            group = img_files[start : start + batch]
            ids_list, px_list, size_list, qid_list = [], [], [], []
            for path in paths[start : start + batch]:
                image = load(path)
                if model == "llava-next":
                    tiles, orig = next_image_prep(engine)(image)
                    ids_list.append(processor(PROMPTS[model])["input_ids"][0])
                    px_list.append(tiles)
                    size_list.append(orig)
                else:
                    inputs = processor(PROMPTS[model], image)
                    ids_list.append(inputs["input_ids"][0])
                    px_list.append(inputs["pixel_values"][0])
                    if model == "instructblip":
                        q = qformer_ids_for(processor, PROMPTS[model], inputs)
                        qid_list.append(np.asarray(q)[0])
            for rows in (ids_list, px_list, size_list, qid_list):  # the last group keeps the
                rows.extend(rows[-1:] * (batch - len(group)))  # batch's shape
            if model == "llava-next":
                result = generate_arm(engine, model, np.stack(ids_list), px_list, size_list)
            elif model == "instructblip":
                result = generate_arm(engine, model, np.stack(ids_list), np.stack(px_list),
                                      np.stack(qid_list))
            else:
                result = generate_arm(engine, model, np.stack(ids_list), np.stack(px_list))
            for i, img_file in enumerate(group):
                text = processor.decode(result.tokens[i][: result.num_tokens[i]])
                emit_caption(captions_path, model, img_file, text)
            _progress(start + len(group), len(img_files))
    else:
        # threads decode the next JPEGs while the card runs this one
        from ..utils.native_image import PrefetchLoader

        loader = PrefetchLoader(paths, load, depth=4, workers=2)
        with profile_trace(getattr(args, "profile_dir", None)):
            for i, ((path, image), img_file) in enumerate(zip(loader, img_files)):
                with timer.stage("generate"):
                    text = run_engine(engine, processor, model, PROMPTS[model], image)
                emit_caption(captions_path, model, img_file, text)
                _progress(i + 1, len(img_files))

    print("the result is saved into", args.output_dir, filename)
    if timer.totals:
        report = timer.report()
        print("stage timings:", json.dumps(report))
        timer.dump(os.path.join(args.output_dir, "stage_timings.json"))

    # --- scoring ---
    with open(captions_path) as f:
        loaded = [json.loads(line) for line in f]
    seen = set()
    deduped = []
    for rec in loaded:
        if rec["image_id"] not in seen:
            seen.add(rec["image_id"])
            deduped.append(rec)

    formatted = chunked_self_critical_eval(coco, deduped)
    os.makedirs("./vlm_results", exist_ok=True)
    formatted_path = os.path.join("./vlm_results", filename)
    with open(formatted_path, "w") as f:
        json.dump(formatted, f)
    print("output file saved at: ", formatted_path)

    chair_eval(
        chair_input_path=formatted_path,
        model_type=model,
        num_images=500,  # the reference hard-codes 500 in result names
        output_dir="./results",
        dataset_name="coco",
        data_dir=args.coco_data_dir,
        metric=args.method,
        verbosity=True,
    )

    if str2bool(getattr(args, "throne", False)):
        # THRONE-format export + class-wise P/R scoring
        from ..evalsuite.throne import evaluate_throne_file
        from .chair2throne import convert

        throne_path = os.path.join(args.output_dir, "throne_" + filename + "l")
        convert(captions_path, throne_path)
        imids = [r["image_id"] for r in deduped]
        ev = ChairEvaluator(imids)
        ev.load_annotations(os.path.join(args.coco_data_dir, "annotations"))
        score = evaluate_throne_file(throne_path, {i: ev.imid_to_objects[i] for i in imids})
        out_path = os.path.join(
            "./results", args.method, f"llava_{model}", "coco",
            f"llava_{model}_coco_throne_results.json",
        )
        with open(out_path, "w") as f:
            json.dump(score, f, indent=2)
        print(
            f"THRONE: macro_f1={score['macro_f1']:.4f} "
            f"macro_f05={score['macro_f05']:.4f} "
            f"halluc_rate={score['hallucination_rate']:.4f} -> {out_path}"
        )


def build_parser():
    """The JAX CLI's parser, flag for flag, name for name, default for
    default; the flags in ``NOT_PORTED`` parse and then raise when the
    engine is built."""
    p = argparse.ArgumentParser(
        description="CHAIR captioning with the PyTorch port (flags whose engine "
        "is not ported yet raise NotImplementedError naming their ROADMAP item)"
    )
    p.add_argument("--method", type=str, default="None")
    p.add_argument("--use-prev-sample", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--original", type=str2bool, default=False)
    p.add_argument("--num-beams", type=int, default=None)
    p.add_argument("--length-penalty", type=float, default=1.0)
    p.add_argument(
        "--early-stopping",
        default="false",
        help="beam stopping rule: true / false / never (HF semantics)",
    )
    # sampling knobs (HF generate surface; the reference's VCD path passes
    # do_sample=True, temperature=1.0, top_p=1, top_k=None —
    # chair_test.py:331-334 — and the VCD sampler here always samples;
    # these also enable sampled dropout-decoding / greedy runs)
    p.add_argument(
        "--consistency",
        type=str2bool,
        default=False,
        help="after CHAIR scoring, produce blank-image LM next-word "
        "distributions for every caption and report the mean LM rank of "
        "hallucinated words (evalsuite/consistency.lm_consistency; the "
        "reference's version is dormant)",
    )
    p.add_argument(
        "--consistency-im",
        type=str,
        default=None,
        choices=("projection", "clip"),
        help="after CHAIR scoring, produce image-classifier labels and "
        "report im-consistency of hallucinated objects (evalsuite/"
        "im_classifier.py; the reference's im_consistency.py is dormant)."
        "  'projection' reads the engine's visual->text top-k table; "
        "'clip' runs zero-shot over a full CLIP checkpoint (--clip-path)",
    )
    p.add_argument("--clip-path", type=str, default=None)
    p.add_argument("--do-sample", type=str2bool, default=False)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--sample-save-name", type=str, default="sample.log")
    p.add_argument("--image-numbers", type=int, default=500)
    p.add_argument("--model", type=str, default="llava-1.5")
    p.add_argument("--coco-data-dir", required=True, type=str)
    p.add_argument("--model-path", required=True, type=str)
    p.add_argument("--avg", type=str2bool, default=False)
    p.add_argument("--voting-numbers", type=int, default=3)
    p.add_argument("--opera", type=str2bool, default=False)
    # OPERA knobs (reference test_opera.py:86-89 flag surface; defaults
    # here are the reference chair arm's values, chair_test.py:312-323)
    p.add_argument("--scale_factor", "--scale-factor", dest="scale_factor",
                   type=float, default=5.0)
    p.add_argument("--threshold", type=int, default=15)
    p.add_argument("--num_attn_candidates", "--num-attn-candidates",
                   dest="num_attn_candidates", type=int, default=1)
    p.add_argument("--penalty_weights", "--penalty-weights",
                   dest="penalty_weights", type=float, default=1.0)
    p.add_argument("--vcd", type=str2bool, default=False)
    p.add_argument("--use_random", type=str2bool, default=False)
    p.add_argument("--output-dir", type=str, default="./outputs")
    # extensions beyond the reference CLI (documented in README):
    p.add_argument(
        "--mask-policy",
        type=str,
        default=None,
        help="override the per-model mask policy (epis, epis_quantile, "
        "epis_kl, epis_no_overlap, random_image, aggressive, keep_overlap)",
    )
    p.add_argument(
        "--text-logit-mask",
        type=str2bool,
        default=False,
        help="also mask generated-text positions by 1/max-logit "
        "(the reference's 'logits' text-mask variant, llava.py:548-557)",
    )
    p.add_argument(
        "--batch-size",
        type=int,
        default=1,
        help="images per device batch (llava-1.5 / llava-next dropout "
        "decoding; the "
        "batch axis data-parallelizes across a mesh)",
    )
    p.add_argument(
        "--fused-step",
        type=str2bool,
        default=False,
        help="single-weight-stream decode step (~2x throughput); overlap "
        "keep-set lags one step — see EnsembleConfig.fused_step",
    )
    p.add_argument(
        "--profile-dir",
        type=str,
        default=None,
        help="write a torch.profiler trace (trace.json, for Perfetto) of the "
        "serial captioning loop to this dir",
    )
    p.add_argument(
        "--quantize",
        type=str,
        default=None,
        choices=[None, "int8", "w8a8", "int4"],
        help="LM tower quantization: 'int8' = weight-only per-channel "
        "symmetric (~2x decode throughput); 'w8a8' = int8 weights + "
        "on-the-fly int8 activations for PREFILL projections on the "
        "native int8 MXU (~1.6x prefill rate; decode unchanged); "
        "'int4' = weight-only group-wise (g=128) clip-searched 4-bit "
        "projections with an int8 lm_head — near-halves the int8 decode "
        "weight stream (drift measured in cli/fused_gap.py --study int4)",
    )
    p.add_argument(
        "--spec-gamma",
        type=int,
        default=None,
        help="speculative greedy decoding for --original runs (llava-1.5, "
        "dense KV): draft N tokens per cycle (--spec-draft picks the "
        "source), verify in one target forward — output is "
        "token-identical to plain greedy (engine/speculative.py; "
        "acceptance-dependent speedup, see STATUS.md)",
    )
    p.add_argument(
        "--spec-draft",
        choices=["int4", "ngram"],
        default="int4",
        help="draft source for --spec-gamma: 'int4' = int4 self-draft of "
        "the same weights (gamma extra int4 weight streams per cycle; "
        "wins at trained-checkpoint acceptance); 'ngram' = prompt-lookup "
        "drafting from the emitted sequence's own bigram repeats (zero "
        "extra weight streams — never slower than greedy by more than "
        "the G+1-wide verify, wins on repetitive output)",
    )
    p.add_argument(
        "--fuse-proj",
        type=str2bool,
        default=True,
        help="fuse qkv and gate+up weight leaves on single-device runs "
        "(identical outputs — a weight-layout change; "
        "tests/test_fused_proj.py); mesh runs always keep split leaves",
    )
    p.add_argument(
        "--w8a8-decode",
        type=str2bool,
        default=False,
        help="int8-MXU DECODE projections (requires --quantize int8/w8a8): "
        "a throughput lever for LARGE-BATCH decoding, where the "
        "B*(K+1)-row projections are MXU-compute-bound (single-stream "
        "decode is HBM-bound and gains nothing); accumulated drift "
        "measured in cli/fused_gap.py --study w8a8decode",
    )
    p.add_argument(
        "--int8-kv",
        type=str2bool,
        default=False,
        help="int8-quantized KV cache (halves the decode cache stream; "
        "with --quantize this is the full-depth-7B-on-16GB deployment "
        "config benchmarked in bench.py; measured token drift below the "
        "method's own RNG-seed variability — STATUS.md)",
    )
    p.add_argument(
        "--throne",
        type=str2bool,
        default=False,
        help="also export THRONE-format responses and score class-wise "
        "P/R/F (evalsuite/throne.py)",
    )
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
