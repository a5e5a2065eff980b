"""POPE probing harness of the port: the question files, the one-token
answers, the timestamped answer archive and the confusion-matrix report of
``dropoutdecoding_tpu/cli/pope_test.py``, over the port's engines.

Usage:
  python -m dropoutdecoding_tpu_torch.cli.pope_test \\
      --model llava --model-path /ckpts/llava-1.5-7b-hf \\
      --coco-data-dir /data/coco --pope-dir ./pope_out --number 3000

It runs on the first CUDA device; ``main(args, device="cpu")`` runs it on
the CPU (the kernels' plain twins).  The parser is the JAX CLI's, flag for
flag.  Three paths answer the questions, each with the greedy first token:

- serial: ``generate`` with one new token, a question at a time;
- ``--batch-size B``: ``engine.probe`` over B right-padded questions at a
  time, the vision tower run once for each unique image (``image_index``);
- ``--prefix-cache True``: each image's questions share the prompt up to
  the question text, so that prefix is prefilled once
  (``engine.probe_prefix``) and the questions run as tails over it
  (``engine.probe_extend``); ``--int8-prefix-cache True`` keeps the prefix
  int8.

``--model instructblip`` runs serially and batched (its Q-Former reads each
question, so a batch carries the questions' Q-Former ids with their
mask); its ``--prefix-cache`` exits before the model loads, as the JAX
CLI's does.  ``--quantize w8a8`` raises ``NotImplementedError`` naming its
ROADMAP Queue 1 item before the model or any image is read.  The grouping and padding are plain functions over id
arrays (``template_prefix_len``, ``group_prefix_len``, ``pad_tails``,
``pad_rows``, ``image_slots``, ``fill_rows``, ``image_runs``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import time
from argparse import Namespace
from datetime import datetime

import numpy as np

from ..evalsuite.pope import (
    build_questions,
    parse_question_file,
    print_scores,
    score_answers,
    seed_question_dir,
    write_questions,
)
from ..engine.instructblip_engine import NO_SHARED_PREFIX
from .chair_test import _progress, str2bool

POPE_PROMPTS = {
    "llava-next": "[INST] <image>\n{}[/INST]",
    "llava": "USER: <image>\n{} ASSISTANT:",
    "instructblip": "{}",
}
# the CLI's model names -> the CHAIR CLI's (make_engine's)
MODEL_KEYS = {"llava": "llava-1.5", "llava-next": "llava-next", "instructblip": "instructblip"}
STRATEGIES = ("adversarial", "popular", "random")
QPAD = 8  # a prefix-cache group's tail rows are padded to a multiple of this
PAD_TO = 8  # and its tails, like --batch-size's rows, to a multiple of this many tokens


def refresh_questions(coco_data_dir: str, out_dir: str, n_images: int = 500, seed=None):
    """Regenerate the three question files from the COCO instance
    annotations: ``n_images`` images with at least 3 objects, 3 questions of
    each label per image (the JAX CLI's rule)."""
    import random

    with open(os.path.join(coco_data_dir, "annotations/instances_val2014.json")) as f:
        inst = json.load(f)
    id_to_name = {c["id"]: c["name"] for c in inst["categories"]}
    img_file = {im["id"]: im["file_name"] for im in inst["images"]}
    objs = {}
    for ann in inst["annotations"]:
        objs.setdefault(ann["image_id"], [])
        name = id_to_name[ann["category_id"]]
        if name not in objs[ann["image_id"]]:
            objs[ann["image_id"]].append(name)
    rich = [i for i, o in objs.items() if len(o) >= 3]
    rng = random.Random(seed)
    chosen = rng.sample(rich, min(n_images, len(rich)))
    segments = [{"image": img_file[i], "objects": objs[i]} for i in chosen]
    paths = {}
    for strategy in ("random", "popular", "adversarial"):
        qs = build_questions(segments, sample_num=3, neg_strategy=strategy, seed=seed)
        paths[strategy] = write_questions(qs, out_dir, "coco", strategy)
    return paths


# --- grouping and padding, over id arrays -------------------------------------


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def template_prefix_len(ids_a: np.ndarray, ids_b: np.ndarray) -> int:
    """The length of the common start of two prompts' ids: with two
    questions that differ from their first letter on ("aaaa", "zzzz"), the
    template's part before the question."""
    m = min(len(ids_a), len(ids_b))
    neq = np.nonzero(ids_a[:m] != ids_b[:m])[0]
    return int(neq[0]) if len(neq) else m


def group_prefix_len(rows: list, template_len: int) -> int:
    """The prefix one image's question rows share: the template's, shrunk
    until every row starts with it (a tokenizer may merge the question's
    first piece into the template's last) and until every row keeps at least
    one tail token."""
    p = min(template_len, min(len(r) for r in rows) - 1)
    while p > 1 and any(not np.array_equal(r[:p], rows[0][:p]) for r in rows):
        p -= 1
    return p


def pad_tails(tails: list, qpad: int = QPAD):
    """Question tails -> (tail_ids [Qp, T] int32, lens [Qp] int32): Qp the
    tail count rounded up to ``qpad`` rows, T the longest tail rounded up
    to ``PAD_TO`` tokens; pad rows have length 1."""
    T = _round_up(max(len(t) for t in tails), PAD_TO)
    Qp = _round_up(len(tails), qpad)
    tail_ids = np.zeros((Qp, T), np.int32)
    lens = np.ones((Qp,), np.int32)
    for i, t in enumerate(tails):
        tail_ids[i, : len(t)] = t
        lens[i] = len(t)
    return tail_ids, lens


def pad_rows(rows: list):
    """Right-pad id rows to a common multiple of ``PAD_TO``; returns (ids
    [B, S] int32, mask [B, S] int32)."""
    S = _round_up(max(len(r) for r in rows), PAD_TO)
    out = np.zeros((len(rows), S), np.int32)
    mask = np.zeros((len(rows), S), np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
        mask[i, : len(r)] = 1
    return out, mask


def image_slots(names: list):
    """(image_index [len(names)], the unique names in first-seen order): row
    i reads unique image ``image_index[i]``."""
    slot = {}
    index = [slot.setdefault(name, len(slot)) for name in names]
    return index, list(slot)


def fill_rows(rows: list, size: int) -> list:
    """``rows`` with its last entry repeated up to ``size``: a short last
    group keeps the batch's shape (its image is already in the unique set)."""
    return rows + [rows[-1]] * (size - len(rows))


def image_runs(names: list) -> list:
    """[(image, start, stop)] of the runs of consecutive questions on one
    image."""
    runs = []
    for i, name in enumerate(names):
        if runs and runs[-1][0] == name:
            runs[-1][2] = i + 1
        else:
            runs.append([name, i, i + 1])
    return [tuple(r) for r in runs]


# --- the three paths ----------------------------------------------------------


def engine_args(args, model_key: str) -> Namespace:
    """The CHAIR CLI's arguments for the engine ``args`` ask for (the JAX
    POPE CLI's field set; ``build_engine`` reads the rest with defaults)."""
    return Namespace(
        model=model_key,
        model_path=args.model_path,
        opera=False,
        vcd=False,
        original=args.original,
        num_beams=1,
        avg=args.avg,
        voting_numbers=args.voting_numbers,
        use_random=args.use_random,
        seed=args.seed,
        quantize=args.quantize,
        int8_kv=args.int8_kv,
        int8_prefix_cache=args.int8_prefix_cache,
    )


def _answer(processor, token) -> str:
    return processor.decode([int(token)]).strip()


def answer_serial(engine, processor, model, prompts, names, load) -> list:
    """One ``generate`` a question (``engine.gen`` says ``max_new_tokens=1``)."""
    from .chair_test import run_engine

    answers = []
    for prompt, name in zip(prompts, names):
        answers.append(run_engine(engine, processor, MODEL_KEYS[model], prompt, load(name)).strip())
        _progress(len(answers), len(prompts), "answered")
    return answers


def answer_batch(engine, processor, model, prompts, names, load, batch: int) -> list:
    """``engine.probe`` over groups of ``batch`` right-padded questions, the
    vision tower run once for each unique image of a group; InstructBLIP's
    rows carry their Q-Former ids, right-padded with their mask."""
    from .chair_test import next_image_prep, qformer_ids_for

    answers = []
    for start in range(0, len(prompts), batch):
        group = prompts[start : start + batch]
        index, unique = image_slots(names[start : start + batch])
        images = [load(name) for name in unique]
        rows = fill_rows([np.asarray(processor(p)["input_ids"])[0] for p in group], batch)
        lens = np.array([len(r) for r in rows], np.int32)
        ids, _ = pad_rows(rows)
        extra = {}
        if model == "llava-next":
            prepped = [next_image_prep(engine)(image) for image in images]
            tiles, sizes = [t for t, _ in prepped], [o for _, o in prepped]
            pixels = (tiles, sizes)
        else:  # each image through the processor with the prompt of its first row
            pixels = (np.concatenate([
                np.asarray(processor(group[index.index(u)], image)["pixel_values"])
                for u, image in enumerate(images)
            ]),)
        if model == "instructblip":  # the Q-Former reads each question
            q_rows = [np.asarray(qformer_ids_for(processor, p, processor(p)))[0] for p in group]
            q_ids, extra["qformer_attention_mask"] = pad_rows(fill_rows(q_rows, batch))
            pixels += (q_ids,)
        index = np.asarray(fill_rows(index, batch), np.int32)
        result = engine.probe(ids, *pixels, text_lens=lens, image_index=index, **extra)
        answers += [_answer(processor, t) for t in result.first_token[: len(group)].tolist()]
        _progress(start + len(group), len(prompts), "answered")
    return answers


def answer_prefix_cached(engine, processor, model, prompts, names, load) -> list:
    """Each image's consecutive questions as tails over one cached prefix:
    ``engine.probe_prefix`` of the shared prompt start, then one
    ``engine.probe_extend`` of the group's tails."""
    from .chair_test import next_image_prep

    template = POPE_PROMPTS[model]
    template_len = template_prefix_len(
        np.asarray(processor(template.format("aaaa"))["input_ids"])[0],
        np.asarray(processor(template.format("zzzz"))["input_ids"])[0],
    )
    answers = []
    for name, start, stop in image_runs(names):
        image = load(name)
        group = prompts[start:stop]
        rows = [np.asarray(processor(p)["input_ids"])[0] for p in group]
        p_use = group_prefix_len(rows, template_len)
        image_pos = int(np.nonzero(rows[0] == engine.cfg.image_token_index)[0][0])
        if p_use <= image_pos:
            raise SystemExit(
                "--prefix-cache: shared prefix does not cover the image token for this "
                "prompt template"
            )
        prefix = rows[0][:p_use][None]
        if model == "llava-next":
            handle = engine.probe_prefix(prefix, *next_image_prep(engine)(image))
        else:
            pixels = processor(group[0], image)["pixel_values"]
            handle = engine.probe_prefix(prefix, pixels)
        tail_ids, lens = pad_tails([r[p_use:] for r in rows])
        result = engine.probe_extend(handle, tail_ids, lens)
        answers += [_answer(processor, t) for t in result.first_token[: len(group)].tolist()]
        _progress(stop, len(prompts), "answered")
    return answers


def main(args, device="cuda"):
    from PIL import Image

    from . import chair_test

    model_key = MODEL_KEYS[args.model]
    if str2bool(args.prefix_cache) and model_key == "instructblip":
        raise SystemExit(NO_SHARED_PREFIX)  # before the model loads: the constraint is structural
    eng_args = engine_args(args, model_key)
    chair_test.check_ported(eng_args)  # before any question, weight or image is read

    question_dir = os.path.join(args.pope_dir, "output", "coco")
    if str2bool(args.refresh_data):
        paths = refresh_questions(args.coco_data_dir, question_dir, seed=args.seed)
        print(f"Question files written: {list(paths.values())}")
    elif not os.path.isdir(question_dir):
        # the vendored canonical question sets: no COCO annotations needed
        paths = seed_question_dir(question_dir)
        print(f"Canonical question files vendored: {paths}")

    engine, processor = chair_test.make_engine(eng_args, device=device)
    engine.gen = dataclasses.replace(engine.gen, max_new_tokens=1)  # one token answers

    ans_dir = os.path.join(args.pope_dir, "answer")
    os.makedirs(ans_dir, exist_ok=True)
    image_base = os.path.join(args.coco_data_dir, "val2014")

    def load(name):
        return Image.open(os.path.join(image_base, name)).convert("RGB")

    # the question sets of this run, kept beside its answers
    run_stamp = datetime.now().strftime("%m-%d_%H-%M-%S")
    snap_dir = os.path.join(args.pope_dir, "pope_samples", run_stamp, "coco")
    os.makedirs(snap_dir, exist_ok=True)
    for strategy in STRATEGIES:
        src = os.path.join(question_dir, f"coco_pope_{strategy}.json")
        shutil.copy2(src, os.path.join(snap_dir, os.path.basename(src)))
    print(f"Question snapshot: {snap_dir}")

    batch = max(args.batch_size or 1, 1)
    for strategy in STRATEGIES:
        qfile = os.path.join(snap_dir, f"coco_pope_{strategy}.json")
        print(f"the pope file is {qfile}")
        questions = parse_question_file(qfile)[: args.number]
        prompts = [POPE_PROMPTS[args.model].format(q["text"]) for q in questions]
        names = [q["image"] for q in questions]
        t0 = time.perf_counter()
        if str2bool(args.prefix_cache):
            texts = answer_prefix_cached(engine, processor, args.model, prompts, names, load)
        elif batch > 1:
            texts = answer_batch(engine, processor, args.model, prompts, names, load, batch)
        else:
            texts = answer_serial(engine, processor, args.model, prompts, names, load)
        secs = time.perf_counter() - t0
        print(f"{strategy}: {len(texts)} questions in {secs:.3f} s "
              f"({secs / max(len(texts), 1):.4f} s a question)")
        answers = [{"question": q["text"], "answer": a} for q, a in zip(questions, texts)]

        # the strategy in the name: same-second runs of two strategies differ
        ans_path = os.path.join(ans_dir, f"{run_stamp}_{strategy}_ans.json")
        with open(ans_path, "w") as f:
            for a in answers:
                f.write(json.dumps(a) + "\n")
        # the sidecar links the archive to its question snapshot
        with open(ans_path.replace("_ans.json", "_ans.meta.json"), "w") as f:
            json.dump({"question_snapshot": snap_dir, "strategy": strategy, "n": len(answers)}, f)
        print(f"Answer file: {ans_path}")
        scores = score_answers(answers, [q["label"] for q in questions])
        print_scores(scores)


def build_parser():
    """The JAX CLI's parser, flag for flag, name for name, default for
    default."""
    p = argparse.ArgumentParser(
        description="POPE with the PyTorch port (--quantize w8a8 raises "
        "NotImplementedError naming its ROADMAP item)"
    )
    p.add_argument("--model", type=str, default="llava")
    p.add_argument("--model-path", type=str, required=True)
    p.add_argument("--coco-data-dir", type=str, required=True)
    p.add_argument("--pope-dir", type=str, default="./pope_out")
    p.add_argument("--original", type=str2bool, default=False)
    p.add_argument("--refresh-data", type=str2bool, default=False)
    p.add_argument("--number", type=int, default=3000)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--avg", type=str2bool, default=False)
    p.add_argument("--voting-numbers", type=int, default=3)
    p.add_argument("--use_random", type=str2bool, default=False)
    p.add_argument(
        "--quantize",
        type=str,
        default=None,
        choices=[None, "int8", "w8a8", "int4"],
        help="LM tower quantization: 'int8' weight-only per channel, 'int4' packed "
        "group-wise projections with an int8 head; 'w8a8' is not ported yet",
    )
    p.add_argument("--int8-kv", type=str2bool, default=False,
                   help="int8-quantized KV cache")
    p.add_argument("--int8-prefix-cache", type=str2bool, default=False,
                   help="keep the --prefix-cache prefixes int8-quantized: half the "
                   "bytes of a cached prefix")
    p.add_argument(
        "--batch-size",
        type=int,
        default=1,
        help="questions a device batch: right-padded rows with their real lengths, "
        "the vision tower once for each unique image of the batch",
    )
    p.add_argument(
        "--prefix-cache",
        type=str2bool,
        default=False,
        help="prefill the prompt start each image's questions share (the image and "
        "the template) once, and run each question as a short extension over its "
        "cached K/V; --model llava / llava-next (InstructBLIP's Q-Former reads the "
        "question, so no shared LM prefix exists)",
    )
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
