"""Interactive case-study REPL; port of
``dropoutdecoding_tpu/cli/step_gen.py``.

Replaces reference case_study/step_gen.py (broken as checked in: it imports
the missing models/utils, step_gen.py:3) and the interactive mask REPL
inside the reference LLaVA-NeXT forward (llavanext.py:833-875): caption an
image, inspect per-visual-token uncertainty, and caption again without the
ensemble.  It builds its engine through the CHAIR CLI's ``make_engine``,
on the card.

Usage:
  python -m dropoutdecoding_tpu_torch.cli.step_gen \
      --model llava-1.5 --model-path /ckpts/llava-1.5-7b-hf
then enter image paths at the prompt; commands:
  <path>              caption the image with dropout decoding
  !uncert             print top/bottom-10 uncertainty tokens for last image
  !greedy <path>      caption without the ensemble
  !quit
"""
from __future__ import annotations

import argparse
from argparse import Namespace

import numpy as np


def main(args, device="cuda"):
    from PIL import Image

    from .chair_test import PROMPTS, make_engine, run_engine

    eng_args = Namespace(
        model=args.model,
        model_path=args.model_path,
        opera=False,
        vcd=False,
        original=False,
        num_beams=1,
        avg=False,
        voting_numbers=3,
        use_random=False,
        seed=args.seed,
    )
    engine, processor = make_engine(eng_args, device=device)
    last_state = None

    while True:
        try:
            line = input("image> ").strip()
        except EOFError:
            break
        if not line:
            continue
        if line == "!quit":
            break
        if line == "!uncert":
            if last_state is None:
                print("no image yet")
                continue
            epis = last_state.epis[0].float().cpu().numpy()
            valid = last_state.visual_mask[0].cpu().numpy()
            epis = np.where(valid, epis, -np.inf)
            order = np.argsort(-epis)
            print("most uncertain visual tokens:", order[:10].tolist())
            print("least uncertain visual tokens:", order[-10:].tolist())
            unc = last_state.uncertainty
            print("image-level epis/alea:", float(unc["epis_uncert"][0]),
                  float(unc["alea_uncert"][0]))
            continue
        greedy = line.startswith("!greedy ")
        path = line[len("!greedy "):] if greedy else line
        try:
            image = Image.open(path).convert("RGB")
        except OSError as e:
            print("cannot open:", e)
            continue
        # the engine is built with the ensemble on (exact mode, no lagged
        # source), so the switch leaves nothing of the other arm behind
        engine.ensemble = not greedy
        text = run_engine(engine, processor, args.model, PROMPTS[args.model], image)
        print(text)
        # keep the state for !uncert (the prefill again); a failure raises
        if args.model == "llava-1.5":
            inputs = processor(PROMPTS[args.model], image)
            last_state = engine.prefill(inputs["input_ids"], inputs["pixel_values"])


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="llava-1.5")
    p.add_argument("--model-path", required=True)
    p.add_argument("--seed", type=int, default=None)
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
