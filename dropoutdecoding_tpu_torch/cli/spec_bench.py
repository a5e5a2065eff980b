"""Speculative greedy decoding at LLaVA-1.5-7B width on the card; port of
``dropoutdecoding_tpu/cli/spec_bench.py``.

Both LM towers come from one synthetic bf16 base
(``utils/convert.synthetic_llava_7b_dual``): the int8 tower is the target,
the int4 tower the self-draft, the pairing ``--spec-gamma`` deploys.
Random weights are the worst case for a draft's agreement, so beside each
measured rate stand:

- alpha (drafts accepted / drafts made) and tokens a cycle;
- ms a cycle split into the draft's and the verify's device spans (CUDA
  events) and the host's rest (the cycle's wall time less both);
- the draft == target run: every draft accepted, the alpha = 1 bound of
  the machinery;
- the ngram draft (no weights) and plain greedy decoding.

Each rate counts the tokens after the prefill's over the decode's wall
time (``torch.cuda.synchronize`` on both sides), summed over the prompts,
after a warm-up.  The target pays a bf16 copy of each int8 weight in every
product (``models/llama._mm``), the verify with it.  The last line of
stdout is one JSON object.

Usage (on the card):  python -m dropoutdecoding_tpu_torch.cli.spec_bench
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--tokens", type=int, default=64)
    p.add_argument("--gammas", type=int, nargs="*", default=[4])
    p.add_argument("--prompts", type=int, default=4)
    return p


def main(argv=None, device="cuda", cfg=None) -> dict:
    """Runs the bench; returns the JSON line's object.  ``cfg`` (a
    ``LlavaConfig``) replaces LLaVA-1.5-7B at ``--layers`` (a narrow model
    for a rehearsal on the CPU)."""
    import dataclasses

    from ..engine.generate import LlavaEngine
    from ..engine.speculative import SpeculativeGreedy
    from ..utils.config import GenerationConfig, LlavaConfig
    from ..utils.convert import synthetic_llava_7b_dual

    args = build_parser().parse_args(argv)
    if cfg is None:
        base = LlavaConfig()
        cfg = dataclasses.replace(
            base, text=dataclasses.replace(base.text, num_hidden_layers=args.layers))
    T, G = args.tokens, max(args.gammas)
    _sync(device)
    t0 = time.perf_counter()
    # the int8 target and its int4 draft, with the bf16 vision tower and projector
    cfg, params, draft = synthetic_llava_7b_dual(device, cfg, seed=0)
    lm8, lm4 = params.lm, draft.lm
    _sync(device)
    dual_s = time.perf_counter() - t0
    eng = LlavaEngine(
        cfg=cfg, params=params,
        gen=GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0),
        # the verify writes gamma rows past prompt + T (``_check_headroom``)
        max_len=cfg.vision.num_patches + 32 + T + G + 1, ensemble=False, seed=24,
    )
    print(f"dual towers (int8 target, int4 draft) of {cfg.text.num_hidden_layers} layers and "
          f"the vision tower made in {dual_s:.1f} s", file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    vocab = min(cfg.text.vocab_size, 30000)
    prompts = []
    for _ in range(args.prompts):
        row = [1] + [int(x) for x in rng.integers(4, vocab, 30)] + [5]
        row = [3 if x == cfg.image_token_index else x for x in row]  # one image token,
        row[4] = cfg.image_token_index  # at 4
        s = cfg.vision.image_size
        prompts.append((np.asarray([row]), rng.normal(size=(1, 3, s, s)).astype(np.float32)))

    def timed(fn):
        _sync(device)
        t = time.perf_counter()
        out = fn()
        _sync(device)
        return out, time.perf_counter() - t

    # greedy: the engine's decode loop after its prefill
    eng.generate(*prompts[0])  # warm-up
    n_tok = wall = 0.0
    for p in prompts:
        state = eng.prefill(*p)
        _, secs = timed(lambda: eng.decode(state))
        n_tok, wall = n_tok + T - 1, wall + secs
    greedy_tps = n_tok / wall
    print(f"greedy: {greedy_tps:.2f} tokens/s", file=sys.stderr, flush=True)

    def run(label, gamma, draft_lm, draft="lm"):
        times = []
        spec = SpeculativeGreedy(engine=eng, draft_lm=draft_lm, gamma=gamma, draft=draft,
                                 cycle_ms=times)
        spec.generate(*prompts[0])  # warm-up
        times.clear()
        n_tok = n_cyc = n_acc = 0
        for p in prompts:
            tokens, cycles, accepted = spec.generate(*p)
            n_tok, n_cyc, n_acc = n_tok + len(tokens) - 1, n_cyc + cycles, n_acc + accepted
        draft_ms, verify_ms, wall_ms = (float(np.mean([t[i] for t in times])) for i in range(3))
        rec = dict(
            label=label, gamma=gamma, alpha=n_acc / max(n_cyc * gamma, 1),
            tok_per_cycle=n_tok / max(n_cyc, 1), cycles=n_cyc,
            tps=n_tok / (sum(t[2] for t in times) / 1e3),
            ms_per_cycle={"draft": draft_ms, "verify": verify_ms,
                          "host": wall_ms - draft_ms - verify_ms, "wall": wall_ms},
        )
        rec["vs_greedy"] = rec["tps"] / greedy_tps
        print(f"{label} gamma={gamma}: {rec['tps']:.2f} tokens/s ({rec['vs_greedy']:.2f}x greedy), "
              f"alpha {rec['alpha']:.3f}, {rec['tok_per_cycle']:.2f} tokens a cycle over {n_cyc} "
              f"cycles; ms a cycle: draft {draft_ms:.2f}, verify {verify_ms:.2f}, host "
              f"{rec['ms_per_cycle']['host']:.2f}", file=sys.stderr, flush=True)
        return rec

    runs = []
    for g in args.gammas:
        runs.append(run("int4-draft", g, lm4))
        runs.append(run("ngram-draft", g, None, "ngram"))
    runs.append(run("target-draft (alpha=1)", args.gammas[0], lm8))
    out = {
        "metric": "speculative_greedy_7b",
        "device": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu",
        "layers": cfg.text.num_hidden_layers, "tokens": T, "prompts": args.prompts,
        "dual_towers_s": dual_s, "greedy_tps": greedy_tps, "runs": runs,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
