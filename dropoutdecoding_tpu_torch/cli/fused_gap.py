"""Quantify the fused-step semantic gap (exact vs fused Dropout Decoding);
port of ``dropoutdecoding_tpu/cli/fused_gap.py``.

Exact mode takes the overlap keep-set from the CURRENT step's unmasked
argmax (reference llava.py:305->345), at the cost of a second forward a
token.  Fused mode (``EnsembleConfig.fused_step``) folds the unmasked
member into one width-(K+1) forward and takes the keep-set from the
PREVIOUS step's unmasked argmax (and, under "epis_kl", its logits): the
weights stream once a token, but the overlap source lags one step.

The study measures what that lag does to the tokens:

- token agreement between exact and fused runs from the same prefill and
  the same draws (the semantic gap);
- token agreement between two exact runs under different draws (the
  method's own run-to-run noise floor; the reference varies by +-2 CHAIRs
  across seeds, SURVEY.md §6);
- exact against plain greedy decoding (the method's effect size, for
  scale);
- the vote winners' distributions of exact and fused runs (total
  variation distance).

Each arm decodes its own copy of the prefill's cache (the port writes a
cache in place) through the engine's own loop (``LlavaEngine.decode``),
which hands out each step's vote winner.  The quantization studies (int8,
int4, w8a8) compare whole generations, each arm with its own prefill.
Every study takes ``uniform``, a function of a seed that returns the
members' mask draws (``LlavaEngine.uniform``; None: the engines' Philox
draws), so a test can inject the JAX package's.

Usage (on the card):
    python -m dropoutdecoding_tpu_torch.cli.fused_gap [--study production]
        [--k 3|8] [--policy epis|epis_kl] [--prompts N] [--seeds N]
        [--tokens T] [--hidden D] [--layers L] [--vocab V] [--json]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

K8_PROBS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8)


def _tiny_config(hidden: int, layers: int, vocab: int):
    """The tiny studies' LLaVA: 8 heads over 4 KV heads, a 2-layer ViT at
    56 px (16 visual tokens)."""
    from ..utils.config import ClipVisionConfig, LlamaConfig, LlavaConfig

    return LlavaConfig(
        text=LlamaConfig(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=hidden * 2,
            num_hidden_layers=layers, num_attention_heads=8, num_key_value_heads=4,
            head_dim=hidden // 8,
        ),
        vision=ClipVisionConfig(
            hidden_size=hidden // 2, intermediate_size=hidden, num_hidden_layers=2,
            num_attention_heads=4, image_size=56, patch_size=14,
        ),
        image_token_index=vocab - 2,
        pad_token_id=vocab - 1,
    )


def _build(hidden, layers, vocab, seed, device):
    """(cfg, fp32 params) of a tiny study."""
    from ..utils.convert import synthetic_llava_params

    cfg = _tiny_config(hidden, layers, vocab)
    return cfg, synthetic_llava_params(cfg, device, torch.float32, seed=seed)


def _engine(cfg, params, *, fused, seed, T, ensemble=True, mask_policy="epis", uniform=None,
            **fields):
    from ..engine.generate import LlavaEngine
    from ..utils.config import EnsembleConfig, GenerationConfig

    return LlavaEngine(
        cfg=cfg,
        params=params,
        ens=EnsembleConfig(fused_step=fused, mask_policy=mask_policy),
        gen=GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0),
        max_len=64 + T,
        ensemble=ensemble,
        seed=seed,
        uniform=None if uniform is None else uniform(seed),
        **fields,
    )


def _tiny_prompts(r, n: int, cfg):
    """``n`` (ids [1, 5], pixels [1, 3, 56, 56]) of the tiny studies, drawn
    from the numpy generator ``r`` in the JAX tool's order."""
    vocab, img = cfg.text.vocab_size, cfg.image_token_index
    prompts = []
    for _ in range(n):
        ids = np.array(
            [[1, int(r.integers(3, vocab - 3)), img, int(r.integers(3, vocab - 3)), 5]], np.int32
        )
        px = r.normal(size=(1, 3, 56, 56)).astype(np.float32)
        prompts.append((ids, px))
    return prompts


def _own_cache(state):
    """``state`` with a copy of its cache: an arm appends to its copy in
    place and leaves the prefill's cache as it found it."""
    from ..models import llama as llama_mod

    return state._replace(cache=llama_mod.cache_map(state.cache, lambda t, axis: t.clone()))


def _row0(t: torch.Tensor) -> np.ndarray:
    return t[0].cpu().numpy().astype(np.int64)


def _run_with_winners(engine, state):
    """Row 0 of the engine's own decode loop on a copy of the state's
    cache: (tokens [T], vote winners [T - 1]) as numpy arrays."""
    winners = []
    tokens = engine.decode(_own_cache(state), winners=winners)
    return _row0(tokens), _row0(torch.stack(winners, dim=1))


def _decode(engine, state) -> np.ndarray:
    """Row 0's tokens of the engine's own decode loop, on a copy of the
    state's cache."""
    return _row0(engine.decode(_own_cache(state)))


def _generate(engine, ids, px) -> np.ndarray:
    """Row 0 of a whole generation: the engine's own prefill, then decode."""
    return engine.generate(ids, px).tokens[0].astype(np.int64)


def _agreement(a: np.ndarray, b: np.ndarray) -> dict:
    eq = a == b
    first_div = int(np.argmin(eq)) if not eq.all() else len(a)
    return {"match_rate": float(eq.mean()), "prefix_len": first_div}


def _summarize(rows, key) -> dict:
    m = [r[key]["match_rate"] for r in rows]
    pl = [r[key]["prefix_len"] for r in rows]
    return {
        "mean_match_rate": round(float(np.mean(m)), 4),
        "mean_prefix_len": round(float(np.mean(pl)), 2),
        "runs": len(m),
    }


def _dist(counts: np.ndarray) -> np.ndarray:
    return counts / max(counts.sum(), 1)


def _tv(pe: np.ndarray, pf: np.ndarray) -> float:
    return round(float(np.abs(pe - pf).sum() / 2), 4)


def _gap_report(rows, winner_counts) -> dict:
    """The exact-vs-fused studies' summaries: each pair of arms, and the
    vote winners' distributions with their total variation."""
    pe, pf = _dist(winner_counts["exact"]), _dist(winner_counts["fused"])
    return {
        "exact_vs_fused": _summarize(rows, "exact_vs_fused"),
        "exact_vs_exact_seed_noise_floor": _summarize(rows, "exact_vs_exact_seed"),
        "exact_vs_greedy_effect_size": _summarize(rows, "exact_vs_greedy"),
        "winner_dist_exact": [round(float(x), 4) for x in pe],
        "winner_dist_fused": [round(float(x), 4) for x in pf],
        "winner_tv_distance": _tv(pe, pf),
    }


def run_study(hidden, layers, vocab, n_prompts, n_seeds, T, model_seed=0, mask_policy="epis",
              device="cuda", uniform=None):
    """Exact against fused on the tiny model, ``n_prompts`` x ``n_seeds``
    runs of T tokens; the JSON report's object."""
    cfg, params = _build(hidden, layers, vocab, model_seed, device)
    r = np.random.default_rng(model_seed)
    rows = []
    winner_counts = {"exact": np.zeros(3), "fused": np.zeros(3)}
    for p in range(n_prompts):
        (ids, px), = _tiny_prompts(r, 1, cfg)
        for s in range(n_seeds):
            seed = 24 + 1000 * s
            kw = dict(T=T, mask_policy=mask_policy, uniform=uniform)
            exact = _engine(cfg, params, fused=False, seed=seed, **kw)
            fused = _engine(cfg, params, fused=True, seed=seed, **kw)
            exact2 = _engine(cfg, params, fused=False, seed=seed + 7, **kw)
            greedy = _engine(cfg, params, fused=False, ensemble=False, seed=seed, T=T)

            st = exact.prefill(ids, px)
            tok_e, win_e = _run_with_winners(exact, st)
            tok_f, win_f = _run_with_winners(fused, st)
            tok_e2 = _decode(exact2, st)
            tok_g = _decode(greedy, st)

            rows.append({
                "prompt": p, "seed": s,
                "exact_vs_fused": _agreement(tok_e, tok_f),
                "exact_vs_exact_seed": _agreement(tok_e, tok_e2),
                "exact_vs_greedy": _agreement(tok_e, tok_g),
            })
            np.add.at(winner_counts["exact"], win_e, 1)
            np.add.at(winner_counts["fused"], win_f, 1)

    return {
        "config": {"hidden": hidden, "layers": layers, "vocab": vocab,
                   "prompts": n_prompts, "seeds": n_seeds, "tokens": T,
                   "mask_policy": mask_policy},
        **_gap_report(rows, winner_counts),
    }


def _arm_study(hidden, layers, vocab, n_prompts, n_seeds, T, model_seed, device, uniform,
               make_arms, pairs):
    """The quantization studies' loop: for each seed, ``make_arms(params,
    mk, seed)`` gives {name: engine} (``mk(params, seed, ensemble,
    **fields)`` an exact-mode engine), each arm generates every prompt
    from its own prefill, and each (key, a, b) of ``pairs`` compares two
    arms.  Returns (cfg, the rows' summaries by key)."""
    cfg, params = _build(hidden, layers, vocab, model_seed, device)
    prompts = _tiny_prompts(np.random.default_rng(model_seed), n_prompts, cfg)

    def mk(prm, seed, ensemble=True, **fields):
        return _engine(cfg, prm, fused=False, seed=seed, T=T, ensemble=ensemble,
                       uniform=uniform, **fields)

    rows = []
    for s in range(n_seeds):
        arms = make_arms(params, mk, 24 + 1000 * s)
        for ids, px in prompts:
            tok = {name: _generate(e, ids, px) for name, e in arms.items()}
            rows.append({key: _agreement(tok[a], tok[b]) for key, a, b in pairs})
    return {key: _summarize(rows, key) for key, _, _ in pairs}


def _int8(params):
    from ..utils.quantize import quantize_llama_params

    return params._replace(lm=quantize_llama_params(params.lm))


def _config(hidden, layers, vocab, n_prompts, n_seeds, T) -> dict:
    return {"hidden": hidden, "layers": layers, "vocab": vocab,
            "prompts": n_prompts, "seeds": n_seeds, "tokens": T}


def run_int8_study(hidden, layers, vocab, n_prompts, n_seeds, T, model_seed=0, device="cuda",
                   uniform=None):
    """int8 (weights + KV cache) against full precision, with the method's
    cross-seed variability as the noise floor: the quality evidence for the
    int8 tier (``utils/quantize.py`` + ``int8_kv``).  Each arm runs its
    own prefill (quantized weights change the prefill logits too)."""
    def arms(params, mk, seed):
        q = _int8(params)
        return {
            "fp": mk(params, seed),
            "int8": mk(q, seed, int8_kv=True),
            "fp_seed2": mk(params, seed + 7),
            "g_fp": mk(params, seed, ensemble=False),
            "g_int8": mk(q, seed, ensemble=False, int8_kv=True),
        }

    out = _arm_study(hidden, layers, vocab, n_prompts, n_seeds, T, model_seed, device, uniform,
                     arms, [("fp_vs_int8", "fp", "int8"), ("fp_vs_fp_seed", "fp", "fp_seed2"),
                            ("greedy_fp_vs_int8", "g_fp", "g_int8")])
    return {
        "config": _config(hidden, layers, vocab, n_prompts, n_seeds, T),
        "exact_fp_vs_int8": out["fp_vs_int8"],
        "exact_fp_vs_fp_seed_noise_floor": out["fp_vs_fp_seed"],
        "greedy_fp_vs_int8": out["greedy_fp_vs_int8"],
    }


def _int4_group(hidden: int) -> int:
    """The int4 group the tiny study quantizes with (the JAX tool's rule)."""
    g = 128
    while hidden % (2 * g) or (2 * hidden) % (2 * g):
        g //= 2
    return g


def run_int4_study(hidden, layers, vocab, n_prompts, n_seeds, T, model_seed=0, device="cuda",
                   uniform=None):
    """int4 (group-wise packed weights + int8 KV) against full precision
    and against the int8 tier, with the cross-seed noise floor: the quality
    evidence for ``--quantize int4``.  int8 against int4 isolates the drift
    of dropping from 8 to 4 weight bits under the same cache."""
    from ..utils.quantize import quantize_llama_params_int4

    g = _int4_group(hidden)

    def arms(params, mk, seed):
        q8 = _int8(params)
        q4 = params._replace(lm=quantize_llama_params_int4(params.lm, group_size=g))
        return {
            "fp": mk(params, seed),
            "int8": mk(q8, seed, int8_kv=True),
            "int4": mk(q4, seed, int8_kv=True),
            "fp_seed2": mk(params, seed + 7),
            "g_fp": mk(params, seed, ensemble=False),
            "g_int4": mk(q4, seed, ensemble=False, int8_kv=True),
        }

    pairs = [("fp_vs_int4", "fp", "int4"), ("int8_vs_int4", "int8", "int4"),
             ("fp_vs_fp_seed", "fp", "fp_seed2"), ("greedy_fp_vs_int4", "g_fp", "g_int4")]
    out = _arm_study(hidden, layers, vocab, n_prompts, n_seeds, T, model_seed, device, uniform,
                     arms, pairs)
    return {
        "config": {**_config(hidden, layers, vocab, n_prompts, n_seeds, T), "int4_group": g},
        "exact_fp_vs_int4": out["fp_vs_int4"],
        "exact_int8_vs_int4": out["int8_vs_int4"],
        "exact_fp_vs_fp_seed_noise_floor": out["fp_vs_fp_seed"],
        "greedy_fp_vs_int4": out["greedy_fp_vs_int4"],
    }


def _w8a8_arms(field):
    """The w8a8 studies' arms over identical int8 weights: ``field``
    (``w8a8_prefill`` or ``w8a8_decode``) off and on."""
    def arms(params, mk, seed):
        q = _int8(params)
        return {
            "a16": mk(q, seed),
            "a8": mk(q, seed, **{field: True}),
            "a16_seed2": mk(q, seed + 7),
            "g_a16": mk(q, seed, ensemble=False),
            "g_a8": mk(q, seed, ensemble=False, **{field: True}),
        }

    return arms


W8A8_PAIRS = [("a16_vs_a8", "a16", "a8"), ("a16_vs_a16_seed", "a16", "a16_seed2"),
              ("greedy_a16_vs_a8", "g_a16", "g_a8")]


def run_w8a8_study(hidden, layers, vocab, n_prompts, n_seeds, T, model_seed=0, device="cuda",
                   uniform=None):
    """w8a8 prefill (int8 activations, ``models/llama._mm_w8a8``) against
    the weight-only prefill over identical int8 weights, with the cross-seed
    noise floor.  Decode is the same in both arms (w8a8 is prefill-only
    here), so a disagreement enters through the prefill's logits, the
    uncertainty, the projection table or the first token."""
    out = _arm_study(hidden, layers, vocab, n_prompts, n_seeds, T, model_seed, device, uniform,
                     _w8a8_arms("w8a8_prefill"), W8A8_PAIRS)
    return {
        "config": _config(hidden, layers, vocab, n_prompts, n_seeds, T),
        "exact_a16_vs_a8": out["a16_vs_a8"],
        "exact_a16_vs_a16_seed_noise_floor": out["a16_vs_a16_seed"],
        "greedy_a16_vs_a8": out["greedy_a16_vs_a8"],
    }


def run_w8a8_decode_study(hidden, layers, vocab, n_prompts, n_seeds, T, model_seed=0,
                          device="cuda", uniform=None):
    """w8a8 decode projections (``decode_step(w8a8=True)``) against the
    weight-only feed over identical int8 weights.  Unlike the prefill study
    the activation error compounds across steps (each step's hidden state
    feeds the next through the cache and the token choice); the prefill is
    weight-only in both arms."""
    out = _arm_study(hidden, layers, vocab, n_prompts, n_seeds, T, model_seed, device, uniform,
                     _w8a8_arms("w8a8_decode"), W8A8_PAIRS)
    return {
        "config": _config(hidden, layers, vocab, n_prompts, n_seeds, T),
        "exact_a16_vs_a8decode": out["a16_vs_a8"],
        "exact_a16_vs_a16_seed_noise_floor": out["a16_vs_a16_seed"],
        "greedy_a16_vs_a8decode": out["greedy_a16_vs_a8"],
    }


def _production_engine(cfg, params, voting_probs, T, uniform, ensemble=True, **ens):
    """A production-study engine: int8 KV, 608 + T slots, seed 24."""
    from ..engine.generate import LlavaEngine
    from ..utils.config import EnsembleConfig, GenerationConfig

    return LlavaEngine(
        cfg=cfg,
        params=params,
        ens=EnsembleConfig(voting_probs=tuple(voting_probs), **ens),
        gen=GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0),
        max_len=608 + T,
        ensemble=ensemble,
        seed=24,
        int8_kv=True,
        uniform=None if uniform is None else uniform(24),
    )


def _production_prompt(r, cfg):
    """One 32-token prompt (the image token at 4) and its pixels."""
    hi_id = min(30000, cfg.text.vocab_size - 3)
    row = [1] + [int(x) for x in r.integers(4, hi_id, 30)] + [5]
    row[4] = cfg.image_token_index
    s = cfg.vision.image_size
    return np.asarray([row], np.int32), r.normal(size=(1, 3, s, s)).astype(np.float32)


def _reseeded(state, p: int):
    """The noise floor's state: the same prompt on an independent draw
    stream (``rng_id`` keys every draw)."""
    return state._replace(rng_id=state.rng_id + 104729 * (p + 1))


def run_production_study(n_prompts, T, voting_probs, model_seed=0, mask_policy="epis",
                         device="cuda", uniform=None, cfg=None):
    """Exact against fused at LLaVA-1.5-7B width and depth (32 layers,
    h4096, V 32064, ViT-L/336) with synthetic int8 weights and an int8 KV
    cache: the tier the fused mode's speed is claimed for.  One engine a
    mode; the noise floor reseeds through ``state.rng_id``.  ``cfg``
    narrows the model (``synthetic_llava_7b``)."""
    from ..utils.convert import synthetic_llava_7b

    cfg, params = synthetic_llava_7b(device, cfg, seed=model_seed)
    K = len(voting_probs)
    exact = _production_engine(cfg, params, voting_probs, T, uniform, mask_policy=mask_policy)
    fused = _production_engine(cfg, params, voting_probs, T, uniform, mask_policy=mask_policy,
                               fused_step=True)
    greedy = _production_engine(cfg, params, voting_probs, T, uniform, ensemble=False,
                                mask_policy=mask_policy)

    r = np.random.default_rng(model_seed)
    rows = []
    wc = {"exact": np.zeros(K), "fused": np.zeros(K)}
    for p in range(n_prompts):
        st = exact.prefill(*_production_prompt(r, cfg))
        tok_e, win_e = _run_with_winners(exact, st)
        tok_f, win_f = _run_with_winners(fused, st)
        tok_e2 = _decode(exact, _reseeded(st, p))
        tok_g = _decode(greedy, st)
        rows.append({
            "prompt": p,
            "exact_vs_fused": _agreement(tok_e, tok_f),
            "exact_vs_exact_seed": _agreement(tok_e, tok_e2),
            "exact_vs_greedy": _agreement(tok_e, tok_g),
        })
        np.add.at(wc["exact"], win_e, 1)
        np.add.at(wc["fused"], win_f, 1)

    return {
        "config": {
            "shape": "llava-1.5-7b (synthetic int8 weights, int8 KV)",
            "mask_policy": mask_policy,
            "hidden": cfg.text.hidden_size,
            "layers": cfg.text.num_hidden_layers,
            "vocab": cfg.text.vocab_size,
            "K": K,
            "voting_probs": list(voting_probs),
            "prompts": n_prompts,
            "tokens": T,
        },
        **_gap_report(rows, wc),
    }


def run_int4_production_study(n_prompts, T, voting_probs, model_seed=0, device="cuda",
                              uniform=None, cfg=None):
    """int8 against int4 drift at LLaVA-1.5-7B width and depth, both towers
    quantized from one synthetic bf16 base (``synthetic_llava_7b_dual``),
    int8 KV in both arms: the 8 -> 4 weight-bit drop at the scale
    ``--quantize int4`` deploys.  Random weights are the worst case for
    round-to-nearest; trained checkpoints quantize far better, so these are
    pessimistic bounds.  ``cfg`` as ``run_production_study``'s."""
    from ..utils.convert import synthetic_llava_7b_dual

    cfg, p8, p4 = synthetic_llava_7b_dual(device, cfg, seed=model_seed)
    K = len(voting_probs)
    e8 = _production_engine(cfg, p8, voting_probs, T, uniform)
    e4 = _production_engine(cfg, p4, voting_probs, T, uniform)
    g8 = _production_engine(cfg, p8, voting_probs, T, uniform, ensemble=False)
    g4 = _production_engine(cfg, p4, voting_probs, T, uniform, ensemble=False)

    r = np.random.default_rng(model_seed)
    rows = []
    wc = {"int8": np.zeros(K), "int4": np.zeros(K)}
    for p in range(n_prompts):
        ids, px = _production_prompt(r, cfg)
        st8, st4 = e8.prefill(ids, px), e4.prefill(ids, px)
        tok8, win8 = _run_with_winners(e8, st8)
        tok4, win4 = _run_with_winners(e4, st4)
        # noise floor: the int8 arm, the same prompt, an independent draw stream
        tok8b = _decode(e8, _reseeded(st8, p))
        tg8, tg4 = _decode(g8, st8), _decode(g4, st4)
        rows.append({
            "int8_vs_int4": _agreement(tok8, tok4),
            "int8_vs_int8_seed": _agreement(tok8, tok8b),
            "greedy_int8_vs_int4": _agreement(tg8, tg4),
        })
        np.add.at(wc["int8"], win8, 1)
        np.add.at(wc["int4"], win4, 1)

    return {
        "config": {
            "shape": "llava-1.5-7b (paired int8/int4 from one bf16 base, int8 KV)",
            "K": K,
            "voting_probs": list(voting_probs),
            "prompts": n_prompts,
            "tokens": T,
        },
        "exact_int8_vs_int4": _summarize(rows, "int8_vs_int4"),
        "int8_seed_noise_floor": _summarize(rows, "int8_vs_int8_seed"),
        "greedy_int8_vs_int4": _summarize(rows, "greedy_int8_vs_int4"),
        "winner_tv_distance": _tv(_dist(wc["int8"]), _dist(wc["int4"])),
    }


TINY_STUDIES = {
    "fused": run_study,
    # the lagged-logits fused variant of the KL keep-set policy
    "epis_kl": lambda *a, **kw: run_study(*a, mask_policy="epis_kl", **kw),
    "int8": run_int8_study,
    "int4": run_int4_study,
    "w8a8": run_w8a8_study,
    "w8a8decode": run_w8a8_decode_study,
}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument(
        "--study",
        default="fused",
        choices=[*TINY_STUDIES, "production", "int4prod"],
        help="fused: exact-vs-fused overlap-lag gap; epis_kl: the same under the "
        "lagged KL keep-set; int8: full-precision vs int8-weights+cache gap; int4: "
        "vs packed int4 weights; w8a8 / w8a8decode: weight-only vs int8-activation "
        "prefill / decode over identical int8 weights; production: exact-vs-fused at "
        "LLaVA-1.5-7B width and depth with synthetic int8 weights (--k selects the "
        "prob ladder); int4prod: int8-vs-int4 drift at that shape, both towers from "
        "one bf16 base",
    )
    ap.add_argument("--k", type=int, default=3, choices=[3, 8],
                    help="production studies only: 3 = the paper's K=3 ladder, "
                    "8 = the K=8 stretch ladder (0.1..0.8)")
    ap.add_argument("--policy", default="epis",
                    help="production study mask policy (epis | epis_kl: the "
                    "lagged-logits fused variant at 7B shape)")
    ap.add_argument("--json", action="store_true")
    return ap


def main(argv=None, device="cuda", cfg=None) -> dict:
    """Runs the study; returns the printed report.  ``cfg`` (a
    ``LlavaConfig``) narrows the production studies' model."""
    from ..utils.config import EnsembleConfig

    args = build_parser().parse_args(argv)
    probs = EnsembleConfig.voting_probs_for(3) if args.k == 3 else K8_PROBS
    if args.study == "int4prod":
        out = run_int4_production_study(args.prompts, args.tokens, probs, device=device, cfg=cfg)
    elif args.study == "production":
        out = run_production_study(args.prompts, args.tokens, probs, mask_policy=args.policy,
                                   device=device, cfg=cfg)
    else:
        out = TINY_STUDIES[args.study](
            args.hidden, args.layers, args.vocab, args.prompts, args.seeds, args.tokens,
            device=device,
        )
    print(json.dumps(out) if args.json else json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
