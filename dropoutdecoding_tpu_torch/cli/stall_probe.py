"""Serving stall probe: how long does an ACTIVE decode stream starve while
a long-prompt request prefills and joins?  Port of
``dropoutdecoding_tpu/cli/stall_probe.py``.

Runs the LLaVA-NeXT engine (a 5-tile anyres image: a ~2.9k-token merged
prompt; the Mistral-7B tower with synthetic int8 weights and an int8 KV
cache, full depth; fused K = 3) under a two-slot ``DecodeServer`` and
measures the longest interval in which an already decoding stream makes no
progress, for

  - a one-shot join (``submit``: the whole prefill queues ahead of every
    decode step; its LM prefill runs K5 in every layer);
  - chunked prefill (``engine.prefill_chunked`` with the server's pump:
    ``--pump-steps`` decode steps between two C-token pieces).

The host reads the server's step counter after every measured step and
pump, so each stamp marks the stream's real progress.  Every case serves
the same two requests.  The last line of stdout is one JSON object
(``metric``, ``one_shot``, ``chunked_best``, ``improvement``; the stalls
in ms).

The reference has no serving tier at all (SURVEY.md: one image decoded to
completion at a time, chair_test.py:274-346).

Usage (on the card):
    python -m dropoutdecoding_tpu_torch.cli.stall_probe [--layers 32]
        [--chunks 512 1024]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--pump-steps", type=int, default=4)
    ap.add_argument("--chunks", type=int, nargs="*", default=[512, 1024])
    return ap


def build_engine(cfg, T: int, device):
    """The probe's engine: int8 weights (``synthetic_int8_lm``) beside a
    bf16 vision tower, projector and newline, fused K = 3, an int8 cache."""
    from ..engine.llavanext_engine import LlavaNextEngine
    from ..models import llavanext as next_mod
    from ..models.llavanext import LlavaNextParams
    from ..utils.config import EnsembleConfig, GenerationConfig
    from ..utils.convert import synthetic_int8_lm, synthetic_llavanext_params

    lm = synthetic_int8_lm(cfg.text, device, seed=0)
    one = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=1))
    shell = synthetic_llavanext_params(one, device, torch.bfloat16, seed=6)
    params = LlavaNextParams(vision=shell.vision, projector=shell.projector,
                             image_newline=shell.image_newline, lm=lm)
    return LlavaNextEngine(
        cfg=cfg,
        params=params,
        ens=EnsembleConfig(fused_step=True),
        gen=GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0),
        max_len=next_mod.max_image_tokens(cfg) + 64,
        ensemble=True,
        seed=506,
        int8_kv=True,
    )


def main(argv=None, device="cuda", cfg=None) -> dict:
    """Runs the probe; returns the JSON line's object.  ``cfg`` (a
    ``LlavaNextConfig``) replaces LLaVA-v1.6-Mistral-7B at ``--layers`` (a
    narrow model for a rehearsal on the CPU)."""
    from ..engine.serving import DecodeServer
    from ..models import llavanext as next_mod
    from ..utils.config import LlavaNextConfig

    args = build_parser().parse_args(argv)
    if cfg is None:
        base = LlavaNextConfig()
        cfg = dataclasses.replace(
            base, text=dataclasses.replace(base.text, num_hidden_layers=args.layers))
    T = args.tokens
    eng = build_engine(cfg, T, device)

    rng = np.random.default_rng(0)
    size = (600, 800)
    n_tiles = next_mod.image_geometry(size, cfg)["n_tiles"]
    img, s = cfg.image_token_index, cfg.vision.image_size
    hi_id = min(1000, cfg.text.vocab_size)

    def make_req():
        row = [1] + [int(x) for x in rng.integers(4, hi_id, 26)] + [2]
        row = [3 if x == img else x for x in row]  # one image token,
        row[3] = img  # at 3
        tiles = rng.normal(size=(n_tiles, 3, s, s)).astype(np.float32)
        return np.asarray([row], np.int32), tiles, size

    def sync(srv):
        srv._carry["steps"].tolist()  # waits for every step queued so far

    a, b = make_req(), make_req()  # every case joins the same two requests

    def run_case(chunk):
        """chunk=None: a one-shot join."""
        srv = DecodeServer(engine=eng, n_slots=2)
        # warm every path this case runs
        srv.submit("w1", *a)
        if chunk:
            srv.submit_chunked("w2", *b, chunk=chunk, pump_steps=args.pump_steps)
        else:
            srv.submit("w2", *b)
        while srv.active():
            srv.step(4)
            srv.harvest()
        sync(srv)

        # measured run: stream A decodes, then B joins
        srv.submit("a", *a)
        srv.step(4)
        sync(srv)
        stamps = [time.perf_counter()]
        srv.step(4)
        sync(srv)
        stamps.append(time.perf_counter())
        if chunk:
            # submit_chunked's pump, instrumented: a read of the step counter
            # after every pump stamps stream A's real progress
            def pump():
                srv.step(args.pump_steps)
                sync(srv)
                stamps.append(time.perf_counter())

            ps = eng.prefill_chunked(*b, chunk=chunk, pump=pump)
            slot = srv.free_slots()[0]
            srv._place(ps._replace(uncertainty={}), slot, "b")
            srv._budgets[slot] = T
        else:
            srv.submit("b", *b)
        srv.step(4)
        sync(srv)
        stamps.append(time.perf_counter())
        while srv.active():
            srv.step(4)
            srv.harvest()
        sync(srv)
        gaps = np.diff(stamps)
        name = f"chunked(c={chunk},pump={args.pump_steps})" if chunk else "one-shot"
        print(f"{name}: max stream-A stall {gaps.max() * 1e3:.0f} ms "
              f"(gaps ms: {[int(g * 1e3) for g in gaps]})", file=sys.stderr, flush=True)
        return float(gaps.max())

    base = run_case(None)
    best = min(run_case(c) for c in args.chunks)
    out = {
        "metric": "serving_max_stall_ms",
        "one_shot": round(base * 1e3, 1),
        "chunked_best": round(best * 1e3, 1),
        "improvement": round(base / best, 2),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
