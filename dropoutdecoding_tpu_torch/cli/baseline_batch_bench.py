"""Measure the batched baseline paths (``--vcd`` / ``--num-beams`` with
``--batch-size``) against one caption at a time at LLaVA-1.5-7B width on
the card; port of ``dropoutdecoding_tpu/cli/baseline_batch_bench.py``.

The reference runs both baselines strictly one caption at a time
(chair_test.py:274 loop; vcd_sample.py is a B=1 monkey-patch); this tool
records what the batched decode loops buy.  Synthetic int8 weights and
synthetic post-prefill states (``_build_state``: the shapes and dtypes of a
595-token prompt's prefill, made on the device) isolate the decode loops:
VCD's one forward over 2B rows a step and beam search's over B x nb rows
(K1 at M = 1 both).  The serial run decodes row 0 of the batched states
alone.  The last line of stdout is one JSON object; the exit code is 1
when a batched path loses to serial.

Usage (on the card):
    python -m dropoutdecoding_tpu_torch.cli.baseline_batch_bench \
        [--layers 32] [--batch 4] [--tokens 32] [--beam-batch 2]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

PROMPT_LEN = 576 + 32  # the visual span + the text: the cache fill after a prefill


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--batch", type=int, default=4, help="VCD batch size")
    p.add_argument("--beam-batch", type=int, default=2)
    p.add_argument("--tokens", type=int, default=32)
    p.add_argument("--num-beams", type=int, default=3)
    return p


def _build_state(engine, B: int, seed: int, prompt_len: int = PROMPT_LEN):
    """A synthetic post-prefill ``PrefillState`` of B rows for ``engine``
    (dense cache in its dtype, every slot drawn normal(0, 1); the first
    ``prompt_len`` are the filled ones), made on its device from a seeded
    ``torch.Generator``."""
    from ..engine.generate import PrefillState
    from ..models.llama import KVCache

    cfg, dev = engine.cfg, engine.device
    N, V = engine.n_visual, cfg.text.vocab_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.text.num_hidden_layers, B, engine.max_len, cfg.text.num_key_value_heads,
             cfg.text.head_dim)

    def normal(*size, dtype=torch.float32):
        return torch.randn(size, generator=gen, device=dev).to(dtype)

    def uniform(*size):
        return torch.rand(size, generator=gen, device=dev).clamp_min(1e-12)

    return PrefillState(
        cache=KVCache(normal(*shape, dtype=engine.dtype), normal(*shape, dtype=engine.dtype)),
        cur_len=torch.full((B,), prompt_len, dtype=torch.long, device=dev),
        last_logits=normal(B, V),
        first_token=torch.full((B,), 7, dtype=torch.long, device=dev),
        epis=-(uniform(B, N).log() + uniform(B, N).log()),  # gamma(2, 1): two exponentials
        topk_ids=torch.randint(0, V, (B, N, 5), generator=gen, device=dev, dtype=torch.int32),
        image_logits=torch.zeros((B, N, 1), device=dev),  # the stub of every policy but epis_kl
        image_pos=torch.full((B,), 5, dtype=torch.long, device=dev),
        visual_mask=torch.ones((B, N), dtype=torch.bool, device=dev),
        probe_ids=torch.full((B, 8), -1, dtype=torch.int32, device=dev),
        rng_id=torch.arange(B),
        uncertainty={},
    )


def _row(state, b: int):
    """Row ``b`` of a state as a B = 1 state (copies)."""
    from ..models import llama as llama_mod

    def one(t):
        return t[b:b + 1].clone() if isinstance(t, torch.Tensor) else t

    fields = {name: one(getattr(state, name)) for name in state._fields
              if name not in ("cache", "uncertainty")}
    cache = llama_mod.cache_map(state.cache, lambda t, axis: t[:, b:b + 1].clone())
    return state._replace(cache=cache, **fields)


def main(argv=None, device="cuda", cfg=None) -> dict:
    """Runs the bench; returns {"vcd": ..., "beam": ...}.  ``cfg`` (a
    ``LlavaConfig``) replaces LLaVA-1.5-7B at ``--layers`` (a narrow model
    for a rehearsal on the CPU)."""
    import dataclasses

    from ..engine.baselines import beam_generate, vcd_generate
    from ..engine.generate import LlavaEngine
    from ..utils.config import EnsembleConfig, GenerationConfig, LlavaConfig
    from ..utils.convert import synthetic_llava_7b

    args = build_parser().parse_args(argv)
    if cfg is None:
        base = LlavaConfig()
        cfg = dataclasses.replace(
            base, text=dataclasses.replace(base.text, num_hidden_layers=args.layers))
    cfg, params = synthetic_llava_7b(device, cfg, seed=0)
    T = args.tokens

    def mk(use_cd):
        return LlavaEngine(
            cfg=cfg, params=params, ens=EnsembleConfig(),
            gen=GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0,
                                 use_cd=use_cd),
            max_len=PROMPT_LEN + T, ensemble=False,
        )

    def timed(fn, warm=1, reps=2):
        for _ in range(warm):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()  # returns host tokens: the device is done
        return (time.perf_counter() - t0) / reps

    results = {}

    # ---- VCD: the clean and the noised states ----
    B = args.batch
    evcd = mk(True)
    st_b = (_build_state(evcd, B, 2), _build_state(evcd, B, 3))
    st_1 = tuple(_row(s, 0) for s in st_b)
    t_b = timed(lambda: vcd_generate(evcd, states=st_b, seed=7))
    t_1 = timed(lambda: vcd_generate(evcd, states=st_1, seed=7))
    agg_b, agg_1 = B * T / t_b, T / t_1
    results["vcd"] = dict(batch=B, batched_tok_s=round(agg_b, 1), serial_tok_s=round(agg_1, 1),
                          speedup=round(agg_b / agg_1, 2))
    print(f"VCD decode: batch{B} {agg_b:.1f} tok/s aggregate vs serial "
          f"{agg_1:.1f} tok/s ({agg_b / agg_1:.2f}x)", flush=True)
    del evcd, st_b, st_1

    # ---- beam search ----
    Bb = args.beam_batch
    ebeam = mk(False)
    sb = _build_state(ebeam, Bb, 4)
    s1 = _row(sb, 0)
    t_b = timed(lambda: beam_generate(ebeam, state=sb, num_beams=args.num_beams))
    t_1 = timed(lambda: beam_generate(ebeam, state=s1, num_beams=args.num_beams))
    agg_b, agg_1 = Bb * T / t_b, T / t_1
    results["beam"] = dict(batch=Bb, num_beams=args.num_beams, batched_tok_s=round(agg_b, 1),
                           serial_tok_s=round(agg_1, 1), speedup=round(agg_b / agg_1, 2))
    print(f"beam-{args.num_beams} decode: batch{Bb} {agg_b:.1f} tok/s aggregate vs serial "
          f"{agg_1:.1f} tok/s ({agg_b / agg_1:.2f}x)", flush=True)
    print(json.dumps({"layers": cfg.text.num_hidden_layers, "tokens": T, **results}), flush=True)
    return results


if __name__ == "__main__":
    # batched paths must not lose to serial
    res = main()
    sys.exit(0 if all(v["speedup"] >= 1.0 for v in res.values()) else 1)
