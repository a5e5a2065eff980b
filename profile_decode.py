#!/usr/bin/env python3
"""Where a prefill's and a decode step's device time goes, by kernel, on one
NVIDIA GPU.

    python3 profile_decode.py [--tree DIR] [tokens] [bf16] [int8] [int4] [next] [kernels] [k2k4]
                              [modes]
                              (default: the three LLaVA-1.5-7B tiers)

For each tier it builds the synthetic full-width model ``chip_smoke.py``
drives (same seeds, prompt and image; "next" is LLaVA-v1.6-Mistral-7B on
its 640 x 480 image), warms up, and runs ``torch.profiler`` over one
``prefill`` and over 8 decode steps of the engine's ``decode``, greedy,
exact K=3 and fused K=3.  It sums the device time of
every CUDA kernel by name into the groups of PERF.md section 5 and prints
one table per tier, then the heaviest kernel names.  The profiler slows the
host, so the span is not the unprofiled step time; the device sums are what
the kernels take.  ``kernels`` instead times every hand-written kernel
of the decode and prefill paths against its bound (``chip_smoke.time_ms``:
the median of 30 CUDA-graph replays, L2 flushed): K1 and K3 at the decode
shapes of both models, K6 at the decode forwards' rows with the stream-only
probes that tell its memory pattern from its decode work, then K5 and K6 at
the prefill shapes, tile by tile and beside the ``mma.sync`` kernels they
replaced there, then K2 at ``chip_smoke.K2_CASES`` with the top-k table
(in a tree whose K2 has no ``top_k``: K2 and ``exact_top_k_ids`` apart) and
K4 beside its launch floor.
``k2k4`` runs those last two alone.  ``modes`` profiles the bf16 decode
step in the other arms: exact and fused "epis_kl", exact sampling, the
exact "entropy" text mask.  ``tokens`` before the tiers prints each
tier's 32 greedy and exact K=3 tokens in place of a profile, so that two
trees can be held token for token.  ``--tree DIR`` takes the package from DIR (say, a parent
commit unpacked there by ``git archive``) and keeps this script's cases and
timer, so that two commits are read in one call, on one card.  Needs a GPU; prints the card's name and power limit.
"""
from __future__ import annotations

import collections
import gc
import sys

import numpy as np
import torch

import chip_smoke

STEPS = 8
GROUPS = (  # (label, substrings of the kernel names), first match wins
    ("K6, wgmma kernel (prefill)", ("int4_wgmma",)),
    ("K6, whole-tile kernel (decode)", ("int4_tile",)),
    ("K6, mma.sync tile / FMA kernel + combine", ("int4_fma", "int4_combine", "int4_mma")),
    ("K1 / K3", ("decode_mma_kernel", "decode_fma_kernel")),
    ("K4", ("append_kernel", "append_row128_kernel")),
    ("K5", ("flash_",)),
    ("K2", ("ab_resident_kernel", "cross_resident_kernel", "finish_kernel", "stats_kernel",
            "topk_stream_kernel", "cross_kernel", "pavg_")),
    ("cuBLAS / other matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas")),
    ("copies / dtype casts", ("copy", "Memcpy", "memcpy", "Memset", "memset")),
)


def device_times(fn) -> tuple[dict, float, int]:
    """(device ms by kernel name, span ms from first launch to last end,
    kernels) of one ``fn()`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(float)
    first, last, n = None, None, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        by_name[ev.name] += (end - start) / 1e3
        first = start if first is None else min(first, start)
        last = end if last is None else max(last, end)
        n += 1
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    return dict(by_name), (last - first) / 1e3, n


def grouped(by_name: dict) -> dict:
    out = collections.OrderedDict((label, 0.0) for label, _ in GROUPS)
    out["other elementwise / reductions"] = 0.0
    for name, ms in by_name.items():
        for label, keys in GROUPS:
            if any(k in name for k in keys):
                out[label] += ms
                break
        else:
            out["other elementwise / reductions"] += ms
    return out


def tier_engines(tier: str, gen):
    """(make, args, params): ``make(ensemble, **changes)`` builds the tier's
    engine at full width with ``chip_smoke.end_to_end``'s synthetic weights,
    prompt and image, its ``EnsembleConfig`` with ``changes`` (say
    ``fused_step=True``); ``args`` are its ``generate`` arguments."""
    import dataclasses

    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
    from dropoutdecoding_tpu_torch.models import llavanext
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils.config import (
        EnsembleConfig,
        LlavaConfig,
        LlavaNextConfig,
    )
    from dropoutdecoding_tpu_torch.utils.convert import (
        synthetic_int4_lm,
        synthetic_int8_lm,
        synthetic_llava_params,
        synthetic_llavanext_params,
    )

    rng = np.random.default_rng(11)  # chip_smoke.end_to_end's prompt and images
    cfg = LlavaNextConfig() if tier == "next" else LlavaConfig()
    ids = rng.integers(2, 32000, size=(1, 20))
    ids[0, 0], ids[0, 5] = 1, cfg.image_token_index
    pixels = rng.normal(size=(1, 3, 336, 336)).astype(np.float32)
    if tier == "next":
        size = (480, 640)
        n_tiles = llavanext.image_geometry(size, cfg)["n_tiles"]
        args = (ids, rng.normal(size=(n_tiles, 3, 336, 336)).astype(np.float32), size)
        params = synthetic_llavanext_params(cfg, "cuda", torch.bfloat16, seed=0)
        ens = EnsembleConfig(mask_accumulate=False, topk=10)  # the reference's NeXT settings

        def make(ensemble, **changes):
            return LlavaNextEngine(
                cfg=cfg, params=params, ens=dataclasses.replace(ens, **changes), gen=gen,
                seed=506, ensemble=ensemble, max_len=llavanext.max_image_tokens(cfg) + 64 + 512,
            )
    else:
        args = (ids, pixels)
        params = synthetic_llava_params(cfg, "cuda", torch.bfloat16, seed=0)
        if tier != "bf16":
            vision, projector = params.vision, params.projector
            del params
            gc.collect()
            torch.cuda.empty_cache()
            lm = synthetic_int8_lm if tier == "int8" else synthetic_int4_lm
            params = LlavaParams(vision, projector, lm(cfg.text, "cuda", seed=0))

        def make(ensemble, **changes):
            return LlavaEngine(
                cfg=cfg, params=params, max_len=1152, ensemble=ensemble, int8_kv=tier != "bf16",
                gen=gen, ens=EnsembleConfig(**changes),
            )
    return make, args, params


def print_tokens(tier: str) -> None:
    """The 32 tokens of the tier's greedy and exact K=3 ``generate``, as
    ``chip_smoke.py`` drives them: two trees must print the same lines."""
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig

    gen = GenerationConfig(max_new_tokens=32, eos_token_id=-1, pad_token_id=0)
    make, args, params = tier_engines(tier, gen)
    for label, ensemble in (("greedy", False), ("exact K=3", True)):
        print(f"tokens {tier} {label}: {make(ensemble).generate(*args).tokens[0].tolist()}")
    del params, make
    gc.collect()
    torch.cuda.empty_cache()


# the decode arms each tier profiles: (label, ensemble, EnsembleConfig
# changes, GenerationConfig changes, engine fields); "modes" is the bf16
# tier's other arms
ARMS = {
    "tier": (
        ("greedy", False, {}, {}, {}),
        ("exact", True, {}, {}, {}),
        ("fused", True, {"fused_step": True}, {}, {}),
    ),
    "modes": (
        ("exact epis_kl", True, {"mask_policy": "epis_kl"}, {}, {}),
        ("fused epis_kl", True, {"mask_policy": "epis_kl", "fused_step": True}, {}, {}),
        ("exact sampled", True, {}, {"do_sample": True, "temperature": 0.7, "top_p": 0.9}, {}),
        ("exact entropy", True, {}, {}, {"text_mask_policy": "entropy"}),
    ),
}


def profile_tier(tier: str) -> None:
    """One prefill (greedy's) and 8 decode steps of each of the tier's arms
    under the profiler; ``modes`` runs the bf16 model."""
    import dataclasses

    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig

    gen = GenerationConfig(max_new_tokens=STEPS + 1, eos_token_id=-1, pad_token_id=0)
    make, args, params = tier_engines("bf16" if tier == "modes" else tier, gen)
    columns = {}
    arms = ARMS["modes" if tier == "modes" else "tier"]
    for label, ensemble, changes, gen_changes, fields in arms:
        eng = dataclasses.replace(
            make(ensemble, **changes), gen=dataclasses.replace(gen, **gen_changes), **fields
        )
        eng.generate(*args)  # warm-up
        if label == "greedy":
            columns["prefill"] = device_times(lambda: eng.prefill(*args))
        state = eng.prefill(*args)
        columns[f"{label} step"] = device_times(lambda: eng.decode(state))
    print_columns("bf16 modes" if tier == "modes" else tier, columns)
    del params, state, eng, make
    gc.collect()
    torch.cuda.empty_cache()


def print_columns(tier: str, columns: dict) -> None:
    """PERF.md section 5's table of ``columns`` (label -> ``device_times``),
    and the heaviest kernels of each."""
    print(f"\n{tier}: ms (prefill: one call; steps: per step, over {STEPS} steps)")
    names = list(columns)
    print("| " + " | ".join(["", *names]) + " |")
    per = {n: 1 if n == "prefill" else STEPS for n in names}
    rows = collections.OrderedDict()
    for n in names:
        by_name, span, count = columns[n]
        busy = sum(by_name.values())
        rows.setdefault("span (under the profiler)", []).append(f"{span / per[n]:.2f}")
        rows.setdefault("device busy", []).append(
            f"{busy / per[n]:.2f} ({100 * busy / span:.0f}%)")
        rows.setdefault("kernels", []).append(f"{count // per[n]}")
        for label, ms in grouped(by_name).items():
            rows.setdefault(label, []).append(f"{ms / per[n]:.3f}")
    for label, cells in rows.items():
        print("| " + " | ".join([label, *cells]) + " |")
    for n in names:  # a decode call of K1, K3 or K6 is one launch: no kernel adds partial sums
        second = [name for name in columns[n][0] if "combine" in name]
        if n != "prefill" and second:
            raise AssertionError(f"{tier} {n}: a second launch on a decode route: {second}")
    for n in names:
        top = sorted(columns[n][0].items(), key=lambda kv: -kv[1])[:6]
        print(f"{tier} {n}, heaviest: " + "; ".join(
            f"{name[:60]} {ms / per[n]:.3f}" for name, ms in top))


def int4_rows() -> None:
    """K6's wgmma kernel at the four fused projections of a 7B layer for 595
    rows with each row tile it is built for (the wrapper picks one by
    ``wgmma_row_tile``; here both run), beside the ``mma.sync`` tile, each
    held against the plain twin first."""
    from dropoutdecoding_tpu_torch.ops import cuda_int4_matmul as k6

    g = torch.Generator(device="cuda").manual_seed(600)
    plan, route = k6.wgmma_row_tile, k6.prefill_route
    R = 595
    for name, D, E in (("qkv", 4096, 12288), ("o", 4096, 4096), ("gate_up", 4096, 22016),
                       ("down", 11008, 4096)):
        q4 = torch.randint(-128, 128, (D // 2, E), dtype=torch.int8, device="cuda", generator=g)
        s4 = torch.empty(D // 128, E, device="cuda").uniform_(0.002, 0.006, generator=g)
        x = torch.randn(R, D, generator=g, device="cuda").to(torch.bfloat16)
        ref = k6.int4_matmul_twin(x, q4, s4).float()
        picked = plan(R, E)
        variants = [(f"wgmma, {rows}-row tile", "wgmma", rows) for rows in k6.WGMMA_ROW_TILES]
        variants.append(("mma.sync, 64-row tile", "mma", None))
        try:
            for label, kernel, rows in variants:
                k6.prefill_route = lambda *a, kernel=kernel, **kw: kernel
                k6.wgmma_row_tile = lambda *a, rows=rows: rows
                err = (k6.int4_matmul(x, q4, s4).float() - ref).abs().max().item()
                ms = chip_smoke.time_ms(lambda: k6.int4_matmul(x, q4, s4))
                print(f"K6 {name} [{R}, {D}] x [{D}, {E}], {label}"
                      f"{' (the plan picks it)' if rows == picked else ''}: {ms * 1e3:.1f} us, "
                      f"{2 * R * D * E / ms / 1e9:.1f} TFLOP/s, max_abs_err {err:.3e}")
        finally:
            k6.wgmma_row_tile, k6.prefill_route = plan, route


def flash_cases() -> None:
    """K5's wgmma and ``mma.sync`` kernels at the LLaVA-NeXT prefill shape,
    with and without the padded key tail and at G = 1."""
    from dropoutdecoding_tpu_torch.ops import cuda_flash_prefill as k5
    from dropoutdecoding_tpu_torch.ops.attention import chunked_prefill_attention

    route = k5.prefill_route
    for label, KH, real in (("G=4, 2362 real keys", 8, 2362), ("G=4, every key real", 8, 2950),
                            ("G=1, 2362 real keys", 32, 2362)):
        B, S, H, D = 1, 2950, 32, 128
        g = torch.Generator(device="cuda").manual_seed(400)
        q, k, v = (torch.randn(B, S, h, D, generator=g, device="cuda").to(torch.bfloat16)
                   for h in (H, KH, KH))
        mask = (torch.arange(S, device="cuda") < real).expand(B, S).clone()
        ref = chunked_prefill_attention(q, k, v, mask).float()
        flops = 4 * H * D * mask.cumsum(1).sum().item()  # the pairs the mask leaves
        try:
            for kernel in ("wgmma", "mma"):
                k5.prefill_route = lambda *a, kernel=kernel: kernel
                err = (k5.flash_prefill_attention(q, k, v, mask).float() - ref).abs().max().item()
                ms = chip_smoke.time_ms(lambda: k5.flash_prefill_attention(q, k, v, mask))
                print(f"K5 S={S} {label}, {kernel}: {ms * 1e3:.1f} us, "
                      f"{flops / ms / 1e9:.1f} TFLOP/s, "
                      f"max_abs_err {err:.3e}")
        finally:
            k5.prefill_route = route


def decode_attention_cases() -> None:
    """K1 and K3 at the decode shapes of the full-width paths (LLaVA-1.5: G =
    1, greedy M = 1 and exact M = 3, 620 of 1152 slots filled; LLaVA-NeXT: G =
    4, 2947 of 3504), each held against the plain twin first, beside its
    bound."""
    from dropoutdecoding_tpu_torch.ops import attention as plain
    from dropoutdecoding_tpu_torch.ops import cuda_decode_attention as k1

    kernels = (
        ("K1", k1.ensemble_decode_attention_fused, plain.ensemble_decode_attention, False),
        ("K3", k1.ensemble_decode_attention_int8kv_fused, plain.ensemble_decode_attention_int8kv,
         True),
    )
    for label, M, KH, S, cur in (("M=1 G=1", 1, 32, 1152, 620), ("M=3 G=1", 3, 32, 1152, 620),
                                 ("M=3 G=4", 3, 8, 1152, 620), ("M=4 G=4", 4, 8, 1152, 620),
                                 ("M=3 G=4, NeXT", 3, 8, 3504, 2947)):
        for name, kernel, twin, int8 in kernels:
            args = chip_smoke._decode_inputs(1, M, 32, KH, 128, S, cur, torch.bfloat16, seed=100,
                                             int8=int8)
            got = kernel(*args)
            err = (got.float() - twin(*args).float()).abs().max().item()
            ms = chip_smoke.time_ms(lambda: kernel(*args))
            nbytes, bound = chip_smoke.decode_least_time(args, got, cur)
            print(f"{name} {label}, {cur} of {S} slots: {ms * 1e3:.1f} us, bound "
                  f"{bound['bound_ms'] * 1e3:.2f} us by {bound['bound_by']}, "
                  f"{nbytes / ms / 1e6:.0f} GB/s, max_abs_err {err:.3e}")


def int4_decode_rows() -> None:
    """K6's whole-tile kernel at the four fused projections of a 7B layer for
    the decode forwards' 1 and 3 rows (and 16, the kernel's last), beside
    the bound, and the stream alone through a TMA ring: the kernel's own
    pattern with the decode and the mmas off; whole tiles of 64 and of 128
    channels (64 and 128 contiguous bytes a row); and equal spans of the
    list of (256-channel tile, 128-row chunk) pairs, 256 contiguous bytes a
    row."""
    from dropoutdecoding_tpu_torch.ops import cuda_int4_matmul as k6

    g = torch.Generator(device="cuda").manual_seed(600)
    probes = [("kernel", {}), ("tiles", dict(width=64)), ("tiles", dict(width=128)),
              ("spans", {})]
    for name, D, E in (("qkv", 4096, 12288), ("o", 4096, 4096), ("gate_up", 4096, 22016),
                       ("down", 11008, 4096)):
        q4 = torch.randint(-128, 128, (D // 2, E), dtype=torch.int8, device="cuda", generator=g)
        s4 = torch.empty(D // 128, E, device="cuda").uniform_(0.002, 0.006, generator=g)
        for R in (1, 3, 16):
            x = torch.randn(R, D, generator=g, device="cuda").to(torch.bfloat16)
            got = k6.int4_matmul(x, q4, s4)
            err = (got.float() - k6.int4_matmul_twin(x, q4, s4).float()).abs().max().item()
            ms = chip_smoke.time_ms(lambda: k6.int4_matmul(x, q4, s4))
            nbytes = chip_smoke._nbytes(x, q4, s4, got)
            bound = chip_smoke.least_time(nbytes, 2 * R * D * E, "bf16")
            print(f"K6 {name} [{R}, {D}] x [{D}, {E}]: {ms * 1e3:.1f} us, bound "
                  f"{bound['bound_ms'] * 1e3:.1f} us by {bound['bound_by']}, "
                  f"{nbytes / ms / 1e6:.0f} GB/s, max_abs_err {err:.3e}")
        x = torch.randn(3, D, generator=g, device="cuda").to(torch.bfloat16)  # the exact step's rows
        for mode, kw in probes if hasattr(k6, "stream_probe") else ():  # not in an older tree
            ms = chip_smoke.time_ms(lambda: k6.stream_probe(x, q4, mode, **kw))
            print(f"   stream only, {mode} {kw}: {ms * 1e3:.1f} us, "
                  f"{q4.numel() / ms / 1e6:.0f} GB/s")


def uncertainty_cases() -> None:
    """K2 with the top-k table at every case of ``chip_smoke.K2_CASES``, held
    against the twin's ids first.  In a tree whose K2 takes no ``top_k`` the
    two calls the main path made then are timed apart and summed."""
    import inspect

    from dropoutdecoding_tpu_torch.ops import cuda_uncertainty as k2
    from dropoutdecoding_tpu_torch.ops import uncertainty as uq

    folded = "top_k" in inspect.signature(k2.vision_uncertainty_fused).parameters
    for i, (label, B, L, V, k, valid, _) in enumerate(chip_smoke.K2_CASES):
        logits, v = chip_smoke.uncertainty_inputs(B, L, V, valid, seed=7 + i)
        two_reads = 2 * chip_smoke._nbytes(logits) / chip_smoke.HBM_BYTES_PER_S * 1e6
        table = chip_smoke.time_ms(lambda: uq.exact_top_k_ids(logits, k)) * 1e3
        if folded:
            got = k2.vision_uncertainty_fused(logits, v, top_k=k)["topk_ids"]
            equal = torch.equal(got, uq.exact_top_k_ids(logits, k))
            both = chip_smoke.time_ms(lambda: k2.vision_uncertainty_fused(logits, v, top_k=k)) * 1e3
            alone = chip_smoke.time_ms(lambda: k2.vision_uncertainty_fused(logits, v)) * 1e3
            print(f"K2 {label}: with the table {both:.1f} us (ids equal {equal}), without "
                  f"{alone:.1f} us, exact_top_k_ids alone {table:.1f} us, two reads "
                  f"{two_reads:.1f} us")
        else:
            alone = chip_smoke.time_ms(lambda: k2.vision_uncertainty_fused(logits, v)) * 1e3
            print(f"K2 {label}: {alone:.1f} us + exact_top_k_ids {table:.1f} us = "
                  f"{alone + table:.1f} us, two reads {two_reads:.1f} us")
        del logits


def cache_append_cases() -> None:
    """K4 at the 7B decode step's shape, three readings each: the kernel and
    the launch floor (where the tree has the probe)."""
    from dropoutdecoding_tpu_torch.ops import cuda_cache_append as k4

    L, B, S, KH, D = 32, 1, 1152, 32, 128
    g = torch.Generator(device="cuda").manual_seed(300)
    kq, vq = (torch.randint(-127, 128, (L, B, S, KH * D), dtype=torch.int8, device="cuda",
                            generator=g) for _ in range(2))
    ks, vs = (torch.rand(L, B, KH, S, device="cuda", generator=g) for _ in range(2))
    k_new, v_new = ((3 * torch.randn(L, B, KH, D, device="cuda", generator=g)).bfloat16()
                    for _ in range(2))
    cur_len = torch.tensor([620], dtype=torch.long, device="cuda")

    def append():
        k4.cache_append_int8(kq, ks, vq, vs, cur_len, k_new, v_new)

    def us(fn):  # 300 replays: these times are near the timer's own spread
        return chip_smoke.time_ms(fn, reps=300) * 1e3

    for reading in range(3):
        line = f"K4 [32, 1, 1152, 4096] bf16, reading {reading}: {us(append):.2f} us"
        if hasattr(k4, "cache_append_floor"):
            line += f", launch floor {us(lambda: k4.cache_append_floor(cur_len, L, KH)):.2f} us"
        print(line)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--tree"] and len(args) > 1:
        sys.path.insert(0, args[1])  # the package is imported inside the functions
        print(f"package from {args[1]}")
        args = args[2:]
    tokens = args[:1] == ["tokens"]
    tiers = args[1:] if tokens else args
    tiers = tiers or ["bf16", "int8", "int4"]
    if any(t not in ("bf16", "int8", "int4", "next", "kernels", "k2k4", "modes") for t in tiers):
        print(__doc__, file=sys.stderr)
        return 2
    print(f"card: {chip_smoke._card_line()}")
    chip_smoke.build()
    for tier in tiers:
        if tier == "kernels":
            decode_attention_cases()
            int4_decode_rows()
            int4_rows()
            flash_cases()
            uncertainty_cases()
            cache_append_cases()
        elif tier == "k2k4":  # the last two of ``kernels`` alone
            uncertainty_cases()
            cache_append_cases()
        elif tokens and tier != "modes":
            print_tokens(tier)
        else:
            profile_tier(tier)
    return 0


if __name__ == "__main__":
    sys.exit(main())
