#!/usr/bin/env python3
"""Where a prefill's and a decode step's device time goes, by kernel, on one
NVIDIA GPU.

    python3 profile_decode.py [bf16] [int8] [int4] [next] [kernels]
                              (default: the three LLaVA-1.5-7B tiers)

For each tier it builds the synthetic full-width model ``chip_smoke.py``
drives (same seeds, prompt and image; "next" is LLaVA-v1.6-Mistral-7B on
its 640 x 480 image), warms up, and runs ``torch.profiler`` over one
``prefill`` and over 8 decode steps of the engine's ``decode``, greedy and
exact K=3.  It sums the device time of
every CUDA kernel by name into the groups of PERF.md section 5 and prints
one table per tier, then the heaviest kernel names.  The profiler slows the
host, so the span is not the unprofiled step time; the device sums are what
the kernels take.  ``kernels`` instead times K5 and K6 at the prefill
shapes, tile by tile and beside the ``mma.sync`` kernels they replaced
there (``chip_smoke.time_ms``: the median of 30 CUDA-graph replays, L2
flushed).  Needs a GPU; prints the card's name and power limit.
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
    ("K6, mma.sync / FMA kernels + combine", ("int4_fma", "int4_combine", "int4_mma")),
    ("K1 / K3 (partial + combine)", ("partial_kernel", "combine_kernel")),
    ("K4", ("append_kernel",)),
    ("K5", ("flash_",)),
    ("K2", ("stats_kernel", "cross_kernel", "pavg_")),
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


def profile_tier(tier: str) -> None:
    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
    from dropoutdecoding_tpu_torch.models import llavanext
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils.config import (
        EnsembleConfig,
        GenerationConfig,
        LlavaConfig,
        LlavaNextConfig,
    )
    from dropoutdecoding_tpu_torch.utils.convert import (
        synthetic_int4_lm,
        synthetic_int8_lm,
        synthetic_llava_params,
        synthetic_llavanext_params,
    )

    gen = GenerationConfig(max_new_tokens=STEPS + 1, eos_token_id=-1, pad_token_id=0)
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

        def make(ensemble):
            return LlavaNextEngine(
                cfg=cfg, params=params, ens=ens, gen=gen, seed=506, ensemble=ensemble,
                max_len=llavanext.max_image_tokens(cfg) + 64 + 512,
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

        def make(ensemble):
            return LlavaEngine(
                cfg=cfg, params=params, max_len=1152, ensemble=ensemble, int8_kv=tier != "bf16",
                gen=gen,
            )
    columns = {}
    for label, ensemble in (("greedy", False), ("exact", True)):
        eng = make(ensemble)
        eng.generate(*args)  # warm-up
        if not ensemble:
            columns["prefill"] = device_times(lambda: eng.prefill(*args))
        state = eng.prefill(*args)
        columns[f"{label} step"] = device_times(lambda: eng.decode(state))
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
    for n in names:
        top = sorted(columns[n][0].items(), key=lambda kv: -kv[1])[:6]
        print(f"{tier} {n}, heaviest: " + "; ".join(
            f"{name[:60]} {ms / per[n]:.3f}" for name, ms in top))
    del params, state, eng
    gc.collect()
    torch.cuda.empty_cache()


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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    tiers = sys.argv[1:] or ["bf16", "int8", "int4"]
    if any(t not in ("bf16", "int8", "int4", "next", "kernels") for t in tiers):
        print(__doc__, file=sys.stderr)
        return 2
    print(f"card: {chip_smoke._card_line()}")
    chip_smoke.build()
    for tier in tiers:
        if tier == "kernels":
            int4_rows()
            flash_cases()
        else:
            profile_tier(tier)
    return 0


if __name__ == "__main__":
    sys.exit(main())
