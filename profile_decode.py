#!/usr/bin/env python3
"""Where a LLaVA-1.5-7B step's device time goes, by kernel, on one NVIDIA GPU.

    python3 profile_decode.py [bf16] [int8] [int4]      (default: all three)

For each tier it builds the synthetic full-width model ``chip_smoke.py``
drives (same seeds, prompt and image), warms up, and runs ``torch.profiler``
over one ``LlavaEngine.prefill`` and over 8 decode steps of
``LlavaEngine.decode``, greedy and exact K=3.  It sums the device time of
every CUDA kernel by name into the groups of PERF.md section 5 and prints
one table per tier, then the heaviest kernel names.  The profiler slows the
host, so the span is not the unprofiled step time; the device sums are what
the kernels take.  Needs a GPU; prints the card's name and power limit.
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
    ("K6 int4 matmul (fma + combine / mma)", ("int4_fma", "int4_combine", "int4_mma")),
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
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig, LlavaConfig
    from dropoutdecoding_tpu_torch.utils.convert import (
        synthetic_int4_lm,
        synthetic_int8_lm,
        synthetic_llava_params,
    )

    cfg = LlavaConfig()
    rng = np.random.default_rng(11)  # chip_smoke.end_to_end's prompt and image
    ids = rng.integers(2, 32000, size=(1, 20))
    ids[0, 0], ids[0, 5] = 1, cfg.image_token_index
    pixels = rng.normal(size=(1, 3, 336, 336)).astype(np.float32)
    params = synthetic_llava_params(cfg, "cuda", torch.bfloat16, seed=0)
    if tier != "bf16":
        vision, projector = params.vision, params.projector
        del params
        gc.collect()
        torch.cuda.empty_cache()
        make = synthetic_int8_lm if tier == "int8" else synthetic_int4_lm
        params = LlavaParams(vision, projector, make(cfg.text, "cuda", seed=0))
    columns = {}
    for label, ensemble in (("greedy", False), ("exact", True)):
        eng = LlavaEngine(
            cfg=cfg, params=params, max_len=1152, ensemble=ensemble, int8_kv=tier != "bf16",
            gen=GenerationConfig(max_new_tokens=STEPS + 1, eos_token_id=-1, pad_token_id=0),
        )
        eng.generate(ids, pixels)  # warm-up
        if not ensemble:
            columns["prefill"] = device_times(lambda: eng.prefill(ids, pixels))
        state = eng.prefill(ids, pixels)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    tiers = sys.argv[1:] or ["bf16", "int8", "int4"]
    if any(t not in ("bf16", "int8", "int4") for t in tiers):
        print(__doc__, file=sys.stderr)
        return 2
    print(f"card: {chip_smoke._card_line()}")
    chip_smoke.build()
    for tier in tiers:
        profile_tier(tier)
    return 0


if __name__ == "__main__":
    sys.exit(main())
