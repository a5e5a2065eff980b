#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of Dropout Decoding once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Card identity: ``nvidia-smi`` name and power limit, torch, CUDA and nvcc
   versions.
2. Build: compiles ``dropoutdecoding_tpu_torch/csrc/*.cu`` for sm_90a, one
   nvcc per source, all at once (or reuses the build in
   ``dropoutdecoding_tpu_torch/_build/``).
3. Kernel vs plain twin at the slice shapes: K1 (ensemble decode attention,
   M in {1, 3}, H = 32, D = 128, S = 1152 with 620 slots filled, bf16, with
   mask holes that differ by member, at G = 1 and G = 4; the LLaVA-NeXT
   cache, 2947 of 3504 slots; 16 and 24 query rows a kv group; B = 2 with
   a fill a row; a member that attends only its own token; fp32; the FMA
   kernel at D = 64; every case one launch, and twice for equal bits), K3
   (the same over an int8 cache with scales in [0.01, 0.03]), K4 (the int8
   cache append at
   [32, 1, 1152, 4096], a B = 2 case and the scalar route at D = 64,
   bit-equal, beside its launch floor), K2 (visual-token uncertainty with the
   top-k table at ``K2_CASES``: LLaVA-1.5's [1, 576, 32064] with and without
   ``valid``, LLaVA-NeXT's 2928 rows, B = 2 with an empty image, rows off
   the 16-byte grid and the streaming route; ids equal to the twin's with
   planted ties, two calls with equal bits) and K5
   (flash prefill at B=1, S=2950, H=32, KH=8, D=128, bf16, with a padded
   key-mask tail, on the wgmma kernel; G=1, S = 1024 and 1025, B = 2 with
   two mask tails, rows with no attendable key at D = 128, 64 and 16, fp32,
   and inputs on which one key tile skipped, stale or wrongly attended
   moves the output by many times the bound: a peaked softmax, and v
   stepped by key tile)
   and K6 (the packed-int4 matmul at the four 7B projection shapes for R =
   1, 3, 16 and 595 rows in bf16, every call twice for equal bits, the
   decode's on the whole-tile kernel, the prefill's on the wgmma kernel,
   also at R = 17, 64, 128, 600, batched and on a layer's view; fp32 input and output, a ragged shape with g = 32, and K6', one
   layer of a stacked weight read in place).  Times are the median
   of 30 CUDA-graph replays, L2 flushed before each.  Beside each kernel
   stand its bound (the larger of its bytes over the card's memory rate and
   its operations over the card's peak rate) and, for K5 and K6, the time
   of the one PyTorch call that computes the same function; the port calls
   neither.
4. Small-model reference: a narrow LLaVA in fp32 through
   ``LlavaEngine.generate`` on the card (kernels) and on the CPU (plain
   twins), with the same injected mask draws, with dense weights and a
   dense cache, then int8 fused weights and ``int8_kv=True``, then packed
   int4 fused weights (K6) and ``int8_kv=True``; then a narrow LLaVA-NeXT in
   fp32 whose merged prompt (1320 tokens) runs K5: tokens must be equal.
5. End to end, greedy then exact K=3, 32 new tokens each, with every
   kernel's launch count checked, and that the prefill's K5 and K6 launches
   took the wgmma kernels: ``LlavaEngine.generate`` at full
   LLaVA-1.5-7B width and depth, first with synthetic bf16 weights and a
   bf16 cache (K1, K2), then synthetic int8 fused weights and an int8 cache
   (K2, K3, K4), on both a batch of two requests too, whose rows stop at
   different steps; then synthetic packed int4 fused weights, an int8 head and
   an int8 cache (K2, K3, K4 and K6 in every projection of every forward);
   then ``LlavaNextEngine.generate`` at full
   LLaVA-v1.6-Mistral-7B width and depth with synthetic bf16 weights and
   one 640 x 480 image (5 tiles, 2340 of 2928 visual slots real), whose
   2947-token prefill runs K5 in every layer (K1 at G=4, K2 with ``valid``).
6. The CHAIR CLI (``chair_cli``): LLaVA-1.5-7B at full width and depth,
   synthetic bf16 weights written as an HF checkpoint (published
   config.json, three .safetensors shards and their index), loaded by the
   CLI's ``build_engine`` with its load time, host peak RSS and device
   peak, leaves checked bit-equal; two images captioned through the CLI
   with the default Dropout Decoding arm and ``--original``, each caption
   equal to ``generate`` called directly, K1 and K2 launches counted.

Prints the kernels' JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when no
GPU is present or the port is missing.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# K1 and K3 (atol, rtol).  bf16: both products run on the tensor cores with the
# probabilities rounded to bf16, where the twin rounds the normalised ones, and
# both round the output, so an output may land on the neighbouring bf16 value
# (2^-8 of itself, under rtol); what the rounded probabilities leave besides
# grows with the row's values, so atol is a share of the row's max|ref| over the
# head dim (at most K1_ATOL_CAP), as for K5: a decode row averages hundreds of
# values and its outputs lie near 0.1, where a constant of 2e-2 hid a skipped
# tile.  fp32: atol absolute, summation order only.
K1_TOL = {torch.bfloat16: (6e-3, 1e-2), torch.float32: (1e-5, 0.0)}
K1_ATOL_CAP = 2e-2
# K2: every field within K2_RTOL of the field's scale.  epis = -alea - C is the
# difference of two fp32 sums over V near log V = 10.4, so where rows are alike
# and epis small (under 0.1) kernel and twin also differ by the rounding of
# those sums: its bound has a floor of K2_EPIS_ULPS fp32 steps of max|alea|.
K2_RTOL = 1e-4
K2_EPIS_ULPS = 16
# K5 (atol, rtol).  bf16: the kernel rounds the unnormalised exp terms to
# bf16 for PV, the twin the normalised probabilities, and both round the
# output, so an output may land on the neighbouring bf16 value (2^-8 of
# itself, under rtol); what the rounded probabilities leave besides grows
# with the row's values, so atol is a share of the row's max|ref| over the
# head dim, not a constant: a row over 2000 diffuse keys has outputs near
# 0.04, where a constant would hide a skipped or phantom key tile.  The
# share is capped at K5_ATOL_CAP, which holds the first rows (one or two
# keys, outputs of v's own size) tighter than their share would.
# fp32: atol absolute, summation order only.
K5_TOL = {torch.bfloat16: (8e-3, 1e-2), torch.float32: (2e-5, 0.0)}
K5_ATOL_CAP = 2e-2
# K6 (atol, rtol), both of max|ref|: bf16 products of x and a nibble are exact
# and the sums are fp32 in another order than the twin's, so a bf16 output
# may round to the neighbouring value (2^-7 of itself); an fp32 output differs
# by summation order only (fp32 x, the FMA kernel).  bf16 x runs on the tensor
# cores, whose fp32 adder truncates: 1e-4 for an fp32 output there.
K6_TOL = {torch.bfloat16: (1e-3, 1e-2), torch.float32: (2e-5, 0.0), "mma fp32": (1e-4, 0.0)}
# The card's published peaks (H100 SXM data sheet, dense): the rates behind
# every bound_ms.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
# narrow model, card vs CPU: epis within this share of its largest value.
# int8 gets a few times its measured gap: the int8 head rounds its input to
# bf16, so a hidden value near a rounding boundary can round apart on the
# two devices.  See CHANGES.md.
NARROW_EPIS_RTOL = {"fp32": 1e-4, "int8": 1e-3, "int4": 1e-3, "next": 1e-4}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def identity() -> str:
    from dropoutdecoding_tpu_torch.ops import _build

    card = _card_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"host: cpu capability {torch.backends.cpu.get_cpu_capability()}, "
          f"{torch.get_num_threads()} threads, {os.cpu_count()} cpus")
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    return card


def build() -> None:
    from dropoutdecoding_tpu_torch.ops import _build

    how = "reused" if _build.library_path().exists() else "built"
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"kernels {how}: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())


_FLUSH = None


def time_ms(fn, reps: int = 30) -> float:
    """Median device time of one ``fn()`` call, in ms, with L2 cold.

    ``fn`` is captured in a CUDA graph behind a 64 MB write that evicts the
    50 MB L2; the graph without ``fn`` is timed too and subtracted.  Graph
    replay keeps host launch latency out of the number, which eager timing
    with events would include.
    """
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    flush_only, both = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(flush_only):
        _FLUSH.zero_()
    with torch.cuda.graph(both):
        _FLUSH.zero_()
        fn()

    def median_replay(graph):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    return median_replay(both) - median_replay(flush_only)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def least_time(nbytes: int, ops: float, kind: str) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the peak rate of their type, whichever is
    larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]
    return {
        "bound_ms": max(by_bytes, by_ops) * 1e3,
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
    }


def _decode_inputs(B, M, H, KH, D, S, cur, dtype, seed, dead_member=False, int8=False):
    """K1's arguments (q, kc, vc, kn, vn, mask), or with ``int8`` K3's
    (q, kq, ks, vq, vs, kn, vn, mask).  ``cur`` is the filled length, one for
    all batch rows or one a row; 40% of the slots of the visual span are
    dropped, member by member."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, kn, vn = rnd(B, M, H, D), rnd(B, M, KH, D), rnd(B, M, KH, D)
    kc, vc = (None, None) if int8 else (rnd(B, S, KH, D), rnd(B, S, KH, D))
    slots = torch.arange(S, device="cuda")
    fill = torch.tensor(cur if isinstance(cur, (list, tuple)) else [cur] * B, device="cuda")
    mask = (slots < fill[:, None, None]).expand(B, M, S).clone()
    holes = torch.rand(B, M, S, generator=g, device="cuda") < 0.4
    mask &= ~(holes & (slots >= 5) & (slots < 5 + 576))  # dropped visual tokens
    if dead_member:
        mask[:, -1] = False  # attends only its own token
    if not int8:
        return q, kc, vc, kn, vn, mask

    def panel():
        return torch.randint(-127, 128, (B, S, KH, D), dtype=torch.int8, device="cuda",
                             generator=g)

    def scales():
        return torch.empty(B, KH, S, device="cuda").uniform_(0.01, 0.03, generator=g)

    return q, panel(), scales(), panel(), scales(), kn, vn, mask


def decode_least_time(args, got, cur: int) -> tuple[int, dict]:
    """(bytes, bound) of one K1 / K3 call on ``_decode_inputs``' arguments
    with one filled length ``cur``: the cache and its scales are read up to
    the filled slot, every other operand whole; QK^T and PV over the filled
    slots and the own token."""
    q = args[0]
    S = args[-1].shape[-1]
    filled = [t[:, :cur] if t.shape[1] == S else t[:, :, :cur] for t in args[1:-3]]
    nbytes = _nbytes(q, *filled, *args[-3:], got)
    return nbytes, least_time(nbytes, 4 * q.numel() * (cur + 1), "bf16")


def check_decode_attention() -> dict:
    """K1 and K3 against their twins: the decode shapes of both models (G = 1
    and G = 4; the LLaVA-NeXT cache at 2947 of 3504 slots), 16 and 24 query
    rows (one tensor-core tile, and two), a member that attends only its own
    token, members whose dropped slots differ inside every tile, two batch
    rows with their own fills (one ends inside a tile, one is a whole number
    of a block's tiles; one holds a single slot), fp32, and the FMA kernel
    at the narrow model's head dim with S one slot into a second tile.
    Every case is one launch and is made twice with equal bits, the second
    call on the scratch and the counters the first left.  Every case runs
    before the first failure is raised, so that a broken kernel shows each
    case that catches it.  Returns the records of the first case of each."""
    from dropoutdecoding_tpu_torch.ops.attention import (
        ensemble_decode_attention,
        ensemble_decode_attention_int8kv,
    )
    from dropoutdecoding_tpu_torch.ops.cuda_decode_attention import (
        ensemble_decode_attention_fused,
        ensemble_decode_attention_int8kv_fused,
    )

    records, failed = {}, []
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (label, B, M, H, KH, D, S, filled slots, dtype, dead member, timed)
        ("M=3 G=1 bf16", 1, 3, 32, 32, 128, 1152, 620, bf16, False, True),
        ("M=1 G=1 bf16", 1, 1, 32, 32, 128, 1152, 620, bf16, False, True),
        ("M=3 G=1 bf16 dead member", 1, 3, 32, 32, 128, 1152, 620, bf16, True, False),
        ("M=3 G=4 bf16", 1, 3, 32, 8, 128, 1152, 620, bf16, False, True),
        # LLaVA-NeXT's decode: 2947 of 3504 slots, the last tile ragged
        ("M=3 G=4 bf16 S=3504", 1, 3, 32, 8, 128, 3504, 2947, bf16, False, True),
        # 16 query rows fill the tensor-core tile; 24 take a second one
        ("M=4 G=4 bf16", 1, 4, 32, 8, 128, 1152, 620, bf16, False, False),
        ("M=6 G=4 bf16 dead member", 1, 6, 32, 8, 128, 1152, 620, bf16, True, False),
        # two batch rows with their own fills: one ends inside a tile, one is a
        # whole number of a block's tiles
        ("B=2 M=3 G=1 bf16, fills 620 / 768", 2, 3, 32, 32, 128, 1152, [620, 768], bf16, False,
         False),
        ("B=2 M=3 G=4 bf16, fills 1 / 1151", 2, 3, 32, 8, 128, 1152, [1, 1151], bf16, True, False),
        ("M=3 G=1 fp32", 1, 3, 32, 32, 128, 1152, 620, fp32, False, True),
        # the FMA kernel at the narrow model's head dim; S ends one slot into a tile
        ("M=3 G=2 D=64 S=65 fp32", 1, 3, 4, 2, 64, 65, 65, fp32, False, False),
        ("M=3 G=2 D=64 S=65 bf16", 1, 3, 4, 2, 64, 65, 64, bf16, False, False),
    ]
    attention = (  # (kernel, wrapper, plain twin, int8 cache, seed base)
        ("K1", ensemble_decode_attention_fused, ensemble_decode_attention, False, 100),
        ("K3", ensemble_decode_attention_int8kv_fused, ensemble_decode_attention_int8kv, True,
         200),
    )
    for name, kernel, twin, int8, seed in attention:
        for i, (label, B, M, H, KH, D, S, cur, dtype, dead, timed) in enumerate(cases):
            args = _decode_inputs(
                B, M, H, KH, D, S, cur, dtype, seed=seed + i, dead_member=dead, int8=int8
            )
            before = kernel.launches
            got = kernel(*args)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise AssertionError(f"{name} {label}: {kernel.launches - before} launches a call")
            same = torch.equal(got, kernel(*args))  # the scratch and its counters serve again
            ref = twin(*args).float()
            diff = (got.float() - ref).abs()
            err = diff.max().item()
            atol, rtol = K1_TOL[dtype]
            row_max = ref.abs().amax(-1, keepdim=True)
            scaled = (atol * row_max).clamp(max=K1_ATOL_CAP) if dtype == bf16 else atol
            within = bool((diff <= scaled + rtol * ref.abs()).all())
            needs = ((diff - rtol * ref.abs()) / (row_max if dtype == bf16 else 1.0)).max().item()
            line = (f"{name} {label}: max_abs_err {err:.3e} (bound {atol:g} "
                    f"{f'row max|ref| (at most {K1_ATOL_CAP:g}) ' if dtype == bf16 else ''}"
                    f"+ {rtol:g} |ref|; the least atol that passes: {max(needs, 0.0):.2e}), "
                    f"twice the same bits {same}")
            if timed:
                ms = time_ms(lambda: kernel(*args))
                plain_ms = time_ms(lambda: twin(*args))
                nbytes, bound = decode_least_time(args, got, cur)
                line += (f", kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
                         f"{bound['bound_ms'] * 1e3:.2f} us by {bound['bound_by']}")
            print(line)
            if not torch.isfinite(got).all() or not within or not same:
                failed.append(f"{name} {label}")
            if i == 0:
                records[name] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None,
                }
    if failed:
        raise AssertionError(f"out of bounds, or two calls that differ: {failed}")
    return records


def check_kernels() -> dict:
    """Each kernel against its plain twin on the card; returns the JSON
    records of the slice-shape cases, keyed by kernel."""
    records = check_decode_attention()
    records["K4"] = check_cache_append()
    records["K5"] = check_flash_prefill()
    records["K6"] = check_int4_matmul()

    records["K2"] = check_uncertainty()
    return records


# K2's cases: (label, B, L, V, k, valid, route).  valid: None, a share of
# rows kept at random, "empty": image 1 has no valid row, or "flood": no mask,
# and in every other row a third of the logits tied at the row's 10th largest.
K2_CASES = [
    ("[1, 576, 32064] k=5", 1, 576, 32064, 5, None, "resident"),
    ("[1, 576, 32064] k=5, 90% valid", 1, 576, 32064, 5, 0.9, "resident"),
    ("[1, 2928, 32064] k=10, 80% valid (LLaVA-NeXT)", 1, 2928, 32064, 10, 0.8, "resident"),
    ("[2, 576, 32064] k=5, an image with no valid row", 2, 576, 32064, 5, "empty", "resident"),
    ("[1, 32, 32001] k=10 (InstructBLIP: rows off the 16-byte grid)", 1, 32, 32001, 10, None,
     "resident"),
    ("[1, 64, 130000] k=5 (a row longer than the ring)", 1, 64, 130000, 5, None, "stream"),
    ("[2, 40, 32064] k=10, 10,000 logits of every other row tied at its 10th value", 2, 40,
     32064, 10, "flood", "resident"),
]


def uncertainty_inputs(B, L, V, valid, seed):
    """(logits [B, L, V] fp32, valid [B, L] bool or None) of a K2 case.  The
    logits are bf16 values (so many are equal to the last bit, as a bf16
    head's are) with ties planted in every row: the row's maximum at columns
    100 and V - 7, the next value at 2047, 2048 and 2051 (either side of a
    copy chunk and of a thread's four columns), the next at 3 and 4;
    ``valid == "flood"`` also ties every third logit of the odd rows at the
    row's 10th value."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = (3.0 * torch.randn(B, L, V, generator=g, device="cuda")).bfloat16().float()
    top = logits.amax(dim=-1, keepdim=True)
    planted = ((1.5, (100, V - 7)), (1.0, (2047, 2048, 2051)), (0.5, (3, 4)))
    for step, cols in planted:
        logits[..., list(cols)] = top + step
    if valid == "flood":  # the selection's candidates overflow their buffer
        tenth = logits.topk(10, dim=-1).values[..., 9:]
        logits[:, 1::2, 6::3] = tenth[:, 1::2]
        for step, cols in planted:
            logits[..., list(cols)] = top + step
    if valid is None or valid == "flood":
        return logits, None
    share = 0.9 if valid == "empty" else valid
    mask = torch.rand(B, L, generator=g, device="cuda") < share
    if valid == "empty":
        mask[1] = False
    return logits, mask


def check_uncertainty() -> dict:
    """K2 against its twin at ``K2_CASES``: every field within ``K2_RTOL`` of
    the field's scale, the top-k ids equal element for element (planted and
    natural ties), the route the case must take, one launch a call, and two
    calls with equal bits.  Every case runs before the first failure is
    raised.  Beside the first and the LLaVA-NeXT case the time of
    ``exact_top_k_ids`` alone (the table as the main path made it before the
    kernel did) and of pass C after the first launch and after an L2 flush.
    Returns the record of the first case."""
    from dropoutdecoding_tpu_torch.ops.cuda_uncertainty import (
        exact_top_k_ids,
        launch_phases,
        vision_uncertainty_fused,
        vision_uncertainty_twin,
    )

    record, failed = None, []
    for i, (label, B, L, V, k, valid, route) in enumerate(K2_CASES):
        logits, v = uncertainty_inputs(B, L, V, valid, seed=7 + i)
        before = dict(vision_uncertainty_fused.route_launches)
        calls = vision_uncertainty_fused.launches
        got = vision_uncertainty_fused(logits, v, top_k=k)
        torch.cuda.synchronize()
        took = [r for r, n in vision_uncertainty_fused.route_launches.items() if n != before[r]]
        if took != [route] or vision_uncertainty_fused.launches != calls + 1:
            raise AssertionError(f"K2 {label}: took {took}, not the {route} route")
        again = vision_uncertainty_fused(logits, v, top_k=k)
        same = all(torch.equal(got[key], again[key]) for key in got)
        ref = vision_uncertainty_twin(logits, v, top_k=k)
        ids_equal = torch.equal(got["topk_ids"], ref["topk_ids"])
        planted = got["topk_ids"][0, 0, :5].tolist() == [100, V - 7, 2047, 2048, 2051]
        err, worst = 0.0, 0.0
        for key, r in ref.items():
            if key == "topk_ids":
                continue
            d = (got[key] - r).abs().max().item()
            # rtol against each field's scale: var is ~1e-6, epis ~1
            scale = r.abs().max().item()
            limit = K2_RTOL * scale
            if key.startswith("epis"):
                alea = ref["alea_uncert_per_token"].abs().max().item()
                limit += K2_EPIS_ULPS * torch.finfo(torch.float32).eps * alea
            err, worst = max(err, d), max(worst, d / limit if limit else d)
            if not d <= limit:
                failed.append(f"{label}: {key} {d:.3e} > {limit:.3e}")
        bad_ids = int((got["topk_ids"] != ref["topk_ids"]).sum())
        ms = time_ms(lambda: vision_uncertainty_fused(logits, v, top_k=k))
        plain_ms = time_ms(lambda: vision_uncertainty_twin(logits, v, top_k=k))
        bound = least_time(_nbytes(logits, *got.values()), 8 * logits.numel(), "fp32")
        two_reads_ms = 2 * _nbytes(logits) / HBM_BYTES_PER_S * 1e3
        line = (f"K2 {label} ({route}): max_abs_err {err:.3e}, at most {worst:.2f} of a field's "
                f"bound (rtol {K2_RTOL:g} of its scale; epis + {K2_EPIS_ULPS} fp32 steps of "
                f"max|alea|), ids differing from the twin {bad_ids}, planted ties in "
                f"order {planted}, twice the same bits {same}, kernel with the table "
                f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
                f"{bound['bound_ms'] * 1e3:.2f} us by {bound['bound_by']}, two reads "
                f"{two_reads_ms * 1e3:.1f} us")
        extra = {}
        if i in (0, 2):
            extra["table_before_ms"] = time_ms(lambda: exact_top_k_ids(logits, k))
            no_table = time_ms(lambda: vision_uncertainty_fused(logits, v))
            # pass C alone: with the L2 as launch 1 left it, and after a flush
            ab = time_ms(lambda: launch_phases(logits, v, k, ab=True))
            ab_c = time_ms(lambda: launch_phases(logits, v, k, ab=True, cross=True))
            c_cold = time_ms(lambda: launch_phases(logits, v, k, cross=True))
            line += (f"; exact_top_k_ids alone {extra['table_before_ms'] * 1e3:.1f} us, kernel "
                     f"without the table {no_table * 1e3:.1f} us; launch 1 {ab * 1e3:.1f} us, "
                     f"pass C after it {(ab_c - ab) * 1e3:.1f} us, after an L2 flush "
                     f"{c_cold * 1e3:.1f} us")
        print(line)
        if not (ids_equal and planted and same):
            failed.append(f"{label}: ids equal {ids_equal}, planted {planted}, same bits {same}")
        if i == 0:
            record = {
                "kernel_route": route, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bound, "two_reads_ms": two_reads_ms, "library_ms": None, **extra,
            }
        if i == 2:
            record["next"] = {"ms": ms, "two_reads_ms": two_reads_ms, **extra}
        del logits, got, again, ref
    if failed:
        raise AssertionError(f"K2: {failed}")
    return record


def check_cache_append() -> dict:
    """K4 against its twin from the same random int8 cache: the whole q and
    s buffers must be bit-equal.  Returns the record of the 7B-shape case."""
    from dropoutdecoding_tpu_torch.ops.cuda_cache_append import (
        cache_append_floor,
        cache_append_int8,
        cache_append_int8_twin,
    )

    record = None
    # (label, L, B, S, KH, D, cur_len, dtype)
    cases = [
        ("[32, 1, 1152, 4096] bf16", 32, 1, 1152, 32, 128, [620], torch.bfloat16),
        ("[32, 2, 1152, 4096] bf16, cur_len 620 / 1151", 32, 2, 1152, 32, 128, [620, 1151],
         torch.bfloat16),
        ("[32, 1, 1152, 4096] fp32", 32, 1, 1152, 32, 128, [7], torch.float32),
        # the scalar route: another head dim
        ("[4, 2, 96, 8 x 64] bf16, cur_len 5 / 95", 4, 2, 96, 8, 64, [5, 95], torch.bfloat16),
    ]
    for i, (label, L, B, S, KH, D, cur, dtype) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        kq, vq = (torch.randint(-127, 128, (L, B, S, KH * D), dtype=torch.int8, device="cuda",
                                generator=g) for _ in range(2))
        ks, vs = (torch.rand(L, B, KH, S, device="cuda", generator=g) for _ in range(2))
        k_new, v_new = (3 * torch.randn(L, B, KH, D, device="cuda", generator=g) for _ in range(2))
        k_new[0, 0, 0] = 0.0  # a zero row: scale 1
        k_new, v_new = k_new.to(dtype), v_new.to(dtype)
        cur_len = torch.tensor(cur, dtype=torch.long, device="cuda")
        got = [t.clone() for t in (kq, ks, vq, vs)]
        ref = [t.clone() for t in (kq, ks, vq, vs)]
        cache_append_int8(*got, cur_len, k_new, v_new)
        torch.cuda.synchronize()
        cache_append_int8_twin(*ref, cur_len, k_new, v_new)
        diff = [int((a != b).sum()) for a, b in zip(got, ref)]  # per kq, ks, vq, vs
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        changed = sum(int((a != b).sum()) for a, b in zip(got, (kq, ks, vq, vs)))
        ms = time_ms(lambda: cache_append_int8(*got, cur_len, k_new, v_new))
        plain_ms = time_ms(lambda: cache_append_int8_twin(*ref, cur_len, k_new, v_new))
        print(
            f"K4 {label}: {sum(diff)} elements differ from the twin (want 0; kq, ks, vq, vs: "
            f"{diff}), max_abs_err {err:g}, {changed} written, kernel {ms * 1e3:.1f} us, "
            f"plain {plain_ms * 1e3:.1f} us"
        )
        if sum(diff) or not changed:
            raise AssertionError(f"K4 {label}: {diff} elements differ, {changed} written")
        if record is None:
            # the launch floor: the same grid, cur_len read, a word a warp written
            words = cache_append_floor(cur_len, L, KH)
            if not bool((words == cur[0]).all()):
                raise AssertionError("K4 floor kernel: wrong words")
            floor_ms = time_ms(lambda: cache_append_floor(cur_len, L, KH))
            print(f"K4 {label}: launch floor {floor_ms * 1e3:.1f} us")
            # the new rows read; the int8 rows and their scales written
            written = 2 * L * B * KH * (D + 4)
            record = {
                "launch_floor_ms": floor_ms,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **least_time(_nbytes(k_new, v_new, cur_len) + written, 8 * k_new.numel(), "fp32"),
                "library_ms": None,
            }
    return record


def check_flash_prefill() -> dict:
    """K5 against its twin: the LLaVA-NeXT prefill shape with a padded key
    tail, at G = 4 and G = 1 in bf16 and in fp32; on the wgmma kernel (bf16,
    D = 128) also S = 1024 and 1025, B = 2 with two different key-mask
    tails, and rows with no attendable key (masked leading keys: the twin's
    softmax is uniform over all S keys there); the same on the mma.sync
    kernel (D = 64) and the scalar one (fp32, D = 16).  Two more wgmma cases
    make single key tiles matter: "peaked" scales q by 8, so that a row's
    weight sits on a few keys and a skipped or stale tile moves the rows
    that peak there by about their own size; "stepped" adds (tile mod 4) -
    1.5 to v by key tile of 128, so that the tiles' shares cancel in a whole
    walk and one tile missing, or one phantom or masked tile counted, shows
    in every later row.  Each case must take the kernel named beside it.  No
    output may be NaN or Inf.  Operations are counted from the mask: a (query,
    key) pair for each attendable key at or before the query.  Returns the
    record of the first case."""
    from dropoutdecoding_tpu_torch.ops.attention import chunked_prefill_attention
    from dropoutdecoding_tpu_torch.ops.cuda_flash_prefill import flash_prefill_attention

    record = None
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (label, B, S, H, KH, D, dtype, real keys per row of B, masked leading keys, kernel)
        ("S=2950 G=4 bf16", 1, 2950, 32, 8, 128, bf16, [2362], 0, "wgmma"),
        ("S=2950 G=1 bf16", 1, 2950, 32, 32, 128, bf16, [2362], 0, "wgmma"),
        ("S=1024 G=4 bf16", 1, 1024, 32, 8, 128, bf16, [1024], 0, "wgmma"),
        ("S=1025 G=1 bf16", 1, 1025, 8, 8, 128, bf16, [1000], 0, "wgmma"),
        ("B=2 S=1300 G=4 bf16, key tails 1100 / 1300", 2, 1300, 16, 4, 128, bf16, [1100, 1300], 0,
         "wgmma"),
        # 130 masked leading keys: the first query tile has no key tile to walk
        ("B=2 S=700 G=2 D=128 bf16, rows without keys", 2, 700, 8, 4, 128, bf16, [650, 520], 130,
         "wgmma"),
        ("S=2950 G=4 bf16 peaked", 1, 2950, 8, 2, 128, bf16, [2362], 0, "wgmma"),
        ("B=2 S=1025 G=1 bf16 peaked", 2, 1025, 4, 4, 128, bf16, [1025, 700], 0, "wgmma"),
        ("S=2950 G=4 bf16 stepped", 1, 2950, 8, 2, 128, bf16, [2362], 0, "wgmma"),
        ("B=2 S=1025 G=1 bf16 stepped", 2, 1025, 4, 4, 128, bf16, [1025, 700], 0, "wgmma"),
        ("S=2950 G=4 fp32", 1, 2950, 32, 8, 128, fp32, [2362], 0, "scalar"),
        ("B=2 S=700 G=2 D=64 bf16, rows without keys", 2, 700, 8, 4, 64, bf16, [650, 650], 5,
         "mma"),
        ("S=1100 G=2 D=16 fp32, rows without keys", 1, 1100, 4, 2, 16, fp32, [1000], 5, "scalar"),
    ]
    for i, (label, B, S, H, KH, D, dtype, real, lead, kernel) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(400 + i)

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device="cuda")

        q, k, v = rnd(B, S, H, D), rnd(B, S, KH, D), rnd(B, S, KH, D)
        if label.endswith("peaked"):
            q *= 8.0
        if label.endswith("stepped"):
            v += (torch.arange(S, device="cuda") // 128 % 4 - 1.5)[None, :, None, None]
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        mask = torch.arange(S, device="cuda") < torch.tensor(real, device="cuda")[:, None]
        mask[:, :lead] = False
        before = dict(flash_prefill_attention.route_launches)
        got = flash_prefill_attention(q, k, v, mask)
        torch.cuda.synchronize()
        took = [r for r, n in flash_prefill_attention.route_launches.items() if n != before[r]]
        ref = chunked_prefill_attention(q, k, v, mask).float()
        finite = bool(torch.isfinite(got).all())
        diff = (got.float() - ref).abs()
        err = diff.max().item()
        atol, rtol = K5_TOL[dtype]
        row_max = ref.abs().amax(-1, keepdim=True)
        scaled = (atol * row_max).clamp(max=K5_ATOL_CAP) if dtype == bf16 else atol
        bound = scaled + rtol * ref.abs()
        within = bool((diff <= bound).all())
        needs = ((diff - rtol * ref.abs()) / (row_max if dtype == bf16 else 1.0)).max().item()
        line = (f"K5 {label} ({'/'.join(took)}): max_abs_err {err:.3e} (bound {atol:g} "
                f"{f'row max|ref| (at most {K5_ATOL_CAP:g}) ' if dtype == bf16 else ''}+ {rtol:g} |ref|; the least atol "
                f"that passes: {max(needs, 0.0):.2e}), finite {finite}")
        timed = S == 2950 and H == 32
        if timed:
            # causal QK^T and PV over the pairs the mask leaves
            flops = 4 * H * D * mask.cumsum(1).sum().item()
            ms = time_ms(lambda: flash_prefill_attention(q, k, v, mask))
            plain_ms = time_ms(lambda: chunked_prefill_attention(q, k, v, mask))
            line += (f", kernel {ms * 1e3:.1f} us ({flops / ms / 1e9:.1f} TFLOP/s over "
                     f"{flops / 4 / H / D:.0f} pairs a head), plain {plain_ms * 1e3:.1f} us")
        print(line)
        if took != [kernel]:
            raise AssertionError(f"K5 {label}: took {took}, not the {kernel} kernel")
        if not finite or not within:
            raise AssertionError(f"K5 {label}: finite {finite}, max_abs_err {err} out of bounds")
        if record is None:
            # the one PyTorch call of the same function: causal and key mask
            # as one boolean mask (built outside the timed call), GQA inside
            allowed = mask[:, None, None, :] & torch.ones(
                S, S, dtype=torch.bool, device="cuda").tril()
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=allowed, enable_gqa=True))
            print(f"K5 {label}: scaled_dot_product_attention {library_ms * 1e3:.1f} us "
                  "(reference only)")
            del allowed
            record = {
                "kernel_route": kernel, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **least_time(_nbytes(q, k, v, mask, got), flops, "bf16"), "library_ms": library_ms,
            }
    return record


def check_int4_matmul() -> dict:
    """K6 against its twin, with uniform bytes (every nibble value, -8
    included) and varied scales: the four projection shapes of a 7B layer
    at the row counts of the main path (1 and 3 in the decode forwards, 595
    in the prefill) and at 16, the last of the whole-tile kernel, in bf16,
    every call made twice with equal bits and o made again after gate_up, a bf16 input with an fp32 output (also at an
    int4 head's shape, whose 32064 channels end inside a tile), fp32 inputs
    at the narrow model's shapes, a ragged shape (43 groups of 32 a half, E
    = 130) on every mma.sync tile shape, and K6': layer 17 of a stacked
    [32, D/2, E] weight passed as a view, which must be read in place.  The
    prefill's cases must take the wgmma kernel: the four shapes at R = 595,
    the o projection also at R = 17, 64, 128 and 600, a batched [2, 595,
    4096] x, a layer's view and the head at R = 576.  Beside each 7B case the time of ``torch.matmul`` of x
    with a bf16 matrix dequantized ahead of time (reference only; the port
    never makes that matrix).  Returns the record of the fused gate/up
    projection at 3 rows, the exact-mode decode's, with the same projection
    at 595 rows under "prefill"."""
    from dropoutdecoding_tpu_torch.ops.cuda_int4_matmul import int4_matmul, int4_matmul_twin
    from dropoutdecoding_tpu_torch.utils.quantize import dequantize_matrix_int4

    g = torch.Generator(device="cuda").manual_seed(600)

    def packed(*lead, D, E, group):
        q4 = torch.randint(-128, 128, (*lead, D // 2, E), dtype=torch.int8, device="cuda",
                           generator=g)
        s4 = torch.empty(*lead, D // group, E, device="cuda").uniform_(0.002, 0.006, generator=g)
        return q4, s4

    def compare(label, x, q4, s4, out_dtype, tol, timed=True, route=None):
        before = dict(int4_matmul.route_launches)
        got = int4_matmul(x, q4, s4, out_dtype=out_dtype)
        torch.cuda.synchronize()
        took = [r for r, n in int4_matmul.route_launches.items() if n != before[r]]
        if route is not None and took != [route]:
            raise AssertionError(f"K6 {label}: took {took}, not the {route} kernel")
        ref = int4_matmul_twin(x, q4, s4, out_dtype=out_dtype)
        if got.dtype != ref.dtype or got.shape != ref.shape:
            raise AssertionError(f"K6 {label}: {got.dtype} {tuple(got.shape)}")
        diff = (got.float() - ref.float()).abs()
        err, scale = diff.max().item(), ref.float().abs().max().item()
        atol, rtol = tol
        within = bool((diff <= atol * scale + rtol * ref.float().abs()).all())
        line = f"K6 {label}: max_abs_err {err:.3e} (bound {atol:g} max|ref| + {rtol:g} |ref|)"
        times = {}
        if timed:
            times["ms"] = time_ms(lambda: int4_matmul(x, q4, s4, out_dtype=out_dtype))
            times["plain_ms"] = time_ms(lambda: int4_matmul_twin(x, q4, s4, out_dtype=out_dtype))
            line += f", kernel {times['ms'] * 1e3:.1f} us, plain {times['plain_ms'] * 1e3:.1f} us"
        print(line)
        if not torch.isfinite(got).all() or not within:
            raise AssertionError(f"K6 {label}: max_abs_err {err} out of bounds")
        return {"max_abs_err": err, **times}, got

    record, prefill, kept = None, None, None
    shapes = [  # the fused leaves of a Vicuna-7B layer: (name, D, E)
        ("qkv", 4096, 12288), ("o", 4096, 4096), ("gate_up", 4096, 22016), ("down", 11008, 4096),
    ]
    for name, D, E in shapes:
        q4, s4 = packed(D=D, E=E, group=128)
        dense = dequantize_matrix_int4({"q4": q4, "s4": s4}, torch.bfloat16)
        for R in (1, 3, 16, 595):  # 16: the last row count of the whole-tile kernel
            x = torch.randn(R, D, generator=g, device="cuda").to(torch.bfloat16)
            route = "wgmma" if R == 595 else "tiles"
            rec, got = compare(f"{name} [{R}, {D}] x [{D}, {E}] bf16 ({route})", x, q4, s4, None,
                               K6_TOL[torch.bfloat16], route=route)
            rec["library_ms"] = time_ms(lambda: torch.matmul(x, dense))
            rec.update(least_time(_nbytes(x, q4, s4, got), 2 * R * D * E, "bf16"))
            print(
                f"K6 {name} R={R}: bound {rec['bound_ms'] * 1e3:.1f} us by {rec['bound_by']} "
                f"({_nbytes(x, q4, s4, got) / rec['ms'] / 1e6:.0f} GB/s, "
                f"{2 * R * D * E / rec['ms'] / 1e9:.1f} TFLOP/s), bf16 matmul on the "
                f"dequantized matrix {rec['library_ms'] * 1e3:.1f} us (reference only)"
            )
            if (name, R) == ("gate_up", 3):
                record = rec
            if (name, R) == ("gate_up", 595):
                prefill = {"route": route, **rec}
            if not torch.equal(got, int4_matmul(x, q4, s4)):
                raise AssertionError(f"K6 {name} R={R}: two calls differ in their bits")
            if (name, R) == ("o", 3):
                kept = (x, q4, s4, got)
        if name == "gate_up" and not torch.equal(kept[3], int4_matmul(*kept[:3])):
            # two shapes back to back: nothing one call leaves behind may reach the next
            raise AssertionError("K6 o R=3 after gate_up differs from o before it")
        if name == "o":  # K6': layer 17 of a stack, in place; and an fp32 output
            stack_q, stack_s = packed(32, D=D, E=E, group=128)
            view_q, view_s = stack_q[17], stack_s[17]
            if view_q.data_ptr() != stack_q.data_ptr() + 17 * (D // 2) * E:
                raise AssertionError("K6' layer view is a copy")
            x = torch.randn(3, D, generator=g, device="cuda").to(torch.bfloat16)
            _, got = compare("K6' layer 17 of [32, 2048, 4096], R=3 bf16", x, view_q, view_s,
                             None, K6_TOL[torch.bfloat16], timed=False)
            alone = int4_matmul(x, view_q.clone(), view_s.clone())
            if not torch.equal(got, alone):
                raise AssertionError("K6' layer view differs from the layer's own copy")
            x = torch.randn(595, D, generator=g, device="cuda").to(torch.bfloat16)
            _, got = compare("K6' layer 17 of [32, 2048, 4096], R=595 bf16 (wgmma)", x, view_q,
                             view_s, None, K6_TOL[torch.bfloat16], timed=False, route="wgmma")
            if not torch.equal(got, int4_matmul(x, view_q.clone(), view_s.clone())):
                raise AssertionError("K6' layer view at R=595 differs from the layer's own copy")
            del stack_q, stack_s
            for R, route in ((3, "tiles"), (595, "wgmma")):
                x = torch.randn(R, D, generator=g, device="cuda").to(torch.bfloat16)
                compare(f"o R={R} bf16 in, fp32 out ({route})", x, q4, s4, torch.float32,
                        K6_TOL["mma fp32"], timed=False, route=route)
            # row counts around the wgmma kernel's tiles: one short tile, a
            # tile's edge, a ragged last tile, whole tiles, and a batched x
            for lead in ((17,), (64,), (128,), (600,), (2, 595)):
                x = torch.randn(*lead, D, generator=g, device="cuda").to(torch.bfloat16)
                compare(f"o {list(lead)} rows bf16 (wgmma)", x, q4, s4, None,
                        K6_TOL[torch.bfloat16], timed=False, route="wgmma")
        del q4, s4, dense

    q4, s4 = packed(D=4096, E=32064, group=128)  # an int4 head: 250.5 channel tiles, fp32 logits
    for R, route in ((3, "tiles"), (576, "wgmma")):
        x = torch.randn(R, 4096, generator=g, device="cuda").to(torch.bfloat16)
        compare(f"head [{R}, 4096] x [4096, 32064] bf16 in, fp32 out ({route})", x, q4, s4,
                torch.float32, K6_TOL["mma fp32"], timed=False, route=route)
    # the narrow model's prefill and decode shapes: fp32 (the FMA kernel), and
    # bf16, where one chunk holds the whole contraction and nothing is split
    for R, D, E in ((73, 256, 768), (3, 256, 768), (3, 512, 256)):
        q4, s4 = packed(D=D, E=E, group=128)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(R, D, generator=g, device="cuda").to(dtype)
            route = "fma" if dtype == torch.float32 else "wgmma" if R > 16 else "tiles"
            compare(f"{str(dtype).split('.')[-1]} [{R}, {D}] x [{D}, {E}] ({route})", x, q4, s4,
                    None, K6_TOL[dtype], timed=dtype == torch.float32, route=route)
    q4, s4 = packed(D=2 * 43 * 32, E=130, group=32)  # 43 groups a half; rows unaligned
    for R, dtype in ((3, torch.bfloat16), (30, torch.bfloat16), (70, torch.bfloat16),
                     (7, torch.float32)):
        x = torch.randn(2, R // 2 + 1, 2 * 43 * 32, generator=g, device="cuda").to(dtype)
        compare(f"ragged [{x.shape[0]}, {x.shape[1]}, 2752] x [2752, 130] g=32 "
                f"{str(dtype).split('.')[-1]}", x, q4, s4, None, K6_TOL[dtype], timed=False,
                route="mma" if dtype == torch.bfloat16 else "fma")
    bad = torch.randn(3, 96, device="cuda")
    try:  # a group the kernel's k-step does not divide must raise, never fall back
        int4_matmul(bad, torch.zeros(48, 8, dtype=torch.int8, device="cuda"),
                    torch.ones(4, 8, device="cuda"))
    except ValueError as e:
        print(f"K6 g=24: raises ({e})")
    else:
        raise AssertionError("K6 accepted a group size of 24")
    return {**record, "prefill": prefill}


def _narrow_config():
    from dropoutdecoding_tpu_torch.utils.config import ClipVisionConfig, LlamaConfig, LlavaConfig

    return LlavaConfig(
        text=LlamaConfig(
            vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, head_dim=64,
        ),
        vision=ClipVisionConfig(
            hidden_size=128, intermediate_size=256, num_hidden_layers=3,
            num_attention_heads=4, image_size=112, patch_size=14,
        ),
        image_token_index=500,
    )


def _narrow_next_config():
    from dropoutdecoding_tpu_torch.utils.config import (
        ClipVisionConfig,
        LlamaConfig,
        LlavaNextConfig,
    )

    return LlavaNextConfig(  # N_max = 256 + 32 * 33 = 1312 visual slots
        text=LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        ),
        vision=ClipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=4, image_size=112, patch_size=7,
        ),
        image_token_index=120,
        image_grid_pinpoints=((112, 224), (224, 112), (224, 224)),
    )


def small_reference(tier: str) -> None:
    """A narrow model in fp32 on the card (kernels) and on the CPU (plain
    twins) with one table of injected mask draws: equal tokens, close epis.
    Weights are scaled up from the synthetic recipe so the logits are
    sharp enough for argmax to be stable against summation order.  Tiers:
    "fp32", "int8" and "int4" are LLaVA (int8 / int4: the LM's weights
    quantized and fused, as the JAX CLI's ``--quantize int8`` / ``int4``
    with its int8 head, and an int8 KV cache; every int4 projection runs K6
    in its fp32 instantiation, g = 128);
    "next" is LLaVA-NeXT with the reference's NeXT settings (no mask
    accumulation, top-10 table, seed 506) and one 150 x 220 image (5 tiles,
    982 of 1312 visual slots real), whose 1320-token prefill runs K5.  A
    CPU prefill in fp64 anchors the epis of both sides, so a miss shows
    which side moved."""
    import numpy as np

    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
    from dropoutdecoding_tpu_torch.models import llavanext
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.ops.cuda_flash_prefill import flash_prefill_attention
    from dropoutdecoding_tpu_torch.utils.config import EnsembleConfig, GenerationConfig
    from dropoutdecoding_tpu_torch.utils.convert import (
        synthetic_llava_params,
        synthetic_llavanext_params,
    )
    from dropoutdecoding_tpu_torch.utils.quantize import (
        fuse_projections,
        quantize_llama_params,
        quantize_llama_params_int4,
    )

    rng = np.random.default_rng(5)
    if tier == "next":
        cfg = _narrow_next_config()
        params = synthetic_llavanext_params(cfg, "cpu", torch.float32, seed=3)
        Params, Engine, max_len, image = llavanext.LlavaNextParams, LlavaNextEngine, 1344, 120
        size = (150, 220)
        n_tiles = llavanext.image_geometry(size, cfg)["n_tiles"]
        tiles = rng.normal(size=(n_tiles, 3, 112, 112)).astype(np.float32)
        images, images64 = (tiles, size), (tiles.astype(np.float64), size)
        kw = dict(ens=EnsembleConfig(mask_accumulate=False, topk=10), seed=506)
    else:
        cfg = _narrow_config()
        params = synthetic_llava_params(cfg, "cpu", torch.float32, seed=3)
        Params, Engine, max_len, image = LlavaParams, LlavaEngine, 128, 500
        pixels = rng.normal(size=(1, 3, 112, 112)).astype(np.float32)
        images, images64 = (pixels,), (pixels.astype(np.float64),)
        kw = dict(int8_kv=tier in ("int8", "int4"))

    # x10: std 0.2.  The narrow NeXT takes x5: at x10 one visual token's fp32
    # epis lands 3.6e-3 from the fp64 one on the CPU (1.1e-3 of the scale),
    # at x5 1.6e-5 (3.1e-5 of the scale).
    factor = 5 if tier == "next" else 10

    def sharpen(part):
        if isinstance(part, dict):
            return {k: sharpen(v) for k, v in part.items()}
        return part * factor if part.dim() >= 2 else part

    params = Params(*(sharpen(p) for p in params))
    if tier in ("int8", "int4"):
        quantize = quantize_llama_params if tier == "int8" else quantize_llama_params_int4
        params = params._replace(lm=fuse_projections(quantize(params.lm)))
    ids = np.array([[1, 17, 29, image, 41, 53, 67, 71, 83]])
    N = Engine(cfg=cfg, params=params, max_len=max_len, **kw).n_visual
    draws = torch.from_numpy(rng.random((16, 1, 3, N), dtype=np.float32))
    gen = GenerationConfig(max_new_tokens=12, eos_token_id=-1, pad_token_id=0)
    out = {}
    flash_prefill_attention.launches = 0
    for device in ("cuda", "cpu"):
        p = Params(*(_to(part, device) for part in params))
        for ensemble in (False, True):
            eng = Engine(
                cfg=cfg, params=p, gen=gen, max_len=max_len, ensemble=ensemble,
                uniform=lambda step, row, m, n: draws[step, row, m, :n], **kw,
            )
            state = eng.prefill(ids, *images)
            valid = state.visual_mask.cpu()
            out[device, ensemble] = (eng.generate(ids, *images).tokens, state.epis.cpu()[valid])
    if tier == "next":  # two prefills per engine on the card, K5 in both layers of each
        want = 2 * 2 * cfg.text.num_hidden_layers
        print(f"narrow {tier}: K5 launched {flash_prefill_attention.launches} times on the card "
              f"(want {want})")
        if flash_prefill_attention.launches != want:
            raise AssertionError(f"narrow {tier}: K5 launches {flash_prefill_attention.launches}")
    wide = Params(*(_to(part, "cpu", torch.float64) for part in params))
    epis64 = Engine(cfg=cfg, params=wide, gen=gen, max_len=max_len, **kw).prefill(
        ids, *images64
    ).epis[valid]
    for ensemble in (False, True):
        (tok_g, epis_g), (tok_c, epis_c) = out["cuda", ensemble], out["cpu", ensemble]
        d = (epis_g - epis_c).abs()
        err, worst = d.max().item(), int(d.argmax())
        # fp32 on two devices: every matmul sums in another order, and epis
        # = -alea - C cancels terms of about log V
        bound = NARROW_EPIS_RTOL[tier] * epis_c.abs().max().item()
        label = "exact K=3" if ensemble else "greedy"
        print(
            f"narrow {tier} {label}: card {tok_g[0].tolist()} cpu {tok_c[0].tolist()} "
            f"epis err {err:.2e} (bound {bound:.2e}); from the fp64 prefill: card "
            f"{(epis_g - epis64).abs().max().item():.2e}, cpu "
            f"{(epis_c - epis64).abs().max().item():.2e}; worst token {worst}: card "
            f"{epis_g.flatten()[worst].item():.7g} cpu {epis_c.flatten()[worst].item():.7g} "
            f"fp64 {epis64.flatten()[worst].item():.7g}"
        )
        if not np.array_equal(tok_g, tok_c):
            raise AssertionError(f"narrow {tier} {label}: card tokens differ from the CPU twins'")
        if not err <= bound:
            raise AssertionError(f"narrow {tier} {label}: epis differs by {err} > {bound}")


def _to(tree, device, float_dtype=None):
    """``tree`` (a dict of tensors, nested, or one tensor) on ``device``;
    with ``float_dtype``, its float leaves in it."""
    if isinstance(tree, dict):
        return {k: _to(v, device, float_dtype) for k, v in tree.items()}
    if float_dtype and tree.is_floating_point():
        return tree.to(device, float_dtype)
    return tree.to(device)


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _wrappers() -> dict:
    """Each kernel's wrapper, keyed by kernel; each counts its launches."""
    from dropoutdecoding_tpu_torch.ops.cuda_cache_append import cache_append_int8
    from dropoutdecoding_tpu_torch.ops.cuda_decode_attention import (
        ensemble_decode_attention_fused,
        ensemble_decode_attention_int8kv_fused,
    )
    from dropoutdecoding_tpu_torch.ops.cuda_flash_prefill import flash_prefill_attention
    from dropoutdecoding_tpu_torch.ops.cuda_int4_matmul import int4_matmul
    from dropoutdecoding_tpu_torch.ops.cuda_uncertainty import vision_uncertainty_fused

    return {
        "K1": ensemble_decode_attention_fused,
        "K2": vision_uncertainty_fused,
        "K3": ensemble_decode_attention_int8kv_fused,
        "K4": cache_append_int8,
        "K5": flash_prefill_attention,
        "K6": int4_matmul,
    }


def drive(make, args, tier: str, int8_kv: bool = False, int4: bool = False) -> dict:
    """Greedy, then exact K=3: 32 new tokens each through the engine's
    ``generate(*args)`` (the main path), ``make(ensemble, gen)`` building
    the engine, with every kernel's launch count set to 0 just before and
    checked just after; one prefill more, hooked, must launch K2 once and
    give the top-k table ``exact_top_k_ids`` gives on its logits.  Returns
    the exact K=3 run's counts."""
    from dropoutdecoding_tpu_torch.models.llama import LONG_PREFILL
    from dropoutdecoding_tpu_torch.ops.cuda_uncertainty import exact_top_k_ids
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig

    wrappers = _wrappers()
    T = 32
    gen = GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0)
    make(True, GenerationConfig(max_new_tokens=3, eos_token_id=-1)).generate(*args)  # warm-up

    counts = None
    for label, ensemble in (("greedy", False), ("exact K=3", True)):
        eng = make(ensemble, gen)
        L, V = eng.cfg.text.num_hidden_layers, eng.cfg.text.vocab_size
        S = args[0].shape[1] + eng.n_visual - 1  # the merged (padded) prompt
        prefill_s = statistics.median(_sync_time(lambda: eng.prefill(*args))[1] for _ in range(3))
        state = eng.prefill(*args)
        real = int(state.cur_len[0])
        _, decode_s = _sync_time(lambda: eng.decode(state))
        del state

        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        for k in ("K5", "K6"):
            wrappers[k].route_launches = dict.fromkeys(wrappers[k].route_launches, 0)
        result, total_s = _sync_time(lambda: eng.generate(*args))  # the main path
        counts = {k: fn.launches for k, fn in wrappers.items()}
        # the prefill's launches of K5 and K6 that took the wgmma kernels
        wgmma = {k: wrappers[k].route_launches["wgmma"] for k in ("K5", "K6")}
        peak = torch.cuda.max_memory_allocated() / 2**30

        tok = result.tokens
        if tok.shape != (1, T) or not ((tok >= 0) & (tok < V)).all():
            raise AssertionError(f"{tier} {label}: bad tokens {tok}")
        tables = []  # one prefill more, its table held against the plain version's
        eng.on_prefill = lambda logits, st: tables.append(
            (wrappers["K2"].launches,
             torch.equal(st.topk_ids, exact_top_k_ids(logits, eng.ens.topk))))
        unc = eng.prefill(*args).uncertainty
        eng.on_prefill = None
        if tables != [(counts["K2"] + 1, True)] or "topk_ids" in unc:
            raise AssertionError(
                f"{tier} {label}: (K2 launches, table equal to exact_top_k_ids) of one more "
                f"prefill {tables}, want [({counts['K2'] + 1}, True)]")
        for key, v in unc.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{tier} {label}: non-finite uncertainty field {key}")
        if unc["epis_uncert_per_token"].shape != (1, eng.n_visual):
            raise AssertionError(
                f"{tier} {label}: epis shape {tuple(unc['epis_uncert_per_token'].shape)}"
            )
        attention = (T - 1) * (2 if ensemble else 1) * L  # every layer of every decode forward
        want = {
            "K1": 0 if int8_kv else attention,
            "K2": 1,
            "K3": attention if int8_kv else 0,
            "K4": T - 1 if int8_kv else 0,  # one append per decode step
            "K5": L if S >= LONG_PREFILL else 0,  # every layer of the one prefill
            # the four fused projections of every layer of every forward
            "K6": 4 * L * (1 + (T - 1) * (2 if ensemble else 1)) if int4 else 0,
        }
        # every K5 launch, and K6's four projections of every layer of the prefill
        want_wgmma = {"K5": want["K5"], "K6": 4 * L if int4 else 0}
        print(
            f"{tier} {label}: prompt {S} tokens ({real} real), prefill {prefill_s * 1e3:.1f} ms, "
            f"decode {(T - 1) / decode_s:.2f} tokens/s ({decode_s / (T - 1) * 1e3:.2f} ms/step), "
            f"generate {T / total_s:.2f} tokens/s end to end, peak {peak:.2f} GiB, "
            f"launches {counts} (want {want}), of them on wgmma {wgmma} (want {want_wgmma}); "
            f"tokens {tok[0, :8].tolist()}..."
        )
        if counts != want:
            raise AssertionError(f"{tier} {label}: launch counts {counts} != {want}")
        if wgmma != want_wgmma:
            raise AssertionError(f"{tier} {label}: wgmma launches {wgmma} != {want_wgmma}")
    return counts


def batch_of_two(cfg, params, tier: str, int8_kv: bool) -> None:
    """Exact K=3 ``generate`` of 16 tokens for two requests in one batch
    (two prompts, two images) whose rows stop at different steps:
    ``eos_token_id`` is a token that a first run without eos shows in one
    row earlier than in the other.  Each row's tokens must equal those of
    the row run without the other, with its own mask-draw streams, and the
    batch's launch counts the larger of the two rows' own (a batch runs
    until its last row is done).  A row runs without the other as a batch
    of itself twice: its matmuls then take the kernels, and so the summation
    order, they take beside the other row (a bf16 batch of one does not, and
    its argmax over synthetic logits parts from the batch's after a few
    steps)."""
    import numpy as np

    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig
    from dropoutdecoding_tpu_torch.utils.prng import PhiloxUniform

    wrappers = _wrappers()
    rng = np.random.default_rng(13)
    ids = rng.integers(2, 32000, size=(2, 20))
    ids[:, 0], ids[:, 5] = 1, cfg.image_token_index
    pixels = rng.normal(size=(2, 3, 336, 336)).astype(np.float32)
    T, seed = 16, 24

    def run(rows, eos):
        """(tokens, launch counts) of the rows' batch; row i of it draws the
        streams of request rows[i]."""
        draws = PhiloxUniform(seed, "cuda")
        eng = LlavaEngine(
            cfg=cfg, params=params, max_len=1152, ensemble=True, int8_kv=int8_kv,
            gen=GenerationConfig(max_new_tokens=T, eos_token_id=eos, pad_token_id=0),
            uniform=lambda step, row, m, n: draws(step, rows[row], m, n),
        )
        for fn in wrappers.values():
            fn.launches = 0
        tokens = eng.generate(ids[rows], pixels[rows]).tokens
        return tokens, {k: fn.launches for k, fn in wrappers.items()}

    free_run, _ = run([0, 1], -1)
    first = [{int(t): i for i, t in reversed(list(enumerate(row)))} for row in free_run]
    # a token whose first step in one row is early, and later or never in the other
    found = [(step, row, tok) for row in (0, 1) for tok, step in first[row].items()
             if tok and 1 <= step <= T // 2 and first[1 - row].get(tok, T) > step + 1]
    if not found:
        raise AssertionError(f"{tier} B=2: no token ends one row before the other: {free_run}")
    step, early, eos = min(found)
    both, counts = run([0, 1], eos)
    alone = [run([row, row], eos) for row in (0, 1)]
    ends = [int(np.argmax(row == eos)) if (row == eos).any() else T for row in both]
    want = {k: max(alone[0][1][k], alone[1][1][k]) for k in counts}
    print(f"{tier} B=2 exact K=3: eos {eos} ends row {early} at step {step}; rows end at {ends}; "
          f"launches {counts} (each row without the other: {alone[0][1]}, {alone[1][1]})")
    if ends[0] == ends[1]:
        raise AssertionError(f"{tier} B=2: both rows end at step {ends[0]}")
    for row in (0, 1):
        if not np.array_equal(both[row], alone[row][0][0]):
            raise AssertionError(
                f"{tier} B=2: row {row} {both[row]} differs from the row without the other "
                f"{alone[row][0][0]}")
    if counts != want or not counts["K3" if int8_kv else "K1"]:
        raise AssertionError(f"{tier} B=2: launch counts {counts} != {want}")


def end_to_end() -> dict:
    """The main paths at full width and depth: LlavaEngine.generate at
    LLaVA-1.5-7B with synthetic bf16 weights and a bf16 cache, then with
    synthetic int8 fused weights and an int8 cache, then with synthetic
    packed int4 fused weights, an int8 head and an int8 cache;
    LlavaNextEngine.generate at LLaVA-v1.6-Mistral-7B with synthetic bf16
    weights.  Returns each
    kernel's launch count from the exact K=3 run of the path that runs it."""
    import gc

    import numpy as np

    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
    from dropoutdecoding_tpu_torch.models import llavanext
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils.config import EnsembleConfig, LlavaConfig, LlavaNextConfig
    from dropoutdecoding_tpu_torch.utils.convert import (
        synthetic_int4_lm,
        synthetic_int8_lm,
        synthetic_llava_params,
        synthetic_llavanext_params,
    )

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    cfg = LlavaConfig()  # LLaVA-1.5-7B: Vicuna-7B + CLIP ViT-L/336
    rng = np.random.default_rng(11)
    ids = rng.integers(2, 32000, size=(1, 20))
    ids[0, 0], ids[0, 5] = 1, cfg.image_token_index  # BOS; "USER: <image> ..."
    pixels = rng.normal(size=(1, 3, 336, 336)).astype(np.float32)

    def llava(params, int8_kv):
        return lambda ensemble, gen: LlavaEngine(
            cfg=cfg, params=params, gen=gen, max_len=1152, ensemble=ensemble, int8_kv=int8_kv
        )  # 1152 = 576 + 64 + 512

    params, secs = _sync_time(lambda: synthetic_llava_params(cfg, "cuda", torch.bfloat16, seed=0))
    print(f"synthetic 7B params: {torch.cuda.memory_allocated() / 2**30:.2f} GiB in {secs:.1f} s")
    drive(llava(params, False), (ids, pixels), "bf16")
    batch_of_two(cfg, params, "bf16", int8_kv=False)

    # free the bf16 tower before the int8 one exists; keep vision + projector
    vision, projector = params.vision, params.projector
    del params
    free()
    lm, secs = _sync_time(lambda: synthetic_int8_lm(cfg.text, "cuda", seed=0))
    params = LlavaParams(vision, projector, lm)
    print(f"synthetic int8 7B params: {torch.cuda.memory_allocated() / 2**30:.2f} GiB in {secs:.1f} s")
    int8 = drive(llava(params, True), (ids, pixels), "int8", int8_kv=True)
    batch_of_two(cfg, params, "int8", int8_kv=True)
    del params, lm
    free()
    lm, secs = _sync_time(lambda: synthetic_int4_lm(cfg.text, "cuda", seed=0))
    params = LlavaParams(vision, projector, lm)
    print(f"synthetic int4 7B params: {torch.cuda.memory_allocated() / 2**30:.2f} GiB in {secs:.1f} s")
    int4 = drive(llava(params, True), (ids, pixels), "int4", int8_kv=True, int4=True)
    del params, vision, projector, lm
    free()

    # LLaVA-NeXT: one COCO-sized 640 x 480 photo, 5 tiles of 336 px
    ncfg = LlavaNextConfig()  # LLaVA-v1.6-Mistral-7B: Mistral-7B + CLIP ViT-L/336
    size = (480, 640)
    n_tiles = llavanext.image_geometry(size, ncfg)["n_tiles"]
    tiles = rng.normal(size=(n_tiles, 3, 336, 336)).astype(np.float32)
    params, secs = _sync_time(
        lambda: synthetic_llavanext_params(ncfg, "cuda", torch.bfloat16, seed=0)
    )
    print(f"synthetic NeXT 7B params: {torch.cuda.memory_allocated() / 2**30:.2f} GiB in "
          f"{secs:.1f} s; {n_tiles} tiles")
    ens = EnsembleConfig(mask_accumulate=False, topk=10)  # the reference's NeXT settings
    nxt = drive(
        lambda ensemble, gen: LlavaNextEngine(
            cfg=ncfg, params=params, ens=ens, gen=gen, seed=506, ensemble=ensemble,
            max_len=llavanext.max_image_tokens(ncfg) + 64 + 512,
        ),
        (ids, tiles, size),
        "next",
    )
    del params
    free()
    return {
        "K1": nxt["K1"], "K2": nxt["K2"], "K3": int8["K3"], "K4": int8["K4"], "K5": nxt["K5"],
        "K6": int4["K6"],
    }


# llava-hf/llava-1.5-7b-hf's config.json as published (the core dims of its
# Vicuna-7B text_config are transformers' LlamaConfig defaults, left out)
LLAVA_7B_HF_CONFIG = {
    "architectures": ["LlavaForConditionalGeneration"],
    "ignore_index": -100,
    "image_token_index": 32000,
    "model_type": "llava",
    "pad_token_id": 32001,
    "projector_hidden_act": "gelu",
    "text_config": {
        "_name_or_path": "lmsys/vicuna-7b-v1.5",
        "architectures": ["LlamaForCausalLM"],
        "max_position_embeddings": 4096,
        "model_type": "llama",
        "rms_norm_eps": 1e-05,
        "torch_dtype": "float16",
        "vocab_size": 32064,
    },
    "tie_word_embeddings": False,
    "torch_dtype": "float16",
    "transformers_version": "4.36.0.dev0",
    "vision_config": {
        "hidden_size": 1024,
        "image_size": 336,
        "intermediate_size": 4096,
        "model_type": "clip_vision_model",
        "num_attention_heads": 16,
        "num_hidden_layers": 24,
        "patch_size": 14,
        "projection_dim": 768,
        "vocab_size": 32000,
    },
    "vision_feature_layer": -2,
    "vision_feature_select_strategy": "default",
    "vocab_size": 32064,
}
# and its preprocessor_config.json (CLIPImageProcessor at 336 px)
LLAVA_7B_HF_PREPROCESSOR = {
    "crop_size": {"height": 336, "width": 336},
    "do_center_crop": True,
    "do_convert_rgb": True,
    "do_normalize": True,
    "do_rescale": True,
    "do_resize": True,
    "image_mean": [0.48145466, 0.4578275, 0.40821073],
    "image_processor_type": "CLIPImageProcessor",
    "image_std": [0.26862954, 0.26130258, 0.27577711],
    "processor_class": "LlavaProcessor",
    "resample": 3,
    "rescale_factor": 0.00392156862745098,
    "size": {"shortest_edge": 336},
}


def _hf_tensors(cfg, params) -> list:
    """The inverse of ``models.llava.params_from_hf``: [(HF name, shape,
    make)] in the real checkpoint's (pre-4.52) key layout, ``make()``
    giving the tensor on the params' device.  Vision tower first, then the
    LM layer by layer, as the published shards are ordered."""
    vc, tc = cfg.vision, cfg.text
    vis, proj, lm = params
    out = []

    def add(name, make):
        out.append((name, tuple(make().shape), make))  # views: no copy for the shape

    v = "vision_tower.vision_model."
    D, P = vc.hidden_size, vc.patch_size
    add(v + "embeddings.class_embedding", lambda: vis["class_embedding"])
    add(v + "embeddings.patch_embedding.weight",
        lambda: vis["patch_embedding"].t().reshape(D, 3, P, P))
    add(v + "embeddings.position_embedding.weight", lambda: vis["position_embedding"])
    add(v + "pre_layrnorm.weight", lambda: vis["pre_ln_w"])
    add(v + "pre_layrnorm.bias", lambda: vis["pre_ln_b"])
    vl = vis["layers"]
    for i in range(vc.num_hidden_layers):
        e = f"{v}encoder.layers.{i}."
        for hf, ours in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
            add(f"{e}{hf}.weight", lambda o=ours, i=i: vl[f"{o}_w"][i])
            add(f"{e}{hf}.bias", lambda o=ours, i=i: vl[f"{o}_b"][i])
        for hf, ours in (("self_attn.q_proj", "q"), ("self_attn.k_proj", "k"),
                         ("self_attn.v_proj", "v"), ("self_attn.out_proj", "out"),
                         ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            add(f"{e}{hf}.weight", lambda o=ours, i=i: vl[f"{o}_w"][i].t())
            add(f"{e}{hf}.bias", lambda o=ours, i=i: vl[f"{o}_b"][i])
    add(v + "post_layernorm.weight", lambda: torch.ones_like(vis["pre_ln_w"]))  # unused by LLaVA
    add(v + "post_layernorm.bias", lambda: torch.zeros_like(vis["pre_ln_b"]))
    for j in (1, 2):
        add(f"multi_modal_projector.linear_{j}.weight", lambda j=j: proj[f"fc{j}_w"].t())
        add(f"multi_modal_projector.linear_{j}.bias", lambda j=j: proj[f"fc{j}_b"])
    add("language_model.model.embed_tokens.weight", lambda: lm["embed_tokens"])
    ll = lm["layers"]
    for i in range(tc.num_hidden_layers):
        e = f"language_model.model.layers.{i}."
        add(e + "input_layernorm.weight", lambda i=i: ll["input_ln"][i])
        add(e + "post_attention_layernorm.weight", lambda i=i: ll["post_attn_ln"][i])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            add(f"{e}self_attn.{name}.weight", lambda n=name, i=i: ll[n][i].t())
        for name in ("gate_proj", "up_proj", "down_proj"):
            add(f"{e}mlp.{name}.weight", lambda n=name, i=i: ll[n][i].t())
    add("language_model.model.norm.weight", lambda: lm["norm"])
    add("language_model.lm_head.weight", lambda: lm["lm_head"].t())
    return out


_ST_NAMES = {torch.bfloat16: "BF16", torch.float32: "F32", torch.float16: "F16"}


def write_hf_checkpoint(path, cfg, params, config: dict, shards: int = 3) -> int:
    """``params`` written as an HF LLaVA checkpoint directory: ``config``
    as config.json, the 336 px preprocessor_config.json, and the tensors in
    ``shards`` .safetensors files (the format: an 8-byte little-endian
    header length, a JSON header padded to 8 bytes, the raw bytes) with a
    ``model.safetensors.index.json``.  One tensor is on the host at a time.
    Returns the bytes written."""
    import numpy as np

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    px = cfg.vision.image_size  # 336: the published file
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({**LLAVA_7B_HF_PREPROCESSOR, "crop_size": {"height": px, "width": px},
                   "size": {"shortest_edge": px}}, f, indent=2)
    tensors = _hf_tensors(cfg, params)
    dtype = params.lm["embed_tokens"].dtype
    item = torch.empty((), dtype=dtype).element_size()
    sizes = [int(np.prod(shape)) * item for _, shape, _ in tensors]
    # cut into shards of about equal bytes, in order
    bounds, acc, total = [0], 0, sum(sizes)
    for k, size in enumerate(sizes):
        acc += size
        if acc >= total * len(bounds) / shards and len(bounds) < shards:
            bounds.append(k + 1)
    bounds.append(len(tensors))
    weight_map, written = {}, 0
    for s in range(shards):
        name = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = range(bounds[s], bounds[s + 1])
        header, offset = {"__metadata__": {"format": "pt"}}, 0
        for k in part:
            key, shape, _ = tensors[k]
            header[key] = {"dtype": _ST_NAMES[dtype], "shape": list(shape),
                           "data_offsets": [offset, offset + sizes[k]]}
            offset += sizes[k]
            weight_map[key] = name
        blob = json.dumps(header).encode()
        blob += b" " * (-len(blob) % 8)
        with open(os.path.join(path, name), "wb") as f:
            f.write(len(blob).to_bytes(8, "little"))
            f.write(blob)
            for k in part:
                t = tensors[k][2]().to(dtype).contiguous().cpu()
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
        written += 8 + len(blob) + offset
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return written


class _StandInTokenizer:
    """The ``transformers`` tokenizer surface ``VlmProcessor`` uses, over a
    fixed word list: a prompt word's id is a hash of it, "<image>" is
    LLaVA's image token, and an id decodes to a word of ``WORDS``."""

    WORDS = ("a", "dog", "sits", "on", "the", "chair", "next", "to", "table", "with", "cat",
             "and", "person", "car", "near", "bed", "in", "room.")
    eos_token_id = 2

    def __init__(self, image_token_index: int, vocab: int):
        self.image, self.vocab = image_token_index, vocab

    def __call__(self, text, return_tensors="np"):
        import zlib

        import numpy as np

        ids = [1] + [
            self.image if w == "<image>" else 3 + zlib.crc32(w.encode()) % (min(self.vocab, 32000) - 3)
            for w in text.split()
        ]
        return {"input_ids": np.array([ids], np.int64)}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.WORDS[int(i) % len(self.WORDS)] for i in ids
                        if not (skip_special_tokens and int(i) < 3))


def _rss_gib() -> float:
    """This process's resident set (``VmRSS``), GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    raise KeyError("VmRSS")


class _RssPeak:
    """The largest ``VmRSS`` seen while the block runs, read every 10 ms by
    a thread (not every kernel keeps a ``VmHWM``)."""

    def __enter__(self):
        import threading

        self.peak, self._stop = _rss_gib(), threading.Event()

        def poll():
            while not self._stop.wait(0.01):
                self.peak = max(self.peak, _rss_gib())

        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_gib())


def chair_cli(cfg=None, config: dict | None = None, device: str = "cuda", max_new: int = 16,
              check_counts=None) -> dict:
    """The port's CHAIR CLI on a real checkpoint layout: LLaVA-1.5-7B at full
    width and depth with synthetic bf16 weights, written in the HF sharded
    layout (the published config.json, three .safetensors shards and the
    index) under ``.smoke_ckpt/``, loaded through the CLI's own
    ``build_engine`` (no cache), leaves checked bit-equal to what was
    written; then the CLI captions two images with the default Dropout
    Decoding arm and with ``--original`` (``max_new`` tokens, no eos), a
    stand-in tokenizer inside the real ``VlmProcessor`` and
    ``ClipImagePreprocessor``: ``main`` whole where PIL and nltk are
    importable, else ``run_engine`` + ``emit_caption`` per image.  Every
    caption must equal the same engine's ``generate`` called directly, and
    the CLI's run launches K1 32 times a step on ``--original`` and 64 on the
    default arm, K2 once a caption.  ``cfg`` / ``config`` / ``device`` make a
    narrow rehearsal on the CPU possible.  Returns the phase's numbers."""
    import dataclasses
    import importlib.util
    import resource
    import shutil

    import numpy as np

    from dropoutdecoding_tpu_torch.cli import chair_test as cli
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig, LlavaConfig
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_llava_params
    from dropoutdecoding_tpu_torch.utils.processor import ClipImagePreprocessor, VlmProcessor

    cfg = cfg or LlavaConfig()
    config = config or LLAVA_7B_HF_CONFIG
    if LlavaConfig.from_hf_dict(config) != cfg:
        raise AssertionError("config.json does not describe the model written")
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(root, ".smoke_ckpt")  # listed in .gitignore
    cuda = device == "cuda"
    record = {}
    try:
        # --- write the checkpoint, keep a sample of its leaves ---
        params = synthetic_llava_params(cfg, device, torch.bfloat16, seed=0)
        L = cfg.text.num_hidden_layers
        ll = params.lm["layers"]
        sample = {"embed_tokens": params.lm["embed_tokens"].clone(),
                  "lm_head": params.lm["lm_head"].clone(),
                  "patch_embedding": params.vision["patch_embedding"].clone()}
        for i in (0, L - 1):
            for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
                sample[f"{n}[{i}]"] = ll[n][i].clone()
        t0 = time.perf_counter()
        nbytes = write_hf_checkpoint(ckpt, cfg, params, config)
        write_s = time.perf_counter() - t0
        del params, ll
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # --- load through the CLI ---
        args = cli.build_parser().parse_args(
            ["--coco-data-dir", "unused", "--model-path", ckpt, "--image-numbers", "2"])
        rss0 = _rss_gib()
        t0 = time.perf_counter()
        with _RssPeak() as rss:
            engine = cli.build_engine(args, device, cache=False)
            if cuda:
                torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        host_peak = rss.peak
        dev_peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
        lm, ll = engine.params.lm, engine.params.lm["layers"]
        E, H, KH, Dh = cfg.text.hidden_size, cfg.text.num_attention_heads, \
            cfg.text.num_key_value_heads, cfg.text.head_dim
        spans = {"q_proj": (0, H * Dh), "k_proj": (H * Dh, (H + KH) * Dh),
                 "v_proj": ((H + KH) * Dh, (H + 2 * KH) * Dh)}
        got = {"embed_tokens": lm["embed_tokens"], "lm_head": lm["lm_head"],
               "patch_embedding": engine.params.vision["patch_embedding"]}
        for i in (0, L - 1):
            for n, (a, b) in spans.items():
                got[f"{n}[{i}]"] = ll["qkv_proj"][i][:, a:b]  # build_engine fuses q/k/v
            got[f"o_proj[{i}]"] = ll["o_proj"][i]
        unequal = [k for k in sample if not torch.equal(got[k], sample[k])]
        print(f"chair_cli: wrote {nbytes / 2**30:.2f} GiB in 3 shards in {write_s:.1f} s; "
              f"build_engine {load_s:.1f} s, host RSS {rss0:.2f} GiB before, peak {host_peak:.2f} "
              f"GiB during it (ru_maxrss of the run "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB), device peak "
              f"{dev_peak:.2f} GiB; {len(sample)} leaves compared, bit-equal: {not unequal}")
        if unequal:
            raise AssertionError(f"chair_cli: loaded leaves differ from the written ones: {unequal}")
        del got, sample, lm, ll

        # --- caption through the CLI ---
        tok = _StandInTokenizer(cfg.image_token_index, cfg.text.vocab_size)
        processor = VlmProcessor(tok, ClipImagePreprocessor.from_checkpoint(ckpt))
        whole = all(importlib.util.find_spec(m) for m in ("PIL", "nltk"))
        print("chair_cli: " + ("main whole (PIL and nltk importable)" if whole else
                                "run_engine + emit_caption per image (nltk not importable)"))
        from PIL import Image

        rng = np.random.default_rng(17)
        images = [Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8))
                  for _ in range(2)]
        files = [f"COCO_val2014_{i:012d}.jpg" for i in (139, 285)]
        coco = os.path.join(ckpt, "coco")
        if whole:  # main reads JPEGs: the direct runs read the same decoded pixels
            _write_coco(coco, files, images)
            images = [Image.open(os.path.join(coco, "val2014", f)).convert("RGB") for f in files]
        gen = GenerationConfig(max_new_tokens=max_new, eos_token_id=-1, pad_token_id=0)
        wrappers = _wrappers()
        make_engine = cli.make_engine
        for arm, extra in (("dropout decoding", []), ("--original", ["--original", "True"])):
            work = os.path.join(ckpt, "run")
            shutil.rmtree(work, ignore_errors=True)
            os.makedirs(work)
            arm_args = cli.build_parser().parse_args(
                ["--coco-data-dir", coco, "--model-path", ckpt, "--image-numbers", "2",
                 "--seed", "0", "--method", "smoke", "--output-dir", os.path.join(work, "out"),
                 "--sample-save-name", os.path.join(work, "sample.log")] + extra)
            eng = dataclasses.replace(engine, gen=gen, ensemble=not cli.str2bool(arm_args.original))
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            if whole:
                cli.make_engine = lambda a, device="cuda": (eng, processor)
                cwd = os.getcwd()
                os.chdir(work)  # main writes ./vlm_results and ./results
                try:
                    cli.main(arm_args, device=device)
                finally:
                    os.chdir(cwd)
                    cli.make_engine = make_engine
                (captions,) = [f for f in os.listdir(arm_args.output_dir) if f.startswith("smoke")]
                captions = os.path.join(arm_args.output_dir, captions)
            else:
                captions = os.path.join(work, "captions.jsonl")
                for img_file, image in zip(files, images):
                    text = cli.run_engine(eng, processor, "llava-1.5", cli.PROMPTS["llava-1.5"], image)
                    cli.emit_caption(captions, "llava-1.5", img_file, text)
            if cuda:
                torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in wrappers.items()}
            direct = os.path.join(work, "direct.jsonl")
            for img_file, image in zip(files, images):
                inputs = processor(cli.PROMPTS["llava-1.5"], image)
                result = eng.generate(inputs["input_ids"], inputs["pixel_values"])
                cli.emit_caption(direct, "llava-1.5", img_file,
                                 processor.decode(result.tokens[0][: result.num_tokens[0]]))
            recs = sorted((json.loads(line) for line in open(captions)), key=lambda r: r["image_id"])
            same = recs == [json.loads(line) for line in open(direct)]  # files are in id order
            steps = len(files) * (max_new - 1)
            want = {"K1": steps * L * (2 if eng.ensemble else 1), "K2": len(files),
                    "K3": 0, "K4": 0, "K5": 0, "K6": 0}
            print(f"chair_cli {arm}: {len(recs)} captions in {cli_s:.2f} s through the CLI, equal to "
                  f"generate called directly: {same}; launches {counts} (want {want}); "
                  f"first caption: {recs[0]['caption']!r}")
            if not same or len(recs) != len(files):
                raise AssertionError(f"chair_cli {arm}: CLI captions differ from generate's")
            (check_counts or _check_counts)(f"chair_cli {arm}", counts, want)
            record[arm] = {"captions_s": cli_s, "launches": counts}
        record.update(write_s=write_s, load_s=load_s, host_peak_gib=host_peak,
                      device_peak_gib=dev_peak, whole_main=whole)
        return record
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _check_counts(label: str, counts: dict, want: dict) -> None:
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")


def _write_coco(data_dir: str, files: list, images: list) -> None:
    """A COCO directory of ``images`` as ``files`` (JPEG) with caption and
    instance annotations, as ``load_coco_data`` and ``chair_eval`` read it."""
    os.makedirs(os.path.join(data_dir, "val2014"), exist_ok=True)
    os.makedirs(os.path.join(data_dir, "annotations"), exist_ok=True)
    entries = []
    for name, image in zip(files, images):
        image.save(os.path.join(data_dir, "val2014", name), "JPEG")
        entries.append({"id": int(name[-10:-4]), "file_name": name})
    caps = {"images": entries, "annotations": [
        {"id": 10 * e["id"] + j, "image_id": e["id"], "caption": f"a dog on a chair {j}"}
        for e in entries for j in range(2)]}
    inst = {"images": entries, "categories": [{"id": 1, "name": "dog"}, {"id": 2, "name": "chair"}],
            "annotations": [{"id": 900 + k, "image_id": e["id"], "category_id": 1 + k % 2}
                            for k, e in enumerate(entries)]}
    for name, d in (("captions_val2014.json", caps), ("instances_val2014.json", inst)):
        with open(os.path.join(data_dir, "annotations", name), "w") as f:
            json.dump(d, f)


KERNELS = {
    "K1": {
        "name": "ensemble_decode_attention",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:166",
    },
    "K2": {
        "name": "vision_uncertainty",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/uncertainty.cu",
        # and the top-k table XLA made beside it (engine/generate.py:334)
        "replaces": "dropoutdecoding_tpu/ops/pallas_uncertainty.py:101",
    },
    "K3": {
        "name": "ensemble_decode_attention_int8kv",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:234",
    },
    "K4": {
        "name": "cache_append_int8",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/cache_append.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:605",
    },
    "K5": {
        "name": "flash_prefill_attention",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_attention.py:66",
    },
    "K6": {  # and K6', int4_matmul_layered (:177): the same kernel on a layer's view
        "name": "int4_matmul",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_int4_matmul.py:236",
    },
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 checks in full fp32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = identity()
    build()
    records = check_kernels()
    small_reference("fp32")
    small_reference("int8")
    small_reference("int4")
    small_reference("next")
    launches = end_to_end()
    cli_record = chair_cli()
    print(f"chair_cli phase: {json.dumps(cli_record)}; card {card}")
    kernels = [{**KERNELS[k], "launches": launches[k], **records[k]} for k in KERNELS]
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
