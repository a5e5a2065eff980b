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
   M in {1, 3, 4}, H = 32, D = 128, S = 1152 with 620 slots filled, bf16, with
   mask holes that differ by member, at G = 1 and G = 4; the LLaVA-NeXT
   cache, 2947 of 3504 slots, at M = 3 and 4; InstructBLIP's 608-slot cache
   filled to 84 at M = 3 and 4 and M = 1 over 2 and 3 rows, and filled
   whole; 16 and 24 query rows a kv group; B = 2 with
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
   1, 3, 4, 16 and 595 rows in bf16, every call twice for equal bits, the
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
   fp32 whose merged prompt (1320 tokens) runs K5; then the fp32 LLaVA in
   fused mode (K1 at M = 4) with lagged "epis_kl", the "entropy" text mask
   and sampling, all three draw streams injected: tokens must be equal.
   Then the POPE path on the narrow LLaVA, its int4 tier and the narrow
   NeXT (``small_pope``): ``probe`` with ``text_lens`` and ``image_index``,
   ``probe_prefix`` + ``probe_extend`` over dense and int8 prefixes, first
   tokens equal card against CPU and across the modes, last_logits within
   ``POPE_NARROW_RTOL``, launch counts exact.  Then the baselines on the
   narrow LLaVA and NeXT (``small_baselines``): VCD, beam search (nb = 3,
   ``early_stopping`` False and "never") and OPERA (nb = 3, nc = 2, rolling
   back), with injected draws, tokens equal card against CPU, and on LLaVA
   VCD and beam search at B = 2 equal to their rows' B = 1 calls.  Then a
   narrow InstructBLIP (``small_instructblip``): greedy, exact and fused
   K=3 under ``epis_quantile``, exact on an int8 cache (K3, K4), VCD, beam
   search and OPERA (rolling back), and a padded ``probe`` with Q-Former
   masks and ``image_index``, card against CPU, launch counts exact.
5. End to end, greedy, exact K=3 and fused K=3 (one M = 4 forward a step),
   32 new tokens each, with every kernel's launch count checked exactly, and
   that the prefill's K5 and K6 launches took the wgmma kernels: ``LlavaEngine.generate`` at full
   LLaVA-1.5-7B width and depth, first with synthetic bf16 weights and a
   bf16 cache (K1, K2), then synthetic int8 fused weights and an int8 cache
   (K2, K3, K4), on both a batch of two requests too, whose rows stop at
   different steps; then synthetic packed int4 fused weights, an int8 head and
   an int8 cache (K2, K3, K4 and K6 in every projection of every forward);
   then ``LlavaNextEngine.generate`` at full
   LLaVA-v1.6-Mistral-7B width and depth with synthetic bf16 weights and
   one 640 x 480 image (5 tiles, 2340 of 2928 visual slots real), whose
   2947-token prefill runs K5 in every layer (K1 at G=4, K2 with ``valid``).
   On LLaVA-1.5 bf16 and on LLaVA-NeXT, the paper's baselines
   (``baselines_full``): VCD (K1 over 2 rows, two prefills), beam search at
   3 beams (K1 over 3 rows) and OPERA at the CLI's defaults (plain
   ``decode_step_attn``, no K1), launch counts exact, ms a step and device
   peak, beam search's cache reorder and OPERA's attention beside K1.
   On bf16 the same runs go on through the other arms (``LLAVA_RUNS``):
   fused and exact "epis_kl", sampling at top-k 1 (tokens equal to the
   arm's unsampled ones) and at temperature 0.7 / top-p 0.9, and the
   "logits" and "entropy" text masks; then the per-step cost of the
   "epis_kl" keep set and of the top-p sort.  On bf16, int4 and NeXT, POPE
   (``pope_full``): twelve questions on two images through the batched
   ``probe`` (B = 8, two unique images), ``probe`` a row at a time and
   ``probe_prefix`` + ``probe_extend``, agreeing within ``POPE_MODES_RTOL``,
   launch counts exact (no kernel on bf16, K2 none anywhere, K6 128 a
   forward on int4, K5 32 a NeXT prefill and none in its extend), ms a
   question and the device peak of each mode.  Serving at 8 slots
   (``serving_full``, bf16): 12 requests of 32 tokens in three waves, fused
   and exact, against ``generate`` one at a time (ms a step, tokens/s,
   requests/s, device peak; each request equal to its run alone in the
   server; K1 32 / 64 a server step, K2 one a submit); w8a8 on the int8
   weights (``w8a8_full``: prefill ms beside the int8 tier's, the first
   step at which greedy tokens part, an 8-slot step with and without
   ``w8a8_decode``); on NeXT a request joining 7 decoding slots by
   ``submit`` and by ``submit_chunked`` (``serving_next``: the longest gap
   between two tokens of an active slot; K5 32 / 0 in the join).  Then
   InstructBLIP-Vicuna-7B at full width and depth with synthetic bf16 weights
   (``instructblip_full``): greedy / exact / fused K=3 (K1 992 / 1984 /
   992, K2 1, K5 0), a batch of two requests whose rows stop at different
   steps, VCD, beam search and OPERA, the vision tower and the Q-Former on
   their own, and POPE through the batched ``probe`` (B = 8, two unique
   images: the ViT twice, the Q-Former on 8 rows) and a row at a time.
6. The CHAIR CLI (``chair_cli``): LLaVA-1.5-7B at full width and depth,
   synthetic bf16 weights written as an HF checkpoint (published
   config.json, three .safetensors shards and their index), loaded by the
   CLI's ``build_engine`` with its load time, host peak RSS and device
   peak, leaves checked bit-equal; two images captioned through the CLI
   with the default Dropout Decoding arm, ``--original``, ``--vcd``,
   ``--original --num-beams 3`` and ``--opera``, each caption equal to the
   arm's engine call made directly, K1 and K2 launches counted.  Then
   the POPE CLI on the same engine (``pope_cli``): 12 vendored questions a
   strategy, serial, ``--batch-size 8`` and ``--prefix-cache True``, each
   answer archive equal to the same mode's engine calls made directly.
   Then the serve CLI on the same engine (``serve_cli``): ``serve.main``
   over HTTP on 127.0.0.1, three concurrent ``/caption``, one
   ``/caption_stream`` and ``/stats``, captions equal to each request run
   alone in an 8-slot server.  Then the same for InstructBLIP-Vicuna-7B
   (``chair_cli(model="instructblip")``): its config.json and BlipImageProcessor config, a
   stand-in tokenizer pair, the five arms, and the POPE CLI serial and
   batched (its ``--prefix-cache`` must exit with the JAX CLI's message).
7. The harness tools.  ``cli/fused_gap.py``: ``run_study`` (epis),
   ``run_int4_study`` and ``run_int8_study`` on a narrow fp32 LLaVA, card
   against CPU with the same host draws, reports equal
   (``fused_gap_narrow``); the production study at LLaVA-1.5-7B width and
   depth (synthetic int8 weights, int8 KV, K=3, epis, 2 prompts x 24
   tokens, every arm through the engine's own decode loop), then
   ``int4prod`` (1 prompt; ``fused_gap_full``).  ``cli/stall_probe.py`` at 32 layers, a
   one-shot and a 512-token chunked NeXT join (``stall_probe_full``).
   ``cli/baseline_batch_bench.py`` at 32 layers, its batched / serial
   ratios printed, not gated (``baseline_bench_full``).  Launch counts
   exact in each, and in the kernels line beside the kernel's check at the
   tool's shapes.

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
NARROW_EPIS_RTOL = {"fp32": 1e-4, "int8": 1e-3, "int4": 1e-3, "next": 1e-4, "modes": 1e-4,
                    "instructblip": 1e-4}


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


def decode_least_time(args, got, cur) -> tuple[int, dict]:
    """(bytes, bound) of one K1 / K3 call on ``_decode_inputs``' arguments
    with the filled length ``cur``, one for every row or a list of one a
    row: each row's cache and scales are read up to its filled slot, every
    other operand whole; QK^T and PV over the filled slots and the own
    token."""
    q = args[0]
    B, S = q.shape[0], args[-1].shape[-1]
    fills = list(cur) if isinstance(cur, (list, tuple)) else [cur] * B
    cache = sum(t[0].numel() * t.element_size() * n // S for t in args[1:-3] for n in fills)
    nbytes = _nbytes(q, *args[-3:], got) + cache
    return nbytes, least_time(nbytes, 4 * q[0].numel() * sum(n + 1 for n in fills), "bf16")


# the 8 slots of a server step: prompts of 595 tokens that joined at 8
# different steps, from a row just placed to one 31 tokens in
SERVING_FILLS = [595, 626, 603, 611, 596, 619, 607, 624]


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
    case that catches it.  Returns the records of the first case of each,
    of K1's VCD and beam-search cases ("K1 VCD", "K1 beam") and of its four
    InstructBLIP cases ("K1 InstructBLIP", "... fused", "... VCD", "...
    beam")."""
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
        # fused mode's forward at LLaVA-1.5's decode shape: K+1 = 4 members
        ("M=4 G=1 bf16", 1, 4, 32, 32, 128, 1152, 620, bf16, False, True),
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
        # fused mode's forward on LLaVA-NeXT: K+1 = 4 members over the ragged cache
        ("M=4 G=4 bf16 S=3504", 1, 4, 32, 8, 128, 3504, 2947, bf16, False, True),
        # the baselines' decode, M = 1: VCD's clean and noised contexts (2 rows),
        # beam search's 3 beams, on both models
        ("B=2 M=1 G=1 bf16 (VCD)", 2, 1, 32, 32, 128, 1152, 620, bf16, False, True),
        ("B=3 M=1 G=1 bf16 (beam search)", 3, 1, 32, 32, 128, 1152, 620, bf16, False, True),
        ("B=2 M=1 G=4 bf16 S=3504 (VCD)", 2, 1, 32, 8, 128, 3504, 2947, bf16, False, False),
        ("B=3 M=1 G=4 bf16 S=3504 (beam search)", 3, 1, 32, 8, 128, 3504, 2947, bf16, False,
         False),
        # InstructBLIP-Vicuna-7B: the CLI's 608-slot cache, filled to 84 (a 20-token
        # instruction, 32 queries and 32 new tokens): exact, fused, VCD, beam search;
        # then filled to its last slot
        ("M=3 G=1 bf16 S=608 (InstructBLIP)", 1, 3, 32, 32, 128, 608, 84, bf16, False, True),
        ("M=4 G=1 bf16 S=608 (InstructBLIP fused)", 1, 4, 32, 32, 128, 608, 84, bf16, False, True),
        ("B=2 M=1 G=1 bf16 S=608 (InstructBLIP VCD)", 2, 1, 32, 32, 128, 608, 84, bf16, False,
         True),
        ("B=3 M=1 G=1 bf16 S=608 (InstructBLIP beam search)", 3, 1, 32, 32, 128, 608, 84, bf16,
         False, True),
        ("M=3 G=1 bf16 S=608, every slot filled", 1, 3, 32, 32, 128, 608, 608, bf16, True, False),
        # the serving layer's step: 8 slots, each row its own fill (a request
        # joined at its own step), exact and fused
        ("B=8 M=3 G=1 bf16, eight fills (serving)", 8, 3, 32, 32, 128, 1152, SERVING_FILLS, bf16,
         False, True),
        ("B=8 M=4 G=1 bf16, eight fills (serving fused)", 8, 4, 32, 32, 128, 1152, SERVING_FILLS,
         bf16, False, True),
        # the harness tools: fused_gap's production study (a 607-token prompt
        # and 24 tokens in 632 slots), stall_probe's two NeXT slots (a 2367-
        # token prompt in 2992 slots, fused M = 4), baseline_batch_bench's
        # batched VCD (2 x 4 rows) and beam search (2 x 3 rows) over 640 slots
        ("M=3 G=1 bf16 S=632 (fused_gap)", 1, 3, 32, 32, 128, 632, 615, bf16, False, True),
        ("B=2 M=4 G=4 bf16 S=2992 (stall_probe)", 2, 4, 32, 8, 128, 2992, [2395, 2371], bf16,
         False, True),
        ("B=8 M=1 G=1 bf16 S=640 (batched VCD)", 8, 1, 32, 32, 128, 640, 620, bf16, False, True),
        ("B=6 M=1 G=1 bf16 S=640 (batched beam search)", 6, 1, 32, 32, 128, 640, 620, bf16, False,
         True),
    ]
    recorded = {  # the cases whose records the kernels line carries, by label
        "K1": {"M=3 G=1 bf16": "K1", "M=1 G=1 bf16": "K1 speculative draft",
               "B=2 M=1 G=1 bf16 (VCD)": "K1 VCD",
               "B=3 M=1 G=1 bf16 (beam search)": "K1 beam",
               "M=3 G=1 bf16 S=608 (InstructBLIP)": "K1 InstructBLIP",
               "M=4 G=1 bf16 S=608 (InstructBLIP fused)": "K1 InstructBLIP fused",
               "B=2 M=1 G=1 bf16 S=608 (InstructBLIP VCD)": "K1 InstructBLIP VCD",
               "B=3 M=1 G=1 bf16 S=608 (InstructBLIP beam search)": "K1 InstructBLIP beam",
               "B=8 M=3 G=1 bf16, eight fills (serving)": "K1 serving",
               "B=8 M=4 G=1 bf16, eight fills (serving fused)": "K1 serving fused",
               "B=8 M=1 G=1 bf16 S=640 (batched VCD)": "K1 baseline_batch_bench VCD",
               "B=6 M=1 G=1 bf16 S=640 (batched beam search)": "K1 baseline_batch_bench beam"},
        "K3": {"M=3 G=1 bf16": "K3", "M=3 G=1 bf16 S=632 (fused_gap)": "K3 fused_gap",
               "B=2 M=4 G=4 bf16 S=2992 (stall_probe)": "K3 stall_probe"},
    }
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
            if label in recorded[name]:
                records[recorded[name][label]] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None,
                }
    if failed:
        raise AssertionError(f"out of bounds, or two calls that differ: {failed}")
    return records


def check_kernels() -> dict:
    """Each kernel against its plain twin on the card; returns the JSON
    records of the slice-shape cases, keyed by kernel."""
    records = check_decode_attention()
    records.update(check_cache_append())
    records.update(check_flash_prefill())
    records["K6"] = check_int4_matmul()
    # a draft step of the int4 self-draft: R = 1; its prefill R = 595
    records["K6 speculative draft"] = {**records["K6"].pop("r1"),
                                       "prefill": records["K6"]["prefill"]}

    records.update(check_uncertainty())
    # the harness tools' calls at shapes checked above: fused_gap's prefill
    # table [1, 576, 32064] k = 5 and its one-row append, its int4 tower's
    # products (R = 595 and R <= 4)
    records["K2 fused_gap"] = records["K2"]
    records["K4 fused_gap"] = records["K4"]
    records["K6 fused_gap int4prod"] = records["K6"]
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
    Returns the records of the first case ("K2"), of InstructBLIP's ("K2
    InstructBLIP") and of LLaVA-NeXT's ("K2 stall_probe")."""
    from dropoutdecoding_tpu_torch.ops.cuda_uncertainty import (
        exact_top_k_ids,
        launch_phases,
        vision_uncertainty_fused,
        vision_uncertainty_twin,
    )

    records, failed = {}, []
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
        if i in (0, 4):
            records["K2" if i == 0 else "K2 InstructBLIP"] = {
                "kernel_route": route, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bound, "two_reads_ms": two_reads_ms, "library_ms": None, **extra,
            }
        if i == 2:
            records["K2"]["next"] = {"ms": ms, "two_reads_ms": two_reads_ms, **extra}
            records["K2 stall_probe"] = {  # stall_probe's NeXT prefills
                "kernel_route": route, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bound, "two_reads_ms": two_reads_ms, "library_ms": None, **extra,
            }
        del logits, got, again, ref
    if failed:
        raise AssertionError(f"K2: {failed}")
    return records


def check_cache_append() -> dict:
    """K4 against its twin from the same random int8 cache: the whole q and
    s buffers must be bit-equal.  Returns the records of the 7B-shape case
    ("K4") and of its B = 2 case ("K4 stall_probe": the probe's two slots)."""
    from dropoutdecoding_tpu_torch.ops.cuda_cache_append import (
        cache_append_floor,
        cache_append_int8,
        cache_append_int8_twin,
    )

    records = {}
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
        if i in (0, 1):
            # the launch floor: the same grid, cur_len read, a word a warp written
            words = cache_append_floor(cur_len, L, KH)
            if not bool((words.view(2, L, B, KH) == cur_len.view(1, 1, B, 1)).all()):
                raise AssertionError("K4 floor kernel: wrong words")
            floor_ms = time_ms(lambda: cache_append_floor(cur_len, L, KH))
            print(f"K4 {label}: launch floor {floor_ms * 1e3:.1f} us")
            # the new rows read; the int8 rows and their scales written
            written = 2 * L * B * KH * (D + 4)
            records["K4" if i == 0 else "K4 stall_probe"] = {
                "launch_floor_ms": floor_ms,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **least_time(_nbytes(k_new, v_new, cur_len) + written, 8 * k_new.numel(), "fp32"),
                "library_ms": None,
            }
    return records


def check_flash_prefill() -> dict:
    """K5 against its twin: the LLaVA-NeXT prefill shape with a padded key
    tail, at G = 4 and G = 1 in bf16 and in fp32; on the wgmma kernel (bf16,
    D = 128) also S = 1024 and 1025, B = 2 with two different key-mask
    tails, B = 8 with eight (NeXT's batched POPE probe), and rows with no attendable key (masked leading keys: the twin's
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
    records of the main path's NeXT prefill (the first case) and of
    stall_probe's one-shot join, by kernels-line key."""
    from dropoutdecoding_tpu_torch.ops.attention import chunked_prefill_attention
    from dropoutdecoding_tpu_torch.ops.cuda_flash_prefill import flash_prefill_attention

    records = {}
    recorded = {"S=2950 G=4 bf16": "K5", "S=2955 G=4 bf16 (stall_probe)": "K5 stall_probe"}
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (label, B, S, H, KH, D, dtype, real keys per row of B, masked leading keys, kernel)
        ("S=2950 G=4 bf16", 1, 2950, 32, 8, 128, bf16, [2362], 0, "wgmma"),
        # stall_probe's 600 x 800 image: 27 text and 2340 of 2928 visual slots real
        ("S=2955 G=4 bf16 (stall_probe)", 1, 2955, 32, 8, 128, bf16, [2367], 0, "wgmma"),
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
        # NeXT's batched POPE probe: eight rows on two images, each its own key tail
        ("B=8 S=2950 G=4 bf16, eight key tails", 8, 2950, 32, 8, 128, bf16,
         [2357, 2360, 2362, 2358, 2161, 2164, 2166, 2160], 0, "wgmma"),
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
        timed = S in (2950, 2955) and H == 32
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
        if label in recorded:
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
            records[recorded[label]] = {
                "kernel_route": kernel, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **least_time(_nbytes(q, k, v, mask, got), flops, "bf16"), "library_ms": library_ms,
            }
    return records


def check_int4_matmul() -> dict:
    """K6 against its twin, with uniform bytes (every nibble value, -8
    included) and varied scales: the four projection shapes of a 7B layer
    at the row counts of the main path (1 and 3 in the decode forwards, 595
    in the prefill), at 16, the last of the whole-tile kernel, and at 128,
    POPE's extend (8 tails of 16 tokens), in bf16,
    every call made twice with equal bits and o made again after gate_up, a bf16 input with an fp32 output (also at an
    int4 head's shape, whose 32064 channels end inside a tile), fp32 inputs
    at the narrow model's shapes, a ragged shape (43 groups of 32 a half, E
    = 130) on every mma.sync tile shape, and K6': layer 17 of a stacked
    [32, D/2, E] weight passed as a view, which must be read in place.  The
    cases over 16 rows must take the wgmma kernel: the four shapes at R =
    128 and 595, the o projection also at R = 17, 64, 128 and 600, a batched
    [2, 595, 4096] x and POPE's batched probe's [8, 616, 4096], a layer's
    view and the head at R = 576.  Beside each 7B case the time of
    ``torch.matmul`` of x
    with a bf16 matrix dequantized ahead of time (reference only; the port
    never makes that matrix).  Returns the record of the fused gate/up
    projection at 3 rows, the exact-mode decode's, with the same projection
    at 595 rows under "prefill" and at 1 row (a speculative draft step)
    under "r1"."""
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

    record, prefill, kept, draft_step = None, None, None, None
    shapes = [  # the fused leaves of a Vicuna-7B layer: (name, D, E)
        ("qkv", 4096, 12288), ("o", 4096, 4096), ("gate_up", 4096, 22016), ("down", 11008, 4096),
    ]
    for name, D, E in shapes:
        q4, s4 = packed(D=D, E=E, group=128)
        dense = dequantize_matrix_int4({"q4": q4, "s4": s4}, torch.bfloat16)
        # 4: fused mode's decode forward, B·(K+1) rows; 16: the whole-tile kernel's last;
        # 128: POPE's extend, 8 tails of 16 tokens
        for R in (1, 3, 4, 16, 128, 595):
            x = torch.randn(R, D, generator=g, device="cuda").to(torch.bfloat16)
            route = "wgmma" if R > 16 else "tiles"
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
            if (name, R) == ("gate_up", 1):  # a draft step of the int4 self-draft
                draft_step = rec
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
            # tile's edge, a ragged last tile, whole tiles, and batched x (the
            # second at POPE's batched probe: 8 right-padded rows of about 600)
            for lead in ((17,), (64,), (128,), (600,), (2, 595), (8, 616)):
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
    return {**record, "prefill": prefill, "r1": draft_step}


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


def _sharpen(part, factor: float):
    """``part`` (a tensor, or dicts and lists of them) with every matrix
    scaled by ``factor``, so that a narrow model's logits are sharp enough
    for argmax to be stable against summation order; vectors (norms,
    biases) kept."""
    if isinstance(part, dict):
        return {k: _sharpen(v, factor) for k, v in part.items()}
    if isinstance(part, list):
        return [_sharpen(v, factor) for v in part]
    return part * factor if part.dim() >= 2 else part


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
    982 of 1312 visual slots real), whose 1320-token prefill runs K5;
    "modes" is the fp32 LLaVA in fused mode (K1 at M = 4) with lagged
    "epis_kl", the "entropy" text mask and sampling (temperature 0.7, top-k
    5, top-p 0.9), its greedy run sampled too, with the text-mask draws and
    the Gumbel noise injected from tables as well.  A CPU prefill in fp64
    anchors the epis of both sides, so a miss shows which side moved.
    "pope" is the POPE path on the narrow models (``small_pope``);
    "baselines" VCD, beam search and OPERA on them (``small_baselines``);
    "speculative" speculative greedy decoding (``small_speculative``)."""
    if tier == "pope":
        return small_pope()
    if tier == "baselines":
        return small_baselines()
    if tier == "instructblip":
        return small_instructblip()
    if tier == "serving":
        return small_serving()
    if tier == "speculative":
        return small_speculative()
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
        if tier == "modes":
            kw = dict(ens=EnsembleConfig(fused_step=True, mask_policy="epis_kl"),
                      text_mask_policy="entropy")

    # x10: std 0.2.  The narrow NeXT takes x5: at x10 one visual token's fp32
    # epis lands 3.6e-3 from the fp64 one on the CPU (1.1e-3 of the scale),
    # at x5 1.6e-5 (3.1e-5 of the scale).
    factor = 5 if tier == "next" else 10
    params = Params(*(_sharpen(p, factor) for p in params))
    if tier in ("int8", "int4"):
        quantize = quantize_llama_params if tier == "int8" else quantize_llama_params_int4
        params = params._replace(lm=fuse_projections(quantize(params.lm)))
    ids = np.array([[1, 17, 29, image, 41, 53, 67, 71, 83]])
    N = Engine(cfg=cfg, params=params, max_len=max_len, **kw).n_visual
    draws = torch.from_numpy(rng.random((16, 1, 3, N), dtype=np.float32))
    text_draws = torch.from_numpy(rng.random((16, 1, max_len), dtype=np.float32))
    noise = -torch.log(-torch.log(torch.from_numpy(
        rng.random((16, 1, cfg.text.vocab_size), dtype=np.float32)).clamp(min=1e-38)))
    sampled = dict(do_sample=True, temperature=0.7, top_k=5, top_p=0.9) if tier == "modes" else {}
    gen = GenerationConfig(max_new_tokens=12, eos_token_id=-1, pad_token_id=0, **sampled)
    out = {}
    flash_prefill_attention.launches = 0
    K1 = _wrappers()["K1"]
    for device in ("cuda", "cpu"):
        p = Params(*(_to(part, device) for part in params))
        for ensemble in (False, True):
            eng = Engine(
                cfg=cfg, params=p, gen=gen, max_len=max_len, ensemble=ensemble,
                uniform=lambda step, row, m, n: draws[step, row, m, :n],
                text_uniform=lambda step, row, n: text_draws[step, row, :n],
                gumbel=lambda step, row, n: noise[step, row, :n], **kw,
            )
            state = eng.prefill(ids, *images)
            valid = state.visual_mask.cpu()
            K1.launches = 0
            out[device, ensemble] = (eng.generate(ids, *images).tokens, state.epis.cpu()[valid])
            if tier == "modes" and device == "cuda" and ensemble:  # one M = K + 1 forward a step
                want = (gen.max_new_tokens - 1) * cfg.text.num_hidden_layers
                print(f"narrow modes fused: K1 launched {K1.launches} times (want {want})")
                if K1.launches != want:
                    raise AssertionError(f"narrow modes: K1 launches {K1.launches} != {want}")
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
        label = ("fused K=3" if tier == "modes" else "exact K=3") if ensemble else "greedy"
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


def small_baselines() -> None:
    """The paper's baselines on the narrow fp32 LLaVA and the narrow NeXT, on
    the card (kernels) and on the CPU (plain twins), with one table of
    injected draws (VCD's pixel noise and Gumbel noise): VCD at B = 1, beam
    search at nb = 3 with ``early_stopping`` False and "never", OPERA at nb =
    3, nc = 2 (the candidate fan-out) with a threshold of 2, at which the
    search rolls back at step 1; on LLaVA also VCD and beam search at B = 2,
    each row equal to its own B = 1 call.  Tokens must be equal, card
    against CPU; the card's launches are printed."""
    import numpy as np

    from dropoutdecoding_tpu_torch.decoding.vcd import diffusion_noise
    from dropoutdecoding_tpu_torch.engine import baselines, opera
    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
    from dropoutdecoding_tpu_torch.models import llavanext
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig
    from dropoutdecoding_tpu_torch.utils.convert import (
        synthetic_llava_params,
        synthetic_llavanext_params,
    )

    rng = np.random.default_rng(9)
    T = 12

    cfg, ncfg = _narrow_config(), _narrow_next_config()
    models = {
        "llava": (LlavaEngine, LlavaParams(*(
            _sharpen(p, 10) for p in synthetic_llava_params(cfg, "cpu", torch.float32, 3))), cfg,
            128, 500),
        "next": (LlavaNextEngine, llavanext.LlavaNextParams(*(
            _sharpen(p, 5) for p in synthetic_llavanext_params(ncfg, "cpu", torch.float32, 3))),
            ncfg, 1344, 120),
    }
    size = (150, 220)
    tiles = rng.normal(size=(llavanext.image_geometry(size, ncfg)["n_tiles"], 3, 112, 112)) \
        .astype(np.float32)
    pixels = rng.normal(size=(2, 3, 112, 112)).astype(np.float32)
    noise = torch.from_numpy(rng.normal(size=tiles.size).astype(np.float32))
    gumbel = -torch.log(-torch.log(torch.from_numpy(
        rng.random((T, 512), dtype=np.float32)).clamp(min=1e-38)))
    opera_kw = dict(num_beams=3, num_attn_candidates=2, threshold=2, scale_factor=50.0,
                    max_rollbacks=3)
    wrappers = _wrappers()
    for name, (Engine, params, mcfg, max_len, image) in models.items():
        ids = np.array([[1, 17, 29, image, 41, 53, 67, 71, 83]])
        out = {}
        for device in ("cuda", "cpu"):
            eng = Engine(
                cfg=mcfg, params=type(params)(*(_to(part, device) for part in params)),
                gen=GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0),
                max_len=max_len, ensemble=False,
                cd_noise=lambda px: diffusion_noise(
                    noise[: px.numel()].reshape(px.shape).to(px.device), px, 500),
                cd_gumbel=lambda step, n, device=device: gumbel[step, :n].to(device),
            )
            if name == "llava":
                images = (pixels[:1],)
                vcd = lambda: baselines.vcd_generate(eng, ids, *images)  # noqa: E731
            else:
                images = (tiles, size)
                vcd = lambda: baselines.vcd_generate(eng, states=(  # noqa: E731
                    eng.prefill(ids, *images),
                    eng.prefill(ids, baselines.noised_pixels(eng, tiles), size)))
            res, stats = {}, {}
            for fn in wrappers.values():
                fn.launches = 0
            res["VCD"] = vcd().tokens
            counts = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
            for es in (False, "never"):
                res[f"beam es={es}"] = baselines.beam_generate(
                    eng, state=eng.prefill(ids, *images), num_beams=3, early_stopping=es).tokens
            res["OPERA"] = opera.opera_generate(eng, state=eng.prefill(ids, *images), stats=stats,
                                                **opera_kw).tokens
            if name == "llava":  # B = 2, each row against its own B = 1 call
                ids2 = np.concatenate([ids, ids])
                res["VCD B=2"] = baselines.vcd_generate(eng, ids2, pixels).tokens
                res["beam B=2"] = baselines.beam_generate(
                    eng, state=eng.prefill(ids2, pixels), num_beams=3).tokens
                serial = {"VCD B=2": [baselines.vcd_generate(eng, ids, pixels[b:b + 1]).tokens[0]
                                      for b in range(2)],
                          "beam B=2": [baselines.beam_generate(eng, ids, pixels[b:b + 1],
                                                               num_beams=3).tokens[0]
                                       for b in range(2)]}
                for key, rows in serial.items():
                    if not np.array_equal(res[key], np.stack(rows)):
                        raise AssertionError(f"narrow {name} {key} on {device}: {res[key]} differs "
                                             f"from the rows' own B = 1 calls {rows}")
            if stats["rollbacks"] < 1:
                raise AssertionError(f"narrow {name} OPERA on {device}: no rollback {stats}")
            out[device] = res
            if device == "cuda":
                print(f"narrow {name} baselines: the card's VCD launched {counts}; OPERA "
                      f"{stats}")
        for key, tok in out["cuda"].items():
            print(f"narrow {name} {key}: card {tok[0].tolist()} cpu {out['cpu'][key][0].tolist()}")
            if not np.array_equal(tok, out["cpu"][key]):
                raise AssertionError(f"narrow {name} {key}: card tokens differ from the CPU twins'")


# small_pope: card against CPU, each mode's last_logits within this share of
# their largest value.  fp32: summation order only, but a single position's
# logits average nothing (the narrow epis checks above hold 1e-4 of theirs, and
# have read 5.3e-4 once); the first card run read 9.1e-5.  A quantized head
# (the int4 tier's is int8) rounds its input to bf16 on each device, so a
# hidden value on a rounding boundary may round apart and move a logit by up to
# a bf16 step of its size: 2^-8.
POPE_NARROW_RTOL = {"fp32": 5e-4, "bf16-rounded head": 2.0**-8}


def _probe_modes(eng, rows, lens, index, images, whole, prefix_len, tails, tail_lens,
                 prefix_only=False):
    """The POPE path's calls on one engine: ``probe`` of right-padded
    ``rows`` (``text_lens`` ``lens``) over the unique ``images`` (a tuple of
    the engine's image arguments, lists or arrays, image 0 first) by
    ``index``; ``probe`` of the ``whole`` rows (ids, lens) on image 0; and
    ``probe_prefix`` of their first ``prefix_len`` ids + ``probe_extend`` of
    their ``tails`` (with ``prefix_only``, these two alone).  Returns
    ({mode: result}, {mode: launches by kernel})."""
    wrappers = _wrappers()
    first = tuple(a[:1] for a in images)
    out, counts = {}, {}

    def run(mode, fn):
        for w in wrappers.values():
            w.launches = 0
        out[mode] = fn()
        counts[mode] = {k: w.launches for k, w in wrappers.items()}

    if not prefix_only:
        run("probe", lambda: eng.probe(rows, *images, text_lens=lens, image_index=index))
        run("probe whole", lambda: eng.probe(whole[0], *first, text_lens=whole[1],
                                             image_index=[0] * len(whole[0])))
    run("prefix", lambda: eng.probe_prefix(whole[0][:1, :prefix_len], *first))
    run("extend", lambda: eng.probe_extend(out["prefix"], tails, tail_lens))
    return out, counts


def small_pope() -> None:
    """The POPE path on the narrow fp32 LLaVA, its int4 tier (K6, fp32
    kernel) and the narrow LLaVA-NeXT (merged prompts of 1316-1323 tokens,
    so K5 runs), on the card (kernels) and on the CPU (plain twins), with
    dense and int8 prefix handles: ``probe`` of four right-padded rows over
    two unique images, ``probe`` of three whole rows on one image, and
    ``probe_prefix`` + ``probe_extend`` of their tails (``_probe_modes``).
    First tokens equal card against CPU in every mode, and the whole rows'
    equal to their tails' over the prefix on each device, dense or int8;
    ``last_logits`` card against CPU within ``POPE_NARROW_RTOL`` of their
    scale, by the head's input (over an int8 prefix, the card reads the
    CPU's handle, so both extend over the same bytes).  Launches on the card, exact: K2 none; K5
    once a layer in each NeXT ``probe`` and ``probe_prefix``, none in its
    extend; K6 four a layer in each int4 forward."""
    import numpy as np

    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
    from dropoutdecoding_tpu_torch.models import llavanext
    from dropoutdecoding_tpu_torch.models.llama import LONG_PREFILL, KVCache
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils.convert import (
        synthetic_llava_params,
        synthetic_llavanext_params,
    )
    from dropoutdecoding_tpu_torch.utils.quantize import fuse_projections, quantize_llama_params_int4

    rng = np.random.default_rng(7)

    cfg, ncfg = _narrow_config(), _narrow_next_config()
    base = LlavaParams(*(_sharpen(p, 10) for p in synthetic_llava_params(cfg, "cpu", torch.float32, 3)))
    nparams = llavanext.LlavaNextParams(
        *(_sharpen(p, 5) for p in synthetic_llavanext_params(ncfg, "cpu", torch.float32, 3)))
    sizes = [(150, 220), (100, 230)]  # 5 and 3 tiles
    tiles = [rng.normal(size=(llavanext.image_geometry(s, ncfg)["n_tiles"], 3, 112, 112))
             .astype(np.float32) for s in sizes]
    pixels = rng.normal(size=(2, 3, 112, 112)).astype(np.float32)
    int4 = base._replace(lm=fuse_projections(quantize_llama_params_int4(base.lm)))
    models = {  # name: (engine class, params, config, max_len, unique images)
        "llava": (LlavaEngine, base, cfg, 128, (pixels,)),
        "llava int4": (LlavaEngine, int4, cfg, 128, (pixels,)),
        "next": (LlavaNextEngine, nparams, ncfg, 1344, (tiles, sizes)),
    }
    for name, (Engine, params, mcfg, max_len, images) in models.items():
        t0 = time.perf_counter()
        L, image = mcfg.text.num_hidden_layers, mcfg.image_token_index
        low, high = 2, min(mcfg.text.vocab_size, image)  # ids that are not the image's
        rows = rng.integers(low, high, size=(4, 12))
        rows[:, 0], rows[:, 3] = 1, image
        lens = np.array([12, 7, 9, 10])
        rows[np.arange(12)[None] >= lens[:, None]] = 0
        prefix_len, tail_lens = 5, np.array([8, 3, 6])
        tails = rng.integers(low, high, size=(3, 8))
        tails[np.arange(8)[None] >= tail_lens[:, None]] = 0
        whole = np.zeros((3, prefix_len + 8), np.int64)
        whole[:, :prefix_len], whole[:, prefix_len:] = rows[0, :prefix_len], tails
        whole = (whole, prefix_len + tail_lens)
        res = {}
        for device in ("cuda", "cpu"):
            p = type(params)(*(_to(part, device) for part in params))
            for int8_prefix in (False, True):
                eng = Engine(cfg=mcfg, params=p, max_len=max_len, int8_prefix_cache=int8_prefix)
                res[device, int8_prefix], counts = _probe_modes(
                    eng, rows, lens, np.array([0, 1, 1, 0]), images, whole, prefix_len, tails,
                    tail_lens, prefix_only=int8_prefix)
                if device == "cpu":
                    continue
                # the text ids of each prefill (the extend runs none)
                text = {"probe": rows.shape[1], "probe whole": whole[0].shape[1],
                        "prefix": prefix_len}
                for mode, got in counts.items():
                    long = mode in text and text[mode] - 1 + eng.n_visual >= LONG_PREFILL
                    want = dict.fromkeys(got, 0)
                    want["K5"] = L if long else 0
                    want["K6"] = 4 * L if "int4" in name else 0
                    _check_counts(f"small pope {name} {mode}", got, want)
            if device == "cuda":  # the card's extend over the CPU's int8 handle, below
                card = eng
        handle = res["cpu", True]["prefix"]
        if name == "next":
            handle = (KVCache(*(_to(leaf, "cuda") for leaf in handle[0])),
                      *(t.cuda() for t in handle[1:]))
        else:
            handle = KVCache(*(_to(leaf, "cuda") for leaf in handle))
        same_bytes = card.probe_extend(handle, tails, tail_lens)
        pairs = [(mode, res["cuda", False][mode], res["cpu", False][mode])
                 for mode in ("probe", "probe whole", "extend")]
        pairs.append(("extend over the CPU's int8 prefix", same_bytes, res["cpu", True]["extend"]))
        rtol = POPE_NARROW_RTOL["bf16-rounded head" if "int4" in name else "fp32"]
        for mode, on_card, on_cpu in pairs:
            d = (on_card.last_logits.cpu() - on_cpu.last_logits).abs()
            err, scale = d.max().item(), on_cpu.last_logits.abs().max().item()
            bound = rtol * scale
            print(f"small pope {name} {mode}: card {on_card.first_token.tolist()} cpu "
                  f"{on_cpu.first_token.tolist()}, last_logits err {err:.2e} = {err / scale:.1e} of "
                  f"their scale, by row {[f'{e:.1e}' for e in d.amax(dim=-1).tolist()]} (bound "
                  f"{bound:.2e})")
            if not torch.equal(on_card.first_token.cpu(), on_cpu.first_token) or not err <= bound:
                raise AssertionError(f"small pope {name} {mode}: the card differs from the CPU")
        tokens = {(device, int8, mode): res[device, int8][mode].first_token.tolist()
                  for device in ("cuda", "cpu") for int8 in (False, True)
                  for mode in ("probe whole", "extend") if mode in res[device, int8]}
        if len({tuple(t) for t in tokens.values()}) != 1:
            raise AssertionError(f"small pope {name}: first tokens differ across modes {tokens}")
        print(f"small pope {name}: the whole rows' first tokens equal their tails' over the "
              f"prefix, dense and int8, on both devices: {next(iter(tokens.values()))}; "
              f"{time.perf_counter() - t0:.1f} s")


def _narrow_ib_config():
    from dropoutdecoding_tpu_torch.utils.config import (
        BlipVisionConfig,
        InstructBlipConfig,
        LlamaConfig,
        QFormerConfig,
    )

    return InstructBlipConfig(  # the LM of _narrow_config, 32 queries, 50 ViT tokens
        text=LlamaConfig(
            vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, head_dim=64,
        ),
        vision=BlipVisionConfig(
            hidden_size=128, intermediate_size=256, num_hidden_layers=3, num_attention_heads=4,
            image_size=98, patch_size=14,
        ),
        qformer=QFormerConfig(
            vocab_size=300, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
            intermediate_size=128, cross_attention_frequency=2, encoder_hidden_size=128,
            max_position_embeddings=64,
        ),
    )


# the reference's InstructBLIP arm: epis_quantile masks restored per member, top-10 table
IB_ENS = dict(mask_policy="epis_quantile", mask_accumulate=False, topk=10)
IB_SEED = 5217


def small_instructblip() -> None:
    """A narrow InstructBLIP in fp32 (``_narrow_ib_config``: ViT 3 x 128 on 98
    px in 14 px patches, head dim 32; Q-Former 4 x 64, cross-attention in
    layers 0 and 2; 32 queries; the narrow LLaVA's LM) on the card (kernels)
    and on the CPU (plain twins), with one table of injected draws (the mask
    uniforms, VCD's pixel noise and Gumbel noise): greedy, exact K=3 and
    fused K=3 under ``epis_quantile``, the exact run again with
    ``int8_kv=True`` (K3, K4), VCD, beam search (nb = 3) and OPERA (nb = 3,
    nc = 2, threshold 2: it rolls back), 12 tokens each, tokens equal card
    against CPU; epis within ``NARROW_EPIS_RTOL`` of its scale, an fp64 CPU
    prefill anchoring both; a ``probe`` of four right-padded rows with their
    Q-Former masks over two unique images (``image_index``), first tokens
    equal and last_logits within ``POPE_NARROW_RTOL``.  Launches on the
    card, exact: K1 a layer of every decode forward (none under OPERA, none
    on an int8 cache, where K3 reads and K4 appends once a step), K2 once a
    prefill, K5 and K6 none, nothing in the probe."""
    import numpy as np

    from dropoutdecoding_tpu_torch.decoding.vcd import diffusion_noise
    from dropoutdecoding_tpu_torch.engine import baselines, opera
    from dropoutdecoding_tpu_torch.engine.instructblip_engine import InstructBlipEngine
    from dropoutdecoding_tpu_torch.models.instructblip import InstructBlipParams
    from dropoutdecoding_tpu_torch.utils.config import EnsembleConfig, GenerationConfig
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_instructblip_params

    rng = np.random.default_rng(31)
    cfg, T, max_len = _narrow_ib_config(), 12, 128
    L, N, V = cfg.text.num_hidden_layers, cfg.num_query_tokens, cfg.text.vocab_size
    # the LM x10, as the narrow LLaVA's; the towers x3: at x10 the ViT and the
    # Q-Former make the visual tokens so large that one token's fp32 epis lands
    # 3.3e-3 of the scale from the fp64 one on the CPU, at x3 1.2e-5
    vision, qf, proj, lm = synthetic_instructblip_params(cfg, "cpu", torch.float32, 3)
    params = InstructBlipParams(_sharpen(vision, 3), _sharpen(qf, 3), _sharpen(proj, 3),
                                _sharpen(lm, 10))
    ids, q_ids = np.array([[1, 17, 29, 41, 53, 67, 71, 83]]), np.array([[5, 19, 33, 47, 61]])
    pixels = rng.normal(size=(2, 3, 98, 98)).astype(np.float32)
    draws = torch.from_numpy(rng.random((T, 1, 3, N), dtype=np.float32))
    noise = torch.from_numpy(rng.normal(size=pixels[0].size).astype(np.float32))
    gumbel = -torch.log(-torch.log(torch.from_numpy(
        rng.random((T, V), dtype=np.float32)).clamp(min=1e-38)))
    S = ids.shape[1] + N  # the merged prompt
    # the probe's rows: right-padded ids, their Q-Former ids and masks, two images
    lens, q_lens = np.array([8, 5, 7, 3]), np.array([5, 2, 4, 3])
    rows = np.where(np.arange(8)[None] < lens[:, None], rng.integers(2, V, size=(4, 8)), 0)
    rows[:, 0] = 1
    q_rows = np.where(np.arange(5)[None] < q_lens[:, None], rng.integers(1, 300, size=(4, 5)), 0)
    q_mask = (np.arange(5)[None] < q_lens[:, None]).astype(np.int32)
    image_index = np.array([0, 1, 1, 0])
    gen = GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0)
    runs = {  # label: (ensemble, EnsembleConfig fields, int8_kv)
        "greedy": (False, {}, False), "exact K=3": (True, {}, False),
        "fused K=3": (True, {"fused_step": True}, False), "exact K=3, int8 KV": (True, {}, True),
    }
    wrappers = _wrappers()
    out, epis = {}, {}

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        res = fn()
        return res, {k: w.launches for k, w in wrappers.items() if w.launches}

    for device in ("cuda", "cpu"):
        p = InstructBlipParams(*(_to(part, device) for part in params))

        def make(ensemble, ens=None, int8_kv=False):
            return InstructBlipEngine(
                cfg=cfg, params=p, gen=gen, max_len=max_len, ensemble=ensemble, seed=IB_SEED,
                ens=EnsembleConfig(**{**IB_ENS, **(ens or {})}), int8_kv=int8_kv,
                uniform=lambda step, row, m, n: draws[step, row, m, :n],
                cd_noise=lambda px: diffusion_noise(noise.reshape(px.shape).to(px.device), px, 500),
                cd_gumbel=lambda step, n, device=device: gumbel[step, :n].to(device),
            )

        res, counts = {}, {}
        for label, (ensemble, ens, int8_kv) in runs.items():
            eng = make(ensemble, ens, int8_kv)
            res[label], counts[label] = counted(lambda: eng.generate(ids, pixels[:1], q_ids).tokens)
            epis[device, label] = eng.prefill(ids, pixels[:1], q_ids).epis.cpu()
            want = want_counts(T, L, 2 if ensemble and not ens else 1, S, int8_kv, False)
            want = {k: n for k, n in want.items() if n}
            if device == "cuda":
                _check_counts(f"narrow instructblip {label}", counts[label], want)
        eng = make(False)
        noised = baselines.noised_pixels(eng, pixels[0])[None]
        calls = {
            "VCD": lambda: baselines.vcd_generate(eng, states=(
                eng.prefill(ids, pixels[:1], q_ids), eng.prefill(ids, noised, q_ids))).tokens,
            "beam nb=3": lambda: baselines.beam_generate(
                eng, state=eng.prefill(ids, pixels[:1], q_ids), num_beams=3).tokens,
        }
        for label, call in calls.items():
            res[label], counts[label] = counted(call)
        stats = {}
        res["OPERA"], counts["OPERA"] = counted(lambda: opera.opera_generate(
            eng, state=eng.prefill(ids, pixels[:1], q_ids), stats=stats, num_beams=3,
            num_attn_candidates=2, threshold=2, scale_factor=50.0, max_rollbacks=3).tokens)
        if stats["rollbacks"] < 1:
            raise AssertionError(f"narrow instructblip OPERA on {device}: no rollback {stats}")
        res["probe"], counts["probe"] = counted(lambda: eng.probe(
            rows, pixels, q_rows, text_lens=lens, qformer_attention_mask=q_mask,
            image_index=image_index))
        if device == "cuda":
            for label, want in (("VCD", {"K1": (T - 1) * L, "K2": 2}),
                                ("beam nb=3", {"K1": (T - 1) * L, "K2": 1}),
                                ("OPERA", {"K2": 1}), ("probe", {})):
                _check_counts(f"narrow instructblip {label}", counts[label], want)
            print(f"narrow instructblip: launches on the card {counts}; OPERA {stats}")
        out[device] = res
    wide = InstructBlipParams(*(_to(part, "cpu", torch.float64) for part in params))
    epis64 = InstructBlipEngine(cfg=cfg, params=wide, gen=gen, max_len=max_len, seed=IB_SEED,
                                ens=EnsembleConfig(**IB_ENS)).prefill(
        ids, pixels[:1].astype(np.float64), q_ids).epis
    for label in runs:
        e_g, e_c = epis["cuda", label], epis["cpu", label]
        err = (e_g - e_c).abs().max().item()
        bound = NARROW_EPIS_RTOL["instructblip"] * e_c.abs().max().item()
        print(f"narrow instructblip {label}: epis err {err:.2e} (bound {bound:.2e}); from the fp64 "
              f"prefill: card {(e_g - epis64).abs().max().item():.2e}, cpu "
              f"{(e_c - epis64).abs().max().item():.2e}")
        if not err <= bound:
            raise AssertionError(f"narrow instructblip {label}: epis differs by {err} > {bound}")
    for label, tok in out["cuda"].items():
        ref = out["cpu"][label]
        if label == "probe":
            d = (tok.last_logits.cpu() - ref.last_logits).abs().max().item()
            bound = POPE_NARROW_RTOL["fp32"] * ref.last_logits.abs().max().item()
            same = torch.equal(tok.first_token.cpu(), ref.first_token)
            print(f"narrow instructblip probe: card {tok.first_token.tolist()} cpu "
                  f"{ref.first_token.tolist()}, last_logits err {d:.2e} (bound {bound:.2e})")
            if not same or not d <= bound:
                raise AssertionError("narrow instructblip probe: the card differs from the CPU")
            continue
        print(f"narrow instructblip {label}: card {tok[0].tolist()} cpu {ref[0].tolist()}")
        if not np.array_equal(tok, ref):
            raise AssertionError(f"narrow instructblip {label}: card tokens differ from the CPU's")


def _to(tree, device, float_dtype=None):
    """``tree`` (a dict or list of tensors, nested, or one tensor) on
    ``device``; with ``float_dtype``, its float leaves in it."""
    if isinstance(tree, dict):
        return {k: _to(v, device, float_dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device, float_dtype) for v in tree]
    if float_dtype and tree.is_floating_point():
        return tree.to(device, float_dtype)
    return tree.to(device)


def _wall(fn):
    """(``fn()``, its wall time in s)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


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


def want_counts(T: int, L: int, forwards: int, S: int, int8_kv: bool, int4: bool) -> dict:
    """Each kernel's launches in a ``generate`` of ``T`` tokens on an
    ``L``-layer model whose decode step runs ``forwards`` forwards (greedy
    and fused 1, exact 2) after a prefill of ``S`` tokens."""
    from dropoutdecoding_tpu_torch.models.llama import LONG_PREFILL

    attention = (T - 1) * forwards * L  # every layer of every decode forward
    return {
        "K1": 0 if int8_kv else attention,
        "K2": 1,
        "K3": attention if int8_kv else 0,
        "K4": T - 1 if int8_kv else 0,  # one append per decode step
        "K5": L if S >= LONG_PREFILL else 0,  # every layer of the one prefill
        # the four fused projections of every layer of every forward
        "K6": 4 * L * (1 + (T - 1) * forwards) if int4 else 0,
    }


# the runs of ``drive``: (label, ensemble, EnsembleConfig fields,
# GenerationConfig fields, engine fields, label of the run whose tokens these
# must equal)
GREEDY = ("greedy", False, {}, {}, {}, None)
EXACT = ("exact K=3", True, {}, {}, {}, None)
FUSED = ("fused K=3", True, {"fused_step": True}, {}, {}, None)
TOP_K_1 = {"do_sample": True, "top_k": 1}
LLAVA_RUNS = [
    GREEDY, EXACT, FUSED,
    ("fused K=3, sampled top-k 1", True, {"fused_step": True}, TOP_K_1, {}, "fused K=3"),
    ("exact K=3, sampled top-k 1", True, {}, TOP_K_1, {}, "exact K=3"),
    ("exact epis_kl", True, {"mask_policy": "epis_kl"}, {}, {}, None),
    ("fused epis_kl (lagged)", True, {"fused_step": True, "mask_policy": "epis_kl"}, {}, {}, None),
    ("exact K=3, sampled T 0.7 top-p 0.9", True, {},
     {"do_sample": True, "temperature": 0.7, "top_p": 0.9}, {}, None),
    ("exact K=3, text mask logits", True, {}, {}, {"text_mask_policy": "logits"}, None),
    ("exact K=3, text mask entropy", True, {}, {}, {"text_mask_policy": "entropy"}, None),
]


def drive(make, args, tier: str, runs: list, ens, int8_kv: bool = False,
          int4: bool = False) -> dict:
    """Each of ``runs``: 32 new tokens through the engine's
    ``generate(*args)`` (the main path), ``make(ensemble, gen, ens=...,
    **fields)`` building the engine from ``ens`` with the run's changes,
    with every kernel's launch count set to 0 just before and checked
    exactly just after (greedy and fused mode one forward a step, exact
    two); tokens in range, and equal to those of the run ``same_as`` names
    (a run sampled at top-k 1 and its arm without sampling).  One prefill
    more, hooked, must launch K2 once, give the top-k table
    ``exact_top_k_ids`` gives on its logits, and keep ``image_logits``
    [B, N, V] fp32 under epis_kl (a [B, N, 1] stub otherwise).  Prints each
    run's prefill ms, decode tokens/s and ms a step.  Returns each run's
    launch counts by label."""
    import dataclasses

    import numpy as np

    from dropoutdecoding_tpu_torch.ops.cuda_uncertainty import exact_top_k_ids
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig

    wrappers = _wrappers()
    T = 32
    runs_counts, tokens = {}, {}
    for label, ensemble, ens_kw, gen_kw, fields, same_as in runs:
        gen = GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0, **gen_kw)
        run_ens = dataclasses.replace(ens, **ens_kw)
        fused = ensemble and run_ens.fused_step
        # warm-up at this run's shapes
        make(ensemble, dataclasses.replace(gen, max_new_tokens=3), ens=run_ens,
             **fields).generate(*args)
        eng = make(ensemble, gen, ens=run_ens, **fields)
        L, V = eng.cfg.text.num_hidden_layers, eng.cfg.text.vocab_size
        S = eng._prompt_lengths(*args)[1]  # the merged (padded) prompt
        prefill_s = statistics.median(_sync_time(lambda: eng.prefill(*args))[1] for _ in range(3))
        decode, decode_s = eng.decode, []

        def timed_decode(state):
            out, secs = _sync_time(lambda: decode(state))
            decode_s.append(secs)
            return out

        eng.decode = timed_decode
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        for k in ("K5", "K6"):
            wrappers[k].route_launches = dict.fromkeys(wrappers[k].route_launches, 0)
        result, total_s = _sync_time(lambda: eng.generate(*args))  # the main path
        counts = runs_counts[label] = {k: fn.launches for k, fn in wrappers.items()}
        # the prefill's launches of K5 and K6 that took the wgmma kernels
        wgmma = {k: wrappers[k].route_launches["wgmma"] for k in ("K5", "K6")}
        peak = torch.cuda.max_memory_allocated() / 2**30

        tok = tokens[label] = result.tokens
        if tok.shape != (1, T) or not ((tok >= 0) & (tok < V)).all():
            raise AssertionError(f"{tier} {label}: bad tokens {tok}")
        if same_as is not None and not np.array_equal(tok, tokens[same_as]):
            raise AssertionError(f"{tier} {label}: tokens {tok} differ from {same_as}'s "
                                 f"{tokens[same_as]}")
        hooked = []  # one prefill more, its table held against the plain version's
        eng.on_prefill = lambda logits, st: hooked.append(
            (wrappers["K2"].launches,
             torch.equal(st.topk_ids, exact_top_k_ids(logits, eng.ens.topk)),
             tuple(st.image_logits.shape), st.image_logits.dtype))
        unc = eng.prefill(*args).uncertainty
        eng.on_prefill = None
        n_img = (1, eng.n_visual, V if run_ens.mask_policy == "epis_kl" else 1)
        want_hooked = [(counts["K2"] + 1, True, n_img, torch.float32)]
        if hooked != want_hooked or "topk_ids" in unc:
            raise AssertionError(
                f"{tier} {label}: (K2 launches, table equal to exact_top_k_ids, image_logits "
                f"shape and dtype) of one more prefill {hooked}, want {want_hooked}")
        for key, v in unc.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{tier} {label}: non-finite uncertainty field {key}")
        if unc["epis_uncert_per_token"].shape != (1, eng.n_visual):
            raise AssertionError(
                f"{tier} {label}: epis shape {tuple(unc['epis_uncert_per_token'].shape)}"
            )
        want = want_counts(T, L, 2 if ensemble and not fused else 1, S, int8_kv, int4)
        # every K5 launch, and K6's four projections of every layer of the prefill
        want_wgmma = {"K5": want["K5"], "K6": 4 * L if int4 else 0}
        print(
            f"{tier} {label}: prompt {S} tokens, prefill {prefill_s * 1e3:.1f} ms, decode "
            f"{(T - 1) / decode_s[0]:.2f} tokens/s ({decode_s[0] / (T - 1) * 1e3:.2f} ms/step), "
            f"generate {T / total_s:.2f} tokens/s end to end, peak {peak:.2f} GiB, "
            f"launches {counts} (want {want}), of them on wgmma {wgmma} (want {want_wgmma}); "
            f"tokens {tok[0, :8].tolist()}..."
        )
        _check_counts(f"{tier} {label}", counts, want)
        if wgmma != want_wgmma:
            raise AssertionError(f"{tier} {label}: wgmma launches {wgmma} != {want_wgmma}")
    return runs_counts


def step_costs(n_visual: int, V: int) -> None:
    """The per-step cost of the epis_kl keep set over [1, ``n_visual``, V]
    fp32 visual-token logits beside its byte floor (the logits read once),
    and of sampling's warp (temperature 0.7, top-p 0.9: a sort of the V
    logits) and draw beside the greedy argmax, at one row."""
    from dropoutdecoding_tpu_torch.ops.sampling import sample_token, warp_logits
    from dropoutdecoding_tpu_torch.ops.uncertainty import lowest_percent_kl_indices_mask
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig

    g = torch.Generator(device="cuda").manual_seed(23)
    image = 3.0 * torch.randn(1, n_visual, V, generator=g, device="cuda")
    logits = 3.0 * torch.randn(1, V, generator=g, device="cuda")
    noise = -torch.log(-torch.log(torch.rand(1, V, generator=g, device="cuda").clamp(min=1e-38)))
    gen = GenerationConfig(do_sample=True, temperature=0.7, top_p=0.9)
    kl_ms = time_ms(lambda: lowest_percent_kl_indices_mask(image, logits))
    floor = least_time(_nbytes(image, logits), 0, "fp32")["bound_ms"]
    warp_ms = time_ms(lambda: warp_logits(logits, 0.7, None, 0.9))
    draw_ms = time_ms(lambda: sample_token(logits, noise, gen))
    argmax_ms = time_ms(lambda: logits.argmax(dim=-1))
    del image
    print(f"step costs: epis_kl keep set over [1, {n_visual}, {V}] {kl_ms * 1e3:.1f} us (byte floor "
          f"{floor * 1e3:.1f} us); top-p warp over V = {V} {warp_ms * 1e3:.1f} us, warp + draw "
          f"{draw_ms * 1e3:.1f} us, greedy argmax {argmax_ms * 1e3:.1f} us")


def llava_pair(cfg):
    """Two LLaVA-1.5 requests' ``generate`` arguments (ids [2, 20] with the
    image at 5, pixels [2, 3, 336, 336]) for ``batch_of_two``."""
    import numpy as np

    rng = np.random.default_rng(13)
    ids = rng.integers(2, 32000, size=(2, 20))
    ids[:, 0], ids[:, 5] = 1, cfg.image_token_index
    return ids, rng.normal(size=(2, 3, 336, 336)).astype(np.float32)


def batch_of_two(make, args: tuple, tier: str, int8_kv: bool, seed: int = 24) -> None:
    """Exact K=3 ``generate`` of 16 tokens for two requests in one batch
    (``args``, the two requests' ``generate`` arguments stacked on a
    leading axis; ``make(gen, uniform)`` builds the engine) whose rows stop
    at different steps:
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

    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig
    from dropoutdecoding_tpu_torch.utils.prng import PhiloxUniform

    wrappers = _wrappers()
    T = 16

    def run(rows, eos):
        """(tokens, launch counts) of the rows' batch; row i of it draws the
        streams of request rows[i]."""
        draws = PhiloxUniform(seed, "cuda")
        eng = make(GenerationConfig(max_new_tokens=T, eos_token_id=eos, pad_token_id=0),
                   lambda step, row, m, n: draws(step, rows[row], m, n))
        for fn in wrappers.values():
            fn.launches = 0
        tokens = eng.generate(*(a[rows] for a in args)).tokens
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


# pope_full: the largest |last_logits| difference between two modes of the
# POPE path at full width, as a share of the largest |logit|.  The modes sum
# in other orders: the prefix cache's fp32 attention over the cached keys
# against the prefill's, and over NeXT's padded prefix against the same
# prefix cut to its real length only the key count differs.  A bf16 output
# then rounds to its neighbour now and then, and 32 layers of synthetic
# weights grow those one-step differences: the card read 2.6% (LLaVA-1.5)
# and 3.3% (NeXT) between the prefix cache and the row at a time, 2.8% between
# NeXT's padded and cut prefixes, while the faults this bound is there for
# read 35% (the tails' positions from NeXT's padded length) and 63% (its
# pad slots unmasked; ``next_pad_check`` plants both on every run).  The
# projections are not where the modes part: a bf16 row reads the same from
# a call of 128 rows as from one of 595 (``matmul_row_rounding``; not from
# one of 16), and batched and row at a time agree to the bit.  On int4,
# fewer one-step differences arise (0.07%): 2^-8.
POPE_MODES_RTOL = {"bf16": 2.0**-4, "int4": 2.0**-8, "next": 2.0**-4, "instructblip": 2.0**-4}


def time_extend_attention(cfg, key_mask: torch.Tensor, B: int = 8, T: int = 16) -> float:
    """One layer's plain-torch extend attention (``ops.attention.
    extend_attention``; no kernel: it is plain XLA in the JAX package) at the
    prefix-cached POPE shape: B tails of T tokens over one shared prefix
    whose pad slots ``key_mask`` [1, P] masks, bf16; its time beside its
    bound."""
    from dropoutdecoding_tpu_torch.ops.attention import extend_attention

    H, KH, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(31)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    P = key_mask.shape[1]
    q, kn, vn, kp, vp = rnd(B, T, H, D), rnd(B, T, KH, D), rnd(B, T, KH, D), rnd(1, P, KH, D), rnd(1, P, KH, D)
    mask = key_mask.cuda()
    ms = time_ms(lambda: extend_attention(q, kn, vn, kp, vp, mask))
    ops = 2 * 2 * B * T * H * (P + T) * D  # QK^T and PV
    bound = least_time(_nbytes(q, kn, vn, kp, vp, mask, q), ops, "bf16")
    L = cfg.num_hidden_layers
    print(f"extend attention, plain torch, one layer: B={B} T={T} over P={P}, {int(mask.sum())} real "
          f"(H={H}, KH={KH}, D={D}, bf16): {ms * 1e3:.1f} us (bound {bound['bound_ms'] * 1e3:.1f} us "
          f"by {bound['bound_by']}; {L * ms:.2f} ms over {L} layers)")
    return ms


def matmul_row_rounding() -> dict:
    """Whether a bf16 ``torch.matmul`` row depends on how many rows share its
    call: the first 16 rows of x [595, 4096] @ w [4096, 4096] (a prefill's
    row count) against the same rows from a call of R = 16 and of R = 128
    (POPE's extend).  Returns, by R, the share of outputs that differ and
    the largest difference as a share of the largest |output|."""
    g = torch.Generator(device="cuda").manual_seed(37)
    x = torch.randn(595, 4096, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(4096, 4096, generator=g, device="cuda") / 64).to(torch.bfloat16)
    whole = torch.matmul(x, w)[:16].float()
    out = {}
    for R in (16, 128):
        part = torch.matmul(x[:R], w)[:16].float()
        out[R] = {"share_differing": (part != whole).float().mean().item(),
                  "max_diff_of_max": ((part - whole).abs().max() / whole.abs().max()).item()}
    print(f"bf16 torch.matmul, 16 rows of a 595-row call against the same rows in a call of R "
          f"rows: {out}")
    return out


def pope_questions(image_token: int, vocab: int, seed: int = 19):
    """Twelve POPE prompts as ids, six on each of two images: a template of
    7 ids with the image at 5, a question of 6-11 ids, a suffix of 3 (as
    "USER: <image>\n{question} ASSISTANT:" tokenizes), and the template's
    two probes with one-id questions ("aaaa", "zzzz").  Returns (rows,
    image of each row, the two probes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    template = [1, *rng.integers(2, image_token, size=4), image_token, 13]
    suffix = list(rng.integers(2, image_token, size=3))
    rows = [np.array(template + list(rng.integers(2, min(vocab, image_token), size=n)) + suffix)
            for n in (6, 9, 11, 7, 8, 10, 11, 6, 9, 8, 10, 7)]
    probes = [np.array(template + [q] + suffix) for q in (300, 301)]
    return rows, [i // 6 for i in range(12)], probes


def pope_direct(eng, rows: list, owner: list, pick, template_len: int | None = None,
                tamper=None, q_rows: list | None = None) -> tuple:
    """The POPE CLI's grouped modes as direct engine calls, through
    ``cli.pope_test``'s grouping helpers: ``rows`` of ids, ``owner`` the
    image of each row, ``pick(unique)`` the engine's image arguments (a
    tuple) for a list of images.  Without ``template_len``, ``probe`` over
    groups of 8 right-padded rows with their unique images, a short group
    filled from its last row.  With it, ``probe_prefix`` of each image's
    run's shared prefix (the template's, shrunk until every row of the run
    shares it) and one ``probe_extend`` of the run's tails, bucketed to 8
    rows; ``tamper`` maps each prefix handle before its extend (a planted
    fault).  ``q_rows``: InstructBLIP's Q-Former ids of the rows, right-padded
    by group with their mask as the CLI pads them.  Returns (ProbeResult
    with one row a question, the prefix handles)."""
    import numpy as np

    from dropoutdecoding_tpu_torch.cli import pope_test as pope
    from dropoutdecoding_tpu_torch.engine.generate import ProbeResult

    parts, handles = [], []
    if template_len is None:
        for start in range(0, len(rows), 8):
            index, unique = pope.image_slots(owner[start : start + 8])
            group = pope.fill_rows(rows[start : start + 8], 8)
            q_args, q_kw = (), {}
            if q_rows is not None:
                q_ids, q_kw["qformer_attention_mask"] = pope.pad_rows(
                    pope.fill_rows(q_rows[start : start + 8], 8))
                q_args = (q_ids,)
            res = eng.probe(pope.pad_rows(group)[0], *pick(unique), *q_args,
                            text_lens=np.array([len(r) for r in group], np.int32),
                            image_index=np.asarray(pope.fill_rows(index, 8), np.int32), **q_kw)
            parts.append((res, len(rows[start : start + 8])))
    else:
        for name, start, stop in pope.image_runs(owner):
            run = rows[start:stop]
            k = pope.group_prefix_len(run, template_len)
            handles.append(eng.probe_prefix(run[0][None, :k], *pick([name])))
            handle = handles[-1] if tamper is None else tamper(handles[-1])
            res = eng.probe_extend(handle, *pope.pad_tails([r[k:] for r in run]))
            parts.append((res, stop - start))
    return ProbeResult(torch.cat([r.first_token[:n] for r, n in parts]),
                       torch.cat([r.last_logits[:n] for r, n in parts])), handles


def next_pad_check(eng, rows, owner, pick, template, padded, per_row, bound) -> dict:
    """What is NeXT's own in the prefix cache: its prefix is padded past
    its real length, so the tails' positions must start at the real length
    and the pad slots must be masked.  The extend over each image's padded
    handle (``padded``, the prefix-cache mode's last_logits) against the
    extend over the same handle cut to its real length must stay within
    ``bound`` (the modes' bound: only the attention's key count differs);
    then two faults planted in the handles, the positions started at the
    padded length and the pad slots unmasked, must each read over ``bound``
    against the row-at-a-time probe (``per_row``).  Returns the readings."""

    def cut(handle):  # no pad slots: the padded length is the real length
        kv, real_len, key_mask = handle
        n = int(real_len[0])
        if not key_mask[:, :n].all() or key_mask[:, n:].any():
            raise AssertionError("pope next: the prefix's pad slots are not its last")
        return type(kv)(kv.k[:, :, :n], kv.v[:, :, :n]), real_len, key_mask[:, :n]

    faults = {
        "positions from the padded length":
            lambda h: (h[0], torch.full_like(h[1], h[2].shape[1]), h[2]),
        "pad slots unmasked": lambda h: (h[0], h[1], torch.ones_like(h[2])),
    }
    short = pope_direct(eng, rows, owner, pick, template, cut)[0].last_logits.float()
    err = (padded - short).abs().max().item()
    record = {"padded against cut": err}
    print(f"pope next: extend over the padded prefix against the prefix cut to its real length: "
          f"max |d last_logits| {err:.4f} (bound {bound:.4f})")
    if not err <= bound:
        raise AssertionError("pope next: the prefix's pad changes what the tails read")
    for fault, tamper in faults.items():
        bad = pope_direct(eng, rows, owner, pick, template, tamper)[0].last_logits.float()
        err = (bad - per_row).abs().max().item()
        record[fault] = err
        print(f"pope next, planted fault ({fault}): max |d last_logits| {err:.4f} against "
              f"per-row, {err / bound:.2f}x the bound; first tokens equal "
              f"{int((bad.argmax(-1) == per_row.argmax(-1)).sum())} of 12")
        if not err > bound:
            raise AssertionError(f"pope next: the bound cannot tell '{fault}' from rounding")
    return record


def pope_full(eng, images: tuple, tier: str, want_per_forward: dict) -> dict:
    """POPE at full width and depth on a built engine: the twelve prompts of
    ``pope_questions`` over two ``images`` (a tuple of the engine's image
    arguments for both, lists or arrays), through each mode of the CLI with
    its grouping and padding (``pope_direct``): the batched ``probe`` (B =
    8 right-padded rows, U = 2 unique images, then the short group filled
    to 8 from its last row), ``probe`` a row at a time, and ``probe_prefix``
    of each image's template + one ``probe_extend`` of its six tails
    (bucketed to 8 rows).  Checks: the largest |last_logits| difference
    from the row-at-a-time probe within ``POPE_MODES_RTOL`` of the largest
    |logit|; first tokens equal wherever the top-2 margin exceeds that
    bound; each mode's launches exactly ``want_per_forward`` times its
    prefills (K5) or its forwards (the rest).  On NeXT, ``next_pad_check``.
    Each mode runs once to warm up, then timed.  Returns ms a question by
    mode and the device peak of each."""
    from dropoutdecoding_tpu_torch.cli import pope_test as pope

    wrappers = _wrappers()
    rows, owner, probes = pope_questions(eng.cfg.image_token_index, eng.cfg.text.vocab_size)
    template = pope.template_prefix_len(*probes)
    V = eng.cfg.text.vocab_size

    def pick(unique):  # the engine's image arguments of the unique images
        return tuple([a[u] for u in unique] if isinstance(a, list) else a[unique] for a in images)

    handles = []

    def batched():
        return pope_direct(eng, rows, owner, pick)[0].last_logits, 2, 2

    def per_row():
        out = [eng.probe(r[None], *pick([o])).last_logits for r, o in zip(rows, owner)]
        return torch.cat(out), 12, 12

    def prefix():
        res, handles[:] = pope_direct(eng, rows, owner, pick, template)
        return res.last_logits, 2, 4  # 2 prefills, 4 forwards

    logits, record, t0 = {}, {}, time.perf_counter()
    for mode, fn in (("batched probe", batched), ("per-row probe", per_row), ("prefix + extend", prefix)):
        fn()  # warm-up
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (out, prefills, forwards), secs = _sync_time(fn)
        counts = {k: w.launches for k, w in wrappers.items()}
        want = {k: n * (prefills if k == "K5" else forwards) for k, n in want_per_forward.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        logits[mode] = out.float()
        record[mode] = {"ms_a_question": secs * 1e3 / 12, "launches": counts,
                        "peak_gib": peak, "above_params_gib": peak - base / 2**30}
        print(f"pope {tier} {mode}: {secs * 1e3 / 12:.2f} ms a question ({secs * 1e3:.1f} ms for "
              f"12), device peak {peak:.2f} GiB ({peak - base / 2**30:.2f} above what was "
              f"allocated before), launches {counts} (want {want})")
        _check_counts(f"pope {tier} {mode}", counts, want)
        if out.shape != (12, V) or not torch.isfinite(out).all():
            raise AssertionError(f"pope {tier} {mode}: last_logits {tuple(out.shape)}, not finite")
    if tier == "next":
        record["extend_attention_ms"] = time_extend_attention(eng.cfg.text, handles[0][2])
    if tier == "bf16":  # do the projections part the modes?
        record["matmul row rounding"] = matmul_row_rounding()
    ref = logits["per-row probe"]
    bound = POPE_MODES_RTOL[tier] * ref.abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > bound  # rows whose first token no rounding can move
    for mode in ("batched probe", "prefix + extend"):
        err = (logits[mode] - ref).abs().max().item()
        same = logits[mode].argmax(-1) == ref.argmax(-1)
        print(f"pope {tier} {mode} against per-row: max |d last_logits| {err:.4f} (bound "
              f"{bound:.4f}); first tokens equal {int(same.sum())} of 12, {int(sure.sum())} rows "
              f"with a top-2 margin over the bound, all equal there: {bool(same[sure].all())}")
        if not err <= bound or not same[sure].all():
            raise AssertionError(f"pope {tier} {mode}: modes disagree beyond the bound")
    if tier == "next":
        record["pad"] = next_pad_check(eng, rows, owner, pick, template,
                                       logits["prefix + extend"], ref, bound)
    record["seconds"] = time.perf_counter() - t0
    return record


# OPERA at the CLI's defaults (the reference's arm): 3 beams, one attention
# candidate, scale 5, threshold 15, penalty weight 1
OPERA_CLI = dict(num_beams=3, num_attn_candidates=1, scale_factor=5.0, threshold=15,
                 penalty_weights=1.0)


def _eager_ms(fn, reps: int = 20) -> float:
    """Median wall time of ``fn()`` with the card synchronised before and
    after, in ms: host work included (for calls a graph cannot capture)."""
    return statistics.median(_sync_time(fn)[1] for _ in range(reps)) * 1e3


def baselines_full(make, args, tier: str, noised=None) -> dict:
    """The paper's baselines at full width and depth, 32 new tokens each, no
    eos: VCD, beam search (nb = 3) and OPERA (``OPERA_CLI``), each through
    its entry point with every kernel's launch count set to 0 just before and
    checked exactly just after: K1 32 a decode forward of VCD (2 rows) and
    beam search (3 rows), none in OPERA (``decode_step_attn`` is plain
    torch); K2 one a prefill (two under VCD); K5 32 a prefill from 1024
    tokens (LLaVA-NeXT); the others none.  ``make(ensemble, gen)`` builds the
    engine; ``noised`` is LLaVA-NeXT's noised tile stack (VCD then runs
    through ``states``).  Prints each run's ms a decode step, its device peak
    and tokens; then beam search's cache reorder in ms a step (the rows it
    moved, as the run moved them, against the JAX package's whole-cache
    gather), and ``decode_step_attn``'s plain attention in us a layer beside
    K1's at the same rows.  Returns each run's launch counts."""
    import numpy as np

    from dropoutdecoding_tpu_torch.engine import baselines, opera
    from dropoutdecoding_tpu_torch.models import llama as llama_mod
    from dropoutdecoding_tpu_torch.models.llama import LONG_PREFILL
    from dropoutdecoding_tpu_torch.ops.cuda_decode_attention import ensemble_decode_attention_fused
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig

    wrappers = _wrappers()
    T = 32
    eng = make(False, GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0))
    text = eng.cfg.text
    L, V = text.num_hidden_layers, text.vocab_size
    S = eng._prompt_lengths(*args)[1]  # the merged (padded) prompt
    k5 = L if S >= LONG_PREFILL else 0
    prefill_s = statistics.median(_sync_time(lambda: eng.prefill(*args))[1] for _ in range(2))
    if noised is None:
        vcd = lambda: baselines.vcd_generate(eng, *args)  # noqa: E731
    else:
        vcd = lambda: baselines.vcd_generate(eng, states=(  # noqa: E731
            eng.prefill(*args), eng.prefill(args[0], noised, *args[2:])))
    stats = {}
    runs = {  # label: (call, prefills, decode forwards that run K1)
        "VCD": (vcd, 2, T - 1),
        "beam search nb=3": (lambda: baselines.beam_generate(
            eng, state=eng.prefill(*args), num_beams=3), 1, T - 1),
        "OPERA nb=3 nc=1": (lambda: opera.opera_generate(
            eng, state=eng.prefill(*args), stats=stats, **OPERA_CLI), 1, 0),
    }
    reorder, moved = llama_mod.cache_reorder_rows, []

    def counted_reorder(cache, src, n_live):
        moved.append(int((src != np.arange(len(src))).sum()))
        reorder(cache, src, n_live)

    llama_mod.cache_reorder_rows = counted_reorder
    counts_by_run = {}
    try:
        for label, (call, prefills, k1_forwards) in runs.items():
            moved.clear()
            torch.cuda.reset_peak_memory_stats()
            for fn in wrappers.values():
                fn.launches = 0
            result, secs = _sync_time(call)  # the main path
            counts = counts_by_run[label] = {k: fn.launches for k, fn in wrappers.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            want = dict.fromkeys(wrappers, 0)
            want.update(K1=k1_forwards * L, K2=prefills, K5=prefills * k5)
            tok = result.tokens
            step_ms = (secs - prefills * prefill_s) / (T - 1) * 1e3
            extra = f", reorders moving rows {sum(m > 0 for m in moved)} of {len(moved)} steps" \
                if moved else ""
            extra += f", OPERA {stats}" if label.startswith("OPERA") else ""
            print(f"{tier} {label}: {T} tokens in {secs:.2f} s ({secs / T * 1e3:.1f} ms a token), "
                  f"{prefills} prefill(s) of {prefill_s * 1e3:.1f} ms, {step_ms:.2f} ms a decode "
                  f"step, peak {peak:.2f} GiB, launches {counts} (want {want}){extra}; tokens "
                  f"{tok[0, :8].tolist()}...")
            if tok.shape != (1, T) or not ((tok >= 0) & (tok < V)).all():
                raise AssertionError(f"{tier} {label}: bad tokens {tok}")
            _check_counts(f"{tier} {label}", counts, want)
    finally:
        llama_mod.cache_reorder_rows = reorder

    # beam search's reorder at this model's 3-row cache, S + T slots filled
    H, KH, Dh = text.num_attention_heads, text.num_key_value_heads, text.head_dim
    cache = llama_mod.empty_cache(text, 3, eng.max_len, torch.bfloat16, "cuda")
    n_live = S + T
    ours = {n: _eager_ms(lambda: reorder(cache, np.array(src), n_live))
            for n, src in ((0, [0, 1, 2]), (1, [0, 0, 2]), (2, [0, 0, 1]))}
    idx = torch.tensor([0, 0, 1], device="cuda")
    whole = time_ms(lambda: (cache.k[:, idx], cache.v[:, idx]))
    print(f"{tier} beam-search reorder, ms a step at {n_live} of {eng.max_len} slots: rows moved "
          f"0 / 1 / 2: {ours[0]:.3f} / {ours[1]:.3f} / {ours[2]:.3f} (host included); the JAX "
          f"package's whole-cache gather {whole:.3f} (device)")
    # decode_step_attn's attention against K1 at OPERA's 3 rows, one layer
    g = torch.Generator(device="cuda").manual_seed(3)
    q, kn, vn = (torch.randn(3, h, Dh, generator=g, device="cuda").to(torch.bfloat16)
                 for h in (H, KH, KH))
    kc, vc = cache.k[0].normal_(generator=g), cache.v[0].normal_(generator=g)
    live = torch.arange(eng.max_len, device="cuda")[None, :] < S
    plain = time_ms(lambda: llama_mod.attention_with_probs(
        q, kn, vn, kc[:, :S], vc[:, :S], live[:, :S].expand(3, S)))
    k1 = time_ms(lambda: ensemble_decode_attention_fused(
        q[:, None], kc, vc, kn[:, None], vn[:, None],
        live[:, None].expand(3, 1, eng.max_len).contiguous()))
    print(f"{tier} decode_step_attn's attention at 3 rows over {S} slots: {plain * 1e3:.1f} us a "
          f"layer (plain torch, with the probabilities); K1 at the same rows {k1 * 1e3:.1f} us")
    del cache
    return counts_by_run


SERVE_SLOTS = 8  # the serve CLI's default --slots
SERVE_CHUNK = 8  # and its --step-chunk


def _count_steps(eng) -> list:
    """Count the calls of ``eng._one_step`` (a server step of every slot)
    from now on; returns the counter, a one-element list."""
    n = [0]
    one_step = eng._one_step

    def counted(*args, **kwargs):
        n[0] += 1
        return one_step(*args, **kwargs)

    eng._one_step = counted
    return n


def _staggered(server, reqs: dict) -> dict:
    """The narrow check's joins on a 3-slot server: the first request alone
    for 2 steps, the second joins, a step later the third, the rest as
    slots free; a harvest after every step.  Returns {rid: tokens}."""
    order, results = list(reqs), {}
    server.submit(order[0], *reqs[order[0]])
    server.step(2)
    server.submit(order[1], *reqs[order[1]])
    server.step()
    pending = order[2:]
    while pending or server.active():
        while pending and server.free_slots():
            rid = pending.pop(0)
            server.submit(rid, *reqs[rid])
        server.step()
        results.update(server.harvest())
    return results


def small_serving() -> None:
    """The serving path on the narrow fp32 models, card (kernels) against
    CPU (plain twins), with one table of injected draws: a 3-slot
    ``DecodeServer`` with staggered joins (``_staggered``) on LLaVA in exact
    and fused mode, each request's tokens equal to its solo ``generate`` on
    the card and card equal to CPU; K1 launched L x forwards times a
    server step and K2 once a submit.  Then LLaVA-NeXT: a request joining by
    ``submit_chunked`` (1320 slots in pieces of 256, 2 pumped steps between
    two) while another decodes, against one joining by ``submit``: the
    active slot advanced 10 steps during the chunked join, K5 none in the
    chunked prefill and 2 in the one-shot one, tokens equal to solo and
    card to CPU.  Then w8a8: int8 fused weights with ``w8a8_prefill`` and
    ``w8a8_decode``, the 3-slot server in fused mode (12 decode rows: the
    card's ``torch._int_mm`` takes them zero-padded) and a greedy
    ``generate`` (1 row), card against CPU."""
    import dataclasses

    import numpy as np

    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
    from dropoutdecoding_tpu_torch.engine.serving import DecodeServer
    from dropoutdecoding_tpu_torch.models import llavanext
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils.config import EnsembleConfig, GenerationConfig
    from dropoutdecoding_tpu_torch.utils.convert import (
        synthetic_llava_params,
        synthetic_llavanext_params,
    )
    from dropoutdecoding_tpu_torch.utils.quantize import (
        fuse_projections,
        int8_column_major,
        quantize_llama_params,
    )

    rng = np.random.default_rng(29)
    T = 12
    gen = GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0)
    wrappers = _wrappers()
    cfg, ncfg = _narrow_config(), _narrow_next_config()
    llava = LlavaParams(*(
        _sharpen(p, 10) for p in synthetic_llava_params(cfg, "cpu", torch.float32, 3)))
    L = cfg.text.num_hidden_layers
    # every request draws from stream 0 at its own steps; a done or empty
    # slot's host count runs on, so the table wraps
    draws = torch.from_numpy(rng.random((64, 1, 3, 1312), dtype=np.float32))

    def uniform(step, row, m, n):
        return draws[step % 64, row, m, :n]

    reqs = {}
    for i in range(4):
        ids = np.array([[1, 17, 29, 500, 41, 53, 67, 71, 83 + i]])
        reqs[f"r{i}"] = (ids, rng.normal(size=(1, 3, 112, 112)).astype(np.float32))

    def run(params, device, ens, **fields):
        """(server tokens, solo tokens on the card (None on the CPU), the
        launches of the server run, its server steps) on ``device``."""
        p = LlavaParams(*(_to(part, device) for part in params))
        eng = LlavaEngine(cfg=cfg, params=p, gen=gen, max_len=128, ens=ens, uniform=uniform,
                          **fields)
        server = DecodeServer(engine=eng, n_slots=3)
        for fn in wrappers.values():
            fn.launches = 0
        steps = _count_steps(eng)
        out = _staggered(server, reqs)
        counts = {k: fn.launches for k, fn in wrappers.items()}
        del eng._one_step  # the class's again
        solo = {rid: eng.generate(*args).tokens[0] for rid, args in reqs.items()} \
            if device == "cuda" else None
        return out, solo, counts, steps[0]

    def check(label, params, ens, forwards, **fields):
        got = {dev: run(params, dev, ens, **fields) for dev in ("cuda", "cpu")}
        (card, card_solo, counts, steps), (cpu, _, _, _) = got["cuda"], got["cpu"]
        want = {**dict.fromkeys(wrappers, 0), "K1": steps * L * forwards, "K2": len(reqs)}
        same_solo = all(np.array_equal(card[r], card_solo[r]) for r in reqs)
        same_cpu = all(np.array_equal(card[r], cpu[r]) for r in reqs)
        print(f"narrow serving {label}: {steps} server steps, launches {counts} (want {want}); "
              f"server equal to solo on the card {same_solo}, card equal to CPU {same_cpu}; "
              f"r1 {card['r1'].tolist()}")
        _check_counts(f"narrow serving {label}", counts, want)
        if not (same_solo and same_cpu and all(len(card[r]) == T for r in reqs)):
            raise AssertionError(f"narrow serving {label}: {card} / solo {card_solo} / cpu {cpu}")

    check("exact", llava, EnsembleConfig(), 2)
    check("fused", llava, EnsembleConfig(fused_step=True), 1)
    # int8 fused weights in the CLI's w8a8 layout (column-major)
    int8 = llava._replace(lm=int8_column_major(fuse_projections(quantize_llama_params(llava.lm))))
    check("w8a8 fused, int8 weights", int8, EnsembleConfig(fused_step=True), 1,
          w8a8_prefill=True, w8a8_decode=True)
    greedy = {}
    for device in ("cuda", "cpu"):
        p = LlavaParams(*(_to(part, device) for part in int8))
        eng = LlavaEngine(cfg=cfg, params=p, gen=dataclasses.replace(gen, max_new_tokens=24),
                          max_len=128, ensemble=False, w8a8_prefill=True, w8a8_decode=True)
        greedy[device] = eng.generate(*reqs["r0"]).tokens
    card, cpu = greedy["cuda"], greedy["cpu"]
    print(f"narrow serving w8a8 greedy (1 decode row): card {card[0].tolist()} "
          f"cpu equal {np.array_equal(card, cpu)}")
    if not np.array_equal(card, cpu):
        raise AssertionError("narrow serving w8a8 greedy: card tokens differ from the CPU's")

    # LLaVA-NeXT: a chunked join pumps the active slot
    nparams = llavanext.LlavaNextParams(*(
        _sharpen(p, 5) for p in synthetic_llavanext_params(ncfg, "cpu", torch.float32, seed=3)))
    size = (150, 220)
    n_tiles = llavanext.image_geometry(size, ncfg)["n_tiles"]
    ids = np.array([[1, 17, 29, 120, 41, 53, 67, 71, 83]])
    tiles = {k: rng.normal(size=(n_tiles, 3, 112, 112)).astype(np.float32) for k in "ab"}
    out = {}
    for device in ("cuda", "cpu"):
        p = llavanext.LlavaNextParams(*(_to(part, device) for part in nparams))
        eng = LlavaNextEngine(cfg=ncfg, params=p, gen=dataclasses.replace(gen, max_new_tokens=16),
                              max_len=1344, seed=506, uniform=uniform,
                              ens=EnsembleConfig(mask_accumulate=False, topk=10))
        for how in ("submit", "submit_chunked"):
            server = DecodeServer(engine=eng, n_slots=2)
            server.submit("a", ids, tiles["a"], size)
            server.step()
            before = server._carry["steps"].tolist()[0]
            wrappers["K5"].launches = 0
            if how == "submit":
                server.submit("b", ids, tiles["b"], size)
            else:
                server.submit_chunked("b", ids, tiles["b"], size, chunk=256, pump_steps=2)
            k5 = wrappers["K5"].launches
            advanced = server._carry["steps"].tolist()[0] - before
            res = {}
            while server.active():
                server.step(2)
                res.update(server.harvest())
            out[device, how] = res
            want = {"advanced": 0 if how == "submit" else 10, "K5": 2 if how == "submit" else 0}
            got = {"advanced": advanced, "K5": k5}
            print(f"narrow serving next {how} on {device}: the active slot advanced {advanced} "
                  f"steps during the join, K5 launched {k5} times (want {want})")
            if advanced != want["advanced"]:
                raise AssertionError(f"narrow serving next {how}: {got} != {want}")
            if device == "cuda":  # the twins count no launch
                _check_counts(f"narrow serving next {how}", got, want)
        if device == "cpu":
            continue
        solo = {k: eng.generate(ids, tiles[k], size).tokens[0] for k in "ab"}
        for how in ("submit", "submit_chunked"):
            if not all(np.array_equal(out[device, how][k], solo[k]) for k in "ab"):
                raise AssertionError(f"narrow serving next {how} on {device}: tokens differ "
                                     f"from solo: {out[device, how]} / {solo}")
    if not all(np.array_equal(out["cuda", h][k], out["cpu", h][k])
               for h in ("submit", "submit_chunked") for k in "ab"):
        raise AssertionError("narrow serving next: card tokens differ from the CPU's")
    b = out["cuda", "submit_chunked"]["b"]
    print(f"narrow serving next: tokens equal, card to CPU and chunked to one-shot; b {b.tolist()}")


def serve_requests(cfg, n: int, seed: int) -> dict:
    """``n`` LLaVA-1.5 requests: ids [1, 20] (BOS, the image at 5, the rest
    their own, below the image token) and pixels [1, 3, 336, 336] (the
    config's image size)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    px = cfg.vision.image_size
    out = {}
    for i in range(n):
        ids = rng.integers(2, cfg.image_token_index, size=(1, 20))
        ids[0, 0], ids[0, 5] = 1, cfg.image_token_index
        out[f"q{i}"] = (ids, rng.normal(size=(1, 3, px, px)).astype(np.float32))
    return out


def serve_waves(server, reqs: dict, wave: int) -> tuple:
    """``reqs`` through ``server`` in waves of ``wave`` requests: the first
    at step 0, the second after one ``step(SERVE_CHUNK)``, each later one
    once ``wave`` slots are free; a harvest after every chunk.  Returns
    ({rid: tokens}, [s of each synchronised step(SERVE_CHUNK)])."""
    order = list(reqs)
    waves = [order[i:i + wave] for i in range(0, len(order), wave)]
    results, chunk_s = {}, []
    for rid in waves.pop(0):
        server.submit(rid, *reqs[rid])
    while waves or server.active():
        _, secs = _sync_time(lambda: server.step(SERVE_CHUNK))
        chunk_s.append(secs)
        results.update(server.harvest())
        if waves and len(server.free_slots()) >= len(waves[0]):
            for rid in waves.pop(0):
                server.submit(rid, *reqs[rid])
    return results, chunk_s


def alone_in_server(eng, reqs: dict, T: int) -> dict:
    """Each request's tokens run alone in a ``SERVE_SLOTS``-slot server: the
    row count of every product of the busy server, so that bf16 rounds the
    same (``matmul_row_rounding``)."""
    from dropoutdecoding_tpu_torch.engine.serving import DecodeServer

    out = {}
    for rid, args in reqs.items():
        server = DecodeServer(engine=eng, n_slots=SERVE_SLOTS)
        server.submit(rid, *args)
        server.step(T - 1)
        out.update(server.harvest())
    return out


def serving_full(make, cfg, label: str = "bf16") -> dict:
    """LLaVA-1.5-7B serving at ``SERVE_SLOTS`` slots (the serve CLI's
    defaults), fused K=3 and exact K=3: 12 requests of 32 tokens joining in
    three waves of 4 (``serve_waves``, ``step(SERVE_CHUNK)`` between
    harvests) against ``generate`` on the same requests one at a time.
    Each request's tokens must equal that request run alone in the same
    8-slot server (``alone_in_server``); how many equal the solo
    ``generate`` is printed (bf16 rows depend on the row count).  Launches
    exact: K1 32 a server step fused, 64 exact, over all 8 rows, whatever
    their fill; K2 one a submit.  Returns, by mode, ms a step(8) (median),
    tokens/s and requests/s of the server and of the sequential runs, the
    device peak and the launches."""
    import numpy as np

    from dropoutdecoding_tpu_torch.engine.serving import DecodeServer
    from dropoutdecoding_tpu_torch.utils.config import EnsembleConfig, GenerationConfig

    T = 32
    gen = GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0)
    reqs = serve_requests(cfg, 12, seed=41)
    wrappers = _wrappers()
    L = cfg.text.num_hidden_layers
    record = {}
    for mode, ens, forwards in (("fused", EnsembleConfig(fused_step=True), 1),
                                ("exact", EnsembleConfig(), 2)):
        eng = make(True, gen, ens=ens)
        warm = DecodeServer(engine=eng, n_slots=SERVE_SLOTS)  # warm-up at the server's shapes
        warm.submit("w", *reqs["q0"])
        warm.step(2)
        del warm
        server = DecodeServer(engine=eng, n_slots=SERVE_SLOTS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        steps = _count_steps(eng)
        (got, chunk_s), total_s = _sync_time(lambda: serve_waves(server, reqs, 4))
        counts = {k: fn.launches for k, fn in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        del eng._one_step  # the class's again
        want = {**dict.fromkeys(wrappers, 0), "K1": steps[0] * L * forwards, "K2": len(reqs)}
        alone = alone_in_server(eng, reqs, T)
        solo, seq_s = _sync_time(lambda: {rid: eng.generate(*a).tokens[0] for rid, a in reqs.items()})
        same_alone = [rid for rid in reqs if np.array_equal(got[rid], alone[rid])]
        same_solo = [rid for rid in reqs if np.array_equal(got[rid], solo[rid])]
        step8 = statistics.median(chunk_s) * 1e3
        rec = record[mode] = {
            "server_steps": steps[0], "ms_per_step8": step8, "ms_per_step": step8 / SERVE_CHUNK,
            "tokens_per_s": len(reqs) * T / total_s, "requests_per_s": len(reqs) / total_s,
            "sequential_requests_per_s": len(reqs) / seq_s,
            "sequential_tokens_per_s": len(reqs) * T / seq_s,
            "speedup": seq_s / total_s, "device_peak_gib": peak, "launches": counts,
        }
        print(f"serving {label} {mode}: 12 requests x {T} tokens in three waves on {SERVE_SLOTS} "
              f"slots, {steps[0]} server steps in {total_s:.2f} s: step({SERVE_CHUNK}) "
              f"{step8:.2f} ms median ({step8 / SERVE_CHUNK:.2f} ms a step; chunks "
              f"{[round(s * 1e3, 1) for s in chunk_s]}), {rec['tokens_per_s']:.1f} tokens/s, "
              f"{rec['requests_per_s']:.3f} requests/s; sequential generate {seq_s:.2f} s, "
              f"{rec['sequential_requests_per_s']:.3f} requests/s ({rec['speedup']:.2f}x); device "
              f"peak {peak:.2f} GiB; launches {counts} (want {want}); equal to alone in the "
              f"server {len(same_alone)}/12, to solo generate {len(same_solo)}/12")
        _check_counts(f"serving {label} {mode}", counts, want)
        if len(same_alone) != len(reqs) or any(len(t) != T for t in got.values()):
            raise AssertionError(f"serving {label} {mode}: requests whose tokens differ from "
                                 f"their run alone: {sorted(set(reqs) - set(same_alone))}")
        del server, alone, solo
    return record


def w8a8_full(make, make_w8a8, cfg) -> dict:
    """w8a8 on the int8 tier's weights (``make(ensemble, gen, **fields)``
    builds an engine over them, an int8 cache; ``make_w8a8`` over the same
    values laid out column-major, as the CLI lays them out for w8a8): the
    prefill at 595 tokens with ``w8a8_prefill`` beside the int8 tier's
    (whose matmuls take bf16 copies of the weights), median of 3; 32 greedy
    tokens with ``w8a8_prefill`` and ``w8a8_decode`` against the tier's,
    and the first step at which they differ; ms a server step at 8 slots,
    fused K=3, with ``w8a8_decode`` and weight-only (32 rows a product;
    the greedy run's 1 row zero-padded).  Launches: K3 32 a step, K4 one."""
    import numpy as np

    from dropoutdecoding_tpu_torch.engine.serving import DecodeServer
    from dropoutdecoding_tpu_torch.utils.config import EnsembleConfig, GenerationConfig

    T = 32
    gen = GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0)
    reqs = serve_requests(cfg, SERVE_SLOTS, seed=43)
    ids, pixels = reqs["q0"]
    wrappers = _wrappers()
    L = cfg.text.num_hidden_layers
    record = {}
    tokens = {}
    for label, mk, fields in (("int8", make, {}),
                              ("w8a8", make_w8a8, dict(w8a8_prefill=True, w8a8_decode=True))):
        eng = mk(False, gen, **fields)
        eng.prefill(ids, pixels)  # warm-up
        record[f"{label}_prefill_ms"] = statistics.median(
            _sync_time(lambda: eng.prefill(ids, pixels))[1] for _ in range(3)) * 1e3
        tokens[label] = eng.generate(ids, pixels).tokens[0]
    differ = np.flatnonzero(tokens["int8"] != tokens["w8a8"])
    record["first_differing_step"] = int(differ[0]) if len(differ) else None
    for label, mk, fields in (("int8", make, {}), ("w8a8_decode", make_w8a8,
                                                   dict(w8a8_decode=True))):
        eng = mk(True, gen, ens=EnsembleConfig(fused_step=True), **fields)
        server = DecodeServer(engine=eng, n_slots=SERVE_SLOTS)
        for rid, args in reqs.items():
            server.submit(rid, *args)
        server.step(2)  # warm-up
        for fn in wrappers.values():
            fn.launches = 0
        chunk_s = [_sync_time(lambda: server.step(SERVE_CHUNK))[1] for _ in range(3)]
        counts = {k: fn.launches for k, fn in wrappers.items()}
        want = {**dict.fromkeys(wrappers, 0), "K3": 3 * SERVE_CHUNK * L, "K4": 3 * SERVE_CHUNK}
        _check_counts(f"w8a8 server {label}", counts, want)
        record[f"{label}_ms_per_step_8_slots"] = statistics.median(chunk_s) * 1e3 / SERVE_CHUNK
        del server
    record["projection"] = w8a8_projection()
    print(f"w8a8 on int8 weights: prefill at 595 tokens {record['w8a8_prefill_ms']:.2f} ms "
          f"(int8 tier {record['int8_prefill_ms']:.2f} ms); 32 greedy tokens first differ from "
          f"int8's at step {record['first_differing_step']} (w8a8 {tokens['w8a8'][:8].tolist()}..., "
          f"int8 {tokens['int8'][:8].tolist()}...); server step at {SERVE_SLOTS} slots, fused: "
          f"w8a8_decode {record['w8a8_decode_ms_per_step_8_slots']:.2f} ms, int8 weight-only "
          f"{record['int8_ms_per_step_8_slots']:.2f} ms; K3/K4 launches exact")
    return record


def _stamp_steps(server) -> list:
    """Make every step of ``server`` (the pump's too) synchronise and stamp
    its end on the host clock; returns the list of stamps."""
    step, stamps = server.step, []

    def stamped(n=1):
        for _ in range(n):
            step()
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    server.step = stamped
    return stamps


def _wall_us(fn, n: int = 100) -> float:
    """Host wall time of one ``fn()`` in a synchronised run of ``n``, µs:
    what a host-bound caller pays, launches included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def w8a8_projection() -> dict:
    """One gate+up projection ([R, 4096] x [4096, 22016], bf16
    activations) at the fused 8-slot decode's 32 rows and a prefill's 595:
    the int8 product (``torch._int_mm``) on a row-major weight (the int8
    tier's layout) and on a column-major one (``int8_column_major``), the
    activation quantizer, the whole ``_mm_w8a8``, the weight-only ``_mm``
    and the bf16 product, device µs (``time_ms``) and host wall µs
    (``_wall_us``).  Returns them by row count."""
    from dropoutdecoding_tpu_torch.models import llama
    from dropoutdecoding_tpu_torch.utils.quantize import quantize_activations, quantize_matrix

    g = torch.Generator(device="cuda").manual_seed(59)
    w = quantize_matrix(torch.randn(4096, 22016, generator=g, device="cuda") * 0.02)
    col = {**w, "q": w["q"].mT.contiguous().mT}
    out = {}
    for R in (32, 595):
        x = torch.randn(R, 4096, generator=g, device="cuda").to(torch.bfloat16)
        qx, _ = quantize_activations(x)
        wb = w["q"].to(torch.bfloat16)
        calls = {
            "int_mm row-major": lambda: torch._int_mm(qx, w["q"]),
            "int_mm column-major": lambda: torch._int_mm(qx, col["q"]),
            "quantize_activations": lambda: quantize_activations(x),
            "mm_w8a8 column-major": lambda: llama._mm_w8a8(x, col),
            "mm int8 weight-only": lambda: llama._mm(x, w),
            "bf16 product": lambda: x @ wb,
        }
        out[R] = {k: {"device_us": time_ms(fn) * 1e3, "wall_us": _wall_us(fn)}
                  for k, fn in calls.items()}
        print(f"w8a8 projection [{R}, 4096] x [4096, 22016]: " + "; ".join(
            f"{k} {v['device_us']:.1f} us device, {v['wall_us']:.1f} us wall"
            for k, v in out[R].items()))
    return out


def serving_next(make_next, cfg, tiles, size) -> dict:
    """LLaVA-v1.6-Mistral-7B serving: 7 slots decode while an 8th request
    joins, by one-shot ``submit`` and by ``submit_chunked(chunk=256,
    pump_steps=4)``.  Every server step is synchronised and stamped; the
    longest gap between two stamps (two tokens of an active slot) across
    the join, one-shot against chunked.  The seven active requests' tokens
    equal between the two runs (the pumped steps advance only them); the
    joiner's prefill (K5's attention against the pieces' plain extend
    attention, both bf16) within ``POPE_MODES_RTOL["next"]`` of the largest
    logit, and the first step at which its tokens part printed.  K5 32 in
    the one-shot join and none in the chunked one; K2 one a submit."""
    import numpy as np

    from dropoutdecoding_tpu_torch.engine.serving import DecodeServer
    from dropoutdecoding_tpu_torch.utils.config import EnsembleConfig, GenerationConfig

    T = 32
    rng = np.random.default_rng(47)
    ids = rng.integers(2, cfg.image_token_index, size=(1, 20))
    ids[0, 0], ids[0, 5] = 1, cfg.image_token_index
    reqs = {f"n{i}": (ids, rng.normal(size=tiles.shape).astype(np.float32), size) for i in range(8)}
    gen = GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0)
    eng = make_next(True, gen, ens=EnsembleConfig(fused_step=True, mask_accumulate=False, topk=10))
    wrappers = _wrappers()
    record, tokens, logits = {}, {}, {}
    for how in ("submit", "submit_chunked"):
        server = DecodeServer(engine=eng, n_slots=SERVE_SLOTS)
        stamps = _stamp_steps(server)
        for rid in list(reqs)[:7]:
            server.submit(rid, *reqs[rid])
        server.step(4)
        stamps.clear()
        server.step(2)
        wrappers["K5"].launches = wrappers["K2"].launches = 0
        t0 = time.perf_counter()
        if how == "submit":
            server.submit("n7", *reqs["n7"])
        else:
            server.submit_chunked("n7", *reqs["n7"], chunk=256, pump_steps=4)
        join_s = time.perf_counter() - t0
        k5, k2 = wrappers["K5"].launches, wrappers["K2"].launches
        logits[how] = server._state.last_logits[7].float().cpu()  # the joiner's, in slot 7
        server.step(4)
        gaps, during = np.diff(stamps), len(stamps) - 6
        res = {}
        while server.active():
            server.step(SERVE_CHUNK)
            res.update(server.harvest())
        tokens[how] = res
        want = {"K5": cfg.text.num_hidden_layers if how == "submit" else 0, "K2": 1}
        record[how] = {"longest_gap_ms": float(gaps.max()) * 1e3,
                       "median_gap_ms": float(np.median(gaps)) * 1e3, "join_s": join_s,
                       "steps_during_join": during, "K5": k5}
        print(f"serving next {how}: join {join_s * 1e3:.1f} ms, {during} steps of the 7 "
              f"active slots during it; gap between two tokens of an active slot: longest "
              f"{gaps.max() * 1e3:.1f} ms, median {np.median(gaps) * 1e3:.1f} ms (every gap, ms: "
              f"{[round(float(g) * 1e3, 1) for g in gaps]}); K5 {k5}, K2 {k2} in the join (want {want})")
        _check_counts(f"serving next {how}", {"K5": k5, "K2": k2}, want)
    same = [r for r in reqs if np.array_equal(tokens["submit"][r], tokens["submit_chunked"][r])]
    a, b = tokens["submit"]["n7"], tokens["submit_chunked"]["n7"]
    part = np.flatnonzero(a != b)
    drift = ((logits["submit"] - logits["submit_chunked"]).abs().max()
             / logits["submit"].abs().max()).item()
    record.update(joiner_logit_drift=drift, joiner_first_differing_step=
                  int(part[0]) if len(part) else None)
    print(f"serving next: tokens equal between the two joins for {same}; the joiner's prefill "
          f"logits {drift:.2e} of the largest apart (bound {POPE_MODES_RTOL['next']:g}), its "
          f"tokens first part at step {record['joiner_first_differing_step']}")
    if sorted(set(reqs) - set(same)) not in ([], ["n7"]) or len(tokens["submit"]) != len(reqs):
        raise AssertionError(f"serving next: active requests' tokens differ between the joins: "
                             f"{sorted(set(reqs) - set(same))}")
    if not drift <= POPE_MODES_RTOL["next"]:
        raise AssertionError(f"serving next: the joiner's chunked prefill is {drift} off")
    return record


SPEC_GAMMA = 4  # the drafts a cycle of the speculative checks, the CLI's --spec-gamma 4


def spec_launches(n_acc: list, gamma: int, L: int, lm: bool, int4: bool) -> dict:
    """Each kernel's launches in one speculative generation on an ``L``-layer
    LLaVA-1.5 with a dense target cache, from its cycles' accepted counts
    ``n_acc``: with a draft tower (``lm``) gamma draft steps a cycle, and one
    more at the start of each cycle that follows a full acceptance (F6),
    each one K1 a layer over the draft cache and, on an ``int4`` draft, one
    K6 a fused projection of a layer, as is its prefill; K2 once, the
    target's prefill; the verify runs the plain extend attention and the
    plain block write."""
    c = len(n_acc)
    steps = gamma * c + sum(1 for a in n_acc[:-1] if a == gamma) if lm else 0
    return {"K1": L * steps, "K2": 1, "K3": 0, "K4": 0, "K5": 0,
            "K6": 4 * L * (1 + steps) if lm and int4 else 0}


def greedy_with_logits(eng, args: tuple):
    """The greedy run of ``eng`` on ``args`` as ``LlavaEngine``'s greedy step
    makes it (M = 1 over the cache, then the head): its tokens [T] and each
    decode step's fp32 logits, a list of T - 1 [V]."""
    from dropoutdecoding_tpu_torch.models import llama

    lm, cfg = eng.params.lm, eng.cfg.text
    with torch.no_grad():
        state = eng.prefill(*args)
        slots = torch.arange(eng.max_len, device=eng.device)
        cur, token = state.cur_len, state.first_token
        tokens, logits = [token], []
        for _ in range(1, eng.gen.max_new_tokens):
            h, kn, vn = llama.decode_step(lm, cfg, llama.embed(lm, token)[:, None], cur,
                                          state.cache, (slots[None] < cur[:, None])[:, None])
            llama.cache_set_rows(state.cache, cur, kn[:, :, 0], vn[:, :, 0])
            step = llama.lm_head(lm, h)[:, 0]
            token, cur = step.argmax(dim=-1), cur + 1
            tokens.append(token)
            logits.append(step[0])
    return torch.cat(tokens).tolist(), logits


def spec_hold(spec, args: tuple, label: str, greedy: tuple, exact: bool) -> dict:
    """``spec.generate_fused`` on ``args`` held to the greedy run ``greedy``
    (``greedy_with_logits``): token-equal, or (unless ``exact``) at the first
    differing position the greedy run's top-2 logit gap no larger than twice
    the largest |verify - decode| logit difference over the agreeing prefix:
    in bf16 the verify's G + 1 rows round otherwise than one-row steps, so a
    near tie may split them.  Returns (and prints) the record: tokens equal,
    the split, both numbers, cycles, each cycle's accepted count and the
    tokens."""
    eng = spec.engine
    S = eng._prompt_lengths(*args)[0]
    tokens_g, logits_g = greedy
    T = len(tokens_g)
    rows, n_acc = {}, []

    def on_verify(cur, logits, n):
        n_acc.append(n)
        for j in range(n + 1):  # rows whose inputs the cycle accepted
            rows[cur + j - S + 1] = logits[j]

    spec.on_verify = on_verify
    try:
        tokens, cycles = spec.generate_fused(*args)
    finally:
        spec.on_verify = None
    tokens = tokens.tolist()
    split = next((k for k in range(min(len(tokens), T)) if tokens[k] != tokens_g[k]), None)
    if split is None and len(tokens) != T:
        split = min(len(tokens), T)
    last = T - 1 if split is None else split
    diff = max(((rows[n] - logits_g[n - 1]).abs().max().item()
                for n in range(1, last + 1) if n in rows), default=0.0)
    gap = None
    if split is not None:
        top2 = logits_g[split - 1].topk(2).values
        gap = (top2[0] - top2[1]).item()
    rec = {"equal": split is None, "split": split, "top2_gap": gap, "max_verify_decode_diff": diff,
           "cycles": cycles, "n_acc": n_acc, "tokens": tokens}
    print(f"{label}: spec tokens equal to greedy: {split is None}"
          + ("" if split is None else f" (first split at {split}: greedy top-2 gap {gap:.4g}, "
                                      f"bound 2 x {diff:.4g})")
          + f"; largest |verify - decode| logit over the agreeing prefix {diff:.4g}; {cycles} "
          f"cycles, accepted {n_acc}")
    if split is not None and (exact or not gap <= 2 * diff):
        raise AssertionError(f"{label}: spec splits from greedy at {split} (top-2 gap {gap}, "
                             f"twice the verify-decode difference {2 * diff}, exact {exact})")
    return rec


def small_speculative() -> None:
    """Speculative greedy decoding on the narrow fp32 LLaVA, card (kernels)
    against CPU (plain twins): the int4 self-draft (fused), draft == target,
    ngram, and an int8-KV target with draft == target and with ngram.
    ``generate``'s tokens, cycles and accepted count equal on both sides,
    ``generate_fused``'s tokens and the engine's greedy tokens equal to
    them, draft == target accepting every draft over a dense target cache
    (over an int8 one the draft's dense cache is not the target's), the
    card's launches exact
    (``spec_launches``).  Then ``cache_write_span`` at LLaVA-1.5-7B's int8
    cache, a block of G + 1 rows, bit-equal to G + 1 appends by K4."""
    import numpy as np

    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.engine.speculative import SpeculativeGreedy
    from dropoutdecoding_tpu_torch.models import llama
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig, LlavaConfig
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_llava_params
    from dropoutdecoding_tpu_torch.utils.quantize import fuse_projections, quantize_llama_params_int4

    cfg = _narrow_config()
    params = synthetic_llava_params(cfg, "cpu", torch.float32, seed=3)
    params = LlavaParams(*(_sharpen(p, 10) for p in params))  # x10: std 0.2
    ids = np.array([[1, 17, 29, 500, 41, 53, 67, 71, 83]])
    pixels = np.random.default_rng(5).normal(size=(1, 3, 112, 112)).astype(np.float32)
    gen = GenerationConfig(max_new_tokens=16, eos_token_id=-1, pad_token_id=0)
    G, L = SPEC_GAMMA, cfg.text.num_hidden_layers
    cases = (("int4 draft", "int4", False), ("draft == target", "target", False),
             ("ngram", None, False), ("int8-KV target, draft == target", "target", True),
             ("int8-KV target, ngram", None, True))
    wrappers = _wrappers()
    out = {}
    for device in ("cuda", "cpu"):
        p = LlavaParams(*(_to(part, device) for part in params))
        drafts = {"int4": fuse_projections(quantize_llama_params_int4(p.lm)), "target": p.lm,
                  None: None}
        for label, draft, int8_kv in cases:
            eng = LlavaEngine(cfg=cfg, params=p, gen=gen, max_len=128, ensemble=False,
                              int8_kv=int8_kv)
            n_acc = []
            spec = SpeculativeGreedy(engine=eng, draft_lm=drafts[draft], gamma=G,
                                     draft="lm" if draft else "ngram",
                                     on_verify=lambda cur, logits, n: n_acc.append(n))
            for fn in wrappers.values():
                fn.launches = 0
            tokens, cycles, accepted = spec.generate(ids, pixels)
            counts = {k: fn.launches for k, fn in wrappers.items()}
            spec.on_verify = None
            greedy = eng.generate(ids, pixels).tokens[0]
            fused, _ = spec.generate_fused(ids, pixels)
            out[device, label] = (tokens.tolist(), cycles, accepted)
            if not (np.array_equal(tokens, greedy) and np.array_equal(fused, greedy)):
                raise AssertionError(f"narrow speculative {label} on {device}: {tokens} / {fused} "
                                     f"against greedy {greedy}")
            if draft == "target" and not int8_kv and accepted != G * cycles:
                raise AssertionError(f"narrow speculative {label}: {accepted} of {G * cycles} "
                                     f"drafts accepted")
            if device == "cuda":
                want = spec_launches(n_acc, G, L, lm=draft is not None, int4=draft == "int4")
                print(f"narrow speculative {label}: {cycles} cycles, {accepted} accepted, "
                      f"launches {counts} (want {want})")
                _check_counts(f"narrow speculative {label}", counts, want)
    for label, *_ in cases:
        if out["cuda", label] != out["cpu", label]:
            raise AssertionError(f"narrow speculative {label}: (tokens, cycles, accepted) card "
                                 f"{out['cuda', label]} cpu {out['cpu', label]}")
    print(f"narrow speculative: card equal to CPU in every case: "
          f"{ {label: out['cuda', label][1:] for label, *_ in cases} }")

    # cache_write_span against K4 at the 7B int8 cache: 32 layers, 1152 slots
    from dropoutdecoding_tpu_torch.ops.cuda_cache_append import cache_append_int8

    g = torch.Generator(device="cuda").manual_seed(41)
    L7, KH, D, S, start = 32, 32, 128, 1152, 600
    k, v = (torch.randn(L7, 1, G + 1, KH, D, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    block = llama.empty_cache(LlavaConfig().text, 1, S, torch.bfloat16, "cuda", quantized=True)
    rows = llama.empty_cache(LlavaConfig().text, 1, S, torch.bfloat16, "cuda", quantized=True)
    llama.cache_write_span(block, start, llama.KVCache(k, v))
    before = cache_append_int8.launches
    for t in range(G + 1):
        llama.cache_set_rows(rows, torch.tensor([start + t], device="cuda"), k[:, :, t].contiguous(),
                             v[:, :, t].contiguous())
    appends = cache_append_int8.launches - before
    equal = all(torch.equal(a, b) for a, b in zip(llama._leaves(block), llama._leaves(rows)))
    print(f"cache_write_span of {G + 1} rows at slot {start} of [32, 1, 1152, 4096] int8: "
          f"bit-equal to {appends} K4 appends: {equal}")
    if not equal or appends != G + 1:
        raise AssertionError("cache_write_span differs from K4's appends")


def speculative_full(params, cfg, ids, pixels) -> dict:
    """Speculative greedy decoding at LLaVA-1.5-7B width, G = 4, 32 new
    tokens.  First fp32 at full width and 4 layers (synthetic weights):
    draft == target, the int4 self-draft and ngram, each token-equal to
    greedy (``spec_hold`` exact), draft == target accepting every draft.
    Then ``params``, the bf16 tower at full depth: the int4 self-draft
    quantized as the CLI quantizes it (``cli.speculative_draft``, timed),
    greedy, the int4 draft, ngram and draft == target, each held to greedy
    by ``spec_hold`` (token-equal or within the margin rule), then run once
    more with every launch counted (``spec_launches``, exact): tokens/s of
    the decode (the cycles' wall time), alpha, tokens a cycle, ms a cycle
    split into draft, verify and host, and the device peak.  Returns the
    records."""
    import dataclasses
    from argparse import Namespace

    from dropoutdecoding_tpu_torch.cli import chair_test as cli
    from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
    from dropoutdecoding_tpu_torch.engine.speculative import SpeculativeGreedy
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_llava_params
    from dropoutdecoding_tpu_torch.utils.quantize import fuse_projections, quantize_llama_params_int4

    T, G = 32, SPEC_GAMMA
    gen = GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0)
    args = (ids, pixels)
    record = {}

    # --- fp32 at full width, 4 layers: exact ---
    cfg4 = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=4))
    p4 = synthetic_llava_params(cfg4, "cuda", torch.float32, seed=7)
    eng4 = LlavaEngine(cfg=cfg4, params=p4, gen=gen, max_len=1152, ensemble=False)
    greedy4 = greedy_with_logits(eng4, args)
    if greedy4[0] != eng4.generate(*args).tokens[0].tolist():
        raise AssertionError("fp32 4-layer: the step-by-step greedy run differs from generate")
    fp32 = {}
    for label, draft_lm in (("draft == target", p4.lm),
                            ("int4 draft", fuse_projections(quantize_llama_params_int4(p4.lm))),
                            ("ngram", None)):
        spec = SpeculativeGreedy(engine=eng4, draft_lm=draft_lm, gamma=G,
                                 draft="ngram" if draft_lm is None else "lm")
        fp32[label] = spec_hold(spec, args, f"speculative fp32 4-layer {label}", greedy4, exact=True)
    if any(a != G for a in fp32["draft == target"]["n_acc"]):
        raise AssertionError(f"fp32 draft == target: accepted {fp32['draft == target']['n_acc']}")
    record["fp32 4-layer"] = {k: {"cycles": v["cycles"], "accepted": sum(v["n_acc"])}
                              for k, v in fp32.items()}
    del p4, eng4, spec
    torch.cuda.empty_cache()

    # --- bf16 at full depth ---
    L = cfg.text.num_hidden_layers
    eng = LlavaEngine(cfg=cfg, params=params, gen=gen, max_len=1152, ensemble=False)
    greedy = greedy_with_logits(eng, args)
    if greedy[0] != eng.generate(*args).tokens[0].tolist():
        raise AssertionError("bf16: the step-by-step greedy run differs from generate")
    state = eng.prefill(*args)
    _, decode_s = _sync_time(lambda: eng.decode(state))
    record["greedy_tps"] = (T - 1) / decode_s
    del state
    draft4, quant_s = _sync_time(
        lambda: cli.speculative_draft(Namespace(spec_gamma=G, spec_draft="int4"), params.lm))
    record["int4_draft_quantize_s"] = quant_s
    print(f"speculative bf16: greedy {record['greedy_tps']:.2f} tokens/s; the int4 self-draft "
          f"quantized from the bf16 tower in {quant_s:.2f} s")
    wrappers = _wrappers()
    for label, draft_lm, int4 in (("int4 draft", draft4, True), ("ngram", None, False),
                                  ("draft == target", params.lm, False)):
        times = []
        spec = SpeculativeGreedy(engine=eng, draft_lm=draft_lm, gamma=G,
                                 draft="ngram" if draft_lm is None else "lm", cycle_ms=times)
        hold = spec_hold(spec, args, f"speculative bf16 {label}", greedy, exact=False)
        hold.pop("tokens")
        times.clear()
        n_acc = []
        spec.on_verify = lambda cur, logits, n: n_acc.append(n)
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        tokens, cycles = spec.generate_fused(*args)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in wrappers.items()}
        want = spec_launches(n_acc, G, L, lm=draft_lm is not None, int4=int4)
        ms = {part: statistics.mean(t[i] for t in times)
              for i, part in enumerate(("draft", "verify", "wall"))}
        ms["host"] = ms["wall"] - ms["draft"] - ms["verify"]
        rec = {"hold": hold, "tps": (len(tokens) - 1) / (sum(t[2] for t in times) / 1e3),
               "alpha": sum(n_acc) / (G * cycles), "tokens_per_cycle": (len(tokens) - 1) / cycles,
               "cycles": cycles, "ms_per_cycle": ms, "launches": counts,
               "device_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"speculative bf16 {label}: {rec['tps']:.2f} tokens/s (greedy "
              f"{record['greedy_tps']:.2f}), alpha {rec['alpha']:.3f}, "
              f"{rec['tokens_per_cycle']:.2f} tokens a cycle over {cycles} cycles, ms a cycle "
              f"{json.dumps(ms)}, launches {counts} (want {want}), device peak "
              f"{rec['device_peak_gib']:.2f} GiB")
        _check_counts(f"speculative bf16 {label}", counts, want)
        record[label] = rec
    return record


def clip_zero_shot_check(vcfg=None, tcfg=None) -> dict:
    """``ClipZeroShot`` at CLIP ViT-L/14-336 and its text tower's widths
    (``ClipVisionConfig()``, ``ClipTextConfig()``) on synthetic fp32 weights,
    the card (fp32 matmuls, TF32 off) against the CPU: the 80 COCO classes'
    normalised text embeddings within 1e-4, two images' cosine similarities
    within 1e-4 and its top-10 labels equal (unless the 10th and 11th
    similarities lie closer than the two sides' difference).  ``vcfg`` /
    ``tcfg`` make a narrow rehearsal on the CPU possible."""
    import numpy as np

    from dropoutdecoding_tpu_torch.evalsuite.im_classifier import ClipZeroShot, coco_class_words
    from dropoutdecoding_tpu_torch.models import clip_text
    from dropoutdecoding_tpu_torch.utils.config import ClipTextConfig, LlamaConfig, LlavaConfig
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_llava_params

    vcfg, tcfg = vcfg or LlavaConfig().vision, tcfg or ClipTextConfig()
    one = LlavaConfig(text=LlamaConfig(vocab_size=8, hidden_size=8, intermediate_size=8,
                                       num_hidden_layers=1, num_attention_heads=1,
                                       num_key_value_heads=1, head_dim=8),
                      vision=vcfg)  # the vision tower, beside an LM of nothing
    vision = synthetic_llava_params(one, "cpu", torch.float32, seed=9).vision
    text = clip_text.init_params(tcfg, "cpu", torch.float32, seed=9)
    g = torch.Generator().manual_seed(9)
    post_ln = (1 + 0.1 * torch.randn(vcfg.hidden_size, generator=g),
               0.1 * torch.randn(vcfg.hidden_size, generator=g))
    proj = 0.02 * torch.randn(vcfg.hidden_size, tcfg.projection_dim, generator=g)
    names = sorted(coco_class_words())
    tok = _StandInClipTokenizer(tcfg.vocab_size)
    px = vcfg.image_size
    pixels = np.random.default_rng(9).normal(size=(1, 1, 3, px, px)).astype(np.float32)
    sides = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        zs = ClipZeroShot(vcfg, _to(vision, device), tuple(x.to(device) for x in post_ln),
                          proj.to(device), tcfg, _to(text, device), tok, names)
        sims, labels = [], []
        for px in pixels:
            labels.append(zs.labels(px, top_n=10))
            sims.append(zs.similarities(px))
        if device == "cuda":
            torch.cuda.synchronize()
        sides[device] = (zs._text_embeds.cpu(), np.stack(sims), labels, time.perf_counter() - t0)
    (te_g, s_g, l_g, secs_g), (te_c, s_c, l_c, secs_c) = sides["cuda"], sides["cpu"]
    text_err = (te_g - te_c).abs().max().item()
    sim_err = float(np.abs(s_g - s_c).max())
    margins = [float(np.sort(s)[::-1][9] - np.sort(s)[::-1][10]) for s in s_c]
    same = [a == b or m < sim_err for a, b, m in zip(l_g, l_c, margins)]
    print(f"ClipZeroShot ViT-L/14-336 + text tower, 80 classes, fp32: text embeddings card vs CPU "
          f"{text_err:.2e}, similarities {sim_err:.2e} (bounds 1e-4), top-10 labels equal "
          f"{[a == b for a, b in zip(l_g, l_c)]} (10th-11th margins {margins}); card {secs_g:.2f} s, "
          f"CPU {secs_c:.2f} s; labels {sorted(l_g[0])}")
    if not (text_err <= 1e-4 and sim_err <= 1e-4 and all(same)):
        raise AssertionError("ClipZeroShot: card and CPU differ")
    return {"text_err": text_err, "sim_err": sim_err, "card_s": secs_g, "cpu_s": secs_c}


class _StandInClipTokenizer:
    """CLIP's tokenizer surface over words: BOS 49406, a word's id a hash of
    it below ``vocab``, EOS 49407."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, text):
        import zlib

        return {"input_ids": [self.vocab - 2] + [zlib.crc32(w.encode()) % (self.vocab - 2)
                                                for w in text.split()] + [self.vocab - 1]}


def spec_consistency_cli(ckpt: str, coco: str, files: list, images: list, processor,
                         device: str, check_counts, max_new: int, whole: bool) -> dict:
    """The CHAIR CLI's last flags on the LLaVA-1.5-7B checkpoint at
    ``ckpt``.  ``--original True --spec-gamma 4``: ``build_engine`` loads
    the checkpoint and quantizes the int4 self-draft from the loaded tower
    (timed), then the two images are captioned with ``--spec-draft int4``
    and ``ngram`` (``max_new`` tokens, no eos), each caption equal to
    ``generate_fused`` made directly, which ``spec_hold`` holds to the
    greedy run, the CLI's launches exact (``spec_launches`` a caption).
    Then the consistency analyses over the int4 arm's captions and their
    CHAIR results (``ChairEvaluator`` on the written annotations):
    ``--consistency`` (``lm_consistency_report``: a distribution for every
    caption word, no kernel launched) and ``--consistency-im projection``
    (``im_consistency_report``: K2 once an image, labels equal to those of
    the plain top-k table of the same logits).  Returns the records."""
    import dataclasses
    import shutil

    from dropoutdecoding_tpu_torch.cli import chair_test as cli
    from dropoutdecoding_tpu_torch.evalsuite.chair import ChairEvaluator
    from dropoutdecoding_tpu_torch.evalsuite.im_classifier import (
        class_token_table,
        coco_class_words,
        projection_labels,
    )
    from dropoutdecoding_tpu_torch.ops.cuda_uncertainty import exact_top_k_ids
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig

    model, prompt, G = "llava-1.5", cli.PROMPTS["llava-1.5"], SPEC_GAMMA
    cuda = device == "cuda"
    work = os.path.join(ckpt, "spec_run")
    argv = ["--coco-data-dir", coco, "--model-path", ckpt, "--image-numbers", "2", "--seed", "0",
            "--method", "smoke", "--output-dir", os.path.join(work, "out"), "--sample-save-name",
            os.path.join(work, "sample.log"), "--original", "True", "--spec-gamma", str(G)]
    t0 = time.perf_counter()
    built = cli.build_engine(cli.build_parser().parse_args(argv), device, cache=False)
    if cuda:
        torch.cuda.synchronize()
    record = {"build_with_int4_draft_s": time.perf_counter() - t0}
    draft_lm = built._spec.draft_lm
    eng = dataclasses.replace(  # the CLI's engine, max_new tokens and no eos
        built, gen=GenerationConfig(max_new_tokens=max_new, eos_token_id=-1, pad_token_id=0))
    del built
    L = eng.cfg.text.num_hidden_layers
    inputs = [processor(prompt, image) for image in images]
    direct_args = [(x["input_ids"], x["pixel_values"]) for x in inputs]
    greedy = [greedy_with_logits(eng, a) for a in direct_args]
    wrappers = _wrappers()
    captions_by_arm = {}
    for draft in ("int4", "ngram"):
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        arm_args = cli.build_parser().parse_args(argv + ["--spec-draft", draft])
        cli.attach_speculative(eng, arm_args, draft_lm if draft == "int4" else None)
        seen = []  # (cur, accepted) of every cycle of the CLI's run
        eng._spec.on_verify = lambda cur, logits, n: seen.append((cur, n))
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        if whole:
            make_engine = cli.make_engine
            cli.make_engine = lambda a, device="cuda": (eng, processor)
            cwd = os.getcwd()
            os.chdir(work)
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
                cli.emit_caption(captions, model, img_file,
                                 cli.run_engine(eng, processor, model, prompt, image))
        if cuda:
            torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in wrappers.items()}
        eng._spec.on_verify = None
        gens = [[]]  # the cycles of each caption: inside one, cur rises every cycle
        for i, (cur, n) in enumerate(seen):
            if i and cur <= seen[i - 1][0]:
                gens.append([])
            gens[-1].append(n)
        want = {k: sum(spec_launches(g, G, L, lm=draft == "int4", int4=True)[k] for g in gens)
                for k in wrappers}
        want["K2"] = len(files)  # the target's prefill, once a caption
        holds, direct = [], os.path.join(work, "direct.jsonl")
        for img_file, a, gr in zip(files, direct_args, greedy):
            hold = spec_hold(eng._spec, a, f"chair_cli --spec-draft {draft} {img_file}", gr,
                             exact=False)
            holds.append({k: v for k, v in hold.items() if k != "tokens"})
            cli.emit_caption(direct, model, img_file, processor.decode(hold["tokens"]))
        recs = sorted((json.loads(line) for line in open(captions)), key=lambda r: r["image_id"])
        same = recs == [json.loads(line) for line in open(direct)]  # files are in id order
        print(f"chair_cli --original --spec-gamma {G} --spec-draft {draft}: {len(recs)} captions "
              f"in {cli_s:.2f} s, equal to generate_fused made directly: {same}; launches {counts} "
              f"(want {want}); first caption: {recs[0]['caption']!r}")
        if not same or len(recs) != len(files):
            raise AssertionError(f"chair_cli --spec-draft {draft}: CLI captions differ")
        (check_counts or _check_counts)(f"chair_cli --spec-draft {draft}", counts, want)
        record[f"--spec-draft {draft}"] = {"captions_s": cli_s, "launches": counts, "holds": holds}
        captions_by_arm[draft] = recs

    # --- the consistency analyses over the int4 arm's captions ---
    recs = captions_by_arm["int4"]
    if not os.path.isdir(os.path.join(coco, "annotations")):
        _write_coco(coco, files, images)
    ev = ChairEvaluator([r["image_id"] for r in recs])
    ev.load_annotations(os.path.join(coco, "annotations"))
    cap_dict = ev.compute(recs)
    hallucinated = sum(len(s["hallucination_idxs"]) for s in cap_dict["sentences"])
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    lm = cli.lm_consistency_report(eng, processor, model, recs, cap_dict,
                                   os.path.join(work, "smoke_lm_consistency.json"))
    lm_s = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    words = {r["image_id"]: len(r["caption"].split()) for r in recs}
    if {k: len(v) for k, v in lm["distributions"].items()} != words or any(
            not d for v in lm["distributions"].values() for d in v.values()):
        raise AssertionError("--consistency: a caption word without its distribution")
    (check_counts or _check_counts)("chair_cli --consistency", counts, dict.fromkeys(wrappers, 0))
    print(f"chair_cli --consistency: {hallucinated} hallucinated words in {len(recs)} captions, "
          f"mean blank-image rank {lm['mean_rank']:.2f}, per image {lm['per_image']}; {lm_s:.2f} s, "
          f"launches {counts}")
    record["--consistency"] = {"mean_rank": lm["mean_rank"], "hallucinated": hallucinated,
                               "seconds": lm_s}
    tables = []
    eng.on_prefill = lambda logits, st: tables.append(exact_top_k_ids(logits, eng.ens.topk)[0])
    for fn in wrappers.values():
        fn.launches = 0
    by_id = {int(f[-10:-4]): image for f, image in zip(files, images)}
    t0 = time.perf_counter()
    try:
        im = cli.im_consistency_report(eng, processor, "projection", recs, cap_dict, by_id.get,
                                       os.path.join(work, "smoke_im_consistency.json"))
    finally:
        eng.on_prefill = None
    im_s = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    token_table = class_token_table(processor.tokenizer, coco_class_words())
    twin = [projection_labels(t, token_table) for t in tables]
    print(f"chair_cli --consistency-im projection: {im['consistency']:.3f} of {im['hallucinated']} "
          f"hallucinated objects fired, labels {[sorted(v) for v in im['labels'].values()]}, equal "
          f"to the plain table's: {list(im['labels'].values()) == twin}; {im_s:.2f} s, launches "
          f"{counts}")
    if list(im["labels"].values()) != twin:
        raise AssertionError("--consistency-im: labels differ from the plain top-k table's")
    (check_counts or _check_counts)("chair_cli --consistency-im", counts,
                                    {**dict.fromkeys(wrappers, 0), "K2": len(files)})
    record["--consistency-im projection"] = {"consistency": im["consistency"],
                                             "hallucinated": im["hallucinated"], "seconds": im_s}
    return record


def end_to_end() -> tuple:
    """The main paths at full width and depth: LlavaEngine.generate at
    LLaVA-1.5-7B with synthetic bf16 weights and a bf16 cache, then with
    synthetic int8 fused weights and an int8 cache, then with synthetic
    packed int4 fused weights, an int8 head and an int8 cache;
    LlavaNextEngine.generate at LLaVA-v1.6-Mistral-7B with synthetic bf16
    weights; on bf16, int4 and NeXT, POPE (``pope_full``); serving on bf16
    (``serving_full``), w8a8 on the int8 weights (``w8a8_full``) and on
    NeXT (``serving_next``); speculative greedy decoding on bf16
    (``speculative_full``).  Returns each kernel's launch count from the
    exact K=3 run of the path that runs it (the server's K1 from its exact
    and fused runs, the int4 self-draft's K1 and K6 from its speculative
    run), ``pope_full``'s records by tier, the serving records and the
    speculative ones."""
    import gc

    import numpy as np

    from dropoutdecoding_tpu_torch.engine import baselines
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
    from dropoutdecoding_tpu_torch.utils.quantize import int8_column_major

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    cfg = LlavaConfig()  # LLaVA-1.5-7B: Vicuna-7B + CLIP ViT-L/336
    rng = np.random.default_rng(11)
    ids = rng.integers(2, 32000, size=(1, 20))
    ids[0, 0], ids[0, 5] = 1, cfg.image_token_index  # BOS; "USER: <image> ..."
    pixels = rng.normal(size=(1, 3, 336, 336)).astype(np.float32)

    def llava(params, int8_kv):
        return lambda ensemble, gen, **fields: LlavaEngine(
            cfg=cfg, params=params, gen=gen, max_len=1152, ensemble=ensemble, int8_kv=int8_kv,
            **fields,
        )  # 1152 = 576 + 64 + 512

    def llava_pair_engine(params, int8_kv):  # batch_of_two's engine
        return lambda gen, uniform: LlavaEngine(cfg=cfg, params=params, max_len=1152, ensemble=True,
                                                int8_kv=int8_kv, gen=gen, uniform=uniform)

    params, secs = _sync_time(lambda: synthetic_llava_params(cfg, "cuda", torch.bfloat16, seed=0))
    print(f"synthetic 7B params: {torch.cuda.memory_allocated() / 2**30:.2f} GiB in {secs:.1f} s")
    drive(llava(params, False), (ids, pixels), "bf16", LLAVA_RUNS, EnsembleConfig())
    step_costs(cfg.vision.num_patches, cfg.text.vocab_size)
    batch_of_two(llava_pair_engine(params, False), llava_pair(cfg), "bf16", int8_kv=False)
    base = baselines_full(llava(params, False), (ids, pixels), "bf16")
    speculative, spec_s = _wall(lambda: speculative_full(params, cfg, ids, pixels))
    speculative["seconds"] = spec_s
    # POPE (one token a question): two images of their own
    prng = np.random.default_rng(23)
    pope_pixels = prng.normal(size=(2, 3, 336, 336)).astype(np.float32)
    no_kernel = dict.fromkeys(_wrappers(), 0)
    L = cfg.text.num_hidden_layers
    pope = {"bf16": pope_full(llava(params, False)(True, GenerationConfig()), (pope_pixels,), "bf16",
                              no_kernel)}
    serving = {"bf16": serving_full(llava(params, False), cfg)}

    # free the bf16 tower before the int8 one exists; keep vision + projector
    vision, projector = params.vision, params.projector
    del params
    free()
    lm, secs = _sync_time(lambda: synthetic_int8_lm(cfg.text, "cuda", seed=0))
    params = LlavaParams(vision, projector, lm)
    print(f"synthetic int8 7B params: {torch.cuda.memory_allocated() / 2**30:.2f} GiB in {secs:.1f} s")
    int8 = drive(llava(params, True), (ids, pixels), "int8", [GREEDY, EXACT, FUSED],
                 EnsembleConfig(), int8_kv=True)["exact K=3"]
    batch_of_two(llava_pair_engine(params, True), llava_pair(cfg), "int8", int8_kv=True)
    colmajor = params._replace(lm=int8_column_major(params.lm))  # the CLI's w8a8 layout
    serving["w8a8"] = w8a8_full(llava(params, True), llava(colmajor, True), cfg)
    del colmajor
    del params, lm
    free()
    lm, secs = _sync_time(lambda: synthetic_int4_lm(cfg.text, "cuda", seed=0))
    params = LlavaParams(vision, projector, lm)
    print(f"synthetic int4 7B params: {torch.cuda.memory_allocated() / 2**30:.2f} GiB in {secs:.1f} s")
    int4 = drive(llava(params, True), (ids, pixels), "int4", [GREEDY, EXACT, FUSED],
                 EnsembleConfig(), int8_kv=True, int4=True)["exact K=3"]
    pope["int4"] = pope_full(llava(params, True)(True, GenerationConfig()), (pope_pixels,), "int4",
                             {**no_kernel, "K6": 4 * L})  # the head is int8: 4 K6 launches a layer
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
    def make_next(ensemble, gen, **fields):
        return LlavaNextEngine(
            cfg=ncfg, params=params, gen=gen, seed=506, ensemble=ensemble,
            max_len=llavanext.max_image_tokens(ncfg) + 64 + 512, **{"ens": ens, **fields},
        )

    nxt = drive(make_next, (ids, tiles, size), "next", [GREEDY, EXACT, FUSED], ens)["exact K=3"]
    noised = baselines.noised_pixels(make_next(False, GenerationConfig()), tiles)
    baselines_full(make_next, (ids, tiles, size), "next", noised=noised)
    step_costs(llavanext.max_image_tokens(ncfg), ncfg.text.vocab_size)
    sizes = [(480, 640), (427, 640)]  # 5 tiles each; 2340 and 2144 of 2928 slots real
    pope_tiles = [prng.normal(size=(llavanext.image_geometry(s, ncfg)["n_tiles"], 3, 336, 336))
                  .astype(np.float32) for s in sizes]
    pope["next"] = pope_full(make_next(True, GenerationConfig()), (pope_tiles, sizes), "next",
                             {**no_kernel, "K5": ncfg.text.num_hidden_layers})  # each prefill's layers
    serving["next"] = serving_next(make_next, ncfg, tiles, size)
    del params
    free()
    launches = {
        "K1": nxt["K1"], "K1 VCD": base["VCD"]["K1"], "K1 beam": base["beam search nb=3"]["K1"],
        "K2": nxt["K2"], "K3": int8["K3"], "K4": int8["K4"], "K5": nxt["K5"], "K6": int4["K6"],
        "K1 serving": serving["bf16"]["exact"]["launches"]["K1"],
        "K1 serving fused": serving["bf16"]["fused"]["launches"]["K1"],
        "K1 speculative draft": speculative["int4 draft"]["launches"]["K1"],
        "K6 speculative draft": speculative["int4 draft"]["launches"]["K6"],
    }
    return launches, pope, serving, speculative


def vit_flops(vc, images: int) -> float:
    """The EVA ViT's matmul operations (2 a multiply-add) over ``images``:
    qkv, projection and MLP of every token, and the two attention products
    over its 1 + P tokens."""
    S, D, I = vc.num_positions, vc.hidden_size, vc.intermediate_size
    return images * vc.num_hidden_layers * (2 * S * (4 * D * D + 2 * D * I) + 4 * S * S * D)


def pope_instructblip(eng, pixels) -> dict:
    """POPE at full width and depth on InstructBLIP: twelve questions, six on
    each of two images (``pixels`` [2, 3, 224, 224]), each with its LM ids
    and its Q-Former ids, through the batched ``probe`` the CLI makes (groups
    of 8 right-padded rows, the Q-Former ids padded with their mask, the
    unique images by ``image_index``, a short group filled from its last
    row) and ``probe`` a row at a time.  The first group's vision tower must
    run on 2 images and its Q-Former on 8 rows (counted at the models'
    ``apply``); the modes must agree within ``POPE_MODES_RTOL`` of the
    largest |logit|, first tokens equal wherever the top-2 margin exceeds
    that bound; no kernel launches (a probe skips K2 and the cache, and 40
    tokens are far below K5's switch).  Returns ms a question and the device
    peak of each mode."""
    import numpy as np

    from dropoutdecoding_tpu_torch.models import blip_vit, qformer

    rng = np.random.default_rng(43)
    lengths = (6, 9, 11, 7, 8, 10, 11, 6, 9, 8, 10, 7)
    rows = [np.array([1, *rng.integers(2, 32000, size=n)]) for n in lengths]
    q_rows = [np.array([101, *rng.integers(1000, 30522, size=n - 2), 102]) for n in lengths]
    owner = [i // 6 for i in range(12)]
    wrappers, seen = _wrappers(), []
    vit_apply, qformer_apply = blip_vit.apply, qformer.apply

    def batched():
        return pope_direct(eng, rows, owner, lambda unique: (pixels[unique],),
                           q_rows=q_rows)[0].last_logits

    def per_row():
        return torch.cat([eng.probe(r[None], pixels[[o]], q[None]).last_logits
                          for r, q, o in zip(rows, q_rows, owner)])

    logits, record = {}, {}
    blip_vit.apply = lambda c, p, px: seen.append(("vit", px.shape[0])) or vit_apply(c, p, px)
    qformer.apply = lambda c, p, i, *a: seen.append(("qformer", i.shape[0])) or qformer_apply(c, p, i, *a)
    try:
        for mode, fn in (("batched probe", batched), ("per-row probe", per_row)):
            fn()  # warm-up
            seen.clear()
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.reset_peak_memory_stats()
            out, secs = _sync_time(fn)
            counts = {k: w.launches for k, w in wrappers.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            logits[mode] = out.float()
            record[mode] = {"ms_a_question": secs * 1e3 / 12, "launches": counts, "peak_gib": peak,
                            "towers": list(seen)}
            print(f"pope instructblip {mode}: {secs * 1e3 / 12:.2f} ms a question ({secs * 1e3:.1f} "
                  f"ms for 12), device peak {peak:.2f} GiB, launches {counts}; the towers' rows a "
                  f"call {seen}")
            _check_counts(f"pope instructblip {mode}", counts, dict.fromkeys(wrappers, 0))
            if out.shape != (12, eng.cfg.text.vocab_size) or not torch.isfinite(out).all():
                raise AssertionError(f"pope instructblip {mode}: last_logits {tuple(out.shape)}")
    finally:
        blip_vit.apply, qformer.apply = vit_apply, qformer_apply
    if record["batched probe"]["towers"][:2] != [("vit", 2), ("qformer", 8)]:
        raise AssertionError(f"pope instructblip: the first group's towers ran on "
                             f"{record['batched probe']['towers'][:2]}, not 2 images and 8 rows")
    ref = logits["per-row probe"]
    bound = POPE_MODES_RTOL["instructblip"] * ref.abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > bound
    err = (logits["batched probe"] - ref).abs().max().item()
    same = logits["batched probe"].argmax(-1) == ref.argmax(-1)
    print(f"pope instructblip batched against per-row: max |d last_logits| {err:.4f} (bound "
          f"{bound:.4f}); first tokens equal {int(same.sum())} of 12, {int(sure.sum())} rows with a "
          f"top-2 margin over the bound, all equal there: {bool(same[sure].all())}")
    if not err <= bound or not same[sure].all():
        raise AssertionError("pope instructblip: batched and per-row disagree beyond the bound")
    return record


def instructblip_full() -> tuple:
    """``InstructBlipEngine`` at InstructBLIP-Vicuna-7B width and depth
    (EVA ViT-g/14 39 x 1408, Q-Former 12 x 768, 32 queries, Vicuna-7B with
    vocabulary 32001), synthetic bf16 weights, a 20-token instruction and
    its 12 Q-Former ids: greedy, exact K=3 and fused K=3 under
    ``epis_quantile`` through ``drive`` (K1 992 / 1984 / 992, K2 1, K5 0,
    exact); two requests in one batch whose rows stop at different steps
    (``batch_of_two``); VCD, beam search (nb = 3) and OPERA at the CLI's
    defaults (``baselines_full``); the vision tower and the Q-Former on their
    own; POPE (``pope_instructblip``).  Returns (the launches the kernels
    line carries, the POPE record, the towers' record)."""
    import gc

    import numpy as np

    from dropoutdecoding_tpu_torch.engine import baselines
    from dropoutdecoding_tpu_torch.engine.instructblip_engine import InstructBlipEngine
    from dropoutdecoding_tpu_torch.models import blip_vit, qformer
    from dropoutdecoding_tpu_torch.models import instructblip as ib_mod
    from dropoutdecoding_tpu_torch.utils.config import (
        EnsembleConfig,
        GenerationConfig,
        InstructBlipConfig,
    )
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_instructblip_params

    cfg = InstructBlipConfig()
    rng = np.random.default_rng(37)
    ids = rng.integers(2, 32000, size=(2, 20))
    ids[:, 0] = 1
    q_ids = rng.integers(1000, 30522, size=(2, 12))
    q_ids[:, 0], q_ids[:, -1] = 101, 102  # BERT's [CLS] ... [SEP]
    pixels = rng.normal(size=(2, 3, 224, 224)).astype(np.float32)
    params, secs = _sync_time(
        lambda: synthetic_instructblip_params(cfg, "cuda", torch.bfloat16, seed=0))
    n = sum(t.numel() for part in params for t in _leaves(part))
    print(f"synthetic InstructBLIP-Vicuna-7B params: {n / 1e9:.3f} B, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB in {secs:.1f} s")
    ens = EnsembleConfig(**IB_ENS)

    def make(ensemble, gen, **fields):
        return InstructBlipEngine(
            cfg=cfg, params=params, gen=gen, seed=IB_SEED, ensemble=ensemble,
            max_len=cfg.num_query_tokens + 64 + 512, **{"ens": ens, **fields},
        )  # 608: the CLI's capacity

    one = (ids[:1], pixels[:1], q_ids[:1])
    runs = drive(make, one, "instructblip", [GREEDY, EXACT, FUSED], ens)
    batch_of_two(lambda gen, uniform: make(True, gen, uniform=uniform), (ids, pixels, q_ids),
                 "instructblip", int8_kv=False, seed=IB_SEED)
    noised = baselines.noised_pixels(make(False, GenerationConfig()), pixels[0])[None]
    base = baselines_full(make, one, "instructblip", noised=noised)

    # the vision tower and the Q-Former on their own, one image
    px = torch.as_tensor(pixels[:1], device="cuda")
    qt = torch.as_tensor(q_ids[:1], device="cuda")
    embeds = blip_vit.apply(cfg.vision, params.vision, px)
    towers = {
        "vit_ms": _eager_ms(lambda: blip_vit.apply(cfg.vision, params.vision, px)),
        "vit_device_ms": time_ms(lambda: blip_vit.apply(cfg.vision, params.vision, px), reps=10),
        "qformer_ms": _eager_ms(lambda: qformer.apply(cfg.qformer, params.qformer, qt, embeds)),
        "visual_tokens_ms": _eager_ms(lambda: ib_mod.visual_tokens(cfg, params, px, qt)),
    }
    flops = vit_flops(cfg.vision, 1)
    towers["vit_tflops"] = flops / towers["vit_device_ms"] / 1e9
    print(f"instructblip towers, one image: ViT-g {towers['vit_ms']:.2f} ms (host included), "
          f"{towers['vit_device_ms']:.2f} ms device (graph replay), {flops / 1e12:.3f} TFLOP, "
          f"{towers['vit_tflops']:.1f} TFLOP/s, bound {flops / PEAK_OPS_PER_S['bf16'] * 1e3:.3f} ms "
          f"by operations; Q-Former {towers['qformer_ms']:.2f} ms (host included); "
          f"visual_tokens {towers['visual_tokens_ms']:.2f} ms (host included)")
    pope_px = np.random.default_rng(47).normal(size=(2, 3, 224, 224)).astype(np.float32)
    pope = pope_instructblip(make(True, GenerationConfig()), pope_px)
    del params, embeds
    gc.collect()
    torch.cuda.empty_cache()
    launches = {
        "K1 InstructBLIP": runs["exact K=3"]["K1"], "K1 InstructBLIP fused": runs["fused K=3"]["K1"],
        "K1 InstructBLIP VCD": base["VCD"]["K1"],
        "K1 InstructBLIP beam": base["beam search nb=3"]["K1"],
        "K2 InstructBLIP": runs["exact K=3"]["K2"],
    }
    return launches, pope, towers


def _leaves(tree):
    """The tensors of a params part (dicts and lists of them)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


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


# Salesforce/instructblip-vicuna-7b's config.json: the keys that fix the
# model's shapes (EVA ViT-g/14 at 224 px, the Q-Former with its 30523-id BERT
# vocabulary and 32 queries, Vicuna-7B with 32001 ids)
INSTRUCTBLIP_7B_HF_CONFIG = {
    "architectures": ["InstructBlipForConditionalGeneration"],
    "initializer_factor": 1.0,
    "initializer_range": 0.02,
    "model_type": "instructblip",
    "num_query_tokens": 32,
    "qformer_config": {
        "attention_probs_dropout_prob": 0.1,
        "cross_attention_frequency": 2,
        "encoder_hidden_size": 1408,
        "hidden_act": "gelu",
        "hidden_size": 768,
        "intermediate_size": 3072,
        "layer_norm_eps": 1e-12,
        "max_position_embeddings": 512,
        "model_type": "instructblip_qformer",
        "num_attention_heads": 12,
        "num_hidden_layers": 12,
        "vocab_size": 30523,
    },
    "text_config": {
        "architectures": ["LlamaForCausalLM"],
        "hidden_size": 4096,
        "intermediate_size": 11008,
        "max_position_embeddings": 2048,
        "model_type": "llama",
        "num_attention_heads": 32,
        "num_hidden_layers": 32,
        "pad_token_id": 0,
        "rms_norm_eps": 1e-06,
        "tie_word_embeddings": False,
        "torch_dtype": "float16",
        "vocab_size": 32001,
    },
    "tie_word_embeddings": False,
    "torch_dtype": "float32",
    "use_decoder_only_language_model": True,
    "vision_config": {
        "hidden_act": "gelu",
        "hidden_size": 1408,
        "image_size": 224,
        "intermediate_size": 6144,
        "layer_norm_eps": 1e-06,
        "model_type": "instructblip_vision_model",
        "num_attention_heads": 16,
        "num_hidden_layers": 39,
        "patch_size": 14,
        "qkv_bias": True,
    },
}
# and its preprocessor_config.json (BlipImageProcessor: 224 x 224, no crop)
INSTRUCTBLIP_7B_HF_PREPROCESSOR = {
    "do_convert_rgb": True,
    "do_normalize": True,
    "do_rescale": True,
    "do_resize": True,
    "image_mean": [0.48145466, 0.4578275, 0.40821073],
    "image_processor_type": "BlipImageProcessor",
    "image_std": [0.26862954, 0.26130258, 0.27577711],
    "processor_class": "InstructBlipProcessor",
    "resample": 3,
    "rescale_factor": 0.00392156862745098,
    "size": {"height": 224, "width": 224},
}


def llava_hf_tensors(cfg, params) -> list:
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
    _hf_lm_tensors(tc, lm, add)
    return out


def _hf_lm_tensors(tc, lm: dict, add) -> None:
    """``add(HF name, make)`` of every leaf of the Llama tower ``lm`` under
    ``language_model.``, layer by layer (the inverse of
    ``llama.params_from_hf``)."""
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


def instructblip_hf_tensors(cfg, params) -> list:
    """The inverse of ``models.instructblip.params_from_hf``: [(HF name,
    shape, make)] of an InstructBlipForConditionalGeneration checkpoint, the
    ViT's fused qkv bias with a zero k third, the Q-Former's leaves by its
    own name map (``qformer.hf_layer_leaves``)."""
    from dropoutdecoding_tpu_torch.models import qformer

    vc, qc = cfg.vision, cfg.qformer
    vis, qf, proj, lm = params
    out = []

    def add(name, make):
        out.append((name, tuple(make().shape), make))

    v, D, P = "vision_model.", vc.hidden_size, vc.patch_size
    add(v + "embeddings.class_embedding", lambda: vis["class_embedding"].reshape(1, 1, D))
    add(v + "embeddings.position_embedding", lambda: vis["position_embedding"][None])
    add(v + "embeddings.patch_embedding.weight",
        lambda: vis["patch_embedding"].t().reshape(D, 3, P, P))
    add(v + "embeddings.patch_embedding.bias", lambda: vis["patch_bias"])
    vl = vis["layers"]
    for i in range(vc.num_hidden_layers):
        e = f"{v}encoder.layers.{i}."
        add(e + "self_attn.qkv.weight", lambda i=i: vl["qkv_w"][i].t())
        add(e + "self_attn.qkv.bias", lambda i=i: torch.cat(
            [vl["q_b"][i], torch.zeros_like(vl["q_b"][i]), vl["v_b"][i]]))
        for hf, ours in (("self_attn.projection", "proj"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            add(f"{e}{hf}.weight", lambda o=ours, i=i: vl[f"{o}_w"][i].t())
            add(f"{e}{hf}.bias", lambda o=ours, i=i: vl[f"{o}_b"][i])
        for hf, ours in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
            add(f"{e}{hf}.weight", lambda o=ours, i=i: vl[f"{o}_w"][i])
            add(f"{e}{hf}.bias", lambda o=ours, i=i: vl[f"{o}_b"][i])
    add(v + "post_layernorm.weight", lambda: vis["post_ln_w"])
    add(v + "post_layernorm.bias", lambda: vis["post_ln_b"])
    add("query_tokens", lambda: qf["query_tokens"][None])
    for hf, ours in (("word_embeddings.weight", "word_embeddings"),
                     ("position_embeddings.weight", "position_embeddings"),
                     ("layernorm.weight", "emb_ln_w"), ("layernorm.bias", "emb_ln_b")):
        add(f"qformer.embeddings.{hf}", lambda o=ours: qf[o])
    for i, lp in enumerate(qf["layers"]):
        for ours, name, transpose in qformer.hf_layer_leaves(qc, i):
            add("qformer." + name, lambda o=ours, lp=lp, t=transpose: lp[o].t() if t else lp[o])
    add("language_projection.weight", lambda: proj["w"].t())
    add("language_projection.bias", lambda: proj["b"])
    _hf_lm_tensors(cfg.text, lm, add)
    return out


_ST_NAMES = {torch.bfloat16: "BF16", torch.float32: "F32", torch.float16: "F16"}


def write_hf_checkpoint(path, tensors: list, files: dict, shards: int = 3) -> int:
    """An HF checkpoint directory: each of ``files`` ({name: dict}) as JSON
    (config.json, preprocessor_config.json), and ``tensors`` ([(HF name,
    shape, make)], ``make()`` giving the tensor, all of one dtype) in
    ``shards`` .safetensors files (the format: an 8-byte little-endian
    header length, a JSON header padded to 8 bytes, the raw bytes) with a
    ``model.safetensors.index.json``.  One tensor is on the host at a time.
    Returns the bytes written."""
    import numpy as np

    os.makedirs(path, exist_ok=True)
    for name, content in files.items():
        with open(os.path.join(path, name), "w") as f:
            json.dump(content, f, indent=2)
    dtype = tensors[0][2]().dtype
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
    fixed word list: a prompt word's id is a hash of it below ``vocab``
    (and 32000), "<image>" is LLaVA's image token, and an id decodes to a
    word of ``WORDS``.  InstructBLIP's pair is two of them, the Q-Former's at
    its vocabulary."""

    WORDS = ("a", "dog", "sits", "on", "the", "chair", "next", "to", "table", "with", "cat",
             "and", "person", "car", "near", "bed", "in", "room.", "no")
    eos_token_id = 2

    def __init__(self, image_token_index: int, vocab: int):
        self.image, self.vocab = image_token_index, vocab

    def __call__(self, text, return_tensors=None, add_special_tokens=True):
        import zlib

        import numpy as np

        ids = [1] * add_special_tokens + [
            self.image if w == "<image>" else 3 + zlib.crc32(w.encode()) % (min(self.vocab, 32000) - 3)
            for w in text.split()
        ]
        return {"input_ids": np.array([ids], np.int64) if return_tensors == "np" else ids}

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
              check_counts=None, model: str = "llava-1.5") -> dict:
    """The port's CHAIR CLI on a real checkpoint layout, ``model``
    LLaVA-1.5-7B or (``"instructblip"``) InstructBLIP-Vicuna-7B at full
    width and depth with synthetic bf16 weights, written in the HF sharded
    layout (the published config.json and preprocessor_config.json, three
    .safetensors shards and the index) under ``.smoke_ckpt/``, loaded
    through the CLI's own ``build_engine`` (no cache), leaves checked
    bit-equal to what was written; then the CLI captions two images with the
    default Dropout Decoding arm, ``--original``, ``--vcd``, ``--original
    --num-beams 3`` and ``--opera`` (``max_new`` tokens, no eos), a stand-in
    tokenizer (InstructBLIP: a pair, the Q-Former's ids below its
    vocabulary) inside the real ``VlmProcessor`` and the image preprocessor
    the checkpoint's config names: ``main`` whole where PIL and nltk are
    importable, else ``run_engine`` + ``emit_caption`` per image.  Every
    caption must equal the arm's engine call made directly (``generate``,
    ``vcd_generate``, ``beam_generate``, ``opera_generate``), and the CLI's
    run launches K1 32 times a step on ``--original``, VCD (over 2 rows) and
    beam search (over 3), 64 on the default arm and none under OPERA, K2
    once a prefill (twice a caption under VCD).  Then the POPE CLI on the
    same engine (``pope_cli``) and, on LLaVA-1.5, the serve CLI
    (``serve_cli``), then ``--spec-gamma`` and the consistency analyses
    (``spec_consistency_cli``).  ``cfg`` / ``config`` / ``device`` make a
    narrow rehearsal on the CPU possible.  Returns the phase's numbers."""
    import dataclasses
    import importlib.util
    import resource
    import shutil

    import numpy as np

    from dropoutdecoding_tpu_torch.cli import chair_test as cli
    from dropoutdecoding_tpu_torch.engine import baselines, opera
    from dropoutdecoding_tpu_torch.utils.config import (
        GenerationConfig,
        InstructBlipConfig,
        LlavaConfig,
    )
    from dropoutdecoding_tpu_torch.utils.convert import (
        synthetic_instructblip_params,
        synthetic_llava_params,
    )
    from dropoutdecoding_tpu_torch.utils.processor import (
        VlmProcessor,
        image_preprocessor_from_checkpoint,
    )

    ib = model == "instructblip"
    if ib:
        config = config or INSTRUCTBLIP_7B_HF_CONFIG
        cfg = cfg or InstructBlipConfig.from_hf_dict(config)
        Config, synthetic, hf_tensors = InstructBlipConfig, synthetic_instructblip_params, instructblip_hf_tensors
        px = cfg.vision.image_size  # 224: the published file
        preprocessor = {**INSTRUCTBLIP_7B_HF_PREPROCESSOR, "size": {"height": px, "width": px}}
        towers = {  # leaves of the vision tower, the Q-Former and the projection
            "patch_embedding": lambda p: p.vision["patch_embedding"],
            "qkv_w[0]": lambda p: p.vision["layers"]["qkv_w"][0],
            "q_b[0]": lambda p: p.vision["layers"]["q_b"][0],
            "v_b[-1]": lambda p: p.vision["layers"]["v_b"][-1],
            "query_tokens": lambda p: p.qformer["query_tokens"],
            "qformer cross_k_w[0]": lambda p: p.qformer["layers"][0]["cross_k_w"],
            "qformer outq_w[-1]": lambda p: p.qformer["layers"][-1]["outq_w"],
            "projection": lambda p: p.projection["w"],
        }
    else:
        config = config or LLAVA_7B_HF_CONFIG
        cfg = cfg or LlavaConfig()
        Config, synthetic, hf_tensors = LlavaConfig, synthetic_llava_params, llava_hf_tensors
        px = cfg.vision.image_size  # 336: the published file
        preprocessor = {**LLAVA_7B_HF_PREPROCESSOR, "crop_size": {"height": px, "width": px},
                        "size": {"shortest_edge": px}}
        towers = {"patch_embedding": lambda p: p.vision["patch_embedding"]}
    if Config.from_hf_dict(config) != cfg:
        raise AssertionError("config.json does not describe the model written")
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(root, ".smoke_ckpt")  # listed in .gitignore
    cuda = device == "cuda"
    record = {}
    try:
        # --- write the checkpoint, keep a sample of its leaves ---
        params = synthetic(cfg, device, torch.bfloat16, seed=0)
        L = cfg.text.num_hidden_layers
        ll = params.lm["layers"]
        sample = {"embed_tokens": params.lm["embed_tokens"].clone(),
                  "lm_head": params.lm["lm_head"].clone(),
                  **{k: get(params).clone() for k, get in towers.items()}}
        for i in (0, L - 1):
            for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
                sample[f"{n}[{i}]"] = ll[n][i].clone()
        t0 = time.perf_counter()
        nbytes = write_hf_checkpoint(ckpt, hf_tensors(cfg, params), {
            "config.json": config, "preprocessor_config.json": preprocessor})
        write_s = time.perf_counter() - t0
        del params, ll
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # --- load through the CLI ---
        args = cli.build_parser().parse_args(
            ["--coco-data-dir", "unused", "--model-path", ckpt, "--image-numbers", "2",
             "--model", model])
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
               **{k: get(engine.params) for k, get in towers.items()}}
        for i in (0, L - 1):
            for n, (a, b) in spans.items():
                got[f"{n}[{i}]"] = ll["qkv_proj"][i][:, a:b]  # build_engine fuses q/k/v
            got[f"o_proj[{i}]"] = ll["o_proj"][i]
        unequal = [k for k in sample if not torch.equal(got[k], sample[k])]
        print(f"chair_cli {model}: wrote {nbytes / 2**30:.2f} GiB in 3 shards in {write_s:.1f} s; "
              f"build_engine {load_s:.1f} s, host RSS {rss0:.2f} GiB before, peak {host_peak:.2f} "
              f"GiB during it (ru_maxrss of the run "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB), device peak "
              f"{dev_peak:.2f} GiB; {len(sample)} leaves compared, bit-equal: {not unequal}")
        if unequal:
            raise AssertionError(f"chair_cli: loaded leaves differ from the written ones: {unequal}")
        del got, sample, lm, ll

        # --- caption through the CLI ---
        image_prep = image_preprocessor_from_checkpoint(ckpt)
        if ib:
            processor = VlmProcessor(
                _StandInTokenizer(None, cfg.text.vocab_size), image_prep,
                qformer_tokenizer=_StandInTokenizer(None, cfg.qformer.vocab_size))
        else:
            processor = VlmProcessor(
                _StandInTokenizer(cfg.image_token_index, cfg.text.vocab_size), image_prep)
        print(f"chair_cli {model}: image preprocessor {type(image_prep).__name__}")
        whole = all(importlib.util.find_spec(m) for m in ("PIL", "nltk"))
        print(f"chair_cli {model}: " + ("main whole (PIL and nltk importable)" if whole else
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
        prompt = cli.PROMPTS[model]

        if ib:  # the engine calls of each arm on the direct inputs a = (ids, pixels, q ids)
            def vcd(e, a):
                noised = torch.stack([baselines.noised_pixels(e, p) for p in a[1]])
                return baselines.vcd_generate(e, states=(e.prefill(*a),
                                                         e.prefill(a[0], noised, a[2])))

            def beam(e, a):
                return baselines.beam_generate(e, state=e.prefill(*a), num_beams=3)

            def opera_call(e, a):
                return opera.opera_generate(e, state=e.prefill(*a), **OPERA_CLI)
        else:
            def vcd(e, a):
                return baselines.vcd_generate(e, *a)

            def beam(e, a):
                return baselines.beam_generate(e, *a, num_beams=3)

            def opera_call(e, a):
                return opera.opera_generate(e, *a, **OPERA_CLI)

        arms = (  # (arm, flags, the engine call the CLI must make, K1 forwards a step, K2 a caption)
            ("dropout decoding", [], lambda e, a: e.generate(*a), 2, 1),
            ("--original", ["--original", "True"], lambda e, a: e.generate(*a), 1, 1),
            ("--vcd", ["--vcd", "True"], vcd, 1, 2),
            ("--num-beams 3", ["--original", "True", "--num-beams", "3"], beam, 1, 1),
            ("--opera", ["--opera", "True"], opera_call, 0, 1),
        )
        for arm, extra, direct_call, forwards, prefills in arms:
            work = os.path.join(ckpt, "run")
            shutil.rmtree(work, ignore_errors=True)
            os.makedirs(work)
            arm_args = cli.build_parser().parse_args(
                ["--coco-data-dir", coco, "--model-path", ckpt, "--image-numbers", "2",
                 "--seed", "0", "--method", "smoke", "--output-dir", os.path.join(work, "out"),
                 "--sample-save-name", os.path.join(work, "sample.log"), "--model", model] + extra)
            opera_arm, vcd_arm = cli.str2bool(arm_args.opera), cli.str2bool(arm_args.vcd)
            eng = dataclasses.replace(  # the arm's engine as build_engine makes it
                engine, gen=dataclasses.replace(gen, num_beams=cli.beam_count(arm_args),
                                                use_cd=vcd_arm),
                ensemble=not (cli.str2bool(arm_args.original) or vcd_arm or opera_arm))
            if opera_arm:
                eng._opera = cli.opera_knobs(arm_args, eng.gen.num_beams)
                if eng._opera != {**OPERA_CLI, "length_penalty": 1.0}:
                    raise AssertionError(f"chair_cli --opera: knobs {eng._opera}")
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
                    text = cli.run_engine(eng, processor, model, prompt, image)
                    cli.emit_caption(captions, model, img_file, text)
            if cuda:
                torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in wrappers.items()}
            direct = os.path.join(work, "direct.jsonl")
            for img_file, image in zip(files, images):
                inputs = processor(prompt, image)
                a = (inputs["input_ids"], inputs["pixel_values"])
                result = direct_call(eng, a + (processor.qformer_ids(prompt),) if ib else a)
                cli.emit_caption(direct, model, img_file,
                                 processor.decode(result.tokens[0][: result.num_tokens[0]]))
            recs = sorted((json.loads(line) for line in open(captions)), key=lambda r: r["image_id"])
            same = recs == [json.loads(line) for line in open(direct)]  # files are in id order
            steps = len(files) * (max_new - 1)
            want = {"K1": steps * L * forwards, "K2": len(files) * prefills,
                    "K3": 0, "K4": 0, "K5": 0, "K6": 0}
            print(f"chair_cli {model} {arm}: {len(recs)} captions in {cli_s:.2f} s through the CLI, "
                  f"equal to the engine call made directly: {same}; launches {counts} (want "
                  f"{want}); first caption: {recs[0]['caption']!r}")
            if not same or len(recs) != len(files):
                raise AssertionError(f"chair_cli {arm}: CLI captions differ from the engine call's")
            (check_counts or _check_counts)(f"chair_cli {model} {arm}", counts, want)
            record[arm] = {"captions_s": cli_s, "launches": counts}
        record["pope_cli"] = pope_cli(engine, processor, ckpt, device, check_counts,
                                      "instructblip" if ib else "llava")
        if not ib:  # the serve CLI serves LLaVA-1.5 and NeXT only
            record["serve_cli"] = serve_cli(engine, processor, ckpt, device, check_counts,
                                            max_new)
            del engine, eng  # the speculative engine loads the checkpoint anew
            if cuda:
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            record["spec_consistency_cli"] = spec_consistency_cli(
                ckpt, coco, files, images, processor, device, check_counts, max_new, whole)
            record["spec_consistency_cli"]["seconds"] = time.perf_counter() - t0
        record.update(write_s=write_s, load_s=load_s, host_peak_gib=host_peak,
                      device_peak_gib=dev_peak, whole_main=whole)
        return record
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def serve_cli(engine, vlm_processor, root: str, device: str = "cuda", check_counts=None,
              max_new: int = 16) -> dict:
    """The port's serve CLI on the engine ``chair_cli`` loaded from its HF
    checkpoint: ``serve.main`` with the CLI's defaults (8 slots, a step
    chunk of 8, fused K=3), its ``make_engine`` giving that engine with the
    serve flags' ensemble and ``max_new`` tokens, its HTTP server bound to
    127.0.0.1 on a free port, in a thread.  Three ``/caption`` and one
    ``/caption_stream`` at once, then ``/stats``: each caption equal to its
    request run alone in an 8-slot server (``alone_in_server``), the
    stream's deltas to its caption, the counters to 4 requests of
    ``max_new`` tokens; K1 launched L times a server step, K2 once a
    request.  Returns the phase's numbers."""
    import concurrent.futures as cf
    import dataclasses
    import http.client
    import threading

    import numpy as np
    from PIL import Image

    from dropoutdecoding_tpu_torch.cli import chair_test as cli
    from dropoutdecoding_tpu_torch.cli import serve
    from dropoutdecoding_tpu_torch.utils.config import GenerationConfig

    args = serve.build_parser().parse_args(["--model-path", root])
    eng = dataclasses.replace(
        engine, ens=cli.build_ensemble_config(args, args.model), ensemble=True,
        gen=GenerationConfig(max_new_tokens=max_new, eos_token_id=-1, pad_token_id=0))
    rng = np.random.default_rng(53)
    paths = []
    for i in range(4):
        paths.append(os.path.join(root, f"serve_{i}.jpg"))
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)).save(paths[-1])
    started = {}

    class Service(serve.CaptionService):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            started["service"] = self

    class LocalServer(serve.ThreadingHTTPServer):
        def __init__(self, address, handler):
            super().__init__(("127.0.0.1", 0), handler)  # main asks for 0.0.0.0:8000
            started["httpd"] = self

    patched = (cli.make_engine, serve.CaptionService, serve.ThreadingHTTPServer)
    cli.make_engine = lambda a, device="cuda": (eng, vlm_processor)
    serve.CaptionService, serve.ThreadingHTTPServer = Service, LocalServer
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    steps = _count_steps(eng)
    thread = threading.Thread(target=serve.main, args=(args, device), daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        while "httpd" not in started:
            if time.perf_counter() - t0 > 60 or not thread.is_alive():
                raise AssertionError("serve_cli: the HTTP server did not start")
            time.sleep(0.05)
        port = started["httpd"].server_address[1]

        def call(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            conn.request(method, path, None if body is None else json.dumps(body))
            resp = conn.getresponse()
            return resp.status, resp.read().decode()

        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=4) as ex:
            futures = [ex.submit(call, "POST", "/caption", {"image_path": p}) for p in paths[:3]]
            futures.append(ex.submit(call, "POST", "/caption_stream", {"image_path": paths[3]}))
            replies = [f.result() for f in futures]
        http_s = time.perf_counter() - t0
        stats = json.loads(call("GET", "/stats")[1])
        counts = {k: fn.launches for k, fn in wrappers.items()}
        n_steps = steps[0]
    finally:
        cli.make_engine, serve.CaptionService, serve.ThreadingHTTPServer = patched
        if "httpd" in started:
            started["httpd"].shutdown()
            started["httpd"].server_close()
        if "service" in started:
            started["service"].close()
        thread.join(30)
        del eng._one_step  # the class's again
    if thread.is_alive():
        raise AssertionError("serve_cli: serve.main did not return after shutdown")
    prompt = cli.PROMPTS[args.model]
    want_captions = []
    for p in paths:
        inputs = vlm_processor(prompt, Image.open(p).convert("RGB"))
        alone = alone_in_server(eng, {"r": (inputs["input_ids"], inputs["pixel_values"])}, max_new)
        want_captions.append(vlm_processor.decode(alone["r"]).strip())
    captions = [json.loads(text)["caption"] for _, text in replies[:3]]
    events = [e[len("data: "):] for e in replies[3][1].split("\n\n") if e]
    deltas = [json.loads(e)["delta"] for e in events[:-1]]
    streamed = " ".join(d for d in deltas if d)  # a delta of special tokens only is empty
    L = eng.cfg.text.num_hidden_layers
    want = {**dict.fromkeys(wrappers, 0), "K1": n_steps * L, "K2": len(paths)}
    ok = (all(s == 200 for s, _ in replies) and captions == want_captions[:3]
          and events[-1] == "[DONE]" and streamed == want_captions[3]
          and stats["requests_done"] == 4 and stats["tokens_generated"] == 4 * max_new)
    print(f"serve_cli: 3 /caption and 1 /caption_stream at once in {http_s:.2f} s over HTTP, "
          f"{n_steps} server steps; captions equal to each request alone in an 8-slot server: "
          f"{captions == want_captions[:3]}, stream ({len(events) - 1} deltas) equal: "
          f"{streamed == want_captions[3]}; /stats {stats}; launches {counts} (want {want}); "
          f"first caption {captions[0]!r}")
    if not ok:
        raise AssertionError(f"serve_cli: replies {replies} / direct {want_captions} / {stats}")
    (check_counts or _check_counts)("serve_cli", counts, want)
    return {"http_s": http_s, "server_steps": n_steps, "stats": stats, "launches": counts}


def pope_cli(engine, vlm_processor, root: str, device: str = "cuda", check_counts=None,
             model: str = "llava") -> dict:
    """The port's POPE CLI on the engine ``chair_cli`` loaded from its HF
    checkpoint: ``pope_test.main(..., device)`` with ``--number 12`` over
    the vendored question sets (two images a set, six questions each), with
    synthetic 640 x 480 JPEGs under the names they read: serial,
    ``--batch-size 8`` and, on LLaVA, ``--prefix-cache True`` (InstructBLIP's
    must exit before the model loads, with the JAX CLI's message).  Each
    answer archive must equal what the same mode's engine calls give when
    made directly (``generate`` of one token a question; ``probe`` over
    groups of 8 right-padded rows with their unique images, InstructBLIP's
    with their padded Q-Former ids; ``probe_prefix`` of each image's shared
    template + ``probe_extend`` of its tails).  Launches: K2 once a question
    serially (``generate``'s prefill; one new token runs no decode step),
    nothing else in any mode.  Answers carry their token ids
    (``vlm_processor``'s word, then the id), so the archives compare tokens.
    ``main`` prints the confusion matrices; this prints the s a question of
    each mode."""
    import dataclasses
    import shutil

    import numpy as np
    from PIL import Image

    from dropoutdecoding_tpu_torch.cli import chair_test as cli
    from dropoutdecoding_tpu_torch.cli import pope_test as pope
    from dropoutdecoding_tpu_torch.engine.instructblip_engine import NO_SHARED_PREFIX
    from dropoutdecoding_tpu_torch.evalsuite.pope import parse_question_file, vendored_question_dir

    ib = model == "instructblip"
    n = 12
    questions = {s: parse_question_file(os.path.join(vendored_question_dir(), f"coco_pope_{s}.json"))[:n]
                 for s in pope.STRATEGIES}
    coco = os.path.join(root, "pope_coco")
    os.makedirs(os.path.join(coco, "val2014"), exist_ok=True)
    rng = np.random.default_rng(29)
    for name in sorted({q["image"] for qs in questions.values() for q in qs}):
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)).save(
            os.path.join(coco, "val2014", name), "JPEG")

    def load(name):
        return Image.open(os.path.join(coco, "val2014", name)).convert("RGB")

    class Answers:  # the processor, its answers carrying their token ids: archives compare tokens
        def __call__(self, *args):
            return vlm_processor(*args)

        def qformer_ids(self, prompt):
            return vlm_processor.qformer_ids(prompt)

        def decode(self, token_ids):
            return f"{vlm_processor.decode(token_ids)} {[int(t) for t in token_ids]}"

    processor = Answers()
    eng = dataclasses.replace(engine)  # main sets its one-token budget on its own copy
    direct = dataclasses.replace(engine, gen=dataclasses.replace(engine.gen, max_new_tokens=1))
    prompt = pope.POPE_PROMPTS[model]

    def ids(p):
        return np.asarray(processor(p)["input_ids"])[0]

    def pixels(name):  # the pixels do not depend on the prompt
        return processor(prompt, load(name))["pixel_values"]

    def serial(prompts, names):
        out = []
        for p, name in zip(prompts, names):
            inputs = processor(p, load(name))
            q = (processor.qformer_ids(p),) if ib else ()
            r = direct.generate(inputs["input_ids"], inputs["pixel_values"], *q)
            out.append(processor.decode(r.tokens[0][: r.num_tokens[0]]).strip())
        return out

    def pick(unique):
        return (np.concatenate([pixels(u) for u in unique]),)

    def tokens(res):
        return [processor.decode([t]).strip() for t in res.first_token.tolist()]

    def batched(prompts, names):
        q_rows = [np.asarray(processor.qformer_ids(p))[0] for p in prompts] if ib else None
        return tokens(pope_direct(direct, [ids(p) for p in prompts], names, pick, q_rows=q_rows)[0])

    def prefixed(prompts, names):
        template = pope.template_prefix_len(ids(prompt.format("aaaa")), ids(prompt.format("zzzz")))
        return tokens(pope_direct(direct, [ids(p) for p in prompts], names, pick, template)[0])

    def argv(extra):
        return ["--model", model, "--model-path", root, "--coco-data-dir", coco, "--pope-dir",
                pope_dir, "--number", str(n), "--seed", "0"] + extra

    wrappers = _wrappers()
    make_engine, record, start = cli.make_engine, {}, time.perf_counter()
    pope_dir = os.path.join(root, "pope_run")
    modes = [("serial", [], serial), ("--batch-size 8", ["--batch-size", "8"], batched)]
    if ib:  # the prefix cache exits before the model loads, with the JAX CLI's message
        try:
            pope.main(pope.build_parser().parse_args(argv(["--prefix-cache", "True"])), device=device)
        except SystemExit as e:
            if str(e) != NO_SHARED_PREFIX:
                raise AssertionError(f"pope_cli --prefix-cache: exit message {e}") from e
        else:
            raise AssertionError("pope_cli --prefix-cache ran on InstructBLIP")
        print("pope_cli instructblip --prefix-cache: exits before the model loads, as the JAX CLI")
    else:
        modes.append(("--prefix-cache", ["--prefix-cache", "True"], prefixed))
    for mode, extra, calls in modes:
        shutil.rmtree(pope_dir, ignore_errors=True)
        args = pope.build_parser().parse_args(argv(extra))
        for w in wrappers.values():
            w.launches = 0
        cli.make_engine = lambda a, device="cuda": (eng, processor)
        try:
            t0 = time.perf_counter()
            pope.main(args, device=device)
            secs = time.perf_counter() - t0
        finally:
            cli.make_engine = make_engine
        counts = {k: w.launches for k, w in wrappers.items()}
        archives = {}
        for f in os.listdir(os.path.join(pope_dir, "answer")):
            if f.endswith("_ans.json"):
                with open(os.path.join(pope_dir, "answer", f)) as fh:
                    archives[f.split("_")[-2]] = [json.loads(line)["answer"] for line in fh]
        want = {s: calls([prompt.format(q["text"]) for q in qs], [q["image"] for q in qs])
                for s, qs in questions.items()}
        total = sum(len(qs) for qs in questions.values())
        want_counts = {**dict.fromkeys(wrappers, 0), "K2": total if mode == "serial" else 0}
        print(f"pope_cli {model} {mode}: {total} questions in {secs:.2f} s through the CLI, "
              f"{secs / total:.4f} s a question; archives equal to the engine calls made directly: "
              f"{archives == want}; answers {sorted(set(a for v in archives.values() for a in v))}; "
              f"launches {counts} (want {want_counts})")
        if archives != want:
            raise AssertionError(f"pope_cli {mode}: archives {archives} != direct calls' {want}")
        (check_counts or _check_counts)(f"pope_cli {model} {mode}", counts, want_counts)
        record[mode] = {"s_a_question": secs / total, "launches": counts}
    shutil.rmtree(pope_dir, ignore_errors=True)
    record["seconds"] = time.perf_counter() - start
    return record


def _table_uniform(seed: int):
    """Members' mask draws from the host, keyed by (seed, step, row, member):
    the same numbers on the card and on the CPU (``LlavaEngine.uniform``)."""
    import numpy as np

    def uniform(step, row, member, n):
        rng = np.random.default_rng([seed, step, row, member])
        return torch.from_numpy(rng.random(n, dtype=np.float32))

    return uniform


def _zero_counts(wrappers: dict) -> None:
    for fn in wrappers.values():
        fn.launches = 0


def _rates(report, label: str) -> None:
    """Every match rate and prefix length of a ``fused_gap`` report in
    range, and every winner distribution a distribution."""
    T = report["config"]["tokens"]
    for key, v in report.items():
        if isinstance(v, dict) and "mean_match_rate" in v:
            if not (0.0 <= v["mean_match_rate"] <= 1.0 and 0.0 <= v["mean_prefix_len"] <= T):
                raise AssertionError(f"{label}: {key} out of range: {v}")
        if key.startswith("winner_dist") and abs(sum(v) - 1.0) > 1e-3:
            raise AssertionError(f"{label}: {key} {v} is not a distribution")
    if not 0.0 <= report["winner_tv_distance"] <= 1.0:
        raise AssertionError(f"{label}: winner TV {report['winner_tv_distance']}")


def fused_gap_narrow() -> dict:
    """``fused_gap``'s ``run_study`` (epis), ``run_int4_study`` and
    ``run_int8_study`` on a narrow fp32 LLaVA (h256, 2 layers, V 512; weights
    x10 as in ``small_reference``), 2 prompts x 12 tokens, on the card
    (kernels) and on the CPU (plain twins) with the same host draws: the
    reports must be equal.  Returns the card's reports."""
    from dropoutdecoding_tpu_torch.cli import fused_gap
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_llava_params

    H, L, V = 256, 2, 512
    cfg = fused_gap._tiny_config(H, L, V)
    base = synthetic_llava_params(cfg, "cpu", torch.float32, seed=3)
    base = LlavaParams(*(_sharpen(p, 10) for p in base))
    build, reports = fused_gap._build, {}
    fused_gap._build = lambda h, l, v, seed, device: (cfg, LlavaParams(*(_to(p, device) for p in base)))
    try:
        for name in ("run_study", "run_int4_study", "run_int8_study"):
            study = getattr(fused_gap, name)
            card, cpu = (study(H, L, V, 2, 1, 12, device=dev, uniform=_table_uniform)
                         for dev in ("cuda", "cpu"))
            print(f"fused_gap narrow {name}: card {json.dumps(card)}")
            if card != cpu:
                raise AssertionError(f"fused_gap {name}: the card's report differs from the CPU's "
                                     f"{json.dumps(cpu)}")
            reports[name] = card
    finally:
        fused_gap._build = build
    return reports


def fused_gap_full(P: int = 2, T: int = 24) -> tuple:
    """``fused_gap``'s production study at LLaVA-1.5-7B width and depth
    (synthetic int8 weights, int8 KV, K = 3, epis, ``P`` prompts x ``T``
    tokens; every arm the engine's own decode loop), then
    ``int4prod`` (1 prompt), each with its launches checked exactly.
    Returns (launches by kernels-line key, the two reports, their s)."""
    from dropoutdecoding_tpu_torch.cli import fused_gap
    from dropoutdecoding_tpu_torch.utils.config import EnsembleConfig

    wrappers = _wrappers()
    L = 32
    probs = EnsembleConfig.voting_probs_for(3)
    _zero_counts(wrappers)
    prod, prod_s = _sync_time(lambda: fused_gap.run_production_study(P, T, probs))
    counts = {k: fn.launches for k, fn in wrappers.items()}
    # a prompt: exact (2 forwards a step), fused (1), the reseeded exact
    # (2), greedy (1)
    want = dict.fromkeys(wrappers, 0)
    want.update(K2=P, K3=6 * P * L * (T - 1), K4=4 * P * (T - 1))
    print(f"fused_gap production (int8, K=3, epis, {P} x {T}): {prod_s:.1f} s, launches {counts}; "
          f"{json.dumps(prod)}")
    _check_counts("fused_gap production", counts, want)
    _rates(prod, "fused_gap production")
    torch.cuda.empty_cache()
    _zero_counts(wrappers)
    int4, int4_s = _sync_time(lambda: fused_gap.run_int4_production_study(1, T, probs))
    counts4 = {k: fn.launches for k, fn in wrappers.items()}
    # two prefills; exact int8 and int4 (2 forwards a step), the reseeded
    # int8 (2), greedy int8 and int4 (1 each); K6 in every int4 forward's
    # four fused projections
    want4 = dict.fromkeys(wrappers, 0)
    want4.update(K2=2, K3=8 * L * (T - 1), K4=5 * (T - 1), K6=4 * L * (1 + 3 * (T - 1)))
    print(f"fused_gap int4prod (1 x {T}): {int4_s:.1f} s, launches {counts4}; {json.dumps(int4)}")
    _check_counts("fused_gap int4prod", counts4, want4)
    _rates(int4, "fused_gap int4prod")
    torch.cuda.empty_cache()
    launches = {"K2 fused_gap": counts["K2"] + counts4["K2"],
                "K3 fused_gap": counts["K3"] + counts4["K3"],
                "K4 fused_gap": counts["K4"] + counts4["K4"], "K6 fused_gap int4prod": counts4["K6"]}
    return launches, {"production": prod, "int4prod": int4}, prod_s + int4_s


def stall_probe_full() -> tuple:
    """``stall_probe.main(["--layers", "32", "--chunks", "512"])``: LLaVA-NeXT
    int8 at full depth, one-shot and chunked joins, launches checked exactly
    (K5 32 a one-shot prefill, K2 one a prefill, K3 32 and K4 one a server
    step).  Returns (launches by kernels-line key, the JSON line's object)."""
    from dropoutdecoding_tpu_torch.cli import stall_probe
    from dropoutdecoding_tpu_torch.engine import serving

    wrappers = _wrappers()
    L = 32
    steps = [0]
    step = serving.DecodeServer.step

    def counted(self, n=1):
        steps[0] += n
        return step(self, n)

    _zero_counts(wrappers)
    serving.DecodeServer.step = counted
    try:
        out = stall_probe.main(["--layers", str(L), "--chunks", "512"])
    finally:
        serving.DecodeServer.step = step
    counts = {k: fn.launches for k, fn in wrappers.items()}
    # one-shot case: four one-shot prefills; chunked: two one-shot, two chunked
    want = dict.fromkeys(wrappers, 0)
    want.update(K2=8, K3=L * steps[0], K4=steps[0], K5=6 * L)
    print(f"stall_probe: {json.dumps(out)}, {steps[0]} server steps, launches {counts}")
    _check_counts("stall_probe", counts, want)
    torch.cuda.empty_cache()
    return {"K2 stall_probe": counts["K2"], "K3 stall_probe": counts["K3"],
            "K4 stall_probe": counts["K4"], "K5 stall_probe": counts["K5"]}, out


def baseline_bench_full() -> tuple:
    """``baseline_batch_bench.main(["--layers", "32"])``: batched VCD (4
    images) and beam search (2 images x 3 beams) against one image, three
    calls each (a warm-up and two timed), K1 32 a decode step of each call,
    counted by baseline.  The ratios are printed, not gated.  Returns
    (launches by kernels-line key, the results)."""
    from dropoutdecoding_tpu_torch.cli import baseline_batch_bench
    from dropoutdecoding_tpu_torch.engine import baselines

    wrappers = _wrappers()
    L, T = 32, 32
    by = {"vcd_generate": 0, "beam_generate": 0}
    saved = {name: getattr(baselines, name) for name in by}

    def counting(name):
        def call(*args, **kw):
            before = wrappers["K1"].launches
            out = saved[name](*args, **kw)
            by[name] += wrappers["K1"].launches - before
            return out
        return call

    _zero_counts(wrappers)
    for name in by:
        setattr(baselines, name, counting(name))
    try:
        res = baseline_batch_bench.main(["--layers", str(L)])
    finally:
        for name, fn in saved.items():
            setattr(baselines, name, fn)
    counts = {k: fn.launches for k, fn in wrappers.items()}
    # six calls of each (three batched, three serial), T - 1 steps of L layers
    want = dict.fromkeys(wrappers, 0)
    want["K1"] = 2 * 6 * (T - 1) * L
    print(f"baseline_batch_bench: {json.dumps(res)}; K1 by baseline {by}, launches {counts}")
    _check_counts("baseline_batch_bench", counts, want)
    _check_counts("baseline_batch_bench, K1 by baseline", by,
                  {"vcd_generate": 6 * (T - 1) * L, "beam_generate": 6 * (T - 1) * L})
    torch.cuda.empty_cache()
    return {"K1 baseline_batch_bench VCD": by["vcd_generate"],
            "K1 baseline_batch_bench beam": by["beam_generate"]}, res


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
    "K1 VCD": {
        "name": "ensemble_decode_attention (VCD: M = 1 over 2 rows, the clean and noised contexts)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:166",
    },
    "K1 beam": {
        "name": "ensemble_decode_attention (beam search: M = 1 over 3 beam rows)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:166",
    },
    "K1 InstructBLIP": {
        "name": "ensemble_decode_attention (InstructBLIP-Vicuna-7B: M = 3, G = 1, 608-slot cache)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:166",
    },
    "K1 InstructBLIP fused": {
        "name": "ensemble_decode_attention (InstructBLIP fused mode: M = 4)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:166",
    },
    "K1 InstructBLIP VCD": {
        "name": "ensemble_decode_attention (InstructBLIP VCD: M = 1 over 2 rows)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:166",
    },
    "K1 InstructBLIP beam": {
        "name": "ensemble_decode_attention (InstructBLIP beam search: M = 1 over 3 rows)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:166",
    },
    "K1 serving": {
        "name": "ensemble_decode_attention (DecodeServer exact: M = 3 over 8 slots, 8 fills)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:166",
    },
    "K1 serving fused": {
        "name": "ensemble_decode_attention (DecodeServer fused: M = 4 over 8 slots, 8 fills)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:166",
    },
    "K1 speculative draft": {
        "name": "ensemble_decode_attention (speculative int4 self-draft step: M = 1 over the "
                "1152-slot dense draft cache)",
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
    "K2 InstructBLIP": {
        "name": "vision_uncertainty (InstructBLIP: [1, 32, 32001], k = 10)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/uncertainty.cu",
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
    "K6 speculative draft": {
        "name": "int4_matmul (the int4 self-draft: R = 1 a draft step, 595 its prefill)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_int4_matmul.py:236",
    },
    "K2 fused_gap": {
        "name": "vision_uncertainty (fused_gap's 7B prefills: [1, 576, 32064] k = 5)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/uncertainty.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_uncertainty.py:101",
    },
    "K3 fused_gap": {
        "name": "ensemble_decode_attention_int8kv (fused_gap at 7B: M = 1 / 3 exact, 4 fused, 632-slot int8 cache)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:234",
    },
    "K4 fused_gap": {
        "name": "cache_append_int8 (fused_gap at 7B: the winner's row, B = 1)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/cache_append.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:605",
    },
    "K6 fused_gap int4prod": {
        "name": "int4_matmul (fused_gap int4prod: R = 595 prefill, R = 1 / 3 decode)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_int4_matmul.py:236",
    },
    "K2 stall_probe": {
        "name": "vision_uncertainty (stall_probe's NeXT prefills: [1, 2928, 32064] k = 10, valid)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/uncertainty.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_uncertainty.py:101",
    },
    "K3 stall_probe": {
        "name": "ensemble_decode_attention_int8kv (stall_probe: NeXT fused M = 4, G = 4, 2 slots)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:234",
    },
    "K4 stall_probe": {
        "name": "cache_append_int8 (stall_probe: 2 slots)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/cache_append.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:605",
    },
    "K5 stall_probe": {
        "name": "flash_prefill_attention (stall_probe's one-shot NeXT joins, S = 2955, 2367 real keys)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_attention.py:66",
    },
    "K1 baseline_batch_bench VCD": {
        "name": "ensemble_decode_attention (baseline_batch_bench VCD: M = 1 over 2 x 4 rows, and 2 rows serial)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:166",
    },
    "K1 baseline_batch_bench beam": {
        "name": "ensemble_decode_attention (baseline_batch_bench beam search: M = 1 over 2 x 3 rows, and 3 serial)",
        "route": "cuda",
        "source": "dropoutdecoding_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dropoutdecoding_tpu/ops/pallas_decode_attention.py:166",
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
    small_reference("modes")
    t_pope = time.perf_counter()
    small_reference("pope")
    t_pope = time.perf_counter() - t_pope
    t_base = time.perf_counter()
    small_reference("baselines")
    print(f"small_reference('baselines') {time.perf_counter() - t_base:.1f} s")
    ib_s = {}
    (_, ib_s["narrow"]) = _wall(lambda: small_reference("instructblip"))
    serve_s = {}
    (_, serve_s["narrow"]) = _wall(lambda: small_reference("serving"))
    spec_s = {}
    (_, spec_s["narrow"]) = _wall(lambda: small_reference("speculative"))
    (launches, pope, serving, speculative), e2e_s = _wall(end_to_end)
    spec_s["speculative_full"] = speculative.pop("seconds")
    print(f"serving phase: {json.dumps(serving)}; card {card}")
    print(f"speculative phase: {json.dumps(speculative, default=str)}; card {card}")
    from dropoutdecoding_tpu_torch.cli import spec_bench

    (_, spec_s["spec_bench"]) = _wall(
        lambda: spec_bench.main(["--layers", "32", "--tokens", "64", "--prompts", "2"]))
    torch.cuda.empty_cache()
    (ib_launches, ib_pope, towers), ib_s["full width"] = _wall(instructblip_full)
    launches.update(ib_launches)
    cli_record, serve_s["chair_cli (with serve_cli)"] = _wall(chair_cli)
    spec_s["chair_cli spec and consistency"] = cli_record["spec_consistency_cli"]["seconds"]
    print(f"chair_cli phase: {json.dumps(cli_record)}; card {card}")
    clip, spec_s["ClipZeroShot"] = _wall(clip_zero_shot_check)
    ib_cli, ib_s["CLI"] = _wall(lambda: chair_cli(model="instructblip"))
    print(f"chair_cli instructblip phase: {json.dumps(ib_cli)}; towers {json.dumps(towers)}; "
          f"POPE {json.dumps(ib_pope)}; card {card}")
    tools_s = {}
    _, tools_s["fused_gap narrow"] = _wall(fused_gap_narrow)
    (gap_launches, gap, _), tools_s["fused_gap 7B"] = _wall(fused_gap_full)
    (stall_launches, stall), tools_s["stall_probe"] = _wall(stall_probe_full)
    (bench_launches, bench), tools_s["baseline_batch_bench"] = _wall(baseline_bench_full)
    for more in (gap_launches, stall_launches, bench_launches):
        launches.update(more)
    print(f"harness tools: fused_gap {json.dumps(gap)}; stall_probe {json.dumps(stall)}; "
          f"baseline_batch_bench {json.dumps(bench)}; card {card}")
    pope_s = {"small": t_pope, **{k: v["seconds"] for k, v in pope.items()},
              "cli": cli_record["pope_cli"]["seconds"]}
    print(f"POPE phases: {json.dumps(pope_s)}, {sum(pope_s.values()):.1f} s added")
    print(f"InstructBLIP phases, s: {json.dumps(ib_s)}, {sum(ib_s.values()):.1f} s added")
    print(f"serving phases, s: {json.dumps(serve_s)}; end_to_end with serving_full "
          f"{e2e_s:.1f} s")
    print(f"speculative and consistency phases, s: {json.dumps(spec_s)}, "
          f"{sum(spec_s.values()):.1f} s added; ClipZeroShot {json.dumps(clip)}")
    print(f"harness tool phases, s: {json.dumps(tools_s)}, {sum(tools_s.values()):.1f} s added")
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
