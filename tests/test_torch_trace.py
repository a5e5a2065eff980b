"""The port's tracer (``engine/trace.py``) and the spans and counters the
engine records into it: off, nothing but a shared no-op; on, one
``decode.step`` a step with its phases in order, the draws counted, the
prefill and probe stages present, and the tokens unchanged; under a
profiler with no recording open, a recording a call and no profiler range."""
import collections
import itertools
import tracemalloc

import numpy as np
import pytest
import torch

from dropoutdecoding_tpu_torch.engine import trace
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
from dropoutdecoding_tpu_torch.models import llavanext as next_mod
from dropoutdecoding_tpu_torch.utils import config as C
from dropoutdecoding_tpu_torch.utils.convert import (
    synthetic_llava_params,
    synthetic_llavanext_params,
)

TEXT = C.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                     max_position_embeddings=256)
VISION = C.ClipVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                            num_attention_heads=2, image_size=28, patch_size=14)
IMAGE = 60
IDS = np.array([[1, 5, IMAGE, 11, 13, 17]] * 2)  # B = 2
B, T, K = 2, 6, 3
SIZE = (30, 50)  # anyres: one base tile and a grid of crops

MODES = {
    "exact": (dict(ensemble=True), {},
              ["decode.forward0", "decode.masks", "decode.members", "decode.vote", "decode.append"]),
    "fused": (dict(ensemble=True), {"fused_step": True},
              ["decode.masks", "decode.forward", "decode.vote", "decode.append"]),
    "greedy": (dict(ensemble=False), {}, ["decode.forward0", "decode.append"]),
    "exact-sampled": (dict(ensemble=True), {},
                      ["decode.forward0", "decode.masks", "decode.members", "decode.vote",
                       "decode.sample", "decode.append"]),
}


@pytest.fixture(scope="module")
def llava_params():
    cfg = C.LlavaConfig(text=TEXT, vision=VISION, image_token_index=IMAGE)
    return cfg, synthetic_llava_params(cfg, "cpu", torch.float32, seed=3)


@pytest.fixture(scope="module")
def next_params():
    cfg = C.LlavaNextConfig(text=TEXT, vision=VISION, image_token_index=IMAGE,
                            image_grid_pinpoints=((28, 56), (56, 28), (56, 56)))
    return cfg, synthetic_llavanext_params(cfg, "cpu", torch.float32, seed=4)


def _llava(weights, mode="exact", sample=False, **kw):
    cfg, params = weights
    engine_kw, ens, _ = MODES[mode]
    gen = C.GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0, do_sample=sample)
    return LlavaEngine(cfg=cfg, params=params, ens=C.EnsembleConfig(**ens), gen=gen, max_len=32,
                       seed=5, **engine_kw, **kw)


def _pixels():
    return torch.randn(1, 3, 28, 28, generator=torch.Generator().manual_seed(0)).expand(B, 3, 28, 28)


def _tiles(cfg):
    n = next_mod.image_geometry(SIZE, cfg)["n_tiles"]
    return torch.randn(n, 3, 28, 28, generator=torch.Generator().manual_seed(1))


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def test_off_is_one_shared_no_op_that_reads_no_clock(monkeypatch, llava_params):
    """Off: ``span`` hands back the one ``OFF`` and ``count`` returns at
    once; neither reads the clock, opens a profiler range or allocates (each
    reads the profiler's one flag), and a whole generate runs with the
    tracer's clock and torch taken away."""

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"the tracer touched {name} while off")

    eng = _llava(llava_params)
    want = eng.generate(IDS, _pixels()).tokens
    monkeypatch.setattr(trace, "time", Untouchable())
    monkeypatch.setattr(trace, "torch", Untouchable())
    assert trace.span("decode.step") is trace.OFF and trace.span("prefill") is trace.OFF
    def spans(n):
        for _ in itertools.repeat(None, n):
            with trace.span("decode.step"):
                trace.count("decode.draws", 6)

    def empty(n):
        for _ in itertools.repeat(None, n):
            with trace.OFF:
                pass

    def peak(loop, n):
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        loop(n)
        return tracemalloc.get_traced_memory()[1] - base

    tracemalloc.start()
    try:
        peak(spans, 10)  # the first pass may warm the interpreter's caches
        # what the loop itself holds, whatever the number of spans
        assert peak(spans, 100) == peak(spans, 2000) == peak(empty, 100)
    finally:
        tracemalloc.stop()
    assert np.array_equal(eng.generate(IDS, _pixels()).tokens, want)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_one_decode_step_a_step_with_its_phases_in_order(llava_params, mode):
    eng = _llava(llava_params, mode, sample=mode.endswith("sampled"))
    with trace.recording() as rec:
        rec.unit = 7
        eng.generate(IDS, _pixels())
        rec.unit = 8
        eng.decode(eng.prefill(IDS, _pixels()))
    spans = rec.spans
    top = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in top] == ["prefill", "decode"] * 2
    for i in top:
        assert {s.unit for s in spans if _root(spans, s) == i} == {spans[i].unit}
    assert [spans[i].unit for i in top] == [7, 7, 8, 8]
    for p in top[0::2]:
        assert _children(spans, p) == ["prefill.towers", "prefill.lm", "prefill.uncertainty",
                                       "prefill.cache"]
    steps = [i for i, s in enumerate(spans) if s.name == "decode.step"]
    assert len(steps) == 2 * (T - 1) == rec.counters["decode.steps"]
    want = MODES[mode][2]
    for i in steps:
        assert spans[spans[i].parent].name == "decode"
        assert _children(spans, i) == want
        kids = [s for s in spans if s.parent == i]
        assert spans[i].start_ns <= kids[0].start_ns
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert kids[-1].end_ns <= spans[i].end_ns
    report = trace.StageTimer(rec).report()
    assert report["decode.step"]["count"] == 2 * (T - 1) and report["prefill"]["count"] == 2


def _root(spans, s):
    i = spans.index(s)
    while spans[i].parent != -1:
        i = spans[i].parent
    return i


@pytest.mark.parametrize("mode,sample,policy,per_row", [
    ("exact", False, "none", K), ("fused", False, "none", K), ("exact", False, "logits", K + 1),
    ("exact", True, "entropy", K + 2), ("greedy", False, "none", 0), ("greedy", True, "none", 1),
])
def test_draws_are_one_a_row_for_each_member_text_policy_and_sample(llava_params, mode, sample,
                                                                    policy, per_row):
    eng = _llava(llava_params, mode, sample=sample, text_mask_policy=policy)
    with trace.recording() as rec:
        eng.generate(IDS, _pixels())
    # every step draws per_row a row; a sampled first token draws once more
    assert rec.counters["decode.draws"] == (T - 1) * B * per_row + B * sample
    assert rec.counters["decode.steps"] == T - 1


@pytest.mark.parametrize("family", ["llava", "llavanext"])
def test_prefill_and_probe_stages(llava_params, next_params, family):
    if family == "llava":
        eng = _llava(llava_params)
        images, one = (_pixels(),), (_pixels()[:1],)
    else:
        cfg, params = next_params
        eng = LlavaNextEngine(cfg=cfg, params=params, gen=C.GenerationConfig(max_new_tokens=3),
                              max_len=128, seed=5)
        tiles = _tiles(cfg)
        images, one = ([tiles, tiles], [SIZE, SIZE]), (tiles, SIZE)
    with trace.recording() as rec:
        eng.prefill(IDS, *images)
        eng.probe(IDS, *images)
        handle = eng.probe_prefix(IDS[:1, :4], *one)
        eng.probe_extend(handle, np.array([[11, 13, 17], [19, 23, 0]]), np.array([3, 2]))
    spans = rec.spans
    top = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in top] == ["prefill", "probe", "probe_prefix", "probe_extend"]
    assert _children(spans, top[0]) == ["prefill.towers", "prefill.lm", "prefill.uncertainty",
                                        "prefill.cache"]
    assert _children(spans, top[1]) == _children(spans, top[2]) == ["probe.towers", "probe.lm"]
    assert _children(spans, top[3]) == ["extend.lm"]
    (ext,) = [i for i, s in enumerate(spans) if s.name == "extend.lm"]
    assert _children(spans, ext) == ["extend.attention"] * TEXT.num_hidden_layers


@pytest.mark.parametrize("mode", sorted(MODES))
def test_recording_leaves_the_tokens_bit_equal(llava_params, mode):
    eng = _llava(llava_params, mode, sample=mode.endswith("sampled"), text_mask_policy="logits")
    off = eng.generate(IDS, _pixels())
    with trace.recording():
        on = eng.generate(IDS, _pixels())
    assert np.array_equal(off.tokens, on.tokens) and np.array_equal(off.num_tokens, on.num_tokens)


def test_a_recording_is_one_at_a_time_and_ends_with_its_block():
    with trace.recording() as rec:
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
        with trace.span("a"):
            with trace.span("b"):
                trace.count("n", 2)
    assert [(s.name, s.parent) for s in rec.spans] == [("a", -1), ("b", 0)]
    assert rec.counters == {"n": 2}
    assert trace.span("a") is trace.OFF
    trace.count("n")
    assert rec.counters == {"n": 2}


def test_under_a_profiler_each_call_records_apart_and_opens_no_range(monkeypatch, llava_params):
    """A profiler with no recording open: each outermost span (an engine
    call) gets a recording of its own, with its counters, and no profiler
    range, so the trace holds what it would without the tracer; inside a
    recording the spans open ranges of their names."""
    from torch.profiler import ProfilerActivity, profile

    eng = _llava(llava_params)
    monkeypatch.setattr(trace, "_profiled", collections.deque(maxlen=trace.PROFILED_CALLS))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.generate(IDS, _pixels())
        trace.count("outside", 1)  # outside every span: dropped
    calls = trace.profiled()
    assert [rec.spans[0].name for rec in calls] == ["prefill", "decode"]
    assert all(rec.spans[0].parent == -1 and not rec.ranges for rec in calls)
    assert calls[1].counters == {"decode.steps": T - 1, "decode.draws": (T - 1) * B * K}
    names = {e.name for e in prof.events()}
    assert not names & {"prefill", "decode", "decode.step"}
    assert trace.span("decode") is trace.OFF  # the profiler stopped
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.recording() as rec:
        eng.generate(IDS, _pixels())
    assert trace.profiled() == calls
    assert {"prefill", "decode", "decode.step"} <= {e.name for e in prof.events()}
    assert rec.counters["decode.steps"] == T - 1
