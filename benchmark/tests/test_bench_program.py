"""The readers of the program's own spans and counters: on hand-made
recordings of the profiled unit's calls and a hand-made trace with known
CUDA calls and kernels; on a tiny CPU run; and on the card, the program's
spans against the profiler's clock (``-m card``)."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import registry, traces
from benchmark.peaks import H100
from dropoutdecoding_tpu_torch.engine import trace
from dropoutdecoding_tpu_torch.engine.trace import Recording, Span

from .tiny import run_tiny

NEW = ["decode_masks_ms", "decode_forwards_ms", "decode_draws_per_step", "decode_launches_per_step",
       "prefill_towers_ms.caption", "prefill_towers_ms.pope"]
MS = 1_000_000  # the recording's ns a millisecond


class Event:
    """A ``torch.profiler`` event: times in ms."""

    def __init__(self, name, start, end, device="CPU", corr=0):
        self._a = (name, start * MS, end * MS, device, corr)

    def name(self):
        return self._a[0]

    def start_ns(self):
        return self._a[1]

    def duration_ns(self):
        return self._a[2] - self._a[1]

    def device_type(self):
        return f"DeviceType.{self._a[3]}"

    def correlation_id(self):
        return self._a[4]

    def is_user_annotation(self):
        return False

    def device_index(self):
        return 0


def _call(spans, **counters):
    """One engine call's recording; spans: (name, start ms, end ms, parent)."""
    rec = Recording(ranges=False)
    rec.spans = [Span(n, s * MS, e * MS, p, None) for n, s, e, p in spans]
    rec.counters.update(counters)
    return rec


# a prefill whose towers launch one kernel, then two decode steps of an
# exact step's phases; on the host: masks 2 / 4 ms, forwards 10 + 12 / 8 + 6
PREFILL = _call([("prefill", 0, 100, -1), ("prefill.towers", 0, 40, 0)])
DECODE = _call([
    ("decode", 100, 400, -1),
    ("decode.step", 100, 250, 0),
    ("decode.forward0", 100, 110, 1), ("decode.masks", 110, 112, 1), ("decode.members", 112, 124, 1),
    ("decode.vote", 124, 125, 1), ("decode.append", 125, 126, 1),
    ("decode.step", 250, 400, 0),
    ("decode.forward0", 250, 258, 7), ("decode.masks", 258, 262, 7), ("decode.members", 262, 268, 7),
    ("decode.vote", 268, 270, 7), ("decode.append", 270, 272, 7),
], **{"decode.steps": 2, "decode.draws": 384})
EARLIER = _call([("decode", -900, -500, -1), ("decode.step", -900, -500, 0)],
                **{"decode.steps": 1, "decode.draws": 5})  # a call before the profiled unit
TRACE = traces.Trace([
    Event("cudaLaunchKernel", 10, 11, corr=1),  # in the towers
    Event("tower_gemm", 12, 15, "CUDA", corr=1),
    Event("cudaLaunchKernel", 50, 51, corr=2),  # in the prefill, not the towers
    Event("lm_gemm", 51, 90, "CUDA", corr=2),
    Event("cudaLaunchKernel", 101, 102, corr=3),
    Event("decode_mma_kernel", 102, 105, "CUDA", corr=3),
    Event("cudaMemcpyAsync", 111, 112, corr=4),
    Event("cudaStreamIsCapturing", 113, 114, corr=5),  # no work on the card
    Event("cuLaunchKernelEx", 260, 261, corr=6),
    Event("gemm", 261, 300, "CUDA", corr=6),
    Event("cudaMemsetAsync", 399, 400, corr=7),
    Event("cudaLaunchKernel", 450, 451, corr=8),  # after the loop
])


def _read(metric, monkeypatch, calls=(EARLIER, PREFILL, DECODE), peaks=H100):
    monkeypatch.setattr(trace, "profiled", lambda: list(calls))
    return registry.metric_reader(metric)(SimpleNamespace(trace=TRACE, peaks=peaks))


@pytest.mark.parametrize("metric,want", [
    ("decode_masks_ms", 3.0), ("decode_forwards_ms", 18.0),  # medians of 2, 4 and of 22, 14
    ("decode_draws_per_step", 192.0),  # not the earlier call's
    # launch, copy, launch and set inside the steps; not the capture query,
    # not the launch after the loop
    ("decode_launches_per_step", 2.0),
    ("prefill_towers_ms.caption", 3.0),
    ("prefill_towers_ms.pope", None),  # no probe.towers span
])
def test_a_reader_on_known_spans_calls_and_kernels(monkeypatch, metric, want):
    got = _read(metric, monkeypatch)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("metric", NEW)
@pytest.mark.parametrize("case", ["no-recording", "no-card", "parent"])
def test_a_reader_without_its_recording_or_a_card_reads_nothing(monkeypatch, metric, case):
    if case == "parent":  # a program whose tracer has no profiled calls
        monkeypatch.delattr(trace, "profiled")
        assert registry.metric_reader(metric)(SimpleNamespace(trace=TRACE, peaks=H100)) is None
        return
    calls, peaks = ((), H100) if case == "no-recording" else ((EARLIER, PREFILL, DECODE), None)
    assert _read(metric, monkeypatch, calls, peaks) is None


def test_a_tiny_traced_run_prints_the_programs_metrics(monkeypatch):
    """A tiny caption cell on the CPU, read as on a card (the device readers
    find no CUDA call there): the four decode_* metrics, 4 rows x K = 3
    draws a step; ``--trace 0`` prints the end-to-end metrics alone."""
    from benchmark import run

    cell = "bakllava.caption_exact_b64"
    info = run.device_info
    monkeypatch.setattr(run, "device_info", lambda device, chips: {
        **info(device, chips), "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"})
    result = run_tiny(cell, trace=1)
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert {"decode_masks_ms", "decode_forwards_ms", "decode_draws_per_step",
            "decode_launches_per_step", "prefill_towers_ms.caption"} <= set(m)
    assert m["decode_draws_per_step"] == 12 and m["decode_launches_per_step"] == 0
    assert 0 < m["decode_masks_ms"] < m["decode_forwards_ms"]
    result = run_tiny(cell, trace=0)
    assert set(result["metrics"]) == {e["name"] for e in registry.cell(cell).end_to_end}


@pytest.mark.card
@pytest.mark.parametrize("host_ops", [False, True], ids=["device-only", "host-operators"])
def test_a_program_span_brackets_its_launch_on_the_profilers_clock(card, host_ops):
    """The program's spans (``engine/trace.py``, ``time.time_ns``) and the
    profiler's CUDA events share one clock: a span around a
    ``torch.cuda._sleep`` launch, recorded as a profiled call, holds that
    launch's CUDA runtime call, and the kernel it launched starts after the
    call did; the span adds no range to the trace."""
    import torch

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()

    def unit():
        for _ in range(20):
            with trace.span("sleep"):
                torch.cuda._sleep(200_000)

    before = set(map(id, trace.profiled()))
    _, t = traces.capture(unit, card, host_ops=host_ops)
    spans = [r.spans[0] for r in trace.profiled() if id(r) not in before]
    assert len(spans) == 20 and "sleep" not in t.spans and "sleep" not in {k[2] for k in t.kernels}
    for s in spans:
        (call,) = [c for c in t.launches if "Launch" in c[2] and s.start_ns <= c[0] <= s.end_ns]
        assert call[1] <= s.end_ns
        (kernel,) = [k for k in t.kernels if k[3] == call[3]]
        assert kernel[0] >= call[0]
