"""The reader of the decode forwards' graph counters
(``metrics/decode_graph_hit_pct.py``): replays that needed no capture, over
the profiled unit's calls; nothing without a replay, a recording or a card."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import registry, traces
from benchmark.peaks import H100
from dropoutdecoding_tpu_torch.engine import trace
from dropoutdecoding_tpu_torch.engine.trace import Recording, Span

MS = 1_000_000  # the recording's ns a millisecond
TRACE = traces.Trace([])
TRACE.window = (0, 1000 * MS)  # the profiled unit


def _call(start, end, **counters):
    rec = Recording(ranges=False)
    rec.spans = [Span("decode", start * MS, end * MS, -1, None)]
    rec.counters.update(counters)
    return rec


def _read(monkeypatch, calls, peaks=H100):
    monkeypatch.setattr(trace, "profiled", lambda: list(calls))
    return registry.metric_reader("decode_graph_hit_pct")(SimpleNamespace(trace=TRACE, peaks=peaks))


def test_replays_that_needed_no_capture_over_the_units_calls(monkeypatch):
    calls = [
        _call(-900, -500, **{"decode.graph_replays": 50, "decode.graph_captures": 50}),  # before
        _call(100, 400, **{"decode.graph_replays": 252, "decode.graph_captures": 2}),
        _call(500, 800, **{"decode.graph_replays": 254}),  # every forward a hit
    ]
    assert _read(monkeypatch, calls) == pytest.approx(100.0 * 504 / 506)
    assert _read(monkeypatch, calls[2:]) == 100.0


@pytest.mark.parametrize("case", ["no-replay", "no-recording", "no-card", "parent"])
def test_nothing_without_a_replay_a_recording_or_a_card(monkeypatch, case):
    eager = _call(100, 400, **{"decode.steps": 127, "decode.draws": 24384})
    if case == "parent":  # a program whose tracer has no profiled calls
        monkeypatch.delattr(trace, "profiled")
        assert registry.metric_reader("decode_graph_hit_pct")(
            SimpleNamespace(trace=TRACE, peaks=H100)) is None
        return
    calls = {"no-replay": [eager], "no-recording": [], "no-card": [eager]}[case]
    assert _read(monkeypatch, calls, None if case == "no-card" else H100) is None
