"""The port's tracer: spans and counters at the engine's layer boundaries
(grown from the port of ``dropoutdecoding_tpu/engine/trace.py``).

- ``span(name)`` / ``count(name, n)``: off unless a ``recording()`` block is
  open or a ``torch.profiler`` runs.  Off, ``span`` returns one shared no-op
  context and ``count`` returns at once: both read one flag of the
  profiler's and nothing else, no clock, no allocation, no profiler range,
  no device.
- ``recording()``: a block in which each span keeps its name, its start and
  end in ns, the index of the span it opened inside (``Span.parent``) and
  the recording's ``unit`` when it opened (the caller sets ``unit``, so
  that the spans of one batch, or of one image's questions, share an id);
  counters are per-name integers.  Everything stays in memory and is the
  caller's when the block ends; nothing here writes a file.  While a
  ``torch.profiler`` is active each of its spans also opens a
  ``record_function`` range of its name, so a Perfetto trace shows it.
- ``profiled()``: while a ``torch.profiler`` runs and no recording is open,
  each outermost span (an engine call) records into a recording of its own,
  and the newest ``PROFILED_CALLS`` of these are kept, for whoever ran the
  profiler to lay over its trace.  Such spans open no profiler range: the
  trace holds what it would hold without them.
- The clock is ``time.time_ns()``: epoch nanoseconds, the clock on which
  ``torch.profiler`` gives its events (its converter maps the CPU's and
  CUPTI's timestamps to epoch time), so a recording lays over a device trace.
- A span never synchronises and never reads a device value: its duration is
  the host's work, plus any time a launch blocks on a full launch queue.
- ``StageTimer``: the per-name summary (total, count, mean) of a recording;
  ``profile_trace``: a ``torch.profiler`` trace of a block, written as a
  Chrome trace (``trace.json``, readable in Perfetto) under a log dir.

One thread records: the engine's calls come from one thread, and a span's
parent is the span open when it opened.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import Counter, defaultdict, deque
from typing import Iterator, NamedTuple

import torch
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index in ``Recording.spans`` of the enclosing span; -1 at the top
    unit: object  # the recording's ``unit`` when the span opened


class Recording:
    """The spans (in the order they opened; None while one is open) and
    counters of one ``recording()`` block, or of one profiled call."""

    def __init__(self, ranges: bool = True):
        self.spans: list = []
        self.counters: Counter = Counter()
        self.unit = None
        self.ranges = ranges  # whether its spans open profiler ranges
        self._open: list = []  # indices of the spans open now, innermost last

    def span(self, name: str) -> "_Open":
        return _Open(self, name)


OFF = contextlib.nullcontext()  # every span while nothing records
_current: Recording | None = None  # the open recording, set only by ``recording()``
PROFILED_CALLS = 64
# one recording an outermost span made under a profiler with no recording open
_profiled: deque = deque(maxlen=PROFILED_CALLS)


class _Open:
    __slots__ = ("rec", "name", "index", "parent", "unit", "start", "range")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.parent = rec._open[-1] if rec._open else -1
        self.index = len(rec.spans)
        self.unit = rec.unit
        rec.spans.append(None)
        rec._open.append(self.index)
        self.range = None
        self.start = time.time_ns()
        if rec.ranges and _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return None

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.time_ns()
        rec = self.rec
        rec._open.pop()
        rec.spans[self.index] = Span(self.name, self.start, end, self.parent, self.unit)
        return False


def span(name: str):
    """A span of the open recording, or under a profiler of the profiled
    call's, or the shared no-op ``OFF``."""
    rec = _current
    if rec is None:
        if not _profiler._is_profiler_enabled:
            return OFF
        rec = _profiled_call(new=True)
    return _Open(rec, name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` of the open recording, or under a
    profiler of the profiled call open now (none outside every span)."""
    rec = _current
    if rec is None:
        if not _profiler._is_profiler_enabled:
            return
        rec = _profiled_call(new=False)
        if rec is None:
            return
    rec.counters[name] += n


def _profiled_call(new: bool) -> Recording | None:
    """The recording of the profiled call open now; with ``new``, a fresh
    one where none is."""
    if _profiled and _profiled[-1]._open:
        return _profiled[-1]
    if not new:
        return None
    _profiled.append(Recording(ranges=False))
    return _profiled[-1]


def profiled() -> list:
    """The recordings of the newest outermost spans made while a
    ``torch.profiler`` ran with no recording open, oldest first."""
    return [rec for rec in _profiled if not rec._open]


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Records the block's spans and counts into the Recording it yields."""
    global _current
    if _current is not None:
        raise RuntimeError("a recording is already open")
    rec = _current = Recording()
    try:
        yield rec
    finally:
        _current = None


def _sync(x) -> None:
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class StageTimer:
    """The per-name summary of a recording's closed spans: total and mean
    seconds and the count, the JAX timer's report.  ``stage`` opens a span
    in that recording (by default one of the timer's own); one given
    ``sync=`` a CUDA tensor waits for its device before the span closes."""

    def __init__(self, recording: Recording | None = None):
        self.recording = Recording() if recording is None else recording

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        with self.recording.span(name):
            try:
                yield
            finally:
                if sync is not None:
                    _sync(sync)

    def report(self) -> dict:
        totals, counts = defaultdict(int), defaultdict(int)
        for s in self.recording.spans:
            if s is not None:
                totals[s.name] += s.end_ns - s.start_ns
                counts[s.name] += 1
        return {
            name: {
                "total_s": round(totals[name] * 1e-9, 4),
                "count": counts[name],
                "mean_s": round(totals[name] * 1e-9 / counts[name], 4),
            }
            for name in totals
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """A ``torch.profiler`` trace (CPU, and CUDA where present) of the block
    into ``log_dir/trace.json`` when a log dir is given; no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
