"""A ``torch.profiler`` trace of one work unit, reduced to what the per-layer
metrics read: device time by operation (kernel names from
``kernels/<operation>/*.txt``), device time under a named span, the union of
the device's busy intervals over the traced window, and the breakdown the
result line carries."""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

HERE = Path(__file__).resolve().parent
WINDOW = "bench.traced"
TOP = 10


def kernel_patterns(operation: str) -> list:
    """The kernel-name patterns of every implementation of ``operation``:
    one file a kernel family, one pattern a line."""
    pats = []
    for f in sorted((HERE / "kernels" / operation).glob("*.txt")):
        pats += [ln.strip() for ln in f.read_text().splitlines() if ln.strip() and not ln.startswith("#")]
    return pats


@contextlib.contextmanager
def wrapped(module, name: str, span: str):
    """``module.name`` called inside a ``record_function(span)`` range while
    the block runs: a span around a call the program makes itself."""
    orig = getattr(module, name)

    def call(*a, **kw):
        with record_function(span):
            return orig(*a, **kw)

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, orig)


class Trace:
    def __init__(self, events):
        self.kernels = []  # (start_ns, end_ns, name, correlation)
        self.launches = []  # (start_ns, end_ns, name, correlation) of CUDA runtime calls
        self.ops = []  # (start_ns, end_ns, name) host operators
        self.spans = defaultdict(list)  # user annotation -> [(start_ns, end_ns)]
        for e in events:
            s = e.start_ns()
            t = s + e.duration_ns()
            name = e.name()
            if str(e.device_type()).endswith("CUDA"):
                if not e.is_user_annotation() and not name.startswith("bench."):
                    self.kernels.append((s, t, name, e.correlation_id()))
            elif e.is_user_annotation():
                self.spans[name].append((s, t))
            elif name.startswith("cu"):
                self.launches.append((s, t, name, e.correlation_id()))
            elif e.device_index() >= 0:  # not the profiler's own bookkeeping
                self.ops.append((s, t, name))
        self.kernels.sort()
        self.launches.sort()
        # the window: the traced unit's host range where it was recorded, else
        # its first CUDA call; to its last device operation
        ends = [k[1] for k in self.kernels] + [c[1] for c in self.launches]
        starts = [k[0] for k in self.kernels] + [c[0] for c in self.launches]
        w = self.spans.get(WINDOW)
        if w:
            starts, ends = [w[0][0]], ends + [w[0][1]]
        self.window = (min(starts, default=0), max(ends, default=0))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy(self) -> list:
        """The union of the device's activity intervals inside the window."""
        lo, hi = self.window
        out = []
        for s, t, _, _ in self.kernels:
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy()) * 1e-9

    def op_seconds(self, operation: str) -> float:
        """Device seconds of the kernels of ``operation``."""
        pats = kernel_patterns(operation)
        return sum(t - s for s, t, name, _ in self.kernels if any(p in name for p in pats)) * 1e-9

    def span_seconds(self, span: str) -> float:
        """Device seconds of every kernel launched inside the host ranges of
        ``span``."""
        ranges = sorted(self.spans.get(span, []))
        if not ranges:
            return 0.0
        starts = [r[0] for r in ranges]
        corr = set()
        for s, _, _, c in self.launches:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= ranges[i][1]:
                corr.add(c)
        return sum(t - s for s, t, _, c in self.kernels if c in corr) * 1e-9

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the host operator running at each gap's middle."""
        by_op = defaultdict(int)
        for s, t, name, _ in self.kernels:
            by_op[name[:160]] += t - s
        gaps = []
        lo, hi = self.window
        prev = lo
        for s, t in self.busy() + [[hi, hi]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        by_host = defaultdict(int)
        for (s, t), name in zip(gaps, self._host_at([(s + t) // 2 for s, t in gaps])):
            by_host[name] += t - s
        top = lambda d: [[k, v * 1e-9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}

    def _host_at(self, times: list) -> list:
        """The innermost host operator running at each of ``times`` (sorted),
        or without recorded operators the CUDA call, or "host" where none
        is."""
        ops = sorted(self.ops) or [c[:3] for c in self.launches]
        out, stack, j = [], [], 0
        for t in times:
            while j < len(ops) and ops[j][0] <= t:
                while stack and stack[-1][1] < ops[j][0]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(stack[-1][2] if stack else "host")
        return out


def capture(fn, device, host_ops: bool):
    """``fn()`` under the profiler -> (its result, the Trace).  The device's
    activity and the CUDA calls are always recorded; the host's operators
    and the spans only with ``host_ops``, which costs the host several
    microseconds an operator and so slows a launch-bound loop."""
    activities = [ProfilerActivity.CPU] if host_ops or torch.device(device).type != "cuda" else []
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            out = fn()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
    return out, Trace(prof.profiler.kineto_results.events())
