"""Tracing / profiling hooks (port of ``dropoutdecoding_tpu/engine/trace.py``).

- ``StageTimer``: wall-clock per stage (prefill / decode / eval), with a
  structured JSON report.  A stage given ``sync=`` a CUDA tensor waits for
  its device (``torch.cuda.synchronize``) before the clock stops, since
  CUDA work is asynchronous to the host.
- ``profile_trace``: a ``torch.profiler`` trace of the block, written as a
  Chrome trace (``trace.json``, readable in Perfetto) under a log dir.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


def _sync(x) -> None:
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name] / self.counts[name], 4),
            }
            for name in self.totals
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
