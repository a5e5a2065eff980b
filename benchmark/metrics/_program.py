"""What the readers of the program's own spans and counters
(``engine/trace.py``) have in common.  They read the recordings the program
made of its calls in the profiled unit (``trace.profiled()``: while a
profiler runs and no recording is open, each engine call records apart and
opens no profiler range), laid over that unit's trace by time: spans are
epoch ns, the clock of the profiler's events.  Where the program records
nothing of its own, or the run has no card (on the CPU the profiler records
every operator, so a span's host time would measure the profiler), they
read nothing.

A span's host milliseconds here include the profiler's cost on each CUDA
call made inside it."""
import bisect
import statistics

# CUDA runtime calls that put work on the card: kernel and graph launches,
# copies and sets
DEVICE_WORK = ("Launch", "Memcpy", "Memset")


def calls(ctx):
    """The program's recordings of the calls that overlap the profiled
    unit's trace, oldest first; None without them."""
    if ctx.peaks is None:
        return None
    try:
        from dropoutdecoding_tpu_torch.engine.trace import profiled
    except ImportError:
        return None
    lo, hi = ctx.trace.window
    recs = [r for r in profiled() if r.spans and r.spans[0].start_ns <= hi and r.spans[0].end_ns >= lo]
    return recs or None


def ranges(recs, name: str) -> list:
    """The sorted (start_ns, end_ns) of the recordings' spans named ``name``."""
    return sorted((s.start_ns, s.end_ns) for r in recs for s in r.spans if s.name == name)


def step_ms(ctx, names):
    """The median over the profiled unit's decode steps of the host
    milliseconds inside the step's phases named ``names``."""
    recs = calls(ctx)
    if recs is None:
        return None
    per_step = {}
    for i, r in enumerate(recs):
        for s in r.spans:
            if s.name in names and s.parent >= 0 and r.spans[s.parent].name == "decode.step":
                key = (i, s.parent)
                per_step[key] = per_step.get(key, 0) + s.end_ns - s.start_ns
    return 1e-6 * statistics.median(per_step.values()) if per_step else None


def per_step(ctx, counter: str):
    """The profiled unit's counter ``counter`` over its decode steps."""
    recs = calls(ctx)
    steps = sum(r.counters.get("decode.steps", 0) for r in recs or ())
    if not steps:
        return None
    return sum(r.counters.get(counter, 0) for r in recs) / steps


def calls_in(trace, spans: list) -> list:
    """The trace's CUDA runtime calls (start_ns, end_ns, name, correlation)
    that start inside one of ``spans`` (sorted, apart)."""
    starts = [s[0] for s in spans]
    out = []
    for call in trace.launches:
        i = bisect.bisect_right(starts, call[0]) - 1
        if i >= 0 and call[0] <= spans[i][1]:
            out.append(call)
    return out


def launches_per_step(ctx):
    """CUDA calls that put work on the card inside the profiled unit's
    ``decode.step`` spans, over its steps."""
    recs = calls(ctx)
    steps = ranges(recs, "decode.step") if recs else []
    if not steps:
        return None
    return sum(any(w in c[2] for w in DEVICE_WORK) for c in calls_in(ctx.trace, steps)) / len(steps)


def launched_ms(ctx, name: str):
    """Device milliseconds of the kernels that CUDA calls made inside the
    profiled unit's ``name`` spans launched (by correlation id)."""
    recs = calls(ctx)
    spans = ranges(recs, name) if recs else []
    if not spans:
        return None
    corr = {c for _, _, _, c in calls_in(ctx.trace, spans)}
    return 1e-6 * sum(t - s for s, t, _, c in ctx.trace.kernels if c in corr)
