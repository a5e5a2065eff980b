"""What the share readers have in common."""


def mfu(ctx):
    """The method's operations over the window (``counts.py``) against the
    card's bf16 peak for the window's length, in percent."""
    if ctx.peaks is None or not ctx.units:
        return None
    return 100.0 * sum(u.flops for u in ctx.units) / (ctx.window_s * ctx.peaks["bf16_flops"])


def dims(ctx):
    from benchmark.counts import Dims

    return Dims.of(ctx.cell.config)


def roofline(ctx, flops, nbytes, seconds):
    """The least time that ``flops`` operations and ``nbytes`` bytes could
    take on the card against the device ``seconds`` their kernels took, in
    percent."""
    if ctx.peaks is None or not seconds:
        return None
    from benchmark.counts import bound_seconds

    return 100.0 * bound_seconds(flops, nbytes, ctx.peaks) / seconds


def idle(ctx):
    """The share of an untraced unit's time in which no operation ran on
    the device: the traced unit's busy seconds (the union of its device
    intervals) against the mean seconds of the window's units, which the
    profiler did not slow."""
    if ctx.trace is None or not ctx.unit_s or ctx.peaks is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / (sum(ctx.unit_s) / len(ctx.unit_s)))
