"""The share of a unit's time in which no operation ran on the card: 1 -
(the union of the traced unit's kernels', copies' and sets' intervals) /
(the mean seconds of the window's units, untraced: the profiler's cost on
every launch slows the traced unit's host, not its device)."""
from benchmark.metrics._share import idle


def read(ctx):
    return idle(ctx)
