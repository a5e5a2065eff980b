"""CUDA runtime calls that put work on the card (kernel and graph launches,
copies, sets) a decode step: those inside the profiled unit's
``decode.step`` spans, over its steps."""
from benchmark.metrics._program import launches_per_step


def read(ctx):
    return launches_per_step(ctx)
