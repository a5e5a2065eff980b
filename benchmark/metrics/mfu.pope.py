"""The whole step's share of the card's bf16 peak over the window: the
method's operations for every finished unit (``counts.py``: every real
prefill token, every decode row, attention over the pairs its masks leave,
the towers) over the window's seconds times 989 TFLOP/s."""
from benchmark.metrics._share import mfu


def read(ctx):
    return mfu(ctx)
