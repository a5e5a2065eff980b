"""Host milliseconds of a decode step's member masks
(``engine/generate.py`` ``_member_drop_slots``: a draw a row and member,
the drop masks): the median over the profiled unit's steps of the
program's ``decode.masks`` span.  A span reads no device value, so this is
the host's work, the profiler's cost on each call included, plus any time
a launch waited on a full queue."""
from benchmark.metrics._program import step_ms


def read(ctx):
    return step_ms(ctx, ("decode.masks",))
