"""Host milliseconds of a decode step's model forwards (exact mode's
unmasked ``decode.forward0`` and K-member ``decode.members``, or fused
mode's one ``decode.forward``, each with its ``lm_head``): the median over
the profiled unit's steps of the program's spans, summed a step.  Host
work, the profiler's cost on each call included: the launches of about
2 x 32 layers."""
from benchmark.metrics._program import step_ms


def read(ctx):
    return step_ms(ctx, ("decode.forward0", "decode.members", "decode.forward"))
