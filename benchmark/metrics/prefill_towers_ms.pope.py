"""Device milliseconds of a POPE batch's vision towers (the CLIP tower once
an image, the projector, the anyres crops, the merge with the questions):
the kernels launched inside the program's ``probe.towers`` span, profiled
unit."""
from benchmark.metrics._program import launched_ms


def read(ctx):
    return launched_ms(ctx, "probe.towers")
