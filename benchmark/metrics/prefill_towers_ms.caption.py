"""Device milliseconds of a caption batch's vision towers (the CLIP tower,
the projector, LLaVA-NeXT's anyres crops, the merge with the text): the
kernels launched inside the program's ``prefill.towers`` span, profiled
unit."""
from benchmark.metrics._program import launched_ms


def read(ctx):
    return launched_ms(ctx, "prefill.towers")
