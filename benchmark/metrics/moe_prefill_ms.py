"""Device milliseconds of a caption batch's routed experts in the prefill:
the kernels launched inside the program's ``prefill.moe`` spans (each routed
layer's eager per-expert products, the routing and the combine), profiled
unit."""
from benchmark.metrics._program import launched_ms


def read(ctx):
    return launched_ms(ctx, "prefill.moe")
