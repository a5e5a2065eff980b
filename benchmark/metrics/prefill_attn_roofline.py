"""K5 (``ops/cuda_flash_prefill.py``) against its roofline: 4·Dh·H a pair of
each prompt's real causal pairs (pad rows and pad keys answer nothing), every
layer of the traced batched probe, over 989 TFLOP/s, against the device time
of the kernels in ``kernels/prefill_attn/``."""
from benchmark import counts
from benchmark.metrics._share import dims, roofline


def read(ctx):
    s = ctx.shapes
    if "reals" not in s:
        return None
    d = dims(ctx)
    return roofline(ctx, d.L * counts.flash_prefill_flops(d, s["reals"]), 0,
                    ctx.trace.op_seconds("prefill_attn"))
