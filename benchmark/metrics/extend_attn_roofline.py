"""The extend attention (``ops/attention.py`` ``extend_attention``, plain
torch) against its roofline: the larger of its bytes (the prefix's real K/V
once, the tails' q, k, v and output) over 3.35 TB/s and its pairs' operations
over 989 TFLOP/s, every layer of the traced image, against the device time of
every kernel launched inside its span (``bench.extend_attention``, the mix's
``trace_spans``): plain torch has no kernel name of its own."""
from benchmark import counts
from benchmark.metrics._share import dims, roofline


def read(ctx):
    s = ctx.shapes
    if "tails" not in s:
        return None
    d = dims(ctx)
    return roofline(ctx, d.L * counts.extend_attn_flops(d, s["prefix"], s["tails"]),
                    d.L * counts.extend_attn_bytes(d, s["prefix"], s["tails"]),
                    ctx.trace.span_seconds("bench.extend_attention"))
