"""K1 (``ops/cuda_decode_attention.py``) against its roofline: the bytes its
calls in the traced batch need (each row's K and V of its filled slots once,
the queries, the members' own K/V, the masks, the output; ``counts.py``
``exact_decode_attn``) over 3.35 TB/s, against the device time of the
kernels in ``kernels/decode_attn/``."""
from benchmark import counts
from benchmark.metrics._share import dims, roofline


def read(ctx):
    s = ctx.shapes
    if "new_tokens" not in s:
        return None
    flops, nbytes = counts.exact_decode_attn(dims(ctx), s["rows"], s["members"], s["real"],
                                             s["new_tokens"], s["slots"])
    return roofline(ctx, flops, nbytes, ctx.trace.op_seconds("decode_attn"))
