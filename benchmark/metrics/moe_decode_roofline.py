"""K7 (``ops/cuda_moe.py``) against its roofline over the traced batch's
decode forwards: its bytes (the three matrices of each routed layer's 64
experts once a forward, the sorted rows in and out) and its operations (2 x
3 x D x I_expert an assignment; ``counts_mla.k7_caption``), against the
device time of the kernels in ``kernels/moe_experts/``.  Nothing where no
such kernel ran."""
from benchmark import counts_mla
from benchmark.metrics._share import roofline


def read(ctx):
    s = ctx.shapes
    if not s or "new_tokens" not in s:
        return None
    d = counts_mla.MlaDims.of(ctx.cell.config)
    flops, nbytes = counts_mla.k7_caption(d, s["rows"], s["members"], s["new_tokens"])
    return roofline(ctx, flops, nbytes, ctx.trace.op_seconds("moe_experts"))
