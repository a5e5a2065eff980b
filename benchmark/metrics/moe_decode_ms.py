"""Device milliseconds of K7 (the kernels in ``kernels/moe_experts/``) a
decode step of the traced caption batch: both forwards' routed layers."""


def read(ctx):
    s = ctx.shapes
    if ctx.peaks is None or not s or "new_tokens" not in s:
        return None
    seconds = ctx.trace.op_seconds("moe_experts")
    return 1e3 * seconds / (s["new_tokens"] - 1) if seconds else None
