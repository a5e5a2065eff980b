"""Milliseconds a decode step of the caption loop (``LlavaEngine.decode``),
host clock between two device synchronises around each batch's ``decode``
call, over every step of the window."""


def read(ctx):
    spans = ctx.spans.get("decode")
    if not spans:
        return None
    steps = len(spans) * (ctx.cell.traffic["new_tokens"] - 1)
    return 1e3 * sum(spans) / steps
