"""Milliseconds of a caption batch's ``prefill`` call (the towers, the LM
prefill, the visual-token logits and K2), host clock between two device
synchronises, the mean over the window's batches."""


def read(ctx):
    spans = ctx.spans.get("prefill")
    return 1e3 * sum(spans) / len(spans) if spans else None
