"""Milliseconds of an image's ``probe_extend`` call (its questions' tails
over the cached prefix), host clock between two device synchronises, the
mean over the window's images."""


def read(ctx):
    spans = ctx.spans.get("extend")
    return 1e3 * sum(spans) / len(spans) if spans else None
