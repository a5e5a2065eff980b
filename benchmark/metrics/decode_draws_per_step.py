"""Calls to the program's draw sources a decode step (``engine/generate.py``
``_rows``: each one generator reseed and one ``torch.rand`` launch, a row
and member, and a row for each text policy or sample): the profiled unit's
``decode.draws`` counter over its ``decode.steps``."""
from benchmark.metrics._program import per_step


def read(ctx):
    return per_step(ctx, "decode.draws")
