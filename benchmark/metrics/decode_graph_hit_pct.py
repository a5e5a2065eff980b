"""The share of the decode forwards' graph replays that needed no capture
(``engine/decode_graphs.py``): 100 x (replays - captures) / replays of the
profiled unit's ``decode.graph_replays`` and ``decode.graph_captures``
counters.  Nothing where no replay was recorded: a program without the
graphs, or a run on the CPU."""
from benchmark.metrics._program import calls


def read(ctx):
    recs = calls(ctx) or ()
    replays = sum(r.counters.get("decode.graph_replays", 0) for r in recs)
    if not replays:
        return None
    captures = sum(r.counters.get("decode.graph_captures", 0) for r in recs)
    return 100.0 * (replays - captures) / replays
