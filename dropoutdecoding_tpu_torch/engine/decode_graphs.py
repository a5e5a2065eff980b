"""CUDA graphs of the decode forwards: ``models/llama.decode_step`` and
``lm_head``, as ``LlavaEngine._one_step`` runs them (exact mode's unmasked
forward and K-member forward, fused mode's one forward, greedy's one).

Eager, a 7B decode forward is about 1,350 launches from Python, host work
that takes longer than the card's work it launches.  Its shapes are fixed
once B, M and the cache's capacity are: the activations are [B, M, D], the
key mask [B, M, Smax] covers the whole capacity, K1 / K3's grid covers the
capacity whatever the fill (``ops/cuda_decode_attention.py``
``decode_plan``), K6's routes depend on shapes only, and every C entry
launches on the current stream.  So the engine captures a forward once and
replays it: a step copies its inputs (x, the position, the mask) into the
graph's static inputs and launches the graph.

A graph bakes in addresses: those of the params' leaves, the cache's leaves
(read only: K4 and the token write stay eager), its static inputs and
outputs, and the kernels' scratch (``decode_scratch``, kept by stream).  So
a graph is keyed on the inputs' shapes and dtypes and on the address, shape,
stride and dtype of every leaf of the params and of the cache, and a key not
seen before captures: once per cache, so once per ``decode`` call unless the
allocator hands a new cache the storage of an old one, and once per server.
The runner keeps no reference to a cache: a graph of a freed cache is only
ever replayed for a cache that lies where it lay.  ``MAX_GRAPHS`` are kept,
the least recently used dropped; an engine's graphs share one memory pool
and one capture stream.

A capture first runs the forward eagerly on the capture stream (the warm-up
capture wants), and that run is the step's result; the capture itself runs
nothing.  A replay's outputs are the graph's static outputs, overwritten by
its next replay: what outlives the step is a copy or is read before the next
replay is enqueued (stream order).

The kernel wrappers count their Python calls (``launches``,
``route_launches``); a replay makes none.  So the counts a capture added are
taken back off, and each replay adds them again: the counters read as in
the eager loop.  Into the open recording (``engine/trace.py``) a replay
counts ``decode.graph_replays`` and a capture ``decode.graph_captures``.
"""
from __future__ import annotations

import gc
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from . import trace

MAX_GRAPHS = 8  # graphs an engine keeps: exact mode's two per cache, for four caches


def for_engine(device: torch.device, tp_mesh) -> "DecodeGraphs | None":
    """The engine's runner: on the card and without a TP mesh, whose
    collectives a graph cannot capture; None (eager forwards) elsewhere."""
    if device.type == "cuda" and tp_mesh is None:
        return DecodeGraphs(device)
    return None


def addresses(tree) -> tuple:
    """(address, shape, stride, dtype) of every tensor of a nested dict,
    list or tuple, in order: what a graph that reads the tree bakes in."""
    if isinstance(tree, torch.Tensor):
        return ((tree.data_ptr(), tree.shape, tree.stride(), tree.dtype),)
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return ()
    return tuple(a for leaf in tree for a in addresses(leaf))


def _counted() -> tuple:
    """The kernel wrappers that count their launches."""
    from ..ops.cuda_cache_append import cache_append_int8
    from ..ops.cuda_decode_attention import (
        ensemble_decode_attention_fused,
        ensemble_decode_attention_int8kv_fused,
    )
    from ..ops.cuda_flash_prefill import flash_prefill_attention
    from ..ops.cuda_int4_matmul import int4_matmul
    from ..ops.cuda_moe import moe_experts
    from ..ops.cuda_uncertainty import vision_uncertainty_fused

    return (ensemble_decode_attention_fused, ensemble_decode_attention_int8kv_fused,
            int4_matmul, cache_append_int8, flash_prefill_attention, vision_uncertainty_fused,
            moe_experts)


def _launch_counts() -> dict:
    return {fn: (fn.launches, dict(getattr(fn, "route_launches", {}))) for fn in _counted()}


def _take_back(before: dict) -> dict:
    """The launches counted since ``before``, taken back off the counters."""
    added = {}
    for fn, (n, routes) in before.items():
        now = getattr(fn, "route_launches", {})
        by_route = {r: c - routes.get(r, 0) for r, c in now.items() if c != routes.get(r, 0)}
        if fn.launches != n or by_route:
            added[fn] = (fn.launches - n, by_route)
            fn.launches = n
            for r, c in by_route.items():
                now[r] -= c
    return added


def _count_again(added: dict) -> None:
    for fn, (n, by_route) in added.items():
        fn.launches += n
        for r, c in by_route.items():
            fn.route_launches[r] += c


class CudaGraph:
    """One forward on the card: warmed and captured on the runner's stream,
    into its pool."""

    def __init__(self, stream: torch.cuda.Stream, pool):
        self.stream, self.pool = stream, pool
        self.graph = None

    def warm(self, fn: Callable):
        """``fn()`` run eagerly on the capture stream: the step's result."""
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = fn()
        main.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable):
        """Captures ``fn()``; returns its static outputs, filled by each
        ``replay``.  The garbage collector waits meanwhile: a graph it frees
        (an engine dropped in a reference cycle) would destroy it inside
        the capture, which CUDA refuses and which ends the capture."""
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.graph = graph
        return out

    def replay(self) -> None:
        self.graph.replay()


class _Entry(NamedTuple):
    graph: object
    inputs: tuple  # static inputs, copied into at each replay
    outputs: tuple  # static outputs, overwritten by each replay
    launches: dict  # the kernel launches of one replay, by wrapper


class DecodeGraphs:
    """An engine's decode-forward graphs.  ``make_graph()`` gives an object
    with ``warm(fn)``, ``capture(fn)`` and ``replay()``: a ``CudaGraph``
    unless a caller swaps in another."""

    def __init__(self, device: torch.device, make_graph: Callable | None = None,
                 max_graphs: int = MAX_GRAPHS):
        self.device = device
        self.make_graph = make_graph  # None: a CudaGraph (no bound method: no cycle)
        self.max_graphs = max_graphs
        self.graphs: OrderedDict = OrderedDict()
        self._stream = self._pool = None  # made at the first capture

    def _cuda_graph(self) -> CudaGraph:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return CudaGraph(self._stream, self._pool)

    def __call__(self, forward: Callable, inputs: tuple, baked: tuple) -> tuple:
        """``forward(*inputs)``, a tuple of tensors, by the graph keyed on
        the inputs' shapes and dtypes and on ``baked`` (what the graph bakes
        in besides them: ``addresses`` of the trees it reads, and any
        setting ``forward`` reads)."""
        key = (tuple((t.shape, t.dtype) for t in inputs), baked)
        entry = self.graphs.get(key)
        if entry is not None:
            self.graphs.move_to_end(key)
            for static, t in zip(entry.inputs, inputs):
                static.copy_(t)
            entry.graph.replay()
            _count_again(entry.launches)
            trace.count("decode.graph_replays")
            return entry.outputs
        static = tuple(t.clone() for t in inputs)
        graph = self.make_graph() if self.make_graph else self._cuda_graph()
        out = graph.warm(lambda: forward(*static))
        before = _launch_counts()
        outputs = graph.capture(lambda: forward(*static))
        if len(self.graphs) >= self.max_graphs:
            if self.device.type == "cuda":  # a replay of the graph dropped may be in flight
                torch.cuda.current_stream(self.device).synchronize()
            self.graphs.popitem(last=False)
        self.graphs[key] = _Entry(graph, static, outputs, _take_back(before))
        trace.count("decode.graph_captures")
        return out
