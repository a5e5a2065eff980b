"""Run one cell of ``BENCHMARK.json`` on one NVIDIA card and print one JSON
line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run builds the program (``dropoutdecoding_tpu_torch``) over weights made
from ``--seed``, warms every shape the cell's traffic uses, then runs whole
work units back to back for ``--seconds`` seconds; the window closes at the
first unit that ends after that.  ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` times the calls into the program by
spans, traces one more unit with ``torch.profiler`` and reports the cell's
per-layer metrics.  Then the program's state is freed and the plain fp32
reference judges a sample of what the window produced: ``correct`` and the
numbers compared, each beside its limit (``limits/<cell>.json``).

``--control int8`` runs the program's own int8 weight tier in place of the
served bfloat16 weights: the control that every limit has to fail.
"""
from __future__ import annotations

import time

_START = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the checkout: this package and the program

FORBIDDEN = ("jax", "jaxlib", "flax", "dropoutdecoding_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("int8",), default=None)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def window(driver, seconds: float, spans) -> tuple:
    """Units back to back until one ends ``seconds`` after the first began:
    (units, each unit's seconds)."""
    units, ends = [], []
    t0 = time.perf_counter()
    while True:
        units.append(driver.unit(len(units), spans))
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            unit_s = [b - a for a, b in zip([0.0] + ends, ends)]
            print(f"[bench] unit seconds: {' '.join(f'{x:.3f}' for x in unit_s)}", file=sys.stderr)
            return units, unit_s


def device_info(device, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
    }


def traced(driver, cell, index: int, device):
    """One more unit under the profiler, with a span around each call the
    mix names under ``trace_spans`` ([module, function]): (its sizes, the
    Trace).  The host's operators are recorded only where the mix asks for
    spans: elsewhere the trace holds the device's activity and the CUDA
    calls, and the traced unit runs at nearly its untraced pace."""
    import contextlib
    import importlib

    from benchmark import traces

    with contextlib.ExitStack() as stack:
        for module, name in cell.traffic.get("trace_spans", []):
            stack.enter_context(traces.wrapped(importlib.import_module(module), name, f"bench.{name}"))
        return traces.capture(lambda: driver.traced_unit(index), device,
                              host_ops=bool(cell.traffic.get("trace_spans")))


def note(what: str, since: float) -> float:
    """A progress line on standard error; returns the clock."""
    now = time.perf_counter()
    print(f"[bench] {what} {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def run(argv=None, device=None, adjust=None) -> dict:
    """One run -> the result's dict.  ``device`` and ``adjust`` (a function
    of the cell, returning the cell to run) are for the tests: they skip the
    look for a card and narrow the cell."""
    args = parse(argv)
    from benchmark import registry
    from benchmark.drivers.base import Spans
    from benchmark.peaks import peaks

    cell = registry.cell(args.workload)
    if adjust is not None:
        cell = adjust(cell)
    import torch

    chips = cell.entry["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"{args.workload} needs {chips} CUDA device(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
        torch.cuda.set_device(0)
    torch.set_num_threads(1)  # no intra-op pool spinning beside the launching thread

    driver = registry.driver(cell.traffic["driver"])(
        cell.config, cell.traffic, cell.limits, args.seed, device, control=args.control)
    with torch.no_grad():
        try:
            driver.setup()
            setup_s = time.perf_counter() - _START
            t = note("setup", _START)
            spans = Spans(device) if args.trace else None
            units, unit_s = window(driver, args.seconds, spans)
            window_s = sum(unit_s)
            t = note(f"window of {len(units)} units", t)
            trace = shapes = None
            if args.trace:
                shapes, trace = traced(driver, cell, len(units), device)
                t = note(f"traced unit, {len(trace.kernels)} device operations", t)
            dev = device_info(device, chips)
        finally:
            driver.release()
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        checks = driver.check(units)
        note("check", t)

    metrics = {}
    if args.trace:
        kind = dev["kind"]
        ctx = SimpleNamespace(
            cell=cell, units=units, window_s=window_s, unit_s=unit_s, spans=spans.seconds,
            trace=trace, shapes=shapes, peaks=peaks(kind) if dev["platform"] == "gpu" else None,
        )
        for m in cell.per_layer:
            value = registry.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
    else:
        rate = sum(u.work for u in units) / window_s
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else rate if m["name"] == driver.work_name else None
            if value is None:
                raise KeyError(f"the {cell.traffic['driver']} driver gives no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": sum(u.requests for u in units),
        "failed": 0,
        "metrics": metrics,
        "device": dev,
    }
    if args.trace:
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    result = run(argv)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
