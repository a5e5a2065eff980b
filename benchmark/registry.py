"""Finds a cell's files by the names in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and the mix's driver (``drivers/<driver>.py``),
its limits (``limits/<cell>.json``), and each metric's reader
(``metrics/<metric>.py``)."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    entry: dict  # the cell's entry of "workloads"
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the end-to-end metrics the cell reports
    per_layer: list  # the per-layer metrics the cell reports


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load(root / "BENCHMARK.json")


def reports(metric: dict, cell: str, end_to_end: dict) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or where it
    lists none, every cell that reports the end-to-end metric it moves (an
    end-to-end metric without a list: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return reports(end_to_end[metric["moves"]], cell, end_to_end)
    return True


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    bench = bench if bench is not None else benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load(root / configs[entry["config"]]["file"])
    traffic = load(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load(HERE / "limits" / f"{name}.json")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return Cell(
        name, entry, config, traffic, limits,
        [m for m in bench["end_to_end"] if reports(m, name, e2e)],
        [m for m in bench["per_layer"] if reports(m, name, e2e)],
    )


def driver(name: str):
    """The driver class a traffic mix names."""
    return importlib.import_module(f"benchmark.drivers.{name}").DRIVER


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``: a number, or None where the
    run gave it nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
