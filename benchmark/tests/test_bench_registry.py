"""``BENCHMARK.json`` agrees with the files that the harness finds by name,
and keeps to the characters and sizes its contract allows."""
from __future__ import annotations

import json
import re

import pytest

from benchmark import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert (registry.ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", sorted(CELLS))
def test_each_cell_finds_its_files(name):
    w = CELLS[name]
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    assert NAME.match(name) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    cell = registry.cell(name)
    assert cell.config["name"] == w["config"]
    registry.driver(cell.traffic["driver"])
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    # every cell reports setup_s, one more end-to-end metric and a per-layer one
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_configs():
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        config = registry.load(registry.ROOT / c["file"])
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_metrics():
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in E2E
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (registry.HERE / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert cell in CELLS
            assert registry.reports(E2E[m["moves"]], cell, E2E), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_kernel_lists_and_traffic_files():
    from benchmark.traces import kernel_patterns

    for op in ("decode_attn", "prefill_attn"):
        assert kernel_patterns(op)
    for w in BENCH["workloads"]:
        t = registry.load(registry.HERE / "traffic" / f"{w['traffic']}.json")
        assert (registry.HERE / "drivers" / f"{t['driver']}.py").is_file()
