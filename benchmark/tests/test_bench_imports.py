"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dropoutdecoding_tpu"}


def _modules() -> list:
    """Every module of the harness a run imports: run.py, the drivers, the
    metric readers, the reference, and what they import."""
    mods = ["benchmark.run", "benchmark.traces", "benchmark.registry"]
    mods += [f"benchmark.drivers.{p.stem}" for p in (HERE / "drivers").glob("*.py")]
    mods += [f"benchmark.reference.{p.stem}" for p in (HERE / "reference").glob("*.py")]
    return mods


def test_no_jax_in_a_fresh_process():
    code = f"""
import importlib, json, sys
sys.path.insert(0, {str(ROOT)!r})
for m in {_modules()!r}:
    importlib.import_module(m)
from benchmark import registry
for p in sorted(registry.HERE.glob("metrics/*.py")):
    if not p.stem.startswith("_"):
        registry.metric_reader(p.stem)
import dropoutdecoding_tpu_torch.engine.llavanext_engine, dropoutdecoding_tpu_torch.utils.quantize
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "dropoutdecoding_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
                assert node.level <= 1, f"{path.name} imports outside the reference"
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN | {"dropoutdecoding_tpu_torch", "benchmark"}, (path.name, n)


def test_forbidden_modules_compares_whole_names():
    from benchmark import run

    before = set(sys.modules)
    sys.modules["jaxfoo"] = sys.modules["json"]
    try:
        assert "jaxfoo" not in run.forbidden_modules()
        assert "dropoutdecoding_tpu" not in run.forbidden_modules() or "dropoutdecoding_tpu" in before
    finally:
        del sys.modules["jaxfoo"]
