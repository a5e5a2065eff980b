"""The PyTorch port stands alone: it imports no JAX, its config copies agree
with the JAX package's field by field, and ``chip_smoke.py`` refuses to run
without a GPU."""
import dataclasses
import json
import os
import re
import subprocess
import sys

import pytest

from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.utils import config as torch_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import dropoutdecoding_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "dropoutdecoding_tpu.")))
print(json.dumps([names, leaked]))
"""
# modules the scan must have imported: one of each layer, the CLI's among them
EXPECTED_MODULES = [
    "ops.cuda_int4_matmul", "utils.hf_io", "utils.cache", "utils.processor",
    "utils.native_image", "engine.trace", "evalsuite.chair", "evalsuite.coco",
    "evalsuite.text", "evalsuite.throne", "evalsuite.metrics.evalcap",
    "evalsuite.metrics.meteor", "evalsuite.metrics.spice_lite", "cli.chair_test",
    "cli.chair2throne", "decoding.vcd", "decoding.opera", "engine.baselines", "engine.opera",
    "models.blip_vit", "models.qformer", "models.instructblip", "engine.instructblip_engine",
    "cli.fused_gap", "cli.stall_probe", "cli.baseline_batch_bench", "cli.step_gen",
    "cli.run_acceptance", "cli.run_experiments", "cli.compare_results", "cli.calibrate_metrics",
    "evalsuite.metrics.calibration", "parallel.mesh", "parallel.distributed",
]
# an import statement of JAX or of the JAX package, in any source line
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax\b|dropoutdecoding_tpu(\.|\s|$))", re.M)


def _run(args, cwd=ROOT, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout,
    )


def test_port_modules_import_no_jax():
    proc = _run(["-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    names, leaked = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(names) >= 51  # every module of the port was imported,
    missing = {f"dropoutdecoding_tpu_torch.{m}" for m in EXPECTED_MODULES} - set(names)
    assert not missing  # the new ones among them
    assert leaked == [], f"port modules pulled in {leaked}"


def test_no_source_line_imports_jax():
    """No import of ``jax`` or of the JAX package in any source file of the
    port or in ``chip_smoke.py``, imported or not (a lazy import inside a
    function is caught here, not by the scan above)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "dropoutdecoding_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) >= 52
    bad = [f for f in files if _FORBIDDEN.search(open(f).read())]
    assert bad == []
    assert _FORBIDDEN.search("    from dropoutdecoding_tpu.utils import hf_io")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from dropoutdecoding_tpu_torch.utils import hf_io")


@pytest.mark.parametrize(
    "name",
    [
        "LlamaConfig", "ClipVisionConfig", "LlavaConfig", "LlavaNextConfig", "EnsembleConfig",
        "GenerationConfig", "QFormerConfig", "BlipVisionConfig", "InstructBlipConfig",
        "ClipTextConfig",
    ],
)
def test_config_copies_agree(name):
    ours, ref = getattr(torch_config, name)(), getattr(jax_config, name)()
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(ref)
    ]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_config_constructors_agree():
    hf = {
        "text_config": {
            "vocab_size": 64, "hidden_size": 48, "intermediate_size": 96,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 2, "rope_theta": 5e5,
        },
        "vision_config": {
            "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 3,
            "num_attention_heads": 4, "image_size": 28, "patch_size": 7,
        },
        "image_token_index": 32,
    }
    ours = torch_config.LlavaConfig.from_hf_dict(hf)
    ref = jax_config.LlavaConfig.from_hf_dict(hf)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for pinpoints in ([], [[28, 56], [56, 28], [56, 56]]):
        d = {**hf, "image_grid_pinpoints": pinpoints}
        ours = torch_config.LlavaNextConfig.from_hf_dict(d)
        ref = jax_config.LlavaNextConfig.from_hf_dict(d)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.vision.num_patches == ref.vision.num_patches == 16
    ib = {
        "text_config": hf["text_config"],
        "vision_config": {**hf["vision_config"], "layer_norm_eps": 1e-5, "qkv_bias": True},
        "qformer_config": {
            "vocab_size": 48, "hidden_size": 24, "num_hidden_layers": 4,
            "num_attention_heads": 4, "intermediate_size": 48, "cross_attention_frequency": 2,
            "encoder_hidden_size": 32, "max_position_embeddings": 64,
        },
        "num_query_tokens": 4,
    }
    ours = torch_config.InstructBlipConfig.from_hf_dict(ib)
    ref = jax_config.InstructBlipConfig.from_hf_dict(ib)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.qformer.num_query_tokens == ours.num_query_tokens == 4
    assert ours.vision.num_positions == ref.vision.num_positions == 17
    for n in range(7):
        assert torch_config.EnsembleConfig.voting_probs_for(
            n
        ) == jax_config.EnsembleConfig.voting_probs_for(n)
    assert torch_config.EnsembleConfig().k == jax_config.EnsembleConfig().k == 3


def test_chip_smoke_refuses_without_gpu(tmp_path):
    # on a machine without CUDA it must exit non-zero and print no result
    proc = _run([os.path.join(ROOT, "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # alone in a directory, without the port beside it, it fails too
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    proc = _run([str(alone)], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
