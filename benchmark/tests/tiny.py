"""A cell narrowed to a size a CPU test run holds: the configuration's
widths cut to a few dozen, two LM layers, 28 px crops, a short window."""
from __future__ import annotations

import copy

from benchmark import run


def narrow(cell, **traffic):
    c = copy.deepcopy(cell.config)
    c["text_config"].update(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2, head_dim=16)
    c["vision_config"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                              num_attention_heads=2, image_size=28, patch_size=14)
    if "image_grid_pinpoints" in c:
        c["image_grid_pinpoints"] = [[28, 56], [56, 28], [56, 56], [84, 28], [28, 84]]
    c["kv_capacity"] = 160
    c["init_std"] = 0.2  # sharper than 0.02, so that two layers of 64 separate a fault from rounding
    t = copy.deepcopy(cell.traffic)
    if t["driver"] == "caption":
        t.update(batch=4, new_tokens=8, check_rows=2)
    t["image_size"] = [24, 32] if "image_grid_pinpoints" in c else [28, 28]
    t.update(traffic)
    return cell._replace(config=c, traffic=t)


def run_tiny(workload: str, seed: int = 3000000017, trace: int = 0, control=None, **traffic) -> dict:
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace)]
    if control:
        argv += ["--control", control]
    return run.run(argv, device="cpu", adjust=lambda cell: narrow(cell, **traffic))
