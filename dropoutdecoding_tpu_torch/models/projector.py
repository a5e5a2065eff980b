"""Multi-modal projector: a 2-layer MLP from the vision width to the LM width
(port of ``dropoutdecoding_tpu/models/projector.py``)."""
from __future__ import annotations

import torch

from ..ops.basic import act_fn


def apply(params: dict, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
    h = act_fn(act)(x @ params["fc1_w"] + params["fc1_b"])
    return h @ params["fc2_w"] + params["fc2_b"]
