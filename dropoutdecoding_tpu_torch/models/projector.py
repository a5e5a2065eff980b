"""Multi-modal projector: a 2-layer MLP from the vision width to the LM width
(port of ``dropoutdecoding_tpu/models/projector.py``)."""
from __future__ import annotations

import torch

from ..ops.basic import act_fn
from ..utils.hf_io import hf_leaf


def params_from_hf(
    sd: dict,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
    prefix: str = "multi_modal_projector.",
) -> dict:
    """HF LlavaMultiModalProjector weights -> the projector's params (JAX
    ``models/projector.py:22``)."""

    def leaf(name, transpose=False):
        return hf_leaf(sd, prefix + name, dtype, device, transpose)

    return {
        "fc1_w": leaf("linear_1.weight", True),
        "fc1_b": leaf("linear_1.bias"),
        "fc2_w": leaf("linear_2.weight", True),
        "fc2_b": leaf("linear_2.bias"),
    }


def apply(params: dict, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
    h = act_fn(act)(x @ params["fc1_w"] + params["fc1_b"])
    return h @ params["fc2_w"] + params["fc2_b"]
