"""Multi-modal projector: a 2-layer MLP from the vision width to the LM width
(port of ``dropoutdecoding_tpu/models/projector.py``)."""
from __future__ import annotations

import torch

from ..ops.basic import act_fn
from ..parallel.mesh import all_reduce, mesh_of
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
    """Under tensor parallelism fc1 is column-parallel and fc2 row-parallel:
    its product is all-reduced before the whole ``fc2_b`` is added."""
    h = act_fn(act)(x @ params["fc1_w"] + params["fc1_b"])
    return all_reduce(h @ params["fc2_w"], mesh_of(params)) + params["fc2_b"]
