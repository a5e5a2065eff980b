"""InstructBLIP composition: EVA ViT-g -> Q-Former (instruction-aware) ->
linear projection -> Vicuna LM, and the loading of an HF checkpoint; port
of ``dropoutdecoding_tpu/models/instructblip.py``.

The 32 projected query outputs are the visual tokens: they come first in
the LM's merged sequence, before the text embeddings (no ``<image>``
placeholder), so the visual span is slots [0, 32).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import blip_vit, llama, qformer
from .llava import load_checkpoint
from ..utils.config import InstructBlipConfig
from ..utils.hf_io import hf_leaf


class InstructBlipParams(NamedTuple):
    vision: dict
    qformer: dict
    projection: dict  # {"w": [Dq, Dlm], "b": [Dlm]}
    lm: dict


def params_from_hf(
    cfg: InstructBlipConfig,
    sd: dict,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> InstructBlipParams:
    """An HF InstructBlipForConditionalGeneration state dict ->
    InstructBlipParams on ``device`` in ``dtype`` (JAX
    ``models/instructblip.py:48``): the prefixes ``vision_model.``,
    ``qformer.`` (with the top-level ``query_tokens``),
    ``language_projection.`` and ``language_model.``."""
    return InstructBlipParams(
        vision=blip_vit.params_from_hf(cfg.vision, sd, dtype, device),
        qformer=qformer.params_from_hf(cfg.qformer, sd, dtype, device),
        projection={
            "w": hf_leaf(sd, "language_projection.weight", dtype, device, transpose=True),
            "b": hf_leaf(sd, "language_projection.bias", dtype, device),
        },
        lm=llama.params_from_hf(cfg.text, sd, dtype, device, prefix="language_model."),
    )


def load(
    model_dir: str,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
    cache: bool = True,
):
    """Config and weights of an HF checkpoint directory ->
    (InstructBlipConfig, InstructBlipParams on ``device``), through the
    converted-params cache (``utils/cache.py``) unless ``cache`` is off."""
    return load_checkpoint(
        model_dir, InstructBlipConfig, params_from_hf, InstructBlipParams, dtype, device, cache
    )


def check_qformer_ids(cfg: InstructBlipConfig, qformer_input_ids: torch.Tensor) -> None:
    """Raise ``ValueError`` unless every id lies in the Q-Former's vocabulary.
    The JAX gather clamps an id past it into the last row, where torch's
    lookup asserts on the device; such ids are LM ids, which
    ``VlmProcessor.qformer_ids`` hands back when the checkpoint has no
    ``qformer_tokenizer/``."""
    if qformer_input_ids.numel() == 0:
        return
    lo, hi = torch.stack(torch.aminmax(qformer_input_ids)).tolist()  # one host read
    if lo < 0 or hi >= cfg.qformer.vocab_size:
        raise ValueError(
            f"Q-Former input ids span [{lo}, {hi}], outside the Q-Former's vocabulary of "
            f"{cfg.qformer.vocab_size} ids: they are not BERT ids from the checkpoint's "
            f"qformer_tokenizer/ (LM ids?)"
        )


def visual_tokens(
    cfg: InstructBlipConfig,
    params: InstructBlipParams,
    pixel_values: torch.Tensor,
    qformer_input_ids: torch.Tensor,
    qformer_attention_mask: torch.Tensor | None = None,
    image_index: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pixels and the instruction -> the projected query outputs [B, 32,
    D_lm] (JAX ``models/instructblip.py:85``).

    ``image_index`` ([B], optional): ``pixel_values`` holds only the batch's
    unique images; the vision tower runs once an image and the rows gather
    its output.  The Q-Former runs a row at a time all the same, since it
    reads each row's instruction."""
    check_qformer_ids(cfg, qformer_input_ids)
    image_embeds = blip_vit.apply(cfg.vision, params.vision, pixel_values)
    if image_index is not None:
        image_embeds = image_embeds[image_index]
    query_out = qformer.apply(
        cfg.qformer, params.qformer, qformer_input_ids, image_embeds, qformer_attention_mask
    )
    return query_out @ params.projection["w"] + params.projection["b"]
