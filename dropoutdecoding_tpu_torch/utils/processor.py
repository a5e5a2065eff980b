"""Input processing: CLIP image preprocessing + prompt tokenization (port
of ``dropoutdecoding_tpu/utils/processor.py``, bit-equal to it on CLIP's and
LLaVA-NeXT's configs).

Image preprocessing follows the checkpoint's preprocessor_config.json
(resize shortest side -> center crop -> rescale -> normalize; anyres tiles
for LLaVA-NeXT; InstructBLIP's BLIP config a resize straight to its height
and width, which the JAX package's copy does not read) with PIL + numpy;
text goes through the checkpoint's fast tokenizer (``transformers``,
imported when a checkpoint's processor is loaded).  Outputs are numpy arrays; the engines move them to their device.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class ClipImagePreprocessor:
    def __init__(
        self,
        size: int = 336,
        crop_size: int | None = None,
        mean=OPENAI_CLIP_MEAN,
        std=OPENAI_CLIP_STD,
        resample="bicubic",
    ):
        self.size = size
        self.crop_size = crop_size or size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.resample = resample

    @classmethod
    def from_checkpoint(cls, model_dir: str) -> "ClipImagePreprocessor":
        path = os.path.join(model_dir, "preprocessor_config.json")
        with open(path) as f:
            d = json.load(f)
        size = d.get("size", {})
        size = size.get("shortest_edge") if isinstance(size, dict) else size
        crop = d.get("crop_size", {})
        crop = crop.get("height") if isinstance(crop, dict) else crop
        return cls(
            size=size or 336,
            crop_size=crop or size or 336,
            mean=d.get("image_mean", OPENAI_CLIP_MEAN),
            std=d.get("image_std", OPENAI_CLIP_STD),
        )

    def __call__(self, image) -> np.ndarray:
        """PIL.Image -> [3, H, W] float32 normalized pixels."""
        from PIL import Image

        if image.mode != "RGB":
            image = image.convert("RGB")
        w, h = image.size
        # HF get_resize_output_image_size semantics: shortest edge snaps to
        # `size`, the long edge is TRUNCATED (int), not rounded.
        if w <= h:
            new_w = self.size
            new_h = int(self.size * h / w)
        else:
            new_h = self.size
            new_w = int(self.size * w / h)
        resample = Image.BICUBIC if self.resample == "bicubic" else Image.BILINEAR
        image = image.resize((new_w, new_h), resample)
        # center crop
        left = (new_w - self.crop_size) // 2
        top = (new_h - self.crop_size) // 2
        image = image.crop((left, top, left + self.crop_size, top + self.crop_size))
        arr = np.asarray(image, np.float32) / 255.0  # [H, W, 3]
        arr = (arr - self.mean) / self.std
        return arr.transpose(2, 0, 1)

    def batch(self, images) -> np.ndarray:
        return np.stack([self(im) for im in images])


class BlipImagePreprocessor:
    """HF ``BlipImageProcessor`` semantics (InstructBLIP): a bicubic resize
    straight to (height, width), no crop, then rescale and normalize."""

    def __init__(self, height: int = 224, width: int = 224, mean=OPENAI_CLIP_MEAN,
                 std=OPENAI_CLIP_STD):
        self.height, self.width = height, width
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image) -> np.ndarray:
        """PIL.Image -> [3, height, width] float32 normalized pixels."""
        from PIL import Image

        if image.mode != "RGB":
            image = image.convert("RGB")
        image = image.resize((self.width, self.height), Image.BICUBIC)
        arr = np.asarray(image, np.float32) / 255.0
        return ((arr - self.mean) / self.std).transpose(2, 0, 1)

    def batch(self, images) -> np.ndarray:
        return np.stack([self(im) for im in images])


def image_preprocessor_from_checkpoint(model_dir: str):
    """The image preprocessor a checkpoint's preprocessor_config.json
    describes: ``BlipImagePreprocessor`` where ``size`` is {height, width}
    with no shortest edge (HF's ``BlipImageProcessor``, InstructBLIP's
    224 px), else ``ClipImagePreprocessor``.  The JAX package reads only a
    shortest edge and a crop height, so on InstructBLIP's config it falls to
    336 px, 577 ViT tokens against the tower's 257 positions."""
    with open(os.path.join(model_dir, "preprocessor_config.json")) as f:
        d = json.load(f)
    size = d.get("size")
    if isinstance(size, dict) and "shortest_edge" not in size and "height" in size:
        return BlipImagePreprocessor(
            height=size["height"], width=size.get("width", size["height"]),
            mean=d.get("image_mean", OPENAI_CLIP_MEAN), std=d.get("image_std", OPENAI_CLIP_STD),
        )
    return ClipImagePreprocessor.from_checkpoint(model_dir)


class LlavaNextImagePreprocessor:
    """Anyres preprocessing (HF LlavaNextImageProcessor semantics): a plain
    square-resized base tile plus the best-resolution aspect-preserving
    resize, center-padded and divided into tile_size patches."""

    def __init__(self, grid_pinpoints, tile_size=336, mean=OPENAI_CLIP_MEAN,
                 std=OPENAI_CLIP_STD):
        self.grid_pinpoints = [tuple(p) for p in grid_pinpoints]
        self.tile = tile_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    @classmethod
    def from_checkpoint(cls, model_dir: str) -> "LlavaNextImagePreprocessor":
        with open(os.path.join(model_dir, "preprocessor_config.json")) as f:
            d = json.load(f)
        size = d.get("size", {})
        size = size.get("shortest_edge") if isinstance(size, dict) else size
        return cls(
            grid_pinpoints=d.get(
                "image_grid_pinpoints",
                [[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]],
            ),
            tile_size=size or 336,
            mean=d.get("image_mean", OPENAI_CLIP_MEAN),
            std=d.get("image_std", OPENAI_CLIP_STD),
        )

    def _norm(self, arr: np.ndarray) -> np.ndarray:
        arr = arr.astype(np.float32) / 255.0
        return ((arr - self.mean) / self.std).transpose(2, 0, 1)

    def __call__(self, image):
        """PIL image -> (tiles [n_tiles, 3, T, T], original_size (H, W))."""
        from PIL import Image

        from ..models.llavanext import select_best_resolution  # the port's own

        if image.mode != "RGB":
            image = image.convert("RGB")
        w, h = image.size
        T = self.tile
        th, tw = select_best_resolution((h, w), self.grid_pinpoints)
        # aspect-preserving resize (HF get_patch_output_size semantics:
        # snap the binding dimension to the target, ceil the other)
        if tw / w < th / h:
            nw, nh = tw, min(math.ceil(h * (tw / w)), th)
        else:
            nh, nw = th, min(math.ceil(w * (th / h)), tw)
        resized = np.asarray(image.resize((nw, nh), Image.BICUBIC))
        # center pad to (th, tw)
        py, ry = divmod(th - nh, 2)
        px, rx = divmod(tw - nw, 2)
        canvas = np.zeros((th, tw, 3), resized.dtype)
        canvas[py : py + nh, px : px + nw] = resized
        # divide into tiles, row-major
        tiles = [
            canvas[r : r + T, c : c + T]
            for r in range(0, th, T)
            for c in range(0, tw, T)
        ]
        base = np.asarray(image.resize((T, T), Image.BICUBIC))
        out = np.stack([self._norm(base)] + [self._norm(t) for t in tiles])
        return out, (h, w)


class VlmProcessor:
    """Tokenizer + image preprocessor pair for a checkpoint directory.

    ``__call__(prompt, image)`` returns {'input_ids': [1, S] (single
    <image> placeholder token), 'pixel_values': [1, 3, H, W]} — the 4.44-era
    convention our merge implements (reference llava.py:74-153)."""

    def __init__(
        self,
        tokenizer,
        image_processor,
        image_token: str = "<image>",
        qformer_tokenizer=None,
    ):
        self.tokenizer = tokenizer
        self.image = image_processor
        self.image_token = image_token
        # InstructBLIP's Q-Former reads the instruction through its own BERT
        # tokenizer (stored under qformer_tokenizer/ in the checkpoint,
        # reference instructblip generate qformer_input_ids)
        self.qformer_tokenizer = qformer_tokenizer

    @classmethod
    def from_checkpoint(cls, model_dir: str) -> "VlmProcessor":
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(model_dir, use_fast=True)
        qtok = None
        qdir = os.path.join(model_dir, "qformer_tokenizer")
        if os.path.isdir(qdir):
            qtok = AutoTokenizer.from_pretrained(qdir, use_fast=True)
        return cls(tok, image_preprocessor_from_checkpoint(model_dir), qformer_tokenizer=qtok)

    def qformer_ids(self, prompt: str):
        """Instruction ids in the Q-Former's tokenizer space (falls back to
        the LM tokenizer when the checkpoint has no qformer_tokenizer, as
        the JAX package does; ids past the Q-Former's vocabulary then make
        ``models/instructblip.visual_tokens`` raise, where JAX's gather
        clamps them)."""
        tok = self.qformer_tokenizer or self.tokenizer
        return tok(prompt, return_tensors="np")["input_ids"].astype("int32")

    def __call__(self, prompt: str, image=None):
        ids = self.tokenizer(prompt, return_tensors="np")["input_ids"]
        out = {"input_ids": ids.astype(np.int32)}
        if image is not None:
            out["pixel_values"] = self.image.batch([image])
        return out

    def decode(self, token_ids, skip_special_tokens=True) -> str:
        return self.tokenizer.decode(
            list(map(int, token_ids)), skip_special_tokens=skip_special_tokens
        )
