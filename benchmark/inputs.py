"""The inputs a traffic mix asks for, made from ``--seed``: prompt ids,
image crops and POPE questions.  The same seed gives the same inputs, and
every seed the same sizes in another order, so a seed changes no work.

Images are the vision tower's inputs as a processor hands them over:
normalized pixels, here uniform in [-1.8, 2.1] (CLIP's normalized range),
one [3, s, s] crop a tile.
"""
from __future__ import annotations

import numpy as np
import torch

from . import seeds
from .reference.anyres import image_geometry

BOS = 1
FIRST_ID = 3  # ids 0-2 are unk, bos, eos


def _ids(r: np.random.Generator, n: int, config: dict) -> np.ndarray:
    high = min(config["text_config"]["vocab_size"], config["image_token_index"])
    return r.integers(FIRST_ID, high, size=n)


def tiles_of(config: dict, size) -> int:
    """Crops an image of ``size`` (h, w) becomes: 1 on LLaVA-1.5, the anyres
    grid and the base tile on LLaVA-NeXT."""
    if config["family"] == "llavanext":
        return image_geometry(size, config)["n_tiles"]
    return 1


def image(config: dict, seed: int, index: int, size, device) -> torch.Tensor:
    """Image ``index``'s crops [tiles, 3, s, s] fp32 on ``device``."""
    s = config["vision_config"]["image_size"]
    g = seeds.generator(device, seed, seeds.IMAGES, index)
    n = tiles_of(config, size)
    return torch.rand((n, 3, s, s), generator=g, device=device) * 3.9 - 1.8


def caption_prompt(config: dict, traffic: dict, seed: int) -> np.ndarray:
    """The run's instruction [S_text]: BOS, random ids, one image token."""
    ids = _ids(seeds.rng(seed, seeds.PROMPT), traffic["prompt_tokens"], config)
    ids[0] = BOS
    ids[traffic["image_pos"]] = config["image_token_index"]
    return ids.astype(np.int64)


class Questions:
    """POPE questions in the POPE order: ``questions_per_image`` an image,
    image after image.  A question is the template's start (BOS, the image
    token), its head ("Is there a"), the object's 1-4 ids and the template's
    end; each image's objects take the lengths of ``object_tokens`` in an
    order drawn from the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        self.config, self.traffic, self.seed = config, traffic, seed
        p = traffic["prompt"]
        ids = _ids(seeds.rng(seed, seeds.PROMPT), p["pre"] + p["head"] + p["rest"], config)
        ids[0] = BOS
        ids[p["image_pos"]] = config["image_token_index"]
        self.pre = ids[: p["pre"]]
        self.head = ids[p["pre"]: p["pre"] + p["head"]]
        self.rest = ids[p["pre"] + p["head"]:]
        self.per_image = traffic["questions_per_image"]

    def objects(self, image: int) -> list:
        r = seeds.rng(self.seed, seeds.OBJECTS, image)
        lengths = r.permutation(self.traffic["object_tokens"])
        return [_ids(r, int(n), self.config) for n in lengths]

    @property
    def prefix(self) -> np.ndarray:
        """The start every question of an image shares: its prefix-cache
        prefix."""
        return np.concatenate([self.pre, self.head]).astype(np.int64)

    def tail(self, question: int) -> np.ndarray:
        image, slot = divmod(question, self.per_image)
        return np.concatenate([self.objects(image)[slot], self.rest]).astype(np.int64)

    def prompt(self, question: int) -> np.ndarray:
        return np.concatenate([self.prefix, self.tail(question)])

    def image_of(self, question: int) -> int:
        return question // self.per_image
