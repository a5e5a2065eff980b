"""LLaVA-NeXT dropout-decoding engine (port of
``dropoutdecoding_tpu/engine/llavanext_engine.py``).

It reuses ``LlavaEngine``'s decode loop and state assembly, and with them
every decoding arm (fused mode, sampling, the text-mask and mask
policies); the prefill differs:

- the host turns each image's anyres geometry into a gather plan and a
  validity mask over ``max_image_tokens`` slots (``models/llavanext.py``),
  and pads a batch's tile stacks to its largest tile count;
- the merged sequence is padded to S_text - 1 + N_max with a key mask, so
  each row's first token comes from its last real position, decoding
  appends at its real length, and the mask policies and the uncertainty's
  mean see only the real visual tokens (``PrefillState.visual_mask``).

At LLaVA-v1.6 widths the merged prompt is about 2.95k tokens, so the LM
prefill runs K5 (``ops/cuda_flash_prefill.py``) in every layer, and the
visual span's uncertainty is K2 over [B, 2928, V] with ``valid``.  Under
"epis_kl" the state keeps those logits, [1, 2928, 32064] fp32 (375 MB) a
row, and every step reads them for the KL keep set.

The reference's LLaVA-NeXT defaults are the caller's: ``EnsembleConfig(
mask_accumulate=False, topk=10)``, seed 506, and ``mask_policy=
"epis_no_overlap"`` under ``use_random``.

Not ported yet (each raises ``NotImplementedError``): ``probe``,
``probe_prefix`` / ``probe_extend`` (ROADMAP Queue 1 item 8) and
``prefill_chunked`` (item 14).  The JAX engine's ``int8_prefix_cache``
option (item 12) has no counterpart: passing it fails at construction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import llama as llama_mod
from ..models import llavanext as next_mod
from .generate import GenerationResult, LlavaEngine, PrefillState


def _later(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


@dataclass
class LlavaNextEngine(LlavaEngine):
    """``generate(input_ids, tile_pixels, original_size)``; ``cfg`` is a
    ``LlavaNextConfig`` and ``params`` ``LlavaNextParams``."""

    def __post_init__(self):
        super().__post_init__()
        self._n_max = next_mod.max_image_tokens(self.cfg)

    @property
    def n_visual(self) -> int:
        return self._n_max

    def _prep_images(self, tile_pixels, original_size, n_images):
        """Host-side anyres prep: the images' tile stacks padded to the
        largest tile count [B, T_pad, 3, s, s], and their gather plans and
        validity masks [B, N_max], on the engine's device."""
        if n_images == 1 and not isinstance(original_size, list):
            original_size = [tuple(original_size)]
        if not isinstance(tile_pixels, (list, tuple)):
            tile_pixels = [tile_pixels] if n_images == 1 else list(tile_pixels)
        if len(tile_pixels) != n_images or len(original_size) != n_images:
            raise ValueError(
                f"{n_images} rows need as many tile stacks and sizes; got "
                f"{len(tile_pixels)} and {len(original_size)}"
            )
        geos = [next_mod.image_geometry(size, self.cfg) for size in original_size]
        t_pad = max(g["n_tiles"] for g in geos)
        tiles, gathers, valids = [], [], []
        for tp, geo in zip(tile_pixels, geos):
            tp = torch.as_tensor(tp, device=self.device)
            if tp.shape[0] != geo["n_tiles"]:
                raise ValueError(f"{tp.shape[0]} tiles for an image of geometry {geo}")
            pad = tp.new_zeros((t_pad - tp.shape[0], *tp.shape[1:]))
            tiles.append(torch.cat([tp, pad]))
            g, v = next_mod.packing_indices(self.cfg, geo, self._n_max, pad_tiles=t_pad)
            gathers.append(g)
            valids.append(v)
        return (
            torch.stack(tiles),
            torch.as_tensor(np.stack(gathers), device=self.device),
            torch.as_tensor(np.stack(valids), device=self.device),
        )

    def _image_positions(self, input_ids: np.ndarray) -> torch.Tensor:
        pos = [int(np.argmax(row == self.cfg.image_token_index)) for row in input_ids]
        return torch.tensor(pos, dtype=torch.long, device=self.device)

    @torch.no_grad()
    def prefill(self, input_ids, tile_pixels, original_size, text_lens=None) -> PrefillState:
        """Args:
          input_ids: [B, S_text], one <image> token per row (right-padded
            rows give their real lengths in ``text_lens``).
          tile_pixels: [n_tiles, 3, s, s] for B = 1, or a list of B such
            stacks (tile counts may differ).
          original_size: (h, w) for B = 1, or a list of B pairs.
        """
        cfg, lm = self.cfg, self.params.lm
        ids = np.asarray(input_ids)
        tiles, gathers, valid = self._prep_images(tile_pixels, original_size, ids.shape[0])
        image_pos = self._image_positions(ids)
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        packed = next_mod.pack_image_features_batched(cfg, self.params, tiles, gathers)
        text_embeds = llama_mod.embed(lm, torch.where(ids == cfg.image_token_index, 0, ids))
        merged, key_mask, real_len = next_mod.merge_with_text_batched(
            text_embeds, packed, valid, image_pos, text_lens
        )
        B, S, _ = merged.shape
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        hidden, kv = llama_mod.prefill(lm, cfg.text, merged, positions, key_mask=key_mask)
        return self._assemble_state(ids, hidden, kv, image_pos, real_len, text_lens, valid)

    def generate(self, input_ids, tile_pixels, original_size) -> GenerationResult:
        return self._generate(input_ids, tile_pixels, original_size)

    def probe(self, *args, **kwargs):
        raise _later("probe (the POPE path)", 8)

    def probe_prefix(self, *args, **kwargs):
        raise _later("probe_prefix (the prefix cache)", 8)

    def probe_extend(self, *args, **kwargs):
        raise _later("probe_extend (the prefix cache)", 8)

    def prefill_chunked(self, *args, **kwargs):
        raise _later("prefill_chunked", 14)
