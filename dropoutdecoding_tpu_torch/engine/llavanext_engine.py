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

The POPE path (``probe``, ``probe_prefix`` / ``probe_extend``) runs as on
LLaVA-1.5, with two differences: ``image_index`` selects the packed
features and the validity masks by row, and a prefix comes back as
``(kv, real_len, key_mask)``: it is padded past its real length, so the
tails' rope positions start at ``real_len`` and its pad slots are masked
out of their attention.  At LLaVA-v1.6 widths the prefix and the batched
probe are ~2.95k-token prefills, so both run K5; the extend does not.

``prefill_chunked`` runs the LM prefill of one request in pieces over the
padded merge, the pad slots masked (``LlavaEngine._lm_chunked``), and
calls the serving layer's pump between two pieces.  The JAX engine passes
the pump on too (``engine/llavanext_engine.py:381``); a ~2.95k-token
prompt is the case it exists for.  No piece runs K5: each is an extend
over the pieces before it (plain attention), as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import llama as llama_mod
from ..models import llavanext as next_mod
from ..models import mla_moe as mla_moe_mod
from ..utils.config import is_mla_moe
from . import trace
from .generate import GenerationResult, LlavaEngine, PrefillState, ProbeResult


@dataclass
class LlavaNextEngine(LlavaEngine):
    """``generate(input_ids, tile_pixels, original_size)``; ``cfg`` is a
    ``LlavaNextConfig`` and ``params`` ``LlavaNextParams``."""

    def __post_init__(self):
        if is_mla_moe(self.cfg.text):
            raise mla_moe_mod.unsupported("LLaVA-NeXT's anyres engine")
        super().__post_init__()
        self._n_max = next_mod.max_image_tokens(self.cfg)

    @property
    def n_visual(self) -> int:
        return self._n_max

    def _sizes(self, original_size, n_images) -> list:
        """The rows' (h, w): ``original_size`` is one pair for B = 1, else a
        list of B pairs."""
        if n_images == 1 and not isinstance(original_size, list):
            return [tuple(original_size)]
        if len(original_size) != n_images:
            raise ValueError(f"{n_images} rows need as many sizes; got {len(original_size)}")
        return list(original_size)

    def _prompt_lengths(self, input_ids, tile_pixels, original_size) -> tuple[int, int]:
        """(the longest real merged prompt, the padded one): a row's real
        length counts only the visual tokens its anyres geometry keeps, as the
        JAX engine's ``cur_len`` does; the padded span is ``max_image_tokens``.
        Host arithmetic on the sizes: no tile is read."""
        B, S_text = np.shape(input_ids)
        n_real = max(next_mod.image_geometry(s, self.cfg)["n_tokens"]
                     for s in self._sizes(original_size, B))
        return S_text - 1 + n_real, S_text - 1 + self._n_max

    def _prep_images(self, tile_pixels, original_size, n_images):
        """Host-side anyres prep: the images' tile stacks padded to the
        largest tile count [B, T_pad, 3, s, s], and their gather plans and
        validity masks [B, N_max], on the engine's device."""
        original_size = self._sizes(original_size, n_images)
        if not isinstance(tile_pixels, (list, tuple)):
            tile_pixels = [tile_pixels] if n_images == 1 else list(tile_pixels)
        if len(tile_pixels) != n_images:
            raise ValueError(f"{n_images} rows need as many tile stacks; got {len(tile_pixels)}")
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

    def _merge_next(self, input_ids, tile_pixels, original_size, text_lens=None, image_index=None):
        """(ids [B, S_text] long, merged [B, S, D] padded past each row's
        real length, key_mask [B, S], real_len [B], image_pos [B], valid
        [B, N_max]).  With ``image_index`` [B], ``tile_pixels`` and
        ``original_size`` hold only the batch's unique images: the tower and
        the packing run once an image, and rows gather the packed features
        and the validity masks."""
        cfg = self.cfg
        ids = np.asarray(input_ids)
        n_images = ids.shape[0] if image_index is None else len(tile_pixels)
        tiles, gathers, valid = self._prep_images(tile_pixels, original_size, n_images)
        image_pos = self._image_positions(ids)
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        packed = next_mod.pack_image_features_batched(cfg, self.params, tiles, gathers)
        if image_index is not None:
            rows = torch.as_tensor(image_index, dtype=torch.long, device=self.device)
            packed, valid = packed[rows], valid[rows]
        text_embeds = llama_mod.embed(self.params.lm, torch.where(ids == cfg.image_token_index, 0, ids))
        merged, key_mask, real_len = next_mod.merge_with_text_batched(
            text_embeds, packed, valid, image_pos, text_lens
        )
        return ids, merged, key_mask, real_len, image_pos, valid

    @torch.no_grad()
    def prefill(self, input_ids, tile_pixels, original_size, text_lens=None) -> PrefillState:
        """Args:
          input_ids: [B, S_text], one <image> token per row (right-padded
            rows give their real lengths in ``text_lens``).
          tile_pixels: [n_tiles, 3, s, s] for B = 1, or a list of B such
            stacks (tile counts may differ).
          original_size: (h, w) for B = 1, or a list of B pairs.
        """
        with trace.span("prefill"):
            with trace.span("prefill.towers"):
                ids, merged, key_mask, real_len, image_pos, valid = self._merge_next(
                    input_ids, tile_pixels, original_size, text_lens
                )
            B, S, _ = merged.shape
            with trace.span("prefill.lm"):
                hidden, kv = llama_mod.prefill(
                    self.params.lm, self.cfg.text, merged, self._positions(B, S), key_mask=key_mask,
                    w8a8=self.w8a8_prefill,
                )
            return self._assemble_state(ids, hidden, kv, image_pos, real_len, text_lens, valid)

    @torch.no_grad()
    def prefill_chunked(self, input_ids, tile_pixels, original_size, chunk: int = 256,
                        pump=None) -> PrefillState:
        """``prefill`` of one request (B = 1) with its LM run in ``chunk``-token
        pieces, ``pump()`` called between two (JAX ``engine/llavanext_engine.
        py:363-382``); the state is ``prefill``'s up to summation order."""
        self._check_one(input_ids)
        ids, merged, _, real_len, image_pos, valid = self._merge_next(
            input_ids, tile_pixels, original_size
        )
        hidden, kv = self._lm_chunked(merged, real_len, chunk, pump)
        return self._assemble_state(ids, hidden, kv, image_pos, real_len, None, valid)

    def generate(self, input_ids, tile_pixels, original_size) -> GenerationResult:
        return self._generate(input_ids, tile_pixels, original_size)

    @torch.no_grad()
    def probe(self, input_ids, tile_pixels, original_size, text_lens=None, image_index=None) -> ProbeResult:
        """First tokens and their logits, as ``LlavaEngine.probe``; with
        ``image_index`` [B], ``tile_pixels`` / ``original_size`` are lists
        of the batch's unique images."""
        with trace.span("probe"):
            with trace.span("probe.towers"):
                _, merged, key_mask, real_len, _, _ = self._merge_next(
                    input_ids, tile_pixels, original_size, text_lens, image_index
                )
            B, S, _ = merged.shape
            with trace.span("probe.lm"):
                hidden = llama_mod.prefill_hidden(
                    self.params.lm, self.cfg.text, merged, self._positions(B, S), key_mask,
                    w8a8=self.w8a8_prefill,
                )
            return self._head(hidden, real_len)

    @torch.no_grad()
    def probe_prefix(self, prefix_ids, tile_pixels, original_size):
        """The prefix handle ``(kv [L, 1, S, KH, Dh], real_len [1],
        key_mask [1, S])`` of one image's shared prompt prefix for
        ``probe_extend``; ``kv`` in int8 reader leaves under
        ``int8_prefix_cache``."""
        with trace.span("probe_prefix"):
            with trace.span("probe.towers"):
                _, merged, key_mask, real_len, _, _ = self._merge_next(
                    prefix_ids, tile_pixels, original_size
                )
            B, S, _ = merged.shape
            with trace.span("probe.lm"):
                _, kv = llama_mod.prefill(
                    self.params.lm, self.cfg.text, merged, self._positions(B, S), key_mask=key_mask,
                    w8a8=self.w8a8_prefill,
                )
            return self._prefix_handle(kv), real_len, key_mask

    @torch.no_grad()
    def probe_extend(self, prefix, tail_ids, text_lens=None) -> ProbeResult:
        """First tokens of question tails over a ``probe_prefix`` handle:
        their positions start at the prefix's real length, its pad slots
        masked."""
        kv, real_len, key_mask = prefix
        return self._extend(kv, real_len, key_mask, tail_ids, text_lens)
