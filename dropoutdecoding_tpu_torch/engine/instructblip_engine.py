"""InstructBLIP Dropout Decoding engine (port of
``dropoutdecoding_tpu/engine/instructblip_engine.py``).

It reuses ``LlavaEngine``'s decode loop and state assembly, and with them
every decoding arm and the baselines over a prefilled state; the prefill
differs: the 32 visual tokens are the Q-Former's projected query outputs
(``models/instructblip.visual_tokens``), which read the instruction too,
and they come before the text embeddings, so the visual span is slots [0,
32) and a right-padded row's real merged length is its text length + 32
(LLaVA's ``<image>`` placeholder gives way to its span, hence its + N - 1).
The KV-capacity guard counts the same length.

The reference's InstructBLIP defaults are the caller's:
``EnsembleConfig(mask_policy="epis_quantile", mask_accumulate=False,
topk=10)`` and seed 5217.

Not valid for this family: the prefix cache (``probe_prefix`` /
``probe_extend``), since no two questions share an LM prefix, and chunked
prefill, since the merged prompt is ~40 tokens.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import instructblip as ib_mod
from ..models import llama as llama_mod
from .generate import GenerationResult, LlavaEngine, PrefillState, ProbeResult

# the JAX POPE CLI's exit for --prefix-cache with InstructBLIP, word for word
NO_SHARED_PREFIX = (
    "--prefix-cache cannot apply to InstructBLIP: its Q-Former "
    "reads the question text (reference instructblip.py:617-631 "
    "passes qformer_input_ids), so the 32 visual tokens — the "
    "START of the merged sequence — differ per question and no "
    "shared LM prefix exists.  Use --batch-size instead: the "
    "batched probe already runs the EVA-ViT-g tower once per "
    "unique image (the expensive shared stage)."
)


@dataclass
class InstructBlipEngine(LlavaEngine):
    """``generate(input_ids, pixel_values, qformer_input_ids)``; ``cfg`` is
    an ``InstructBlipConfig`` and ``params`` ``InstructBlipParams``."""

    @property
    def n_visual(self) -> int:
        return self.cfg.num_query_tokens

    def _fill(self, B: int, S: int, text_lens):
        """(cur_len [B], text_lens or None): a right-padded row's real merged
        length is its text length + N (JAX ``instructblip_engine.py:79``)."""
        if text_lens is None:
            return torch.full((B,), S, dtype=torch.long, device=self.device), None
        text_lens = torch.as_tensor(text_lens, dtype=torch.long, device=self.device)
        return text_lens + self.n_visual, text_lens

    def _merge(self, input_ids, pixel_values, qformer_input_ids, qformer_attention_mask=None,
               image_index=None):
        """(ids [B, S_text] long, merged [B, N + S_text, D]): the projected
        query outputs, then the text embeddings.  With ``image_index`` [B],
        ``pixel_values`` holds only the batch's unique images."""
        dev = self.device
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=dev)
        visual = ib_mod.visual_tokens(
            self.cfg, self.params,
            torch.as_tensor(pixel_values, device=dev),
            torch.as_tensor(qformer_input_ids, dtype=torch.long, device=dev),
            None if qformer_attention_mask is None
            else torch.as_tensor(qformer_attention_mask, device=dev),
            None if image_index is None else torch.as_tensor(image_index, dtype=torch.long,
                                                             device=dev),
        )
        text = llama_mod.embed(self.params.lm, ids)
        return ids, torch.cat([visual.to(text.dtype), text], dim=1)

    @torch.no_grad()
    def prefill(self, input_ids, pixel_values, qformer_input_ids, text_lens=None,
                qformer_attention_mask=None) -> PrefillState:
        """Args:
          input_ids: [B, S_text] LM ids of the instruction (right-padded rows
            give their real lengths in ``text_lens``).
          pixel_values: [B, 3, 224, 224].
          qformer_input_ids: [B, T] the instruction in the Q-Former's
            vocabulary, ``qformer_attention_mask`` [B, T] its pads.
        """
        ids, merged = self._merge(input_ids, pixel_values, qformer_input_ids,
                                  qformer_attention_mask)
        B, S, _ = merged.shape
        hidden, kv = llama_mod.prefill(
            self.params.lm, self.cfg.text, merged, self._positions(B, S), w8a8=self.w8a8_prefill
        )
        cur_len, text_lens = self._fill(B, S, text_lens)
        image_pos = torch.zeros((B,), dtype=torch.long, device=self.device)
        return self._assemble_state(ids, hidden, kv, image_pos, cur_len, text_lens)

    @torch.no_grad()
    def probe(self, input_ids, pixel_values, qformer_input_ids, text_lens=None,
              qformer_attention_mask=None, image_index=None) -> ProbeResult:
        """The first token and its logits of each prompt (POPE): ``prefill``
        without the visual-span logits, the uncertainty and the cache.
        ``pixel_values`` may hold only the batch's unique images, with
        ``image_index`` [B] mapping rows to them: the vision tower runs once
        an image, the Q-Former a row."""
        _, merged = self._merge(input_ids, pixel_values, qformer_input_ids,
                                qformer_attention_mask, image_index)
        B, S, _ = merged.shape
        hidden = llama_mod.prefill_hidden(self.params.lm, self.cfg.text, merged,
                                          self._positions(B, S), w8a8=self.w8a8_prefill)
        return self._head(hidden, self._fill(B, S, text_lens)[0])

    def generate(self, input_ids, pixel_values, qformer_input_ids=None) -> GenerationResult:
        if qformer_input_ids is None:
            # the Q-Former reads BERT ids (30523); LM ids are another vocabulary
            raise ValueError(
                "qformer_input_ids is required (BERT-tokenized instruction from the "
                "InstructBLIP processor); LM input_ids are from a different vocabulary"
            )
        return self._generate(input_ids, pixel_values, qformer_input_ids)

    def _prompt_lengths(self, input_ids, *images) -> tuple[int, int]:
        """(the longest real merged prompt, the padded one): S_text + N for
        both, as the JAX engine's ``cur_len`` counts a row."""
        S = np.shape(input_ids)[1] + self.n_visual
        return S, S

    def probe_prefix(self, *args, **kwargs):
        raise ValueError(NO_SHARED_PREFIX)

    def probe_extend(self, *args, **kwargs):
        raise ValueError(NO_SHARED_PREFIX)

    def prefill_chunked(self, *args, **kwargs):
        raise NotImplementedError(  # the JAX engine's message, word for word
            "chunked prefill targets long prompts; InstructBLIP merged "
            "prompts are ~64 tokens (32 Q-Former queries + instruction) — "
            "a single prefill dispatch is already shorter than one chunk"
        )
