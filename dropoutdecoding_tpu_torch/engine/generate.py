"""The inference engine: prefill, then the exact-mode ensemble (or greedy)
decode loop.  Port of ``LlavaEngine`` in
``dropoutdecoding_tpu/engine/generate.py``; ``engine/llavanext_engine.py``
reuses its decode loop and its state assembly.

Per generated token, exact mode runs:

  1. the unmasked forward of the current token against the cache (M=1);
  2. the overlap keep-set from that forward's argmax, and the K members'
     drop masks from the prefill-time epistemic uncertainty;
  3. one M=K forward in which every member reads the shared cache
     (K1 over a dense cache, K3 over an int8 one,
     ``ops/cuda_decode_attention.py``);
  4. the vote, and an append of only the winner's K/V to the cache (K4,
     ``ops/cuda_cache_append.py``, quantizes it into an int8 cache).

``int8_kv=True`` with int8 weights (``utils/quantize.py``) is the JAX
package's deployment tier (``--quantize int8 --int8-kv``); with packed int4
weights (``quantize_llama_params_int4``, every projection through K6,
``ops/cuda_int4_matmul.py``) its int4 tier (``--quantize int4``).  The tier
is a property of the params: the engine has no field for it.

The loop makes no host sync per token: it reads ``done`` back only every
``DONE_CHECK_EVERY`` steps.  CUDA graphs are later work.

Not ported yet (each raises ``NotImplementedError``): fused mode
(``EnsembleConfig.fused_step``), sampling (``GenerationConfig.do_sample``),
the text-mask policies, the mask policies other than "epis",
"epis_no_overlap", "random_image" and "none" (among them ``epis_kl``).
The JAX engine's w8a8 and int8-prefix-cache options have no counterpart yet
(ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..decoding.aggregate import select_by_average, select_by_vote
from ..decoding.masks import build_member_drop_mask, check_policy, overlap_keep_mask
from ..models import llama as llama_mod
from ..models import llava as llava_mod
from ..models.llama import KVCache
from ..ops.uncertainty import vision_uncertainty_auto
from ..utils.config import EnsembleConfig, GenerationConfig, LlavaConfig
from ..utils.prng import PhiloxUniform, UniformSource

DONE_CHECK_EVERY = 8  # decode steps between host reads of ``done``


class PrefillState(NamedTuple):
    cache: KVCache
    cur_len: torch.Tensor  # [B] cache fill (= merged prompt length)
    last_logits: torch.Tensor  # [B, V] logits at the prompt's last position
    first_token: torch.Tensor  # [B] greedy token from those logits
    epis: torch.Tensor  # [B, N] epistemic uncertainty per visual token
    topk_ids: torch.Tensor  # [B, N, k] text-projection table
    image_pos: torch.Tensor  # [B] start of the visual span
    visual_mask: torch.Tensor  # [B, N] real visual tokens (all True on LLaVA-1.5)
    uncertainty: dict  # the full uncertainty dict


class GenerationResult(NamedTuple):
    tokens: np.ndarray  # [B, T] generated tokens (pad after eos)
    num_tokens: np.ndarray  # [B]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1)")


@dataclass
class LlavaEngine:
    """LLaVA-1.5 dropout-decoding engine: ``generate(input_ids, pixel_values)``.

    The params' device and dtype are the engine's.  ``uniform`` is the
    mask-draw source ``uniform(step, row, member, n)``; by default torch
    Philox along the seed -> step -> row -> member key tree
    (``utils/prng.py``).  A row's index in the batch is its RNG stream id.
    """

    cfg: LlavaConfig
    params: llava_mod.LlavaParams
    ens: EnsembleConfig = EnsembleConfig()
    gen: GenerationConfig = GenerationConfig()
    max_len: int = 1280
    seed: int = 24
    ensemble: bool = True  # False => plain greedy
    text_logits_mask: bool = False
    text_mask_policy: str = "none"
    int8_kv: bool = False  # int8 KV cache (K3 reads it, K4 appends to it)
    uniform: UniformSource | None = None
    # called as on_prefill(img_logits [B, N, V], state) at the end of every
    # prefill: a check's view of the logits the state was made from
    on_prefill: Callable | None = None

    def __post_init__(self):
        if self.ensemble and self.ens.fused_step:
            raise _not_ported("fused mode (EnsembleConfig.fused_step)")
        if self.gen.do_sample:
            raise _not_ported("sampling (GenerationConfig.do_sample)")
        if self.text_logits_mask or self.text_mask_policy != "none":
            raise _not_ported("text-mask policies")
        if self.ensemble:
            check_policy(self.ens.mask_policy)  # at construction, not the first step
        embed = self.params.lm["embed_tokens"]
        self.device, self.dtype = embed.device, embed.dtype
        if self.uniform is None:
            self.uniform = PhiloxUniform(self.seed, self.device)

    @property
    def n_visual(self) -> int:
        return self.cfg.vision.num_patches

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, input_ids, pixel_values) -> PrefillState:
        cfg, lm = self.cfg, self.params.lm
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=self.device)
        pix = torch.as_tensor(pixel_values, device=self.device)
        B = ids.shape[0]
        image_pos = llava_mod.find_image_pos(ids, cfg.image_token_index).long()
        feats = llava_mod.image_features(cfg, self.params, pix)
        text_embeds = llama_mod.embed(
            lm, torch.where(ids == cfg.image_token_index, 0, ids)
        )
        merged = llava_mod.merge_image_features(text_embeds, feats, image_pos)
        S = merged.shape[1]
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        hidden, kv = llama_mod.prefill(lm, cfg.text, merged, positions)
        cur_len = torch.full((B,), S, dtype=torch.long, device=self.device)
        return self._assemble_state(hidden, kv, image_pos, cur_len)

    def _assemble_state(
        self, hidden, kv, image_pos, cur_len, visual_mask=None
    ) -> PrefillState:
        """PrefillState from the LM prefill's outputs; LLaVA-NeXT shares it.

        Args:
          hidden: [B, S, D] final-norm hidden states; kv: the prefill K/V.
          image_pos: [B] start of each row's visual span of ``n_visual``
            slots.
          cur_len: [B] each row's real merged length: the first token comes
            from the hidden row at ``cur_len - 1``, and decoding appends
            there.
          visual_mask: optional [B, N] real visual tokens of a padded span
            (the uncertainty's mean and the mask policies use only them);
            None means all N are real.
        """
        lm = self.params.lm
        B, S, E = hidden.shape
        N = self.n_visual
        rows = torch.arange(B, device=self.device)
        last_logits = llama_mod.lm_head(lm, hidden[rows, cur_len - 1])  # [B, V]
        first_token = last_logits.argmax(dim=-1)
        # visual-span logits -> uncertainty + top-k projection table
        start = image_pos.clamp(0, S - N)
        idx = start[:, None] + torch.arange(N, device=self.device)[None]
        hidden_img = hidden.gather(1, idx[..., None].expand(B, N, E))
        img_logits = llama_mod.lm_head(lm, hidden_img)  # [B, N, V] fp32
        # one call: K2 finds the top-k ids while it takes its first statistics
        uncert = vision_uncertainty_auto(img_logits, visual_mask, top_k=self.ens.topk)
        topk_ids = uncert.pop("topk_ids")

        cache = llama_mod.empty_cache(
            self.cfg.text, B, self.max_len, self.dtype, self.device, quantized=self.int8_kv
        )
        llama_mod.cache_seed(cache, kv)
        if visual_mask is None:
            visual_mask = torch.ones((B, N), dtype=torch.bool, device=self.device)
        state = PrefillState(
            cache=cache,
            cur_len=cur_len,
            last_logits=last_logits,
            first_token=first_token,
            epis=uncert["epis_uncert_per_token"],
            topk_ids=topk_ids,
            image_pos=image_pos,
            visual_mask=visual_mask,
            uncertainty=uncert,
        )
        if self.on_prefill is not None:
            self.on_prefill(img_logits, state)
        return state

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _member_drop_slots(self, state: PrefillState, argmax0: torch.Tensor, step: int):
        """The K members' cache-slot drop masks [B, K, Smax] at ``step``;
        only real visual tokens (``state.visual_mask``) are ever dropped."""
        ens = self.ens
        B, N = state.epis.shape
        valid = state.visual_mask
        overlap = overlap_keep_mask(argmax0, state.topk_ids)  # [B, N]
        drops = []
        prev = torch.zeros((B, N), dtype=torch.bool, device=self.device)
        for m, cap in enumerate(ens.voting_probs):
            u = torch.stack([self.uniform(step, row, m, N) for row in range(B)])
            prev = build_member_drop_mask(
                u.to(self.device), ens.mask_policy, state.epis, cap, overlap, prev,
                ens.mask_accumulate, floor=ens.prob_floor, valid=valid,
            )
            drops.append(prev)
        drops = torch.stack(drops, dim=1) & valid[:, None, :]  # [B, K, N]
        # slot s holds visual token s - image_pos inside the real span
        slots = torch.arange(self.max_len, device=self.device)[None, :]
        p = state.image_pos[:, None]
        n_img = valid.sum(dim=-1)[:, None]
        in_span = (slots >= p) & (slots < p + n_img)
        tok_idx = (slots - p).clamp(0, N - 1)
        K = drops.shape[1]
        drop_slots = drops.gather(2, tok_idx[:, None, :].expand(B, K, self.max_len))
        return drop_slots & in_span[:, None, :]

    def _one_step(self, state, step, token, cur_len, done, tokens):
        """One decode step at generation index ``step``; writes
        ``tokens[:, step]`` and appends to the cache in place.  Returns
        (next_token, cur_len, done)."""
        cfg, lm = self.cfg, self.params.lm
        cache = state.cache
        B = token.shape[0]
        x = llama_mod.embed(lm, token)  # [B, D]
        slots = torch.arange(self.max_len, device=self.device)
        base_mask = slots[None, :] < cur_len[:, None]  # [B, Smax]

        h0, k0, v0 = llama_mod.decode_step(
            lm, cfg.text, x[:, None], cur_len, cache, base_mask[:, None]
        )
        logits0 = llama_mod.lm_head(lm, h0)[:, 0]  # [B, V]
        argmax0 = logits0.argmax(dim=-1)
        if not self.ensemble:
            next_token = argmax0
            kw, vw = k0[:, :, 0], v0[:, :, 0]
        else:
            drop_slots = self._member_drop_slots(state, argmax0, step)
            member_mask = base_mask[:, None, :] & ~drop_slots  # [B, K, Smax]
            K = member_mask.shape[1]
            xk = x[:, None].expand(B, K, x.shape[-1])
            hk, kk, vk = llama_mod.decode_step(
                lm, cfg.text, xk, cur_len, cache, member_mask
            )
            logits_k = llama_mod.lm_head(lm, hk)  # [B, K, V]
            agg = select_by_average if self.ens.use_avg else select_by_vote
            winner, next_token = agg(logits_k)
            rows = torch.arange(B, device=self.device)
            kw, vw = kk[:, rows, winner], vk[:, rows, winner]  # [L, B, KH, D]

        llama_mod.cache_set_rows(cache, cur_len, kw, vw)
        next_token = torch.where(done, self.gen.pad_token_id, next_token)
        tokens[:, step] = next_token  # pad for rows already done
        return (
            next_token,
            cur_len + (~done).long(),
            done | (next_token == self.gen.eos_token_id),
        )

    @torch.no_grad()
    def decode(self, state: PrefillState) -> torch.Tensor:
        """The decode loop from a prefill state; returns tokens [B, T].
        Updates ``state.cache`` in place."""
        B = state.first_token.shape[0]
        T = self.gen.max_new_tokens
        token = state.first_token
        tokens = torch.full(
            (B, T), self.gen.pad_token_id, dtype=torch.long, device=self.device
        )
        tokens[:, 0] = token
        done = token == self.gen.eos_token_id
        cur_len = state.cur_len.clone()
        for step in range(1, T):  # decode steps start at 1, like the JAX loop
            if step % DONE_CHECK_EVERY == 0 and bool(done.all()):
                break  # the only host sync in the loop
            token, cur_len, done = self._one_step(
                state, step, token, cur_len, done, tokens
            )
        return tokens

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def generate(self, input_ids, pixel_values) -> GenerationResult:
        return self._generate(input_ids, pixel_values)

    def _generate(self, input_ids, *images) -> GenerationResult:
        """``prefill(input_ids, *images)``, then the decode loop."""
        # KV-capacity guard: each of the T-1 decode steps appends one row
        # at cur_len.  The merged prompt length follows from the shapes, so
        # the check needs no device sync and runs before any work.
        longest = np.shape(input_ids)[1] + self.n_visual - 1
        if longest + self.gen.max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"prompt ({longest} tokens) + max_new_tokens "
                f"({self.gen.max_new_tokens}) - 1 exceeds the KV capacity "
                f"max_len={self.max_len}; raise max_len or lower the budget"
            )
        state = self.prefill(input_ids, *images)
        tokens = self.decode(state).cpu().numpy().astype(np.int32)
        eos = self.gen.eos_token_id
        num = np.array(
            [
                (np.where(row == eos)[0][0] + 1) if (row == eos).any() else len(row)
                for row in tokens
            ]
        )
        return GenerationResult(tokens=tokens, num_tokens=num)
