"""The inference engine: prefill, then the ensemble (exact or fused) or
greedy decode loop.  Port of ``LlavaEngine`` in
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

Fused mode (``EnsembleConfig.fused_step``) runs one M=K+1 forward a token
instead of steps 1 and 3: member 0 unmasked, members 1..K masked from the
previous step's argmax, so the weights stream once a token instead of
twice; the K/V of member ``winner + 1`` goes to the cache.

Along the way, each as the JAX engine does it:

- sampling (``GenerationConfig.do_sample``): HF's warpers, then a draw from
  the vote winner's logits (the member average under ``use_avg``), every
  token sampled, the first from the prefill's logits; masks and overlap
  stay on the argmax (``ops/sampling.py``);
- the text-mask policies (``text_mask_policy`` "logits" or "entropy";
  ``text_logits_mask=True`` means "logits"): generated positions dropped
  by the statistics of the step that emitted them, the last 3 always
  attended;
- "epis_kl" keeps the prefill's visual-token logits in the state
  (``PrefillState.image_logits``); fused mode reads the previous step's
  unmasked logits against them (the lagged variant).

Draws come from three sources, one a stream, each keyed by a row's
``rng_id`` (``utils/prng.py``).  ``int8_kv=True`` with int8 weights
(``utils/quantize.py``) is the JAX package's deployment tier (``--quantize
int8 --int8-kv``); with packed int4 weights (``quantize_llama_params_int4``,
every projection through K6, ``ops/cuda_int4_matmul.py``) its int4 tier
(``--quantize int4``).  The tier is a property of the params: the engine
has no field for it.

The loop makes no host sync per token: it reads ``done`` back only every
``DONE_CHECK_EVERY`` steps.  On the card with no TP mesh each decode forward
(``decode_step`` and ``lm_head``) replays a CUDA graph
(``engine/decode_graphs.py``); the masks, their draws, the vote, the append
and the token write stay eager.  Each row keeps
its own generation index (``steps``, as the JAX engine's): a finished row
stops there, and the serving layer (``engine/serving.py``) steps rows that
joined at different times in one batch.  ``w8a8_prefill`` /
``w8a8_decode`` run the projections on int8 weights with int8 activations
(``models/llama._mm_w8a8``).  ``prefill_chunked`` runs one request's LM
prefill in pieces with a callback between two, so that a server can step
its other rows meanwhile.

Inside a ``recording()`` block (``engine/trace.py``) the prefill, the
probes and each decode step record spans at their phases' boundaries
(``prefill.towers``, ``prefill.lm``, ``prefill.uncertainty``,
``prefill.cache``; ``decode.step`` and in it ``decode.forward0``,
``decode.masks``, ``decode.members``, ``decode.vote``, ``decode.append``,
or fused mode's ``decode.forward``, and ``decode.sample``), and count
``decode.steps``, ``decode.draws`` (one a call to a draw source),
``decode.graph_replays`` and ``decode.graph_captures``;
outside one they cost a no-op context each.

The decoder's module follows the text config (``decoder_module``):
``models/llama.py`` for the Llama / Mistral configs, ``models/mla_moe.py``
for a DeepSeek-V3-style ``MlaMoeConfig`` (latent cache, routed experts; its
decode forwards count ``moe.assignments``, rows x members x top-k).  The
masks, the vote and the append do not read the cache's layout.  With the
MLA + MoE decoder the int8 KV cache, w8a8, a TP mesh, the chunked prefill
and the prefix cache raise ``ValueError``.

A one-token workload (POPE) reads only the first token, which no mask can
change, so it skips everything after the prompt's last logits:

- ``probe``: the prefill with no visual-span logits, no K2, no cache and no
  K/V kept (``llama.prefill_hidden``); with ``image_index`` the vision
  tower runs once per unique image and rows gather their features;
- ``probe_prefix`` / ``probe_extend``: the prefix cache.  A prompt prefix
  shared by several questions (the image and the template) is prefilled
  once and its K/V handed back, int8 in the cache's reader layout under
  ``int8_prefix_cache``; each batch of question tails then runs
  ``llama.prefill_extend`` over it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..decoding.aggregate import select_by_average, select_by_vote
from ..decoding.masks import (
    build_member_drop_mask,
    check_policy,
    overlap_keep_mask,
    overlap_keep_mask_multi,
)
from ..models import llama as llama_mod
from ..models import llava as llava_mod
from ..models import mla_moe as mla_moe_mod
from ..models.llama import KVCache
from ..ops.sampling import sample_token
from ..ops.uncertainty import (
    entropy_varentropy,
    lowest_percent_kl_indices_mask,
    vision_uncertainty_auto,
)
from ..parallel.mesh import mesh_of
from ..utils.config import EnsembleConfig, GenerationConfig, LlavaConfig, is_mla_moe
from ..utils.prng import (
    PhiloxGumbel,
    PhiloxTextUniform,
    PhiloxUniform,
    RowSource,
    StepSource,
    UniformSource,
)
from . import decode_graphs, trace

DONE_CHECK_EVERY = 8  # decode steps between host reads of ``done``
TEXT_POLICIES = ("none", "logits", "entropy")


def decoder_module(text_cfg):
    """The module of the decoder a text config describes: ``models/mla_moe.py``
    for a DeepSeek-V3-style ``model_type``, ``models/llama.py`` else."""
    return mla_moe_mod if is_mla_moe(text_cfg) else llama_mod


def require_dense(engine, what: str) -> None:
    """Raises where ``engine`` runs the MLA + MoE decoder: ``what`` (a path
    that reads the Llama cache or leaves) is not supported with it."""
    if getattr(engine, "_moe", False):
        raise mla_moe_mod.unsupported(what)


def extract_probe_ids(
    input_ids: torch.Tensor,
    marker: int = 727,
    max_probes: int = 8,
    text_lens: torch.Tensor | None = None,
) -> torch.Tensor:
    """The token ids after the first ``marker`` ('?') token of each row,
    [B, max_probes] int32, -1 padded (the "vqa" policy's probe words).
    ``text_lens``: each right-padded row's real length, so that its pad
    ids are never taken."""
    B, S = input_ids.shape
    hit = input_ids == marker
    pos = hit.int().argmax(dim=1)  # the first hit
    gather = pos[:, None] + 1 + torch.arange(max_probes, device=input_ids.device)[None]
    limit = S if text_lens is None else torch.as_tensor(text_lens, device=input_ids.device)[:, None]
    valid = hit.any(dim=1)[:, None] & (gather < limit)
    ids = input_ids.gather(1, gather.clamp(0, S - 1))
    return torch.where(valid, ids, -1).int()


class TextMaskState(NamedTuple):
    """Per-generated-position statistics for the text-mask policies, [B, T]
    each, of the step that emitted the position."""

    prob: torch.Tensor  # 1 / max logit
    ent: torch.Tensor  # entropy (base 2)
    vent: torch.Tensor  # varentropy


class PrefillState(NamedTuple):
    cache: KVCache
    cur_len: torch.Tensor  # [B] cache fill (= merged prompt length)
    last_logits: torch.Tensor  # [B, V] logits at the prompt's last position
    first_token: torch.Tensor  # [B] greedy token from those logits
    epis: torch.Tensor  # [B, N] epistemic uncertainty per visual token
    topk_ids: torch.Tensor  # [B, N, k] text-projection table
    image_logits: torch.Tensor  # [B, N, V] fp32 visual-token logits under
    #   "epis_kl" (its keep set reads them every step), a [B, N, 1] stub else
    image_pos: torch.Tensor  # [B] start of the visual span
    visual_mask: torch.Tensor  # [B, N] real visual tokens (all True on LLaVA-1.5)
    probe_ids: torch.Tensor  # [B, P] "vqa" probe token ids, -1 padded
    rng_id: torch.Tensor  # [B] each row's stream id, on the host: the draw
    #   sources are called from Python, so reading it costs no device sync
    uncertainty: dict  # the full uncertainty dict


class GenerationResult(NamedTuple):
    tokens: np.ndarray  # [B, T] generated tokens (pad after eos)
    num_tokens: np.ndarray  # [B]


def first_index(rows: np.ndarray, value: int, plus: int = 0) -> np.ndarray:
    """Each row's first position of ``value`` + ``plus``, or its length: a
    generation's token count (``plus=1`` counts the eos itself)."""
    return np.array([np.flatnonzero(r == value)[0] + plus if (r == value).any() else len(r)
                     for r in rows])


class ProbeResult(NamedTuple):
    """What a one-token workload reads of a prefill."""

    first_token: torch.Tensor  # [B] greedy token at each row's last real position
    last_logits: torch.Tensor  # [B, V] fp32 logits there


def kl_logits_or_stub(img_logits: torch.Tensor, mask_policy: str) -> torch.Tensor:
    """The visual-token logits for "epis_kl", the only policy that reads
    them after the prefill; a [B, N, 1] zero stub for every other, so that
    the [B, N, V] fp32 buffer does not stay alive in the state."""
    if mask_policy == "epis_kl":
        return img_logits
    return img_logits.new_zeros(img_logits.shape[:-1] + (1,))


def _record_text_stats(tm: TextMaskState, step, winner_logits: torch.Tensor) -> TextMaskState:
    """Write 1 / max logit, the entropy and the varentropy of the emitting
    step's logits [B, V] at generation index ``step`` (an int for every row,
    or each row's own, [B] long; past the end at the last position), in
    place; returns ``tm``."""
    T = tm.prob.shape[1]
    if isinstance(step, int):
        at = (slice(None), min(max(step, 0), T - 1))
    else:
        at = (torch.arange(step.shape[0], device=step.device), step.clamp(0, T - 1))
    ent, vent = entropy_varentropy(winner_logits)
    tm.prob[at] = 1.0 / winner_logits.float().amax(dim=-1)
    tm.ent[at] = ent
    tm.vent[at] = vent
    return tm


class _Carry(NamedTuple):
    """What a decode step hands the next besides token, fill and done."""

    tm: TextMaskState | None  # None unless a text policy is on
    prev_argmax0: torch.Tensor  # [B] member 0's argmax (fused mode's overlap source)
    prev_logits0: torch.Tensor | None  # [B, V] member 0's logits (lagged epis_kl only)
    winner: torch.Tensor | None = None  # [B] the step's winning member (ensemble only)


@dataclass
class LlavaEngine:
    """LLaVA-1.5 dropout-decoding engine: ``generate(input_ids, pixel_values)``.

    The params' device and dtype are the engine's.  The draw sources, by
    default torch Philox along each stream's key tree (``utils/prng.py``):
    ``uniform(step, row, member, n)`` the members' mask draws,
    ``text_uniform(step, row, n)`` the text-mask draws and ``gumbel(step,
    row, n)`` the sampling noise; ``row`` is the row's ``rng_id``.
    """

    cfg: LlavaConfig
    params: llava_mod.LlavaParams
    ens: EnsembleConfig = EnsembleConfig()
    gen: GenerationConfig = GenerationConfig()
    max_len: int = 1280
    seed: int = 24
    ensemble: bool = True  # False => plain greedy (or sampled, under do_sample)
    text_logits_mask: bool = False  # the "+ logit text-mask" variant: policy "logits"
    text_mask_policy: str = "none"  # "none" | "logits" | "entropy"
    int8_kv: bool = False  # int8 KV cache (K3 reads it, K4 appends to it)
    # int8 activations x int8 weights (s8 x s8 -> s32) in every projection of
    # the prefills (prefill, probe, the prefix cache, chunked) / of the decode
    # steps; dense and int4 weights ignore them
    w8a8_prefill: bool = False
    w8a8_decode: bool = False
    # probe_prefix hands back int8 handles (kv_int8_reader_layout): half the
    # bytes of a cached prefix dense, read by extend_attention_int8prefix
    int8_prefix_cache: bool = False
    uniform: UniformSource | None = None
    text_uniform: RowSource | None = None
    gumbel: RowSource | None = None
    # VCD's draws (engine/baselines.py): cd_noise(pixels) -> the pixels noised
    # at gen.cd_noise_step, cd_gumbel(step, n) one step's noise for every row;
    # None: torch Philox at the seed vcd_generate is given
    cd_noise: Callable | None = None
    cd_gumbel: StepSource | None = None
    # called as on_prefill(img_logits [B, N, V], state) at the end of every
    # prefill: a check's view of the logits the state was made from
    on_prefill: Callable | None = None

    def __post_init__(self):
        if self.ensemble:
            check_policy(self.ens.mask_policy)  # at construction, not the first step
        self.text_policy = "logits" if self.text_logits_mask else self.text_mask_policy
        if self.text_policy not in TEXT_POLICIES:
            raise ValueError(f"unknown text-mask policy: {self.text_policy}")
        # fused epis_kl reads the previous step's unmasked logits (lagged)
        self._lag_kl = self.ensemble and self.ens.fused_step and self.ens.mask_policy == "epis_kl"
        embed = self.params.lm["embed_tokens"]
        self.device, self.dtype = embed.device, embed.dtype
        # TP / DP: params cut by parallel/mesh.shard_* before construction
        # carry their mesh; decode_step gets it, and under DP a row keeps its
        # global rng_id (_assemble_state)
        self.tp_mesh = mesh_of(self.params)
        self.lm_mod = decoder_module(self.cfg.text)
        self._moe = self.lm_mod is mla_moe_mod
        if self._moe:
            self._check_mla_moe()
        self._graphs = decode_graphs.for_engine(self.device, self.tp_mesh)
        if self.uniform is None:
            self.uniform = PhiloxUniform(self.seed, self.device)
        if self.text_uniform is None:
            self.text_uniform = PhiloxTextUniform(self.seed, self.device)
        if self.gumbel is None:
            self.gumbel = PhiloxGumbel(self.seed, self.device)

    def _check_mla_moe(self) -> None:
        """What the MLA + MoE decoder does not run raises at construction."""
        for flag, what in ((self.int8_kv, "an int8 KV cache"),
                           (self.w8a8_prefill or self.w8a8_decode, "w8a8"),
                           (self.int8_prefix_cache, "an int8 prefix cache")):
            if flag:
                raise mla_moe_mod.unsupported(what)
        mla_moe_mod.check_params(self.params.lm)

    @property
    def n_visual(self) -> int:
        return self.cfg.vision.num_patches

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def _merge_inputs(self, input_ids, pixel_values, image_index=None):
        """(ids [B, S_text] long, merged embeddings [B, S, D], image_pos [B])
        of the prompt ids and the images.  ``image_index`` [B]: row -> image
        when ``pixel_values`` holds only the batch's unique images, so the
        vision tower runs once an image."""
        cfg, lm = self.cfg, self.params.lm
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=self.device)
        pix = torch.as_tensor(pixel_values, device=self.device)
        image_pos = llava_mod.find_image_pos(ids, cfg.image_token_index).long()
        feats = llava_mod.image_features(cfg, self.params, pix)
        if image_index is not None:
            feats = feats[torch.as_tensor(image_index, dtype=torch.long, device=self.device)]
        text_embeds = self.lm_mod.embed(lm, torch.where(ids == cfg.image_token_index, 0, ids))
        return ids, llava_mod.merge_image_features(text_embeds, feats, image_pos), image_pos

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device)[None].expand(B, S)

    def _fill(self, B: int, S: int, text_lens):
        """(cur_len [B], text_lens or None) of a merged prompt of S tokens:
        each right-padded row's real merged length is its text length +
        N - 1."""
        if text_lens is None:
            return torch.full((B,), S, dtype=torch.long, device=self.device), None
        text_lens = torch.as_tensor(text_lens, dtype=torch.long, device=self.device)
        return text_lens + self.n_visual - 1, text_lens

    @torch.no_grad()
    def prefill(self, input_ids, pixel_values, text_lens=None) -> PrefillState:
        """``text_lens``: optional [B] real lengths of right-padded rows;
        their pads sit after every real token, so only the first token's
        position and the fill need them."""
        with trace.span("prefill"):
            with trace.span("prefill.towers"):
                ids, merged, image_pos = self._merge_inputs(input_ids, pixel_values)
            B, S, _ = merged.shape
            with trace.span("prefill.lm"):
                hidden, kv = self.lm_mod.prefill(
                    self.params.lm, self.cfg.text, merged, self._positions(B, S),
                    w8a8=self.w8a8_prefill,
                )
            cur_len, text_lens = self._fill(B, S, text_lens)
            return self._assemble_state(ids, hidden, kv, image_pos, cur_len, text_lens)

    # ------------------------------------------------------------------
    # chunked prefill (serving: bound the stall a long prompt causes)
    # ------------------------------------------------------------------
    @staticmethod
    def _check_one(input_ids) -> None:
        if np.shape(input_ids)[0] != 1:
            raise ValueError("prefill_chunked is per-request (B=1)")

    def _lm_chunked(self, merged: torch.Tensor, real_len, chunk: int, pump):
        """The LM prefill of one merged prompt [1, S, D] in ``chunk``-token
        pieces, ``pump()`` called between two (JAX ``engine/generate.py:
        372-461``): each piece is one ``prefill_extend`` over the K/V of the
        pieces before it, the slots at or past ``real_len`` (an int, or a [1]
        tensor: a NeXT prompt's padding) masked out, so its rows are those
        of one causal prefill up to summation order.  Returns (hidden [1, S,
        D], KVCache [L, 1, S, KH, Dh])."""
        lm, cfg = self.params.lm, self.cfg.text
        B, S, _ = merged.shape
        KH = llama_mod.local_heads(cfg, self.tp_mesh)[1]
        shape = (cfg.num_hidden_layers, B, S, KH, cfg.head_dim)
        kbuf, vbuf = merged.new_zeros(shape), merged.new_zeros(shape)
        live = torch.as_tensor(real_len, device=self.device).reshape(-1, 1)
        hidden = []
        for i, off in enumerate(range(0, S, chunk)):
            if pump is not None and i > 0:
                pump()
            n = min(chunk, S - off)
            prefix_mask = torch.arange(off, device=self.device)[None] < live.clamp(max=off)
            h, kv = llama_mod.prefill_extend(
                lm, cfg, merged[:, off:off + n], off + self._positions(B, n),
                KVCache(kbuf[:, :, :off], vbuf[:, :, :off]), w8a8=self.w8a8_prefill,
                prefix_mask=prefix_mask,
            )
            kbuf[:, :, off:off + n] = kv.k
            vbuf[:, :, off:off + n] = kv.v
            hidden.append(h)
        return torch.cat(hidden, dim=1), KVCache(kbuf, vbuf)

    @torch.no_grad()
    def prefill_chunked(self, input_ids, *rest, chunk: int = 256, pump=None) -> PrefillState:
        """``prefill`` of one request (B = 1) with its LM run in ``chunk``-token
        pieces, ``pump()`` called between two (JAX ``engine/generate.py:
        419``): the serving layer's pump steps the active slots, so a long
        prompt stalls them for one piece at a time, not the whole prompt
        (``DecodeServer.submit_chunked``).  The state is ``prefill``'s up to
        summation order."""
        self._check_one(input_ids)
        require_dense(self, "the chunked prefill")
        ids, merged, image_pos = self._merge_inputs(input_ids, *rest)
        B, S, _ = merged.shape
        hidden, kv = self._lm_chunked(merged, S, chunk, pump)
        return self._assemble_state(ids, hidden, kv, image_pos, self._fill(B, S, None)[0])

    def _head(self, hidden: torch.Tensor, cur_len: torch.Tensor) -> ProbeResult:
        """The logits [B, V] at each row's last real position ``cur_len - 1``
        of ``hidden`` [B, S, D], and their argmax."""
        B, S, _ = hidden.shape
        rows = torch.arange(B, device=self.device)
        last_logits = self.lm_mod.lm_head(self.params.lm, hidden[rows, (cur_len - 1).clamp(0, S - 1)])
        return ProbeResult(last_logits.argmax(dim=-1), last_logits)

    def _assemble_state(
        self, input_ids, hidden, kv, image_pos, cur_len, text_lens=None, visual_mask=None
    ) -> PrefillState:
        """PrefillState from the LM prefill's outputs; LLaVA-NeXT shares it.

        Args:
          input_ids: [B, S_text] the prompt ids (the "vqa" probe words).
          hidden: [B, S, D] final-norm hidden states; kv: the prefill K/V.
          image_pos: [B] start of each row's visual span of ``n_visual``
            slots.
          cur_len: [B] each row's real merged length: the first token comes
            from the hidden row at ``cur_len - 1``, and decoding appends
            there.
          text_lens: optional [B] real text lengths of right-padded rows.
          visual_mask: optional [B, N] real visual tokens of a padded span
            (the uncertainty's mean and the mask policies use only them);
            None means all N are real.
        """
        lm = self.params.lm
        B, S, E = hidden.shape
        N = self.n_visual
        first_token, last_logits = self._head(hidden, cur_len)
        # visual-span logits -> uncertainty + top-k projection table
        with trace.span("prefill.uncertainty"):
            start = image_pos.clamp(0, S - N)
            idx = start[:, None] + torch.arange(N, device=self.device)[None]
            hidden_img = hidden.gather(1, idx[..., None].expand(B, N, E))
            img_logits = self.lm_mod.lm_head(lm, hidden_img)  # [B, N, V] fp32
            # one call: K2 finds the top-k ids while it takes its first statistics
            uncert = vision_uncertainty_auto(img_logits, visual_mask, top_k=self.ens.topk)
            topk_ids = uncert.pop("topk_ids")

        with trace.span("prefill.cache"):
            cache = self.lm_mod.empty_cache(
                self.cfg.text, B, self.max_len, self.dtype, self.device, quantized=self.int8_kv,
                tp_mesh=self.tp_mesh,
            )
            self.lm_mod.cache_seed(cache, kv)
        if visual_mask is None:
            visual_mask = torch.ones((B, N), dtype=torch.bool, device=self.device)
        state = PrefillState(
            cache=cache,
            cur_len=cur_len,
            last_logits=last_logits,
            first_token=first_token,
            epis=uncert["epis_uncert_per_token"],
            topk_ids=topk_ids,
            image_logits=kl_logits_or_stub(img_logits, self.ens.mask_policy),
            image_pos=image_pos,
            visual_mask=visual_mask,
            probe_ids=extract_probe_ids(input_ids, text_lens=text_lens),
            rng_id=torch.arange(B) + B * (self.tp_mesh.data_rank if self.tp_mesh else 0),
            uncertainty=uncert,
        )
        if self.on_prefill is not None:
            self.on_prefill(img_logits, state)
        return state

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _rows(self, source, state, step, *rest, n):
        """[B, n] draws of ``source`` (with ``rest``, the member) for every
        row's ``rng_id``, each at ``step``: one int for every row, or a list
        of each row's own; on the engine's device."""
        rows = state.rng_id.tolist()
        steps = step if isinstance(step, list) else [step] * len(rows)
        trace.count("decode.draws", len(rows))
        draws = [source(s, row, *rest, n) for s, row in zip(steps, rows)]
        return torch.stack(draws).to(self.device)

    def _member_drop_slots(
        self, state: PrefillState, argmax_src, step, logits_for_kl=None, cur_len=None,
        tm: TextMaskState | None = None,
    ):
        """The K members' cache-slot drop masks [B, K, Smax] at ``step`` (an
        int, or each row's: ``_rows``), from an argmax source (this step's
        unmasked argmax in exact mode, the previous step's in fused mode);
        ``logits_for_kl`` [B, V] feed "epis_kl", ``cur_len`` and ``tm`` the
        text policy.  Only real visual tokens (``state.visual_mask``) are
        ever dropped as visual tokens."""
        ens = self.ens
        B, N = state.epis.shape
        valid = state.visual_mask
        if ens.mask_policy == "vqa":
            overlap = overlap_keep_mask_multi(state.probe_ids, state.topk_ids)  # [B, N]
        else:
            overlap = overlap_keep_mask(argmax_src, state.topk_ids)
        kl_keep = None
        if ens.mask_policy == "epis_kl":
            kl_keep = lowest_percent_kl_indices_mask(state.image_logits, logits_for_kl)
        drops = []
        prev = torch.zeros((B, N), dtype=torch.bool, device=self.device)
        for m, cap in enumerate(ens.voting_probs):
            u = self._rows(self.uniform, state, step, m, n=N)
            prev = build_member_drop_mask(
                u, ens.mask_policy, state.epis, cap, overlap, prev,
                ens.mask_accumulate, kl_keep=kl_keep, floor=ens.prob_floor, valid=valid,
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
        drop_slots = drop_slots & in_span[:, None, :]
        if self.text_policy == "none":
            return drop_slots
        # generated positions, by the statistics of the step that emitted
        # each; the last 3 are always attended
        gen_start = state.cur_len[:, None]  # the prompt's length
        gidx = (slots - gen_start).clamp(0, tm.prob.shape[1] - 1)
        gprob = tm.prob.gather(1, gidx)  # [B, Smax]
        u = self._rows(self.text_uniform, state, step, n=self.max_len)
        if self.text_policy == "logits":
            tdrop = u < gprob  # drop with probability 1 / max logit
        else:  # "entropy"
            ent, vent = tm.ent.gather(1, gidx), tm.vent.gather(1, gidx)
            low = (ent < 0.1) & (vent < 0.1)  # confident: always attended
            high = (ent > 5.0) & (vent > 5.0)  # chaotic: a coin flip
            tdrop = ~low & torch.where(high, u <= 0.5, u < gprob)
        in_gen = (slots >= gen_start) & (slots < cur_len[:, None] - 3)
        return drop_slots | (tdrop & in_gen)[:, None, :]

    def _sample_rows(self, state: PrefillState, step, logits: torch.Tensor) -> torch.Tensor:
        """Each row's token [B] drawn from ``logits`` [B, V] (HF's warpers,
        then the categorical draw) with the row's noise at ``step`` (an int,
        or each row's: ``_rows``)."""
        noise = self._rows(self.gumbel, state, step, n=logits.shape[-1])
        return sample_token(logits, noise, self.gen)

    def _aggregate(self, logits_k: torch.Tensor):
        """(winner [B], token [B], the logits sampling and the text stats
        read [B, V]) of the members' logits [B, K, V]: the winner's, or
        under ``use_avg`` the fp32 member average."""
        if self.ens.use_avg:
            winner, token = select_by_average(logits_k)
            return winner, token, logits_k.float().mean(dim=1)
        winner, token = select_by_vote(logits_k)
        rows = torch.arange(logits_k.shape[0], device=self.device)
        return winner, token, logits_k[rows, winner]

    def _decode_forward(self, x, cur_len, cache: KVCache, mask):
        """(fp32 logits [B, M, V], k_new, v_new [L, B, M, ...]) of one decode
        forward: the token's embedding ``x`` [B, D] for every member at
        position ``cur_len`` [B] over ``cache`` under the key masks ``mask``
        [B, M, Smax].  k_new / v_new are the new-token K and V [.., KH, Dh]
        (the MLA + MoE decoder: latent [.., 512] and roped key [.., 64]).
        With the engine's graphs, a replay whose outputs the graph's next
        replay overwrites."""
        lm, cfg, mod = self.params.lm, self.cfg.text, self.lm_mod
        if self._moe:
            trace.count("moe.assignments", mask.shape[0] * mask.shape[1] * cfg.num_experts_per_tok)

        def forward(x, cur_len, mask):
            B, M = mask.shape[:2]
            h, k, v = mod.decode_step(
                lm, cfg, x[:, None].expand(B, M, x.shape[-1]), cur_len, cache, mask,
                tp_mesh=self.tp_mesh, w8a8=self.w8a8_decode,
            )
            return mod.lm_head(lm, h), k, v

        if self._graphs is None:
            return forward(x, cur_len, mask)
        baked = (decode_graphs.addresses(lm), decode_graphs.addresses(cache), self.w8a8_decode)
        return self._graphs(forward, (x, cur_len, mask), baked)

    def _one_step(self, state, steps, draw_steps, token, cur_len, done, tokens, carry: _Carry):
        """One decode step of every row at its own generation index (JAX
        ``engine/generate.py:630``).

        ``steps`` [B] long is each row's index on the device; ``draw_steps``
        is the step the row's draws are keyed by, host values (an int for
        every row, or a list), equal to ``steps`` on every row not done: a
        done row's draws reach nothing it returns.  A row not done writes its
        token at ``tokens[b, steps[b]]`` (a done row, or one past the
        buffer, keeps it) and its K/V at ``cur_len[b]``, both in place.
        Returns (next_token, cur_len, steps, done, carry): fill and index
        advance only on rows that were not done."""
        lm = self.params.lm
        cache = state.cache
        B = token.shape[0]
        x = self.lm_mod.embed(lm, token)  # [B, D]
        slots = torch.arange(self.max_len, device=self.device)
        base_mask = slots[None, :] < cur_len[:, None]  # [B, Smax]
        tm = carry.tm

        if self.ensemble and self.ens.fused_step:
            # one M=K+1 forward: member 0 unmasked, members 1..K masked from
            # the previous step's argmax (and lagged logits for epis_kl)
            with trace.span("decode.masks"):
                drop_slots = self._member_drop_slots(
                    state, carry.prev_argmax0, draw_steps, carry.prev_logits0, cur_len, tm
                )
                masks = torch.cat([base_mask[:, None], base_mask[:, None] & ~drop_slots], dim=1)
            with trace.span("decode.forward"):
                logits_all, ka, va = self._decode_forward(x, cur_len, cache, masks)  # [B, K+1, V]
                logits0 = logits_all[:, 0]
                argmax0 = logits0.argmax(dim=-1)
            with trace.span("decode.vote"):
                winner, next_token, winner_logits = self._aggregate(logits_all[:, 1:])
                rows = torch.arange(B, device=self.device)
                kw, vw = ka[:, rows, winner + 1], va[:, rows, winner + 1]  # [L, B, ...]
        else:
            with trace.span("decode.forward0"):
                logits0, k0, v0 = self._decode_forward(x, cur_len, cache, base_mask[:, None])
                logits0 = logits0[:, 0]  # [B, V]
                argmax0 = logits0.argmax(dim=-1)
            if not self.ensemble:
                winner, next_token, winner_logits = None, argmax0, logits0
                kw, vw = k0[:, :, 0], v0[:, :, 0]
            else:
                with trace.span("decode.masks"):
                    drop_slots = self._member_drop_slots(
                        state, argmax0, draw_steps, logits0, cur_len, tm
                    )
                    member_mask = base_mask[:, None, :] & ~drop_slots  # [B, K, Smax]
                with trace.span("decode.members"):
                    logits_k, kk, vk = self._decode_forward(x, cur_len, cache, member_mask)
                with trace.span("decode.vote"):
                    winner, next_token, winner_logits = self._aggregate(logits_k)
                    rows = torch.arange(B, device=self.device)
                    kw, vw = kk[:, rows, winner], vk[:, rows, winner]  # [L, B, ...]
        if self.gen.do_sample:
            # HF samples the forward's returned (vote winner's) logits
            with trace.span("decode.sample"):
                next_token = self._sample_rows(state, draw_steps, winner_logits)

        with trace.span("decode.append"):
            if tm is not None:
                _record_text_stats(tm, steps, winner_logits)
            self.lm_mod.cache_set_rows(cache, cur_len, kw, vw)
            next_token = torch.where(done, self.gen.pad_token_id, next_token)
            rows = torch.arange(B, device=self.device)
            at = steps.clamp(max=tokens.shape[1] - 1)
            keep = done | (steps >= tokens.shape[1])  # done, or past the buffer
            tokens[rows, at] = torch.where(keep, tokens[rows, at], next_token)
            # the lagged logits outlive the step: a copy, not a graph's output
            carry = _Carry(tm, argmax0, logits0.clone() if self._lag_kl else None, winner)
            live = (~done).long()
            return (
                next_token,
                cur_len + live,
                steps + live,
                done | (next_token == self.gen.eos_token_id),
                carry,
            )

    @torch.no_grad()
    def decode(self, state: PrefillState, winners: list | None = None) -> torch.Tensor:
        """The decode loop from a prefill state; returns tokens [B, T].
        Updates ``state.cache`` in place.  ``winners``, a list, gets each
        step's winning member [B] (the one whose K/V the cache keeps) in
        ensemble mode."""
        with trace.span("decode"):
            B = state.first_token.shape[0]
            T = self.gen.max_new_tokens
            if self.gen.do_sample:  # every token is sampled: the first at step 0
                token = self._sample_rows(state, 0, state.last_logits)
            else:
                token = state.first_token
            tokens = torch.full(
                (B, T), self.gen.pad_token_id, dtype=torch.long, device=self.device
            )
            tokens[:, 0] = token
            done = token == self.gen.eos_token_id
            cur_len = state.cur_len.clone()
            tm = None
            if self.ensemble and self.text_policy != "none":
                zeros = [torch.zeros((B, T), device=self.device) for _ in range(3)]
                # entry 0: the stats of the prefill, which emitted token 0
                tm = _record_text_stats(TextMaskState(*zeros), 0, state.last_logits)
            # fused mode's first overlap source is the prefill's argmax, also
            # when token 0 was sampled; lagged epis_kl starts from its logits
            carry = _Carry(tm, state.first_token, state.last_logits if self._lag_kl else None)
            steps = torch.ones(B, dtype=torch.long, device=self.device)
            for step in range(1, T):  # decode steps start at 1, like the JAX loop
                with trace.span("decode.step"):
                    # every row not done is at ``step``
                    token, cur_len, steps, done, carry = self._one_step(
                        state, steps, step, token, cur_len, done, tokens, carry
                    )
                    if winners is not None:
                        winners.append(carry.winner)
                    trace.count("decode.steps")
                    # before every DONE_CHECK_EVERY-th step: the only host sync in the loop
                    if (step + 1) % DONE_CHECK_EVERY == 0 and step + 1 < T and bool(done.all()):
                        break
            return tokens

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def generate(self, input_ids, pixel_values) -> GenerationResult:
        return self._generate(input_ids, pixel_values)

    @torch.no_grad()
    def probe(self, input_ids, pixel_values, text_lens=None, image_index=None) -> ProbeResult:
        """The first token and its logits of each prompt: ``prefill``
        without the visual-span logits, the uncertainty and the cache.
        ``pixel_values`` may hold only the batch's unique images, with
        ``image_index`` [B] mapping rows to them; ``text_lens`` as
        ``prefill``'s."""
        with trace.span("probe"):
            with trace.span("probe.towers"):
                _, merged, _ = self._merge_inputs(input_ids, pixel_values, image_index)
            B, S, _ = merged.shape
            with trace.span("probe.lm"):
                hidden = self.lm_mod.prefill_hidden(
                    self.params.lm, self.cfg.text, merged, self._positions(B, S),
                    w8a8=self.w8a8_prefill,
                )
            return self._head(hidden, self._fill(B, S, text_lens)[0])

    def _prefix_handle(self, kv: KVCache) -> KVCache:
        if not self.int8_prefix_cache:
            return kv
        return KVCache(llama_mod.kv_int8_reader_layout(kv.k), llama_mod.kv_int8_reader_layout(kv.v))

    @torch.no_grad()
    def probe_prefix(self, prefix_ids, pixel_values) -> KVCache:
        """The K/V [L, 1, P, KH, Dh] of a prompt prefix shared by several
        questions (its image included), for ``probe_extend``; int8 reader
        leaves under ``int8_prefix_cache``."""
        require_dense(self, "the prefix cache")
        with trace.span("probe_prefix"):
            with trace.span("probe.towers"):
                _, merged, _ = self._merge_inputs(prefix_ids, pixel_values)
            B, S, _ = merged.shape
            with trace.span("probe.lm"):
                _, kv = llama_mod.prefill(
                    self.params.lm, self.cfg.text, merged, self._positions(B, S),
                    w8a8=self.w8a8_prefill,
                )
            return self._prefix_handle(kv)

    @torch.no_grad()
    def probe_extend(self, prefix_kv: KVCache, tail_ids, text_lens=None) -> ProbeResult:
        """``probe`` of [prefix + tail] for a batch of question tails [B, T]
        (plain text, right-padded; ``text_lens`` their real lengths) over a
        ``probe_prefix`` handle: the prefix is not run again."""
        require_dense(self, "the prefix cache")
        leaf = prefix_kv.k["q"] if llama_mod.cache_is_quantized(prefix_kv) else prefix_kv.k
        P = torch.full((1,), leaf.shape[2], dtype=torch.long, device=self.device)
        return self._extend(prefix_kv, P, None, tail_ids, text_lens)

    def _extend(self, prefix_kv, prefix_len, prefix_mask, tail_ids, text_lens) -> ProbeResult:
        """The tails' first tokens over a prefix of real length
        ``prefix_len`` [Bp]: their rope positions start there."""
        with trace.span("probe_extend"):
            ids = torch.as_tensor(tail_ids, dtype=torch.long, device=self.device)
            B, T = ids.shape
            positions = (prefix_len[:, None] + torch.arange(T, device=self.device)[None]).expand(B, T)
            with trace.span("extend.lm"):
                hidden, _ = llama_mod.prefill_extend(
                    self.params.lm, self.cfg.text, llama_mod.embed(self.params.lm, ids), positions,
                    prefix_kv, w8a8=self.w8a8_prefill, prefix_mask=prefix_mask,
                )
            if text_lens is None:
                last = torch.full((B,), T, dtype=torch.long, device=self.device)
            else:
                last = torch.as_tensor(text_lens, dtype=torch.long, device=self.device)
            return self._head(hidden, last)

    def _prompt_lengths(self, input_ids, *images) -> tuple[int, int]:
        """(the longest real merged prompt, the padded merged prompt) of a
        ``generate`` call, in cache slots, from the shapes alone: LLaVA-1.5's
        visual span is never padded, so the two are equal."""
        S = np.shape(input_ids)[1] + self.n_visual - 1
        return S, S

    def _check_capacity(self, input_ids, *images) -> None:
        """The KV-capacity guard of ``generate``, before any work and with no
        device sync: the padded prompt must fit the cache for ``cache_seed``,
        and each of the T-1 decode steps appends one row at a row's real
        length, as the JAX engine counts it (``cur_len``)."""
        longest, padded = self._prompt_lengths(input_ids, *images)
        if padded > self.max_len:
            raise ValueError(
                f"the merged prompt ({padded} slots) exceeds the KV capacity "
                f"max_len={self.max_len}"
            )
        if longest + self.gen.max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"prompt ({longest} tokens) + max_new_tokens "
                f"({self.gen.max_new_tokens}) - 1 exceeds the KV capacity "
                f"max_len={self.max_len}; raise max_len or lower the budget"
            )

    def _generate(self, input_ids, *images) -> GenerationResult:
        """``prefill(input_ids, *images)``, then the decode loop."""
        self._check_capacity(input_ids, *images)
        state = self.prefill(input_ids, *images)
        tokens = self.decode(state).cpu().numpy().astype(np.int32)
        num = first_index(tokens, self.gen.eos_token_id, 1)
        return GenerationResult(tokens=tokens, num_tokens=num)
