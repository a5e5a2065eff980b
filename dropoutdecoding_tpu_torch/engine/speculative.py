"""Speculative greedy decoding: the target's own greedy tokens from cheap
drafts; port of ``dropoutdecoding_tpu/engine/speculative.py``.

A cycle drafts ``gamma`` tokens, then runs one target forward
(``llama.prefill_extend``) over [token, d_1 .. d_gamma] against the cache,
and accepts the longest prefix of drafts that equal the target's own
argmaxes; the target's argmax after that prefix ends the cycle, so a cycle
emits 1 to gamma + 1 tokens.  Acceptance is greedy: the output is the
target's greedy sequence whatever the drafts.  That is exact in fp32; in
bf16 the verify's gamma + 1 rows round otherwise than one-row decode steps,
so a near tie can split the two.

Two draft sources (``draft``):

- "lm": a draft tower of the target's architecture (the CLI's int4
  self-draft) with its own dense cache in the engine's dtype, seeded by a
  prefill over the engine's merged prompt.  A draft step is
  ``llama.decode_step`` at M = 1 (K1 over the draft cache, K6 in every
  projection of an int4 tower), and its argmax feeds the next step as a
  device tensor.  ``LlavaEngine`` only.
- "ngram": prompt lookup.  The emitted sequence's last bigram is matched
  against its own history, and the tokens that followed its latest
  occurrence are proposed.  No weights; every engine family.

A cycle reads the host once: the gamma + 1 target argmaxes and the
accepted count together.  The JAX package runs a whole generation in one
``lax.while_loop`` dispatch (``generate_fused``); here ``generate_fused`` is
a host loop with that program's bookkeeping (its buffer, its EOS cut and
its ``done`` rule), and ``generate`` the per-cycle loop that counts cycles
and accepted drafts.

The verify writes its gamma + 1 K/V rows at ``cur``
(``llama.cache_write_span``, quantized on an int8 cache).  Rows past the
accepted prefix are junk that the next cycle's block overwrites before
anything attends them.

Repaired against the reference (ROADMAP Queue 3 F6): the JAX draft scan
feeds d_1 .. d_{gamma-1} back but never d_gamma, so after a cycle that
accepts every draft the draft cache lacks d_gamma's row (the cycle's
``cur + gamma``), and the next cycle's drafts attend an empty row.  Here a
cycle that follows full acceptance first runs one draft step on d_gamma at
that slot, which writes the row; its logits are not computed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..models import llama as llama_mod
from ..models import mla_moe as mla_moe_mod
from ..parallel.mesh import mesh_of
from ..utils.config import is_mla_moe


def _stamp(device: torch.device):
    """A point in time: a recorded CUDA event on the card, the host clock
    elsewhere."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _elapsed_ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3


@dataclass
class SpeculativeGreedy:
    """Wraps a greedy (``ensemble=False``) engine with a draft source.

    Args:
      engine: a LlavaEngine-family engine, dense or int8 cache.
      draft_lm: the draft's Llama params (same architecture as the target's,
        e.g. ``quantize_llama_params_int4`` of them); None for "ngram".
      gamma: drafted tokens a cycle.
      draft: "lm" (the draft tower) or "ngram" (prompt lookup).
      cycle_ms: when a list, each cycle appends (draft ms, verify ms, wall
        ms): draft and verify between CUDA events on the card (the host
        clock elsewhere), wall on the host clock from the cycle's start to
        its read.
      on_verify: called as ``on_verify(cur, logits, n_acc)`` after each
        cycle's read, with the verify's target logits [G + 1, V] at slots
        cur .. cur + G: a check's view of what the cycle accepted from.
    """

    engine: Any
    draft_lm: dict | None
    gamma: int = 4
    draft: str = "lm"
    cycle_ms: list | None = None
    on_verify: Callable | None = None

    def __post_init__(self):
        if is_mla_moe(self.engine.cfg.text):
            raise mla_moe_mod.unsupported("speculative decoding")
        if getattr(self.engine, "ensemble", True):
            raise ValueError(
                "speculative decoding accelerates the GREEDY baseline "
                "(--original); build the engine with ensemble=False"
            )
        if self.draft not in ("lm", "ngram"):
            raise ValueError(f"draft must be 'lm' or 'ngram': {self.draft}")
        if self.draft == "lm" and self.draft_lm is None:
            raise ValueError("draft='lm' needs a draft_lm tower")
        if self.draft == "lm" and type(self.engine).__name__ != "LlavaEngine":
            # the draft prefill takes LlavaEngine's merged embeddings; the
            # NeXT and InstructBLIP merges take other inputs
            raise NotImplementedError(
                "draft='lm' is implemented for LlavaEngine; use "
                "draft='ngram' for LLaVA-NeXT / InstructBLIP engines"
            )
        if self.draft == "lm" and mesh_of(self.draft_lm) is not self.engine.tp_mesh:
            # the draft's cache is allocated with the target's local heads
            raise ValueError(
                "the draft tower must be cut for the target's mesh "
                "(parallel/mesh.shard_llama_params), or neither be sharded"
            )
        # slot ids: positions and masks are views and comparisons of it, so a
        # host-side ``cur`` reaches the device without a copy
        self._slots = torch.arange(self.engine.max_len, device=self.engine.device)

    # ------------------------------------------------------------------
    # the cycle
    # ------------------------------------------------------------------
    def _draft_prefill(self, input_ids, pixel_values) -> llama_mod.KVCache:
        """The draft's dense cache over the engine's merged prompt (vision
        and merge are the target's; only the LM tower differs)."""
        eng = self.engine
        _, merged, _ = eng._merge_inputs(input_ids, pixel_values)
        B, S, _ = merged.shape
        _, kv = llama_mod.prefill(self.draft_lm, eng.cfg.text, merged, eng._positions(B, S))
        cache = llama_mod.empty_cache(eng.cfg.text, B, eng.max_len, eng.dtype, eng.device,
                                      tp_mesh=eng.tp_mesh)
        return llama_mod.cache_seed(cache, kv)

    def _draft_step(self, dcache, pos: int, token: torch.Tensor, head: bool = True):
        """One draft forward of ``token`` [1] at slot ``pos`` over the slots
        before it; writes its K/V at ``pos`` and returns its argmax [1]
        (None without ``head``)."""
        lm, cfg = self.draft_lm, self.engine.cfg.text
        position = self._slots[pos:pos + 1]
        mask = (self._slots < pos)[None, None]  # [1, 1, Smax]
        x = llama_mod.embed(lm, token)[:, None]  # [1, 1, D]
        hidden, k_new, v_new = llama_mod.decode_step(lm, cfg, x, position, dcache, mask)
        llama_mod.cache_set_rows(dcache, position, k_new[:, :, 0], v_new[:, :, 0])
        if head:
            return llama_mod.lm_head(lm, hidden)[:, 0].argmax(dim=-1)
        return None

    def _verify(self, tcache, cur: int, token: torch.Tensor, drafts: torch.Tensor):
        """One target forward over [token, d_1 .. d_G] at slots cur ..
        cur + G against the cache's first ``cur`` slots; writes their K/V
        there.  Returns the target's fp32 logits [G + 1, V]."""
        eng = self.engine
        G = self.gamma
        toks = torch.cat([token, drafts])[None]  # [1, G + 1]
        hidden, kv = llama_mod.prefill_extend(
            eng.params.lm, eng.cfg.text, llama_mod.embed(eng.params.lm, toks),
            self._slots[cur:cur + G + 1][None], tcache, prefix_mask=(self._slots < cur)[None],
        )
        llama_mod.cache_write_span(tcache, cur, kv)
        return llama_mod.lm_head(eng.params.lm, hidden)[0]

    def _cycle(self, tcache, dcache, cur: int, token: torch.Tensor, propose=None, refill=None):
        """One cycle from ``token`` [1], the last emitted token (not yet in
        the caches), at slot ``cur``.  ``propose()`` gives the drafts [G]
        ("ngram"); else the draft tower makes them, after a step on
        ``refill`` [1] (d_G of a fully accepted cycle) at ``cur - 1``.
        Returns (the target argmaxes [G + 1] on the device, the same as a
        host list, the accepted count)."""
        clock = self.cycle_ms is not None
        if clock:
            t0, s0 = time.perf_counter(), _stamp(token.device)
        if propose is not None:
            drafts = propose()
        else:
            if refill is not None:
                self._draft_step(dcache, cur - 1, refill, head=False)
            tok, out = token, []
            for i in range(self.gamma):
                tok = self._draft_step(dcache, cur + i, tok)
                out.append(tok)
            drafts = torch.cat(out)
        if clock:
            s1 = _stamp(token.device)
        logits = self._verify(tcache, cur, token, drafts)
        g = logits.argmax(dim=-1)
        n_acc = torch.cumprod((g[:-1] == drafts).long(), dim=0).sum()
        if clock:
            s2 = _stamp(token.device)
        *g_host, n = torch.cat([g, n_acc[None]]).tolist()  # the cycle's one host read
        if clock:
            self.cycle_ms.append(
                (_elapsed_ms(s0, s1), _elapsed_ms(s1, s2), (time.perf_counter() - t0) * 1e3)
            )
        if self.on_verify is not None:
            self.on_verify(cur, logits, n)
        return g, g_host, n

    # ------------------------------------------------------------------
    # the ngram draft
    # ------------------------------------------------------------------
    def _ngram_drafts(self, buf: torch.Tensor, n: int, token: torch.Tensor) -> torch.Tensor:
        """The device matcher: G drafts from the ``n`` emitted tokens of
        ``buf`` [BUF] (pad past them) whose last is ``token`` [1].  The
        latest earlier occurrence of the last bigram, and the G tokens after
        it; ``token`` G times where there is none (n < 3 included)."""
        G = self.gamma
        BUF = buf.shape[0]
        idx = torch.arange(BUF, device=buf.device)
        prev, cur = buf[max(n - 2, 0)], token[0]
        nxt = torch.cat([buf[1:], buf.new_full((1,), -1)])
        hit = (buf == prev) & (nxt == cur) & (idx < n - 2)
        i_star = torch.where(hit, idx, -1).max()
        start = (i_star.clamp(min=0) + 2).clamp(max=BUF - G)  # as dynamic_slice clamps
        found = buf[start + torch.arange(G, device=buf.device)]
        return torch.where(i_star >= 0, found, cur.expand(G))

    @staticmethod
    def ngram_propose_np(hist, gamma, pad):
        """Host mirror of ``_ngram_drafts`` for ``generate``: ``hist`` the
        emitted tokens."""
        hist = list(hist)
        n = len(hist)
        if n >= 3:
            prev, cur = hist[-2], hist[-1]
            for i in range(n - 3, -1, -1):
                if hist[i] == prev and hist[i + 1] == cur:
                    cont = hist[i + 2 : i + 2 + gamma]
                    out = np.full((gamma,), pad, np.int32)
                    out[: len(cont)] = cont
                    return out
        return np.full((gamma,), hist[-1] if n else pad, np.int32)

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------
    def _check_headroom(self, cur: int) -> None:
        """The verify writes G + 1 rows at the current slot: the cache needs
        ``gamma`` rows past prompt + max_new_tokens."""
        eng = self.engine
        need = cur + eng.gen.max_new_tokens + self.gamma
        if need > eng.max_len:
            raise ValueError(
                f"engine max_len={eng.max_len} lacks speculative headroom: "
                f"needs prompt+max_new_tokens+gamma={need} rows "
                f"(build the engine with max_len >= that)"
            )

    def _start(self, input_ids, rest):
        """The target's prefill; (its state, the fill, the first token), one
        host read for both."""
        if np.shape(input_ids)[0] != 1:
            # the cycle is single-stream: a B > 1 state would be corrupted,
            # not batched
            raise ValueError("speculative decoding runs one image per call")
        state = self.engine.prefill(input_ids, *rest)
        cur, first = torch.stack([state.cur_len[0], state.first_token[0]]).tolist()
        self._check_headroom(cur)
        return state, cur, first

    @torch.no_grad()
    def generate_fused(self, input_ids, *rest):
        """Greedy generation with the JAX whole-generation program's
        bookkeeping.  Returns (tokens [T'], cycles)."""
        eng = self.engine
        G, T = self.gamma, eng.gen.max_new_tokens
        eos, pad = eng.gen.eos_token_id, eng.gen.pad_token_id
        state, cur, first = self._start(input_ids, rest)
        if T == 1 or first == eos:
            return np.asarray([first], np.int32), 0
        lm = self.draft == "lm"
        dcache = self._draft_prefill(input_ids, *rest) if lm else None
        # the emitted buffer, on the device (the ngram matcher reads it): the
        # lm program's starts after the first token, the ngram one holds it
        # in slot 0
        buf = torch.full((T + G + 1,), pad, dtype=torch.long, device=eng.device)
        n_out, limit = (0, T - 1) if lm else (1, T)
        if not lm:
            buf[0] = state.first_token[0]
        token, refill = state.first_token, None
        done, cycles = False, 0
        while not done and cycles < T:
            propose = None if lm else (lambda: self._ngram_drafts(buf, n_out, token))
            g, g_host, n_acc = self._cycle(state.cache, dcache, cur, token, propose, refill)
            cycles += 1
            # the tokens emitted, g[0 .. n_acc], cut after the first EOS among them
            first_eos = next((i for i in range(n_acc + 1) if g_host[i] == eos), G + 1)
            n_adv = min(n_acc + 1, first_eos + 1)
            hit_eos = first_eos <= n_acc
            emit = g.clone()
            emit[n_adv:] = pad
            buf[n_out:n_out + G + 1] = emit
            n_out += n_adv
            done = hit_eos or n_out >= limit
            # after an EOS cut, the next token and slot follow the emitted prefix
            k = min(n_adv, G) if hit_eos else n_acc
            cur += n_adv if hit_eos else n_acc + 1
            token = g[k:k + 1]
            refill = g[G - 1:G] if lm and not hit_eos and n_acc == G else None
        emitted = buf[:min(n_out, T)].tolist()
        out = np.asarray([first] + emitted if lm else emitted, np.int32)[:T]
        hits = np.flatnonzero(out == eos)  # cut at eos, as the engine's harvest
        return (out[: hits[0] + 1] if hits.size else out), cycles

    @torch.no_grad()
    def generate(self, input_ids, *rest):
        """Greedy generation cycle by cycle, token-equal to
        ``engine.generate`` on the same inputs.  Returns (tokens [T'],
        cycles, accepted drafts); the drafts of "ngram" come from the host
        mirror."""
        eng = self.engine
        G, T = self.gamma, eng.gen.max_new_tokens
        eos, pad = eng.gen.eos_token_id, eng.gen.pad_token_id
        state, cur, first = self._start(input_ids, rest)
        out = [first]
        if T == 1 or first == eos:
            return np.asarray(out, np.int32), 0, 0
        lm = self.draft == "lm"
        dcache = self._draft_prefill(input_ids, *rest) if lm else None
        token, refill = state.first_token, None
        cycles = accepted = 0
        while len(out) < T and out[-1] != eos:
            propose = None if lm else (lambda: torch.as_tensor(
                self.ngram_propose_np(out, G, pad), dtype=torch.long, device=eng.device))
            g, g_host, n_acc = self._cycle(state.cache, dcache, cur, token, propose, refill)
            cycles += 1
            accepted += n_acc
            for t in g_host[: n_acc + 1]:
                out.append(t)
                if len(out) >= T or t == eos:
                    break
            cur += n_acc + 1
            token = g[n_acc:n_acc + 1]
            refill = g[G - 1:G] if lm and n_acc == G else None
        return np.asarray(out[:T], np.int32), cycles, accepted
