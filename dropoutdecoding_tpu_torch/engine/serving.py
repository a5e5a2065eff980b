"""Continuous-batching decode server; port of
``dropoutdecoding_tpu/engine/serving.py``.

Up to ``n_slots`` Dropout Decoding generations share one batched decode
step:

- ``submit()`` prefills one request (the engine's ``prefill``) and copies
  its cache and state into a free slot, so requests join while others
  decode; ``submit_many()`` prefills several waiting requests as one
  right-padded batch and places every row at once; ``submit_chunked()``
  prefills one request in pieces (``engine.prefill_chunked``) and steps the
  active slots between two pieces, so a long prompt stalls them by one
  piece at a time, not the whole prompt;
- ``step(n)`` runs the engine's ``_one_step`` ``n`` times over every slot;
  each slot keeps its own generation index, so rows that joined at
  different times draw and write at their own;
- ``harvest()`` collects the finished requests (done, or at their token
  budget) and frees their slots; ``cancel()`` frees one early.

The engine's decode step serves unchanged, so every mode runs: exact,
fused and greedy, sampling, the text masks, every mask policy ("epis_kl"
keeps each slot's [N, V] visual-token logits, allocated only then), an
int8 cache (K3, K4), int4 weights (K6) and w8a8.  On the card a step
launches K1 (K3 on an int8 cache) in every layer of every forward over all
``n_slots`` rows, empty ones included: 32 a step fused or greedy, 64 exact,
at 7B depth.

Departures from the JAX server, none of which changes a token:

- there is no jit: ``step(n)`` is a Python loop of ``n`` steps that reads
  nothing back.  The host keeps each slot's draw step itself (the slots
  it placed, plus one a step), so ``harvest`` makes the only host read;
- the KV-capacity guard runs at ``submit``, from the prompt's shape (the
  engine's ``_prompt_lengths``), before any work; the JAX server defers it
  to ``harvest`` so as not to wait on the prefill.  The message is JAX's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import llama as llama_mod
from .generate import PrefillState, TextMaskState, _Carry, _record_text_stats, require_dense


@dataclass
class DecodeServer:
    engine: Any
    n_slots: int = 8

    def __post_init__(self):
        eng = self.engine
        require_dense(eng, "the decode server")
        T = eng.gen.max_new_tokens
        S, N, V = self.n_slots, eng.n_visual, eng.cfg.text.vocab_size
        dev = eng.device
        f32 = dict(dtype=torch.float32, device=dev)
        i64 = dict(dtype=torch.long, device=dev)
        # "epis_kl" reads each slot's [N, V] visual-token logits every step
        # (S x N x V fp32: 0.6 GB at 8 x 576 x 32k): only then is it kept
        self._track_kl = eng.ens.mask_policy == "epis_kl"
        self._state = PrefillState(
            cache=llama_mod.empty_cache(eng.cfg.text, S, eng.max_len, eng.dtype, dev,
                                        quantized=eng.int8_kv, tp_mesh=eng.tp_mesh),
            cur_len=torch.ones(S, **i64),  # >= 1 so that an empty slot's mask is sane
            last_logits=torch.zeros(S, V, **f32),
            first_token=torch.zeros(S, **i64),
            epis=torch.zeros(S, N, **f32),
            topk_ids=torch.full((S, N, eng.ens.topk), -1, dtype=torch.int32, device=dev),
            image_logits=torch.zeros(S, N, V if self._track_kl else 1, **f32),
            image_pos=torch.zeros(S, **i64),
            visual_mask=torch.zeros(S, N, dtype=torch.bool, device=dev),
            probe_ids=torch.full((S, 8), -1, dtype=torch.int32, device=dev),
            rng_id=torch.zeros(S, dtype=torch.long),  # on the host, as the engine's
            uncertainty={},
        )
        text_masks = eng.ensemble and eng.text_policy != "none"
        self._carry = dict(
            cur_len=torch.ones(S, **i64),
            token=torch.zeros(S, **i64),
            steps=torch.zeros(S, **i64),
            draw_steps=[0] * S,  # the host's count of ``steps`` (see _one_step)
            tokens_buf=torch.full((S, T), eng.gen.pad_token_id, **i64),
            done=torch.ones(S, dtype=torch.bool, device=dev),  # empty slots are done
            tm=TextMaskState(*(torch.zeros(S, T, **f32) for _ in range(3))) if text_masks else None,
            prev_argmax0=torch.zeros(S, **i64),
            prev_logits0=torch.zeros(S, V, **f32) if eng._lag_kl else None,  # lagged epis_kl
        )
        self._requests: List[Optional[Any]] = [None] * S
        # per-request budgets (<= T), applied at harvest: the step always runs
        # every slot; a slot is harvested (its tokens cut) once it reaches
        # its budget
        self._budgets: List[int] = [T] * S

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._requests) if r is None]

    def active(self) -> int:
        return sum(r is not None for r in self._requests)

    def _place_rows(self, ps: PrefillState, slots: List[int]) -> None:
        """Row i of the prefilled ``ps`` into slot ``slots[i]`` (JAX
        ``_place_impl`` / ``_place_many_impl``): its cache and state, and the
        decode carry a solo ``decode`` starts from: token 0 (under sampling
        drawn at step 0 from the request's own stream), index 1, the text
        statistics of the prefill at entry 0, the prefill's argmax as fused
        mode's first overlap source and its logits as lagged epis_kl's."""
        eng, st, c = self.engine, self._state, self._carry
        idx = torch.tensor(slots, dtype=torch.long, device=eng.device)
        llama_mod.cache_copy_slots(st.cache, ps.cache, idx)
        for name in ("cur_len", "last_logits", "first_token", "epis", "topk_ids", "image_pos",
                     "visual_mask", "probe_ids"):
            getattr(st, name)[idx] = getattr(ps, name)
        if self._track_kl:
            st.image_logits[idx] = ps.image_logits
        st.rng_id[slots] = ps.rng_id
        emit = eng._sample_rows(ps, 0, ps.last_logits) if eng.gen.do_sample else ps.first_token
        c["cur_len"][idx] = ps.cur_len
        c["token"][idx] = emit
        c["steps"][idx] = 1
        c["done"][idx] = emit == eng.gen.eos_token_id
        c["tokens_buf"][idx] = eng.gen.pad_token_id
        c["tokens_buf"][idx, 0] = emit
        if c["tm"] is not None:
            B, T = len(slots), c["tokens_buf"].shape[1]
            fresh = TextMaskState(*(torch.zeros(B, T, device=eng.device) for _ in range(3)))
            for t, f in zip(c["tm"], _record_text_stats(fresh, 0, ps.last_logits)):
                t[idx] = f
        c["prev_argmax0"][idx] = ps.first_token
        if c["prev_logits0"] is not None:
            c["prev_logits0"][idx] = ps.last_logits
        for slot in slots:
            c["draw_steps"][slot] = 1

    def _place(self, ps: PrefillState, slot: int, request_id) -> None:
        """A one-request prefill ``ps`` into ``slot``, for ``request_id``."""
        self._place_rows(ps, [slot])
        self._requests[slot] = request_id

    def _budget(self, max_new_tokens: Optional[int]) -> int:
        T = self._carry["tokens_buf"].shape[1]
        if max_new_tokens is not None and not (1 <= max_new_tokens <= T):
            raise ValueError(
                f"max_new_tokens={max_new_tokens} outside [1, {T}] "
                "(the server's compiled token budget; raise the engine's "
                "gen.max_new_tokens for longer requests)"
            )
        return max_new_tokens or T

    def _check_capacity(self, slot: int, budget: int, longest: int, padded: int) -> None:
        """The JAX server's KV-capacity guard (``harvest``), here before the
        prefill: a request's T - 1 appends start at its real length, and the
        padded prompt must fit the cache it is seeded into."""
        max_len = self.engine.max_len
        if padded > max_len:
            raise ValueError(
                f"the merged prompt ({padded} slots) exceeds the KV capacity max_len={max_len}"
            )
        if longest + budget - 1 > max_len:
            raise ValueError(
                f"slot {slot}: prompt ({longest} tokens) + budget "
                f"({budget}) - 1 exceeds max_len={max_len} — the slot's KV "
                f"appends overflow the cache"
            )

    def _take(self, prefill_args, max_new_tokens) -> tuple:
        """(the free slot a request takes, its budget), once the capacity
        guard has passed."""
        slots = self.free_slots()
        if not slots:
            raise RuntimeError("no free slots; call step()/harvest() first")
        budget = self._budget(max_new_tokens)
        self._check_capacity(slots[0], budget, *self.engine._prompt_lengths(*prefill_args))
        return slots[0], budget

    def submit(self, request_id, *prefill_args, max_new_tokens=None) -> int:
        """Prefill one request and place it into a free slot.

        ``max_new_tokens`` (optional): a budget <= the engine's T; the
        request is harvested once it has emitted that many tokens, a prefix
        of its solo tokens (decoding is causal)."""
        slot, budget = self._take(prefill_args, max_new_tokens)
        self._place(self.engine.prefill(*prefill_args), slot, request_id)
        self._budgets[slot] = budget
        return slot

    def submit_chunked(self, request_id, *prefill_args, chunk: int = 256, pump_steps: int = 4,
                       max_new_tokens=None) -> int:
        """``submit`` with the prefill in ``chunk``-token pieces and
        ``pump_steps`` decode steps of the active slots between two: a long
        prompt (LLaVA-NeXT's ~2.95k tokens) stalls running streams by one
        piece at a time.  Tokens are ``submit``'s: the chunked prefill is
        the one-shot prefill up to summation order, and the pumped steps
        advance only the other slots."""
        slot, budget = self._take(prefill_args, max_new_tokens)

        def pump():
            if self.active():
                self.step(pump_steps)

        ps = self.engine.prefill_chunked(*prefill_args, chunk=chunk, pump=pump)
        self._place(ps, slot, request_id)
        self._budgets[slot] = budget
        return slot

    def submit_many(self, items) -> List[int]:
        """Prefill several waiting requests as one batch and place each row
        into a free slot.

        Args:
          items: list of (request_id, (input_ids [1, S], pixel_values [1,
            ...])), the LLaVA-1.5 prefill's arguments; the rows are
            right-padded to their longest, rounded up to a multiple of 8,
            and prefilled with their real lengths.  Other engines take
            ``submit``.
        Returns the slots used, one an item, in order.  Every request gets
        the engine's whole budget.
        """
        slots = self.free_slots()
        if len(items) > len(slots):
            raise RuntimeError(f"{len(items)} submissions but only {len(slots)} free slots")
        if len(items) == 1:
            rid, args = items[0]
            return [self.submit(rid, *args)]
        T = self._carry["tokens_buf"].shape[1]
        id_rows = [np.asarray(a[0])[0] for _, a in items]
        lens = np.array([len(r) for r in id_rows], np.int64)
        S = -(-int(lens.max()) // 8) * 8
        ids = np.zeros((len(items), S), np.int64)
        for i, r in enumerate(id_rows):
            ids[i, : len(r)] = r
        px = torch.cat([torch.as_tensor(a[1]) for _, a in items])
        used = slots[: len(items)]
        padded = self.engine._prompt_lengths(ids, px)[1]
        for slot, (_, args) in zip(used, items):
            self._check_capacity(slot, T, self.engine._prompt_lengths(*args)[0], padded)
        ps = self.engine.prefill(ids, px, text_lens=lens)
        # a B = 1 prefill draws from stream 0: pin every row to it, so that
        # submit_many gives submit's tokens
        self._place_rows(ps._replace(rng_id=torch.zeros_like(ps.rng_id)), used)
        for slot, (rid, _) in zip(used, items):
            self._requests[slot] = rid
            self._budgets[slot] = T
        return used

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, n: int = 1) -> None:
        """Advance every slot ``n`` tokens; done and empty slots keep their
        tokens and fill."""
        eng, c = self.engine, self._carry
        for _ in range(n):
            token, cur_len, steps, done, carry = eng._one_step(
                self._state, c["steps"], c["draw_steps"], c["token"], c["cur_len"], c["done"],
                c["tokens_buf"], _Carry(c["tm"], c["prev_argmax0"], c["prev_logits0"]),
            )
            c.update(token=token, cur_len=cur_len, steps=steps, done=done, tm=carry.tm,
                     prev_argmax0=carry.prev_argmax0, prev_logits0=carry.prev_logits0,
                     draw_steps=[s + 1 for s in c["draw_steps"]])

    def cancel(self, request_id) -> bool:
        """Abort an in-flight request: its slot is marked done (the step
        leaves it be) and is free at once; a finished or unknown id returns
        False."""
        for slot, rid in enumerate(self._requests):
            if rid == request_id:
                self._requests[slot] = None
                self._carry["done"][slot] = True
                return True
        return False

    def harvest(self) -> Dict[Any, np.ndarray]:
        """Collect finished requests (done, or at their budget), tokens
        int32 up to and with eos; their slots become free."""
        c = self._carry
        T = c["tokens_buf"].shape[1]
        done, steps = torch.stack([c["done"].long(), c["steps"]]).tolist()  # one host read
        finished, buf, freed = {}, None, []
        for slot, req in enumerate(self._requests):
            if req is None:
                continue
            budget = self._budgets[slot]
            if done[slot] or steps[slot] >= budget:
                if buf is None:
                    buf = c["tokens_buf"].cpu().numpy().astype(np.int32)
                finished[req] = buf[slot][: min(steps[slot], budget, T)]
                self._requests[slot] = None
                freed.append(slot)
        if freed:
            c["done"][freed] = True
        return finished

    def run(self, requests, prefill_args_fn, max_steps=10_000, batch_prefill=True,
            step_chunk=1):
        """Feed ``requests`` (ids) through the slots to completion;
        ``prefill_args_fn(rid)`` gives a request's prefill arguments.
        ``batch_prefill``: the waiting requests of a round in one
        ``submit_many`` (LLaVA-1.5's signature), else ``submit`` each;
        ``step_chunk``: steps between two rounds.  Returns {rid: tokens}."""
        pending = list(requests)
        results = {}
        steps = 0
        while (pending or self.active()) and steps < max_steps:
            free = self.free_slots()
            if pending and free:
                take = [pending.pop(0) for _ in range(min(len(free), len(pending)))]
                if batch_prefill:
                    self.submit_many([(rid, prefill_args_fn(rid)) for rid in take])
                else:
                    for rid in take:
                        self.submit(rid, *prefill_args_fn(rid))
            self.step(step_chunk)
            steps += step_chunk
            results.update(self.harvest())
        return results
