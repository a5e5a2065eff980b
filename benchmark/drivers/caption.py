"""Captioning with Dropout Decoding, batches back to back: the program's
``prefill`` then ``decode`` (exact mode) on a batch of images under one
instruction, every row to ``new_tokens`` tokens (end of sequence ignored).

The mix's keys: ``batch``, ``prompt_tokens``, ``image_pos``, ``image_size``
[h, w], ``new_tokens``, ``ensemble`` (the program's ``EnsembleConfig``
fields) and ``check_rows``.

``correct``: one finished batch drawn from the seed, and in it
``check_rows`` rows drawn from each half of the batch.  The reference runs
each row's prompt and image, then follows the served tokens step by step:
it draws the K members' masks again from the seed and its own uncertainty,
runs the unmasked and the K masked streams, votes over its own members,
and reads the served token's gap in the member that the program's vote
chose; that member's K/V is the one it keeps, as the program keeps it.
Compared: the KL divergence of the prefill's last logits from the
reference's (the widest over the rows), the mean over every served token
of its gap below the reference's best, and the served tokens (with their
members) that the reference's vote cannot give within the program's own
logit error (exact, limit 0: the window keeps each checked row's member
logits as the program's vote read them).  The first two grow with the
square of the program's error, so the program's int8 tier reads 4-7 times
what bfloat16 does; the widest gap and the uncertainty's error grow with
the error itself and do not part the two by three times (PERF.md).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import counts, inputs, seeds
from ..reference.anyres import image_geometry, max_tokens
from ..reference.dropout import drop_masks, epistemic, member_draws, top_ids
from .base import Driver, Unit, gap, kl, span, sync, vote_unexplained


# decode steps of the warm unit: past the loop's first host read of ``done``
# (``engine/generate.py`` ``DONE_CHECK_EVERY``), at every shape of the batch
WARM_NEW_TOKENS = 9


class Caption(Driver):
    work_name = "caption_tokens_per_s"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        tr, cfg = self.traffic, self.config
        self.B, self.T = tr["batch"], tr["new_tokens"]
        self.size = tuple(tr["image_size"])
        self.next = cfg["family"] == "llavanext"
        self.prompt = inputs.caption_prompt(cfg, tr, self.seed)
        self.n_visual = (image_geometry(self.size, cfg)["n_tokens"] if self.next
                         else (cfg["vision_config"]["image_size"] // cfg["vision_config"]["patch_size"]) ** 2)
        self.real = len(self.prompt) - 1 + self.n_visual  # merged prompt, real tokens
        self.tiles = inputs.tiles_of(cfg, self.size)
        self.dims = counts.Dims.of(cfg)
        ens = tr["ensemble"]
        self.caps, self.K = tuple(ens["voting_probs"]), len(ens["voting_probs"])
        r = seeds.rng(self.seed, seeds.CHECK, 0)
        half, n = self.B // 2, tr["check_rows"] // 2
        lo = r.choice(half, n, replace=False) if half else np.zeros(0, int)
        hi = half + r.choice(self.B - half, tr["check_rows"] - n, replace=False)
        self.rows = sorted(int(x) for x in np.concatenate([lo, hi]))
        self._steps = self._vote = None

    def _engine(self, params, new_tokens):
        from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
        from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
        from dropoutdecoding_tpu_torch.utils.config import EnsembleConfig, GenerationConfig

        from .base import program_config

        cls = LlavaNextEngine if self.next else LlavaEngine
        return cls(
            program_config(self.config), params, ens=EnsembleConfig(**{
                **self.traffic["ensemble"], "voting_probs": self.caps}),
            # eos -1: no row stops early, every row emits new_tokens tokens
            gen=GenerationConfig(max_new_tokens=new_tokens, eos_token_id=-1),
            max_len=self.config["kv_capacity"], seed=self.seed, ensemble=True,
        )

    def _record_votes(self):
        """Wraps the program's vote (``engine/generate.py`` calls
        ``select_by_vote`` by its module's name) so that each decode step
        keeps the checked rows' member logits [R, K, V] as the vote read
        them: one device copy a step, moved to the host at the unit's end."""
        from dropoutdecoding_tpu_torch.engine import generate

        orig = self._vote = generate.select_by_vote
        rows = torch.as_tensor(self.rows, device=self.device)

        def vote(member_logits):
            if self._steps is not None:
                self._steps.append(member_logits.index_select(0, rows))
            return orig(member_logits)

        generate.select_by_vote = vote

    def setup(self):
        self._record_votes()
        params = self.make_weights()
        self.engine = self._engine(params, self.T)
        warm = self._engine(params, WARM_NEW_TOKENS)
        self._batch(warm, -1, None)  # every shape of the mix: prefill and decode at B rows
        sync(self.device)

    def _images(self, i):
        imgs = [inputs.image(self.config, self.seed, i * self.B + r, self.size, self.device)
                for r in range(self.B)]
        if self.next:
            return imgs, [self.size] * self.B
        return (torch.cat(imgs),)

    def _batch(self, engine, i, spans):
        ids = np.tile(self.prompt, (self.B, 1))
        with span(spans, "prefill"):
            state = engine.prefill(ids, *self._images(i))
        winners, self._steps = [], []
        with span(spans, "decode"):
            tokens = engine.decode(state, winners)
        out = {
            "tokens": tokens.cpu().numpy(),  # the unit's host read: the captions
            "winners": torch.stack(winners).cpu().numpy() if winners else np.zeros((0, self.B), int),
            "member_logits": torch.stack(self._steps).cpu(),  # [T - 1, R, K, V]
            "last_logits": state.last_logits[self.rows].float().cpu(),
        }
        self._steps = None
        return out

    def flops(self, new_tokens):
        return counts.caption_batch_flops(self.dims, self.B, self.B * self.tiles, self.real,
                                          self.n_visual, new_tokens, self.K)

    def unit(self, i, spans=None) -> Unit:
        out = self._batch(self.engine, i, spans)
        return Unit(i, int(out["tokens"].size), self.B, self.flops(self.T), out)

    def traced_unit(self, i):
        """One batch, and its sizes, from which the roofline readers count
        its operations' work (``counts.py``)."""
        self._batch(self.engine, i, None)
        return {"rows": self.B, "members": self.K, "real": self.real,
                "visual": self.n_visual, "new_tokens": self.T, "tiles": self.B * self.tiles,
                "slots": self.config["kv_capacity"]}

    def release(self):
        self.engine = None
        if self._vote is not None:
            from dropoutdecoding_tpu_torch.engine import generate

            generate.select_by_vote, self._vote = self._vote, None

    # --- correct ---------------------------------------------------------------

    def check(self, units) -> dict:
        u = units[int(seeds.rng(self.seed, seeds.CHECK, 1).integers(len(units)))]
        ref = self.reference()
        ens = self.traffic["ensemble"]
        draw_n = max_tokens(self.config) if self.next else self.n_visual
        tokens, winners = u.out["tokens"], u.out["winners"]
        R, S = len(self.rows), self.real
        Smax = S + self.T
        worst_kl, gaps, votes, contested, outvoted = 0.0, [], 0, 0, 0
        L = len(ref.layers)
        KH, Dh = self.config["text_config"]["num_key_value_heads"], self.config["text_config"]["head_dim"]
        cache = [(torch.zeros(R, Smax, KH, Dh, device=self.device),
                  torch.zeros(R, Smax, KH, Dh, device=self.device)) for _ in range(L)]
        epis, tables, pos0 = [], [], []
        for j, r in enumerate(self.rows):
            crops = inputs.image(self.config, self.seed, u.index * self.B + r, self.size, self.device)
            emb, pos, n = ref.merge(self.prompt, ref.visual_tokens(crops, self.size))
            if emb.shape[0] != S:
                raise AssertionError(f"reference prompt {emb.shape[0]} tokens, program {S}")
            hidden, kv = ref.forward(emb)
            for (kc, vc), (k, v) in zip(cache, kv):
                kc[j, :S], vc[j, :S] = k, v
            last = ref.logits(hidden[-1])
            vis = ref.logits(hidden[pos:pos + n])
            epis.append(epistemic(vis))
            tables.append(top_ids(vis, ens["topk"]))
            pos0.append(pos)
            worst_kl = max(worst_kl, kl(last, u.out["last_logits"][j]))
            gaps.append(gap(last, int(tokens[r, 0])))
            del hidden, kv, vis
        slot = torch.arange(Smax, device=self.device)
        rows_t = torch.arange(R, device=self.device)
        for t in range(1, self.T):
            cur = S + t - 1
            x = ref.embed[torch.as_tensor(tokens[self.rows, t - 1], device=self.device)]
            base = (slot < cur)[None].expand(R, Smax)
            pos = torch.full((R,), cur, device=self.device)
            h0, _ = ref.step(x[:, None], pos, cache, base[:, None])
            argmax0 = ref.logits(h0[:, 0]).argmax(-1).tolist()
            masks = []
            for j, r in enumerate(self.rows):
                draws = [member_draws(self.seed, t, r, m, draw_n, self.device) for m in range(self.K)]
                drops = drop_masks(epis[j], tables[j], argmax0[j], draws, self.caps,
                                   ens["mask_accumulate"], ens["prob_floor"])
                n = drops.shape[1]
                dslot = torch.zeros(self.K, Smax, dtype=torch.bool, device=self.device)
                dslot[:, pos0[j]:pos0[j] + n] = drops
                masks.append(base[j][None] & ~dslot)
            hk, kvk = ref.step(x[:, None].expand(R, self.K, x.shape[-1]), pos, cache,
                               torch.stack(masks))
            lk = ref.logits(hk)  # [R, K, V]
            got = u.out["member_logits"][t - 1].to(self.device)
            w = torch.as_tensor(winners[t - 1, self.rows], device=self.device)
            for j, r in enumerate(self.rows):
                gaps.append(gap(lk[j, w[j]], int(tokens[r, t])))
                votes += vote_unexplained(lk[j], got[j], int(tokens[r, t]), int(w[j]))
                firsts = lk[j].argmax(-1).tolist()
                contested += len(set(firsts)) > 1
                outvoted += firsts.count(firsts[0]) < max(map(firsts.count, firsts))
            for (kc, vc), (k, v) in zip(cache, kvk):
                kc[:, cur], vc[:, cur] = k[rows_t, w], v[rows_t, w]
        # how many votes the check could catch a wrong one in
        print(f"[bench] reference votes: {contested} of {len(gaps) - R} contested, "
              f"member 0 outvoted in {outvoted}", file=sys.stderr)
        return self.checks({"logits_kl": worst_kl, "token_gap_mean": sum(gaps) / len(gaps),
                            "votes_unexplained": votes})


DRIVER = Caption
