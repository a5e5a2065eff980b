"""Captioning with Dropout Decoding on a DeepSeek-V3-style decoder (latent
attention, routed experts; ``configs/kimi-vl-a3b.clip336.json``) behind the
LLaVA-1.5 tower: ``caption.py``'s batches, engine and comparison, with this
decoder's weights, reference (``reference/mla_moe.py``), operation counts
(``counts_mla.py``) and reference cache (a layer's normalised latents and
roped keys).

``correct`` compares what ``caption.py`` compares: the KL divergence of the
prefill's last logits, the mean gap of the served tokens in the member the
vote chose, and the votes the reference cannot explain; with the program's
expert choices.  Under bf16 a near-tie in the top-k goes otherwise than in
fp32 in about 1% of a layer's picks, and a different expert then carries
through every later layer and token (about 15% of the picks differ by the
last layer, and the prefill's KL reaches that of the int8 control: my chip
runs, PERF.md).  So the checked unit runs again with its forwards eager,
which gives the same bits (``rerun_differs``: tokens and winners that do
not, limit 0), its router recorded, and the reference takes the program's
experts at every routed layer of every forward, with its own weights for
them.  The choices are held to the reference's own router with an
allowance that is no number of the program's: ``routes_unexplained_pct``
is the share of the checked rows' (row, routed layer, forward) choices
that no scores within ``ROUTE_ALLOWANCE`` of the reference's choice scores
(sigmoid + bias) would rank first.  A router that leaves its bias out, or
a wrong router leaf, moves its picks by the bias's size (0.02) and more,
far past the allowance; under bf16 a few near-ties a thousand need more.
The picks that are not the reference's own top-k, the largest allowance a
row's picks need and the largest choice-score error are printed.
``--control int8``: every matrix of the language model (projections, the
router, the experts, the head) rounded to int8 per output channel and back
to bf16 before the program gets it (``utils/quantize``'s quantizer, in
place); the reference then runs on the bf16 tree made again from the seed.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import counts_mla, inputs, seeds, weights as weights_mod
from ..reference.dropout import drop_masks, epistemic, member_draws, top_ids
from ..reference.mla_moe import MlaMoeReference
from .base import Driver, gap, kl, vote_unexplained
from .caption import Caption


def make_tree(config: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{"vision", "projector", "lm"}: the tower and projector by
    ``weights.make``'s recipe (its language model left empty), then the
    decoder in the program's layout from its own stream of the seed:
    normal(0, ``init_std``) matrices and router biases (fp32), normal(0,
    ``embed_std``) token embeddings, norm weights 1.  At ``init_std`` the
    embeddings would be small beside what attention adds from the shared
    context, and the rows of a decode forward would route alike."""
    t = config["text_config"]
    tower_only = {**config, "family": "llava", "text_config": {
        "hidden_size": t["hidden_size"], "intermediate_size": 0, "num_hidden_layers": 0,
        "num_attention_heads": 0, "num_key_value_heads": 0, "head_dim": 0, "vocab_size": 0}}
    tree = weights_mod.make(tower_only, seed, device, dtype)
    gen = seeds.generator(device, seed, seeds.WEIGHTS, 1)
    std = config["init_std"]

    def nrm(*shape, std=std):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    d = counts_mla.MlaDims.of(config)
    tree["lm"] = {
        "embed_tokens": nrm(d.V, d.D, std=config["embed_std"]),
        "layers": {
            "input_ln": ones(d.L, d.D),
            "post_attn_ln": ones(d.L, d.D),
            "q_proj": nrm(d.L, d.D, d.H * (d.dn + d.dr)),
            "kv_a_proj": nrm(d.L, d.D, d.R + d.dr),
            "kv_a_ln": ones(d.L, d.R),
            "kv_b_proj": nrm(d.L, d.R, d.H * (d.dn + d.dv)),
            "o_proj": nrm(d.L, d.H * d.dv, d.D),
        },
        "dense": {"gate_proj": nrm(d.Ld, d.D, d.I), "up_proj": nrm(d.Ld, d.D, d.I),
                  "down_proj": nrm(d.Ld, d.I, d.D)},
        "moe": {
            "router": nrm(d.Lm, d.D, d.E),
            "router_bias": nrm(d.Lm, d.E).float(),
            "gate_proj": nrm(d.Lm, d.E, d.D, d.Ie),
            "up_proj": nrm(d.Lm, d.E, d.D, d.Ie),
            "down_proj": nrm(d.Lm, d.E, d.Ie, d.D),
            "shared_gate_proj": nrm(d.Lm, d.D, d.Is),
            "shared_up_proj": nrm(d.Lm, d.D, d.Is),
            "shared_down_proj": nrm(d.Lm, d.Is, d.D),
        },
        "norm": ones(d.D),
        "lm_head": nrm(d.D, d.V),
    }
    return tree


def round_int8_(lm: dict) -> None:
    """Every matrix of the decoder ([.., in, out] leaves) rounded to int8 per
    output channel and back, in place, one [in, out] panel at a time."""
    from dropoutdecoding_tpu_torch.utils.quantize import dequantize_matrix, quantize_matrix

    def panels(t):
        return [t] if t.dim() == 2 else [p for s in t.unbind(0) for p in panels(s)]

    leaves = [lm["lm_head"]]
    for group in ("layers", "dense", "moe"):
        leaves += [w for name, w in lm[group].items()
                   if w.dtype != torch.float32 and not name.endswith(("_ln",))]
    for w in leaves:
        for p in panels(w):
            p.copy_(dequantize_matrix(quantize_matrix(p), p.dtype))


# the choice-score distance (sigmoid + bias, an expert) within which a pick
# the reference's own top-k lacks is explained: a quarter of the largest
# error a sound bf16 run's scores show (PERF.md)
ROUTE_ALLOWANCE = 0.01


class CaptionMla(Caption):
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, device,
                 control: str | None = None):
        Driver.__init__(self, config, traffic, limits, seed, device, control)
        tr = traffic
        self.B, self.T = tr["batch"], tr["new_tokens"]
        self.size = tuple(tr["image_size"])
        self.next = False
        self.prompt = inputs.caption_prompt(config, tr, seed)
        v = config["vision_config"]
        self.n_visual = (v["image_size"] // v["patch_size"]) ** 2
        self.real = len(self.prompt) - 1 + self.n_visual
        self.tiles = 1
        ens = tr["ensemble"]
        self.caps, self.K = tuple(ens["voting_probs"]), len(ens["voting_probs"])
        r = seeds.rng(seed, seeds.CHECK, 0)
        half, n = self.B // 2, tr["check_rows"] // 2
        lo = r.choice(half, n, replace=False) if half else np.zeros(0, int)
        hi = half + r.choice(self.B - half, tr["check_rows"] - n, replace=False)
        self.rows = sorted(int(x) for x in np.concatenate([lo, hi]))
        self._steps = self._vote = None
        self.params = None

    def make_weights(self):
        # a program without this decoder fails here, before any weight is made
        from dropoutdecoding_tpu_torch.models import mla_moe  # noqa: F401
        from dropoutdecoding_tpu_torch.models.llava import LlavaParams

        self.tree = make_tree(self.config, self.seed, self.device)
        if self.control == "int8":
            round_int8_(self.tree["lm"])
        elif self.control is not None:
            raise ValueError(f"unknown control {self.control!r}")
        self.params = LlavaParams(self.tree["vision"], self.tree["projector"], self.tree["lm"])
        return self.params

    def reference(self) -> MlaMoeReference:
        if self.control is not None:  # the reference keeps the bf16 tree
            self.tree = self.params = None
            if torch.device(self.device).type == "cuda":
                torch.cuda.empty_cache()
            self.tree = make_tree(self.config, self.seed, self.device)
        return MlaMoeReference(self.config, self.tree)

    def flops(self, new_tokens):
        return counts_mla.caption_batch_flops(self.config, self.B, self.B * self.tiles, self.real,
                                              self.n_visual, new_tokens, self.K)

    # --- correct ---------------------------------------------------------------

    def _rerun(self, u):
        """The checked unit once more through an engine with eager forwards
        (its decode graphs off; on the card eager and replay give the same
        bits), its router recorded: (tokens, winners, routes), routes a list
        of (the program's experts [n, k], its choice scores [n, E]) of the
        checked rows, one a routed layer of each forward in order: the
        prefill's (n = R x S), then each step's unmasked forward (n = R) and
        its members' (n = R x K, row-major)."""
        from dropoutdecoding_tpu_torch.models import mla_moe

        eng = self._engine(self.params, self.T)
        eng._graphs = None
        rows = torch.as_tensor(self.rows, device=self.device)
        orig, log = mla_moe.route, []

        def route(cfg, lp, h):
            idx, w, choice = orig(cfg, lp, h)
            per = h.shape[0] // self.B
            sel = (rows[:, None] * per + torch.arange(per, device=h.device)).reshape(-1)
            log.append((idx[sel], choice[sel]))
            return idx, w, choice

        mla_moe.route = route
        try:
            state = eng.prefill(np.tile(self.prompt, (self.B, 1)), *self._images(u.index))
            winners = []
            tokens = eng.decode(state, winners).cpu().numpy()
        finally:
            mla_moe.route = orig
        return tokens, torch.stack(winners).cpu().numpy(), log

    @staticmethod
    def _judge(prog, ref, tol: float) -> tuple:
        """(picks the program made that the reference's own top-k lacks,
        rows whose picks the reference's scores cannot explain, the largest
        |program - reference| choice score, the largest allowance a row's
        picks need) of one routed layer: a set is explained where some
        scores within ``tol`` of the reference's (an expert) rank it first,
        i.e. each pick the reference lacks lies above each expert it has
        that the program lacks, less ``2 tol``."""
        (idx, choice), (ref_choice, own) = prog, ref
        ref_choice = ref_choice.double()
        err = float((choice.double().to(ref_choice.device) - ref_choice).abs().max())
        mine = torch.zeros_like(ref_choice, dtype=torch.bool).scatter_(1, idx.to(own.device), True)
        theirs = torch.zeros_like(mine).scatter_(1, own, True)
        extra, missing = mine & ~theirs, theirs & ~mine
        low = torch.where(extra, ref_choice, torch.inf).amin(-1)
        high = torch.where(missing, ref_choice, -torch.inf).amax(-1)
        need = ((high - low) / 2).clamp(min=0.0)  # rows with no extra pick need 0
        return int(extra.sum()), int((need > tol).sum()), err, float(need.max())

    def check(self, units) -> dict:
        u = units[int(seeds.rng(self.seed, seeds.CHECK, 1).integers(len(units)))]
        ens = self.traffic["ensemble"]
        t = self.config["text_config"]
        tokens, winners = u.out["tokens"], u.out["winners"]
        control = self.control is not None
        again, again_w, log = self._rerun(u)
        differ = int((again != tokens).sum() + (again_w != winners).sum())
        ref = self.reference()
        R, S, K = len(self.rows), self.real, self.K
        Lm = len(ref.layers) - t["first_k_dense_replace"]
        Smax = S + self.T
        dev = self.device
        cache = [(torch.zeros(R, Smax, t["kv_lora_rank"], device=dev),
                  torch.zeros(R, Smax, t["qk_rope_head_dim"], device=dev)) for _ in ref.layers]
        worst_kl, gaps, votes, contested, outvoted = 0.0, [], 0, 0, 0
        flips = picks = routes = 0
        score_err, need = 0.0, 0.0

        def experts(calls, rows_of):
            """The program's experts of ``calls`` (one a routed layer), each
            cut to ``rows_of``: the reference's ``routes``."""
            return [c[0][rows_of] for c in calls]

        def judge(calls, rows_of):
            """The program's choices of ``calls`` against the routing the
            reference recorded in its last call."""
            nonlocal flips, picks, routes, score_err, need
            for (idx, choice), theirs in zip(calls, ref.routing):
                f, n, e, a = self._judge((idx[rows_of], choice[rows_of]), theirs, ROUTE_ALLOWANCE)
                flips, routes, picks = flips + f, routes + n, picks + idx[rows_of].numel()
                score_err, need = max(score_err, e), max(need, a)

        prefill, log = log[:Lm], log[Lm:]
        epis, tables, pos0 = [], [], []
        for j, r in enumerate(self.rows):
            crops = inputs.image(self.config, self.seed, u.index * self.B + r, self.size, dev)
            emb, pos, n = ref.merge(self.prompt, ref.visual_tokens(crops, self.size))
            if emb.shape[0] != S:
                raise AssertionError(f"reference prompt {emb.shape[0]} tokens, program {S}")
            mine = slice(j * S, (j + 1) * S)
            hidden, rows = ref.forward(emb, experts(prefill, mine))
            judge(prefill, mine)
            for (cc, kc), (c, k) in zip(cache, rows):
                cc[j, :S], kc[j, :S] = c, k
            last = ref.logits(hidden[-1])
            vis = ref.logits(hidden[pos:pos + n])
            epis.append(epistemic(vis))
            tables.append(top_ids(vis, ens["topk"]))
            pos0.append(pos)
            worst_kl = max(worst_kl, kl(last, u.out["last_logits"][j]))
            gaps.append(gap(last, int(tokens[r, 0])))
            del hidden, rows, vis
        slot = torch.arange(Smax, device=dev)
        rows_t = torch.arange(R, device=dev)
        every = slice(None)
        for step in range(1, self.T):
            first, members, log = log[:Lm], log[Lm:2 * Lm], log[2 * Lm:]
            cur = S + step - 1
            x = ref.embed[torch.as_tensor(tokens[self.rows, step - 1], device=dev)].float()
            base = (slot < cur)[None].expand(R, Smax)
            pos = torch.full((R,), cur, device=dev)
            hist = [(c[:, :cur], k[:, :cur]) for c, k in cache]
            h0, _ = ref.step(x[:, None], pos, hist, base[:, None, :cur], experts(first, every))
            judge(first, every)
            argmax0 = ref.logits(h0[:, 0]).argmax(-1).tolist()
            masks = []
            for j, r in enumerate(self.rows):
                draws = [member_draws(self.seed, step, r, m, self.n_visual, dev) for m in range(K)]
                drops = drop_masks(epis[j], tables[j], argmax0[j], draws, self.caps,
                                   ens["mask_accumulate"], ens["prob_floor"])
                dslot = torch.zeros(K, Smax, dtype=torch.bool, device=dev)
                dslot[:, pos0[j]:pos0[j] + drops.shape[1]] = drops
                masks.append(base[j][None] & ~dslot)
            hk, new = ref.step(x[:, None].expand(R, K, x.shape[-1]), pos, hist,
                               torch.stack(masks)[..., :cur], experts(members, every))
            judge(members, every)
            lk = ref.logits(hk)  # [R, K, V]
            got = u.out["member_logits"][step - 1].to(dev)
            w = torch.as_tensor(winners[step - 1, self.rows], device=dev)
            for j, r in enumerate(self.rows):
                gaps.append(gap(lk[j, w[j]], int(tokens[r, step])))
                votes += vote_unexplained(lk[j], got[j], int(tokens[r, step]), int(w[j]))
                firsts = lk[j].argmax(-1).tolist()
                contested += len(set(firsts)) > 1
                outvoted += firsts.count(firsts[0]) < max(map(firsts.count, firsts))
            for (cc, kc), (c, k) in zip(cache, new):
                cc[:, cur], kc[:, cur] = c[rows_t, w], k[rows_t, w]
        print(f"[bench] routing: {flips} of {picks} of the program's picks (token, layer, pick) "
              f"on the checked rows are not the reference's own top-k; {routes} of "
              f"{picks // t['num_experts_per_tok']} rows' picks it cannot explain (the picks need "
              f"an allowance of {need:.3e}); choice scores off by {score_err:.3e} at most"
              f"{' (control)' if control else ''}", file=sys.stderr)
        print(f"[bench] reference votes: {contested} of {len(gaps) - R} contested, "
              f"member 0 outvoted in {outvoted}", file=sys.stderr)
        return self.checks({"logits_kl": worst_kl, "token_gap_mean": sum(gaps) / len(gaps),
                            "votes_unexplained": votes,
                            "routes_unexplained_pct": 100.0 * routes * t["num_experts_per_tok"] / picks,
                            "rerun_differs": differ})


DRIVER = CaptionMla
