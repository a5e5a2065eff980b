"""POPE questions, answered by their first token, in the POPE order
(``questions_per_image`` an image), through one of the program's two probe
paths:

- ``mode: batched``: ``probe`` over ``batch`` right-padded questions, the
  vision tower once for each image of the batch (``cli/pope_test.py``
  ``answer_batch``); a unit is a batch;
- ``mode: prefix``: ``probe_prefix`` of an image's shared prompt start, then
  one ``probe_extend`` of its questions' tails padded to a multiple of 8 rows
  (``answer_prefix_cached``); a unit is an image.

The mix's keys: ``mode``, ``batch`` (batched only), ``questions_per_image``,
``object_tokens``, ``image_size`` [h, w], ``prompt`` {``pre``,
``image_pos``, ``head``, ``rest``}, ``pad_to``.

``correct``: one finished unit drawn from the seed; the reference runs each
of its questions whole (prompt and image, no cache, no padding).  Compared:
the KL divergence of the program's first-token logits from the reference's
(the widest over the questions), and the answers that the program's own
logit error cannot explain (exact: an answer served as the best of the
program's logits never counts, whatever their rounding).
"""
from __future__ import annotations

import numpy as np

from .. import counts, inputs, seeds
from ..reference.anyres import image_geometry
from .base import Driver, Unit, kl, span, sync, unexplained


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad(rows: list, multiple: int, min_rows: int = 1):
    """Id rows right-padded -> (ids [Q, S], lens [Q]): Q the rows, at least
    ``min_rows`` (pad rows of length 1), S the longest row rounded up to
    ``multiple``."""
    S = _round_up(max(len(r) for r in rows), multiple)
    Q = max(len(rows), min_rows)
    ids = np.zeros((Q, S), np.int64)
    lens = np.ones(Q, np.int64)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        lens[i] = len(r)
    return ids, lens


class Pope(Driver):
    work_name = "pope_answers_per_s"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        tr, cfg = self.traffic, self.config
        self.q = inputs.Questions(cfg, tr, self.seed)
        self.per_image = tr["questions_per_image"]
        self.prefix_mode = tr["mode"] == "prefix"
        self.batch = self.per_image if self.prefix_mode else tr["batch"]
        self.size = tuple(tr["image_size"])
        self.geo = image_geometry(self.size, cfg)
        self.n_visual = self.geo["n_tokens"]
        self.dims = counts.Dims.of(cfg)

    def setup(self):
        from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
        from dropoutdecoding_tpu_torch.utils.config import GenerationConfig

        from .base import program_config

        if self.config["family"] != "llavanext":
            raise ValueError("the POPE drivers run LLaVA-NeXT configurations")
        self.engine = LlavaNextEngine(
            program_config(self.config), self.make_weights(),
            gen=GenerationConfig(max_new_tokens=1), max_len=self.config["kv_capacity"],
            seed=self.seed, ensemble=False,
        )
        self._unit(-1, None)  # every shape of the mix
        sync(self.device)

    def questions(self, i) -> list:
        return list(range(i * self.batch, (i + 1) * self.batch))

    def _image(self, index):
        return inputs.image(self.config, self.seed, index, self.size, self.device)

    def _unit(self, i, spans):
        if i < 0:  # warm-up: questions no unit of the window asks
            qs = [q + (1 << 40) for q in self.questions(0)]
        else:
            qs = self.questions(i)
        if self.prefix_mode:
            return self._prefix_unit(qs, spans)
        return self._batched_unit(qs, spans)

    def _batched_unit(self, qs, spans):
        images = sorted({self.q.image_of(q) for q in qs})
        index = [images.index(self.q.image_of(q)) for q in qs]
        ids, lens = pad([self.q.prompt(q) for q in qs], self.traffic["pad_to"])
        with span(spans, "probe"):
            res = self.engine.probe(ids, [self._image(m) for m in images],
                                    [self.size] * len(images), text_lens=lens, image_index=index)
        answers = res.first_token.tolist()  # the unit's host read
        reals = [int(n) - 1 + self.n_visual for n in lens]
        tiles = len(images) * self.geo["n_tiles"]
        flops = counts.probe_flops(self.dims, reals, tiles)
        return answers, res.last_logits.float().cpu(), flops, {"reals": reals, "tiles": tiles}

    def _prefix_unit(self, qs, spans):
        image = self.q.image_of(qs[0])
        tails = [self.q.tail(q) for q in qs]
        tail_ids, lens = pad(tails, self.traffic["pad_to"], _round_up(len(tails), self.traffic["pad_to"]))
        prefix = self.q.prefix[None]
        with span(spans, "prefix"):
            handle = self.engine.probe_prefix(prefix, self._image(image), self.size)
        with span(spans, "extend"):
            res = self.engine.probe_extend(handle, tail_ids, lens)
        answers = res.first_token[: len(qs)].tolist()  # the unit's host read
        p_real = prefix.shape[1] - 1 + self.n_visual
        t = [len(x) for x in tails]
        flops = counts.prefix_probe_flops(self.dims, p_real, t, self.geo["n_tiles"])
        return answers, res.last_logits[: len(qs)].float().cpu(), flops, {
            "prefix": p_real, "tails": t, "tiles": self.geo["n_tiles"]}

    def unit(self, i, spans=None) -> Unit:
        answers, logits, flops, _ = self._unit(i, spans)
        return Unit(i, len(answers), len(answers), flops, {"answers": answers, "logits": logits})

    def traced_unit(self, i):
        """One unit, and its sizes, from which the roofline readers count
        its operations' work (``counts.py``): the batched probe's rows of
        real tokens, or the prefix's real tokens and the question tails."""
        return self._unit(i, None)[3]

    def release(self):
        self.engine = None

    def check(self, units) -> dict:
        u = units[int(seeds.rng(self.seed, seeds.CHECK, 1).integers(len(units)))]
        ref = self.reference()
        worst = {"logits_kl": 0.0, "answers_unexplained": 0}
        visual = {}
        for j, q in enumerate(self.questions(u.index)):
            m = self.q.image_of(q)
            if m not in visual:
                visual[m] = ref.visual_tokens(self._image(m), self.size)
            emb, _, _ = ref.merge(self.q.prompt(q), visual[m])
            hidden, _ = ref.forward(emb)
            last = ref.logits(hidden[-1])
            del hidden
            got, served = u.out["logits"][j], int(u.out["answers"][j])
            worst["logits_kl"] = max(worst["logits_kl"], kl(last, got))
            worst["answers_unexplained"] += unexplained(last, got, served)
        return self.checks(worst)


DRIVER = Pope
