"""What every driver shares: the program built from a configuration and the
benchmark's weights, spans around the calls into it, and the numbers that
decide ``correct``."""
from __future__ import annotations

import contextlib
import itertools
import time
from collections import defaultdict
from typing import NamedTuple

import torch

from .. import weights as weights_mod
from ..reference.dropout import vote_ids
from ..reference.model import Reference


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Spans:
    """Host-clock spans around calls into the program, each closed by a
    device synchronise, and named ``record_function`` ranges for a trace.
    Off (``None`` in a driver) in a run that reports end-to-end metrics."""

    def __init__(self, device):
        self.device = device
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        sync(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        sync(self.device)
        self.seconds[name].append(time.perf_counter() - t0)


@contextlib.contextmanager
def span(spans: Spans | None, name: str):
    if spans is None:
        yield
    else:
        with spans(name):
            yield


class Unit(NamedTuple):
    index: int  # the unit's number from the window's start: its inputs' seed path
    work: int  # what the end-to-end rate counts: tokens, or answers
    requests: int  # the captions or questions it answered
    flops: int  # the operations the method needs for it (counts.py)
    out: dict  # the program's outputs kept for the check


def program_config(config: dict):
    """The program's configuration object of a configuration file."""
    from dropoutdecoding_tpu_torch.utils.config import LlavaConfig, LlavaNextConfig

    cls = LlavaNextConfig if config["family"] == "llavanext" else LlavaConfig
    return cls.from_hf_dict(config)


def program_params(config: dict, tree: dict, control: str | None):
    """The program's params over the benchmark's weight tree (the same
    tensors, no copy).  ``control="int8"``: the LM's projections and head
    through the program's own weight-only int8 tier (``--quantize int8``),
    the nearest precision below the configuration's bfloat16."""
    from dropoutdecoding_tpu_torch.models.llava import LlavaParams
    from dropoutdecoding_tpu_torch.models.llavanext import LlavaNextParams
    from dropoutdecoding_tpu_torch.utils.quantize import quantize_llama_params

    lm = tree["lm"]
    if control == "int8":
        lm = quantize_llama_params(lm)
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    if config["family"] == "llavanext":
        return LlavaNextParams(tree["vision"], tree["projector"], tree["image_newline"], lm)
    return LlavaParams(tree["vision"], tree["projector"], lm)


class Driver:
    """The parts of a driver that do not depend on the entry point."""

    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int, device,
                 control: str | None = None):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device, self.control = seed, device, control
        self.tree = None

    def make_weights(self):
        self.tree = weights_mod.make(config=self.config, seed=self.seed, device=self.device)
        return program_params(self.config, self.tree, self.control)

    def reference(self) -> Reference:
        return Reference(self.config, self.tree)

    def checks(self, values: dict) -> dict:
        """{name: {"value", "limit"}} of the compared numbers."""
        return {k: {"value": float(v), "limit": float(self.limits[k])} for k, v in values.items()}


def gap(ref_logits: torch.Tensor, token: int) -> float:
    """How far the served ``token``'s reference logit lies below the
    reference's best, as a share of the largest reference logit's size."""
    ref = ref_logits.float()
    return float((ref.max() - ref[token]) / ref.abs().max())


def kl(ref_logits: torch.Tensor, got_logits: torch.Tensor) -> float:
    """KL(softmax(reference) || softmax(program)) of one row's logits, in
    nats: it grows with the square of the program's error."""
    ref = torch.log_softmax(ref_logits.double(), -1)
    got = torch.log_softmax(got_logits.double().to(ref.device), -1)
    return float((ref.exp() * (ref - got)).sum())


def unexplained(ref_logits: torch.Tensor, got_logits: torch.Tensor, served: int) -> int:
    """1 where the served token lies further below the reference's best than
    the program's own logit error at the two can explain: a token served as
    the best of the program's logits never does, whatever their rounding."""
    ref, got = ref_logits.double(), got_logits.double().to(ref_logits.device)
    top = int(ref.argmax())
    err = (got[top] - ref[top]).abs() + (got[served] - ref[served]).abs()
    return int(ref[top] - ref[served] > err)


def vote_unexplained(ref_members: torch.Tensor, got_members: torch.Tensor, served: int,
                     winner: int) -> int:
    """1 where no vote that the program's own logit error allows serves
    ``served`` from member ``winner``.  Each of the K members may put first
    any token that lies below the reference's best by no more than the
    program's error at the two (``unexplained``'s rule); the vote
    (``reference.dropout.vote_ids``) serves the token most members put
    first, from the first member that did.  A sound vote over the program's
    logits never counts, whatever their rounding: each member's own first is
    among those it may put first."""
    ref = ref_members.double()
    err = (got_members.double().to(ref.device) - ref).abs()
    top = ref.argmax(-1, keepdim=True)
    allowed = (ref.gather(-1, top) - ref) <= err.gather(-1, top) + err  # [K, V]
    K = ref.shape[0]
    options = []
    for k in range(K):
        ids = torch.nonzero(allowed[k]).flatten().tolist()
        # ``served`` where allowed, and up to K others: enough that the
        # others can be told apart, which is all a vote for ``served`` wants
        # of them (alike, they could only outvote it)
        others = [i for i in ids if i != served][:K]
        options.append(([served] if served in ids else []) + others)
    return int(not any(vote_ids(list(a)) == (winner, served) for a in itertools.product(*options)))
