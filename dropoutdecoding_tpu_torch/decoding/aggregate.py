"""Ensemble aggregation: majority vote / logit averaging (port of
``dropoutdecoding_tpu/decoding/aggregate.py``), batched over leading axes.

Vote ties follow Python's ``Counter.most_common`` + first match: the winner
is the first member whose argmax token attains the highest count.
"""
from __future__ import annotations

import torch


def select_by_vote(member_logits: torch.Tensor):
    """Majority vote over members' last-token logits.

    Args:
      member_logits: [..., K, V]
    Returns:
      (winner [...], next_token [...]): the winning member's index and its
      argmax token id.
    """
    ids = member_logits.argmax(dim=-1)  # [..., K]; first max on ties
    counts = (ids[..., None, :] == ids[..., :, None]).sum(dim=-1)
    winner = counts.argmax(dim=-1)  # first member with the top count
    return winner, ids.gather(-1, winner[..., None])[..., 0]


def select_by_average(member_logits: torch.Tensor):
    """Logit averaging: member 0's K/V is the one propagated.

    Returns:
      (winner, all 0; next_token from the averaged logits).
    """
    avg = member_logits.float().mean(dim=-2)
    token = avg.argmax(dim=-1)
    return torch.zeros_like(token), token
