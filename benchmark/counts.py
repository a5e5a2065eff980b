"""Operations and bytes of the work a cell asks for, from the configuration's
shapes alone: the numerators of every ``mfu`` and ``*_roofline`` metric.

A multiply-add is two operations.  Attention counts 4·Dh·H operations a
(query, key) pair: QKᵀ and PV.  Only what the inputs need is counted: the
real tokens of a padded prompt, each byte of a read-once operand once.
"""
from __future__ import annotations

from dataclasses import dataclass

BF16 = 2  # bytes an element of the served dtype
MASK = 1  # bytes a bool key-mask element


@dataclass(frozen=True)
class Dims:
    """The sizes the counts need, from a configuration file."""

    D: int  # LM hidden
    I: int  # LM FFN
    L: int  # LM layers
    H: int  # query heads
    KH: int  # KV heads
    Dh: int  # head size
    V: int  # vocabulary
    Dv: int  # vision hidden
    Iv: int  # vision FFN
    Lv: int  # vision layers run (to the feature layer)
    patch: int
    image: int  # vision input size, px

    @property
    def patches(self) -> int:
        return (self.image // self.patch) ** 2

    @classmethod
    def of(cls, config: dict) -> "Dims":
        t, v = config["text_config"], config["vision_config"]
        layer = config.get("vision_feature_layer", -2)
        lv = v["num_hidden_layers"] + 1 + layer if layer < 0 else layer
        return cls(
            D=t["hidden_size"], I=t["intermediate_size"], L=t["num_hidden_layers"],
            H=t["num_attention_heads"], KH=t["num_key_value_heads"], Dh=t["head_dim"],
            V=t["vocab_size"], Dv=v["hidden_size"], Iv=v["intermediate_size"], Lv=lv,
            patch=v["patch_size"], image=v["image_size"],
        )


# --- the language model ------------------------------------------------------


def lm_token_flops(d: Dims) -> int:
    """The projections of one token through every layer: q, k, v, o, gate,
    up, down."""
    q, kv = d.H * d.Dh, d.KH * d.Dh
    return 2 * d.L * (d.D * q + 2 * d.D * kv + q * d.D + 3 * d.D * d.I)


def head_flops(d: Dims, rows: int) -> int:
    """``rows`` hidden rows through the LM head."""
    return 2 * rows * d.D * d.V


def attn_pair_flops(d: Dims, pairs: int) -> int:
    """(query, key) ``pairs`` in every layer, QKᵀ and PV over all heads."""
    return 4 * d.Dh * d.H * pairs * d.L


def causal_pairs(real: int) -> int:
    """Pairs a causal mask leaves among ``real`` tokens."""
    return real * (real + 1) // 2


# --- the vision tower and the projector ----------------------------------------


def vision_flops(d: Dims, tiles: int) -> int:
    """CLIP over ``tiles`` crops to the feature layer, then the 2-layer
    projector over the patch rows (CLS dropped)."""
    T = d.patches + 1
    embed = 2 * d.patches * (3 * d.patch * d.patch) * d.Dv
    layer = 2 * T * 4 * d.Dv * d.Dv + 2 * T * 2 * d.Dv * d.Iv + 4 * T * T * d.Dv
    proj = 2 * d.patches * (d.Dv * d.D + d.D * d.D)
    return tiles * (embed + d.Lv * layer + proj)


# --- one work unit of each driver ------------------------------------------------


def prefill_flops(d: Dims, real: int, visual: int) -> int:
    """The LM prefill of one prompt of ``real`` merged tokens that keeps the
    visual-token logits (``visual`` rows) for the uncertainty, and its last
    position's logits."""
    return (real * lm_token_flops(d) + attn_pair_flops(d, causal_pairs(real))
            + head_flops(d, visual + 1))


def exact_step_flops(d: Dims, rows: int, members: int, filled: int) -> int:
    """One exact Dropout Decoding step of ``rows`` rows: the unmasked
    forward and the ``members`` masked ones, (1 + members)·rows decode rows,
    each over the ``filled`` cache slots and its own key.  The members' drop
    masks are not subtracted (at most the visual span's share of a row's
    keys)."""
    r = rows * (1 + members)
    return r * (lm_token_flops(d) + attn_pair_flops(d, filled + 1)) + head_flops(d, r)


def caption_batch_flops(d: Dims, rows: int, tiles: int, real: int, visual: int,
                        new_tokens: int, members: int) -> int:
    """A caption batch: the towers, ``rows`` prefills of ``real`` tokens, and
    ``new_tokens - 1`` exact steps (the first token comes from the
    prefill)."""
    steps = sum(exact_step_flops(d, rows, members, real + s) for s in range(new_tokens - 1))
    return vision_flops(d, tiles) + rows * prefill_flops(d, real, visual) + steps


def probe_flops(d: Dims, reals: list, tiles: int) -> int:
    """A batched POPE probe: the towers over ``tiles`` crops, each row's
    ``real`` tokens with causal attention, one logits row each."""
    return vision_flops(d, tiles) + sum(
        r * lm_token_flops(d) + attn_pair_flops(d, causal_pairs(r)) for r in reals
    ) + head_flops(d, len(reals))


def extend_pairs(prefix: int, tail: int) -> int:
    """Pairs of a tail of ``tail`` tokens over a ``prefix``: every tail token
    attends the whole prefix and causally the tail."""
    return tail * prefix + causal_pairs(tail)


def prefix_probe_flops(d: Dims, prefix: int, tails: list, tiles: int) -> int:
    """One image's prefix prefill of ``prefix`` real tokens (K/V kept, no
    logits), then its question ``tails`` over it, one logits row each."""
    pre = prefix * lm_token_flops(d) + attn_pair_flops(d, causal_pairs(prefix))
    ext = sum(t * lm_token_flops(d) + attn_pair_flops(d, extend_pairs(prefix, t)) for t in tails)
    return vision_flops(d, tiles) + pre + ext + head_flops(d, len(tails))


# --- single operations: the roofline numerators ------------------------------------


def decode_attn_bytes(d: Dims, rows: int, members: int, filled: int, slots: int) -> int:
    """One decode-attention call of one layer (K1): each row's K and V of its
    ``filled`` slots once, the queries, the members' own K/V, the key masks
    over the ``slots`` allocated, the output."""
    cache = rows * filled * d.KH * d.Dh * 2 * BF16
    q_out = 2 * rows * members * d.H * d.Dh * BF16
    own = rows * members * d.KH * d.Dh * 2 * BF16
    return cache + q_out + own + rows * members * slots * MASK


def decode_attn_flops(d: Dims, rows: int, members: int, filled: int) -> int:
    """One call of one layer: every member over the filled slots and itself."""
    return 4 * d.Dh * d.H * rows * members * (filled + 1)


def exact_decode_attn(d: Dims, rows: int, members: int, real: int, new_tokens: int,
                      slots: int) -> tuple:
    """(operations, bytes) of K1's calls in a caption batch of ``rows``
    prompts of ``real`` tokens: in every layer of each of the
    ``new_tokens - 1`` exact steps, one call for the unmasked stream and one
    for the ``members``, over the slots filled so far."""
    flops = nbytes = 0
    for s in range(new_tokens - 1):
        for m in (1, members):
            flops += decode_attn_flops(d, rows, m, real + s)
            nbytes += decode_attn_bytes(d, rows, m, real + s, slots)
    return d.L * flops, d.L * nbytes


def flash_prefill_flops(d: Dims, reals: list) -> int:
    """One prefill-attention call of one layer (K5) over prompts of
    ``reals`` real tokens: their causal pairs.  A padded prompt's pad rows
    and pad keys answer nothing and are not counted."""
    return 4 * d.Dh * d.H * sum(causal_pairs(r) for r in reals)


def extend_attn_bytes(d: Dims, prefix: int, tails: list) -> int:
    """One extend-attention call of one layer: the shared prefix's real K/V
    once, each real tail token's q, k, v and output."""
    t = sum(tails)
    return (prefix * d.KH * d.Dh * 2 + t * (2 * d.H * d.Dh + 2 * d.KH * d.Dh)) * BF16


def extend_attn_flops(d: Dims, prefix: int, tails: list) -> int:
    return 4 * d.Dh * d.H * sum(extend_pairs(prefix, t) for t in tails)


def bound_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: operations over the bf16 peak or
    bytes over the bandwidth, whichever is longer."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])
