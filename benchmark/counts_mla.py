"""Operations and bytes of the Kimi-VL-A3B cell's work (a DeepSeek-V3-style
decoder: latent attention, routed experts), from the configuration's shapes
alone: the numerators of ``mfu.caption`` and ``moe_decode_roofline`` there.

A multiply-add is two operations.  Only the active parameters count: of a
routed layer, the router, the ``num_experts_per_tok`` chosen experts and the
shared experts.  Attention counts the form the program runs: the prefill's
decompressed heads (QK over 192 dims, PV over 128, a (query, key) pair),
the decode's absorbed heads (QK over 576, PV over 512, and the two
absorption products a row).  The towers are ``counts.py``'s.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import counts

BF16, F32 = 2, 4


@dataclass(frozen=True)
class MlaDims:
    D: int  # hidden
    V: int  # vocabulary
    L: int  # layers
    Ld: int  # leading dense layers
    H: int  # heads
    dn: int  # q / k no-rope dims a head
    dr: int  # rope dims
    dv: int  # v dims a head
    R: int  # latent (kv_lora_rank)
    I: int  # dense FFN
    Ie: int  # a routed expert's FFN
    Is: int  # the shared experts' FFN
    E: int  # routed experts
    k: int  # experts a token

    @property
    def Lm(self) -> int:
        return self.L - self.Ld

    @classmethod
    def of(cls, config: dict) -> "MlaDims":
        t = config["text_config"]
        return cls(
            D=t["hidden_size"], V=t["vocab_size"], L=t["num_hidden_layers"],
            Ld=t["first_k_dense_replace"], H=t["num_attention_heads"], dn=t["qk_nope_head_dim"],
            dr=t["qk_rope_head_dim"], dv=t["v_head_dim"], R=t["kv_lora_rank"],
            I=t["intermediate_size"], Ie=t["moe_intermediate_size"],
            Is=t["moe_intermediate_size"] * t["n_shared_experts"], E=t["n_routed_experts"],
            k=t["num_experts_per_tok"],
        )


def vision_dims(config: dict) -> counts.Dims:
    """The tower's and projector's sizes as ``counts.vision_flops`` reads them."""
    v, t = config["vision_config"], config["text_config"]
    layer = config.get("vision_feature_layer", -2)
    return counts.Dims(
        D=t["hidden_size"], I=0, L=0, H=0, KH=0, Dh=0, V=0, Dv=v["hidden_size"],
        Iv=v["intermediate_size"], Lv=v["num_hidden_layers"] + 1 + layer if layer < 0 else layer,
        patch=v["patch_size"], image=v["image_size"],
    )


def token_flops(d: MlaDims) -> int:
    """One token's projections through every layer, active experts only."""
    attn = d.D * d.H * (d.dn + d.dr) + d.D * (d.R + d.dr) + d.R * d.H * (d.dn + d.dv) + d.H * d.dv * d.D
    dense = 3 * d.D * d.I
    routed = d.D * d.E + d.k * 3 * d.D * d.Ie + 3 * d.D * d.Is
    return 2 * (d.L * attn + d.Ld * dense + d.Lm * routed)


def prefill_pair_flops(d: MlaDims, pairs: int) -> int:
    """Decompressed attention over ``pairs`` (query, key) pairs, every layer."""
    return 2 * d.H * (d.dn + d.dr + d.dv) * pairs * d.L


def decode_row_flops(d: MlaDims, filled: int) -> int:
    """One decode row's absorbed attention over ``filled`` slots and itself,
    with its two absorption products, every layer."""
    absorb = 2 * d.H * d.R * (d.dn + d.dv)
    return (absorb + 2 * d.H * (2 * d.R + d.dr) * (filled + 1)) * d.L


def head_flops(d: MlaDims, rows: int) -> int:
    return 2 * rows * d.D * d.V


def caption_batch_flops(config: dict, rows: int, tiles: int, real: int, visual: int,
                        new_tokens: int, members: int) -> int:
    """A caption batch: the towers, ``rows`` prefills of ``real`` tokens that
    keep the visual-token logits, and ``new_tokens - 1`` exact steps of
    (1 + members) x rows decode rows."""
    d = MlaDims.of(config)
    prefill = real * token_flops(d) + prefill_pair_flops(d, counts.causal_pairs(real)) \
        + head_flops(d, visual + 1)
    r = rows * (1 + members)
    steps = sum(r * (token_flops(d) + decode_row_flops(d, real + s)) + head_flops(d, r)
                for s in range(new_tokens - 1))
    return counts.vision_flops(vision_dims(config), tiles) + rows * prefill + steps


def k7_forward(d: MlaDims, rows: int) -> tuple:
    """(operations, bytes) of K7 in one decode forward of ``rows`` rows: in
    each routed layer, rows x k assignments through the gated and the down
    product; the three matrices of all E experts once (a balanced router
    over 32 or more rows leaves few unread: PERF.md gives the share the cell
    leaves), the sorted rows in (bf16) and their outputs (fp32)."""
    a = rows * d.k
    weights = d.E * 3 * d.D * d.Ie * BF16
    return d.Lm * 2 * 3 * d.D * d.Ie * a, d.Lm * (weights + a * d.D * (BF16 + F32))


def k7_caption(d: MlaDims, rows: int, members: int, new_tokens: int) -> tuple:
    """(operations, bytes) of K7 in a caption batch's decode: each of the
    ``new_tokens - 1`` exact steps runs a forward of ``rows`` rows and one of
    ``rows x members``."""
    f1, b1 = k7_forward(d, rows)
    fk, bk = k7_forward(d, rows * members)
    n = new_tokens - 1
    return n * (f1 + fk), n * (b1 + bk)
