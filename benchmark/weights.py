"""Synthetic weights of a configuration, made on the device from ``--seed``.

One ``torch.Generator`` on the device draws every matrix in the served
dtype, a whole stacked leaf ([layers, in, out]) a call: normal(0,
``init_std``) matrices, embeddings and ``image_newline`` (the
configuration's key, 0.02 as the JAX package's ``init_params``), norm
weights 1, biases 0.  The
tree is laid out as the program reads its params (``x @ W``, W [in, out],
layers on a leading axis) and is handed unchanged to the program and to the
reference, which upcasts it: neither side makes weights of its own.
"""
from __future__ import annotations

import torch

from . import seeds


def make(config: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{"vision", "projector", "lm"} (and "image_newline" for LLaVA-NeXT)."""
    gen = seeds.generator(device, seed, seeds.WEIGHTS)
    std = config["init_std"]

    def nrm(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    v, t = config["vision_config"], config["text_config"]
    Dv, Iv, Lv, P = v["hidden_size"], v["intermediate_size"], v["num_hidden_layers"], v["patch_size"]
    positions = (v["image_size"] // P) ** 2 + 1
    vision = {
        "class_embedding": nrm(Dv),
        "patch_embedding": nrm(3 * P * P, Dv),
        "position_embedding": nrm(positions, Dv),
        "pre_ln_w": ones(Dv),
        "pre_ln_b": zeros(Dv),
        "layers": {
            "ln1_w": ones(Lv, Dv), "ln1_b": zeros(Lv, Dv),
            "ln2_w": ones(Lv, Dv), "ln2_b": zeros(Lv, Dv),
            "q_w": nrm(Lv, Dv, Dv), "q_b": zeros(Lv, Dv),
            "k_w": nrm(Lv, Dv, Dv), "k_b": zeros(Lv, Dv),
            "v_w": nrm(Lv, Dv, Dv), "v_b": zeros(Lv, Dv),
            "out_w": nrm(Lv, Dv, Dv), "out_b": zeros(Lv, Dv),
            "fc1_w": nrm(Lv, Dv, Iv), "fc1_b": zeros(Lv, Iv),
            "fc2_w": nrm(Lv, Iv, Dv), "fc2_b": zeros(Lv, Dv),
        },
    }
    D, I, L = t["hidden_size"], t["intermediate_size"], t["num_hidden_layers"]
    H, KH, Dh, V = t["num_attention_heads"], t["num_key_value_heads"], t["head_dim"], t["vocab_size"]
    projector = {"fc1_w": nrm(Dv, D), "fc1_b": zeros(D), "fc2_w": nrm(D, D), "fc2_b": zeros(D)}
    lm = {
        "embed_tokens": nrm(V, D),
        "layers": {
            "input_ln": ones(L, D),
            "post_attn_ln": ones(L, D),
            "q_proj": nrm(L, D, H * Dh),
            "k_proj": nrm(L, D, KH * Dh),
            "v_proj": nrm(L, D, KH * Dh),
            "o_proj": nrm(L, H * Dh, D),
            "gate_proj": nrm(L, D, I),
            "up_proj": nrm(L, D, I),
            "down_proj": nrm(L, I, D),
        },
        "norm": ones(D),
        "lm_head": nrm(D, V),
    }
    tree = {"vision": vision, "projector": projector, "lm": lm}
    if config["family"] == "llavanext":
        tree["image_newline"] = nrm(D)
    return tree
