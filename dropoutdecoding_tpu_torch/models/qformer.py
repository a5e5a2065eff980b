"""InstructBLIP's Q-Former: a BERT encoder over [query tokens ‖ instruction
tokens], whose query slice cross-attends to the vision tower's output every
``cross_attention_frequency`` layers; port of
``dropoutdecoding_tpu/models/qformer.py``.

The layers are not all alike, so ``params["layers"]`` is a list of dicts:

- only layer i with ``i % cross_attention_frequency == 0`` has ``cross_*``
  weights and runs cross-attention (its query slice only);
- the query and the text slices have feed-forward branches of their own
  (``interq`` / ``outq`` and ``inter`` / ``out``), and the text branch is
  skipped when there is no instruction text (T = 0);
- self-attention masks the instruction's pads with -1e30 (the query tokens
  always attend); cross-attention masks nothing.

The output is the query slice [B, Q, D], the 32 visual tokens before their
projection to the LM's width.  Plain torch, as it is plain XLA in the JAX
package: it runs once a prefill, not a step.
"""
from __future__ import annotations

import math

import torch

from ..ops.basic import act_fn, layer_norm
from ..utils.config import QFormerConfig
from ..utils.hf_io import hf_leaf

_NEG = -1e30


def _mha(q_in, kv_in, lp: dict, prefix: str, num_heads: int, mask=None) -> torch.Tensor:
    """BERT attention (JAX ``models/qformer.py:22``): fp32 scores over
    sqrt(head dim), pads at -1e30, fp32 softmax, probabilities rounded to the
    value dtype before PV."""
    B, Sq, _ = q_in.shape
    Sk = kv_in.shape[1]
    E = lp[f"{prefix}_q_w"].shape[-1]
    Dh = E // num_heads
    q = (q_in @ lp[f"{prefix}_q_w"] + lp[f"{prefix}_q_b"]).reshape(B, Sq, num_heads, Dh)
    k = (kv_in @ lp[f"{prefix}_k_w"] + lp[f"{prefix}_k_b"]).reshape(B, Sk, num_heads, Dh)
    v = (kv_in @ lp[f"{prefix}_v_w"] + lp[f"{prefix}_v_b"]).reshape(B, Sk, num_heads, Dh)
    # divided, as JAX divides (on CUDA torch multiplies by the fp32
    # reciprocal: an ulp apart at most, and no host-to-device copy a call)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(Dh)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], _NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q_in.dtype).reshape(B, Sq, E)


def apply(
    cfg: QFormerConfig,
    params: dict,
    input_ids: torch.Tensor,
    image_embeds: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Run the Q-Former (JAX ``models/qformer.py:43``).

    Args:
      input_ids: [B, T] instruction ids in the Q-Former's (BERT) vocabulary,
        all below ``cfg.vocab_size``.
      image_embeds: [B, P, D_enc] the vision tower's last hidden state.
      attention_mask: optional [B, T] instruction mask (1 = a real token).
    Returns:
      [B, num_query_tokens, D] the query outputs.
    """
    B, T = input_ids.shape
    Q, eps, H = cfg.num_query_tokens, cfg.layer_norm_eps, cfg.num_attention_heads
    act = act_fn("gelu")
    text = params["word_embeddings"][input_ids] + params["position_embeddings"][None, :T]
    queries = params["query_tokens"][None].expand(B, Q, text.shape[-1])
    x = layer_norm(torch.cat([queries, text], dim=1), params["emb_ln_w"], params["emb_ln_b"], eps)
    text_mask = (
        torch.ones((B, T), dtype=torch.bool, device=x.device) if attention_mask is None
        else attention_mask.bool()
    )
    self_mask = torch.cat([torch.ones((B, Q), dtype=torch.bool, device=x.device), text_mask], 1)
    for i, lp in enumerate(params["layers"]):
        a = _mha(x, x, lp, "self", H, mask=self_mask)
        x = layer_norm(a @ lp["self_out_w"] + lp["self_out_b"] + x, lp["self_ln_w"],
                       lp["self_ln_b"], eps)
        q_part, t_part = x[:, :Q], x[:, Q:]
        if i % cfg.cross_attention_frequency == 0:
            c = _mha(q_part, image_embeds, lp, "cross", H)
            q_part = layer_norm(c @ lp["cross_out_w"] + lp["cross_out_b"] + q_part,
                                lp["cross_ln_w"], lp["cross_ln_b"], eps)
        fq = act(q_part @ lp["interq_w"] + lp["interq_b"]) @ lp["outq_w"] + lp["outq_b"]
        q_part = layer_norm(fq + q_part, lp["outq_ln_w"], lp["outq_ln_b"], eps)
        if T > 0:
            ft = act(t_part @ lp["inter_w"] + lp["inter_b"]) @ lp["out_w"] + lp["out_b"]
            t_part = layer_norm(ft + t_part, lp["out_ln_w"], lp["out_ln_b"], eps)
        x = torch.cat([q_part, t_part], dim=1)
    return x[:, :Q]


# (our name, HF module under "encoder.layer.{i}.") of every layer's linear
# and LayerNorm modules, and of the cross-attention layers' besides
_LINEARS = [
    ("self_q", "attention.attention.query"),
    ("self_k", "attention.attention.key"),
    ("self_v", "attention.attention.value"),
    ("self_out", "attention.output.dense"),
    ("interq", "intermediate_query.dense"),
    ("outq", "output_query.dense"),
    ("inter", "intermediate.dense"),
    ("out", "output.dense"),
]
_NORMS = [
    ("self_ln", "attention.output.LayerNorm"),
    ("outq_ln", "output_query.LayerNorm"),
    ("out_ln", "output.LayerNorm"),
]
_CROSS_LINEARS = [
    ("cross_q", "crossattention.attention.query"),
    ("cross_k", "crossattention.attention.key"),
    ("cross_v", "crossattention.attention.value"),
    ("cross_out", "crossattention.output.dense"),
]
_CROSS_NORMS = [("cross_ln", "crossattention.output.LayerNorm")]


def hf_layer_leaves(cfg: QFormerConfig, i: int) -> list:
    """[(our key, HF name under ``qformer.``, transpose)] of layer ``i``'s
    leaves: a linear's weight is transposed ([out, in] -> [in, out]); the
    cross-attention leaves only where layer ``i`` runs it."""
    linears, norms = list(_LINEARS), list(_NORMS)
    if i % cfg.cross_attention_frequency == 0:
        linears += _CROSS_LINEARS
        norms += _CROSS_NORMS
    base = f"encoder.layer.{i}."
    out = []
    for ours, hf in linears:
        out += [(f"{ours}_w", f"{base}{hf}.weight", True), (f"{ours}_b", f"{base}{hf}.bias", False)]
    for ours, hf in norms:
        out += [(f"{ours}_w", f"{base}{hf}.weight", False), (f"{ours}_b", f"{base}{hf}.bias", False)]
    return out


def params_from_hf(
    cfg: QFormerConfig,
    sd: dict,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
    prefix: str = "qformer.",
) -> dict:
    """An HF InstructBLIP state dict -> the Q-Former's params on ``device`` in
    ``dtype`` (JAX ``models/qformer.py:111``), with ``query_tokens`` (a
    top-level HF parameter).  Every leaf a layer must have is read by name,
    so a missing one raises ``KeyError`` naming it; the cross-attention
    leaves of layer i are read exactly where it runs cross-attention, and a
    layer that does not run it but has them in ``sd`` raises too (the
    checkpoint's ``cross_attention_frequency`` is another)."""

    def leaf(name, transpose=False):
        return hf_leaf(sd, prefix + name, dtype, device, transpose)

    layers = []
    for i in range(cfg.num_hidden_layers):
        stray = f"{prefix}encoder.layer.{i}.crossattention."
        if i % cfg.cross_attention_frequency and any(k.startswith(stray) for k in sd):
            raise ValueError(
                f"{stray}* is in the checkpoint, but with cross_attention_frequency="
                f"{cfg.cross_attention_frequency} layer {i} runs none"
            )
        layers.append({ours: leaf(name, transpose) for ours, name, transpose in hf_layer_leaves(cfg, i)})
    return {
        "word_embeddings": leaf("embeddings.word_embeddings.weight"),
        "position_embeddings": leaf("embeddings.position_embeddings.weight"),
        "emb_ln_w": leaf("embeddings.layernorm.weight"),
        "emb_ln_b": leaf("embeddings.layernorm.bias"),
        "query_tokens": hf_leaf(sd, "query_tokens", dtype, device).reshape(cfg.num_query_tokens, -1),
        "layers": layers,
    }
