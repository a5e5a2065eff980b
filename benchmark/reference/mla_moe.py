"""Kimi-VL-A3B's decoder (DeepSeek-V3-style: latent attention, sigmoid-routed
experts) behind the LLaVA-1.5 tower, in fp32 with TF32 off, from the
published DeepseekV3 modeling code's equations:

- attention, decompressed: ``q = x Wq`` [nope 128 | rope 64] a head;
  ``[c | k_pe] = x W_kv_a``; ``c = RMSNorm(c)`` (eps 1e-6, the module's
  default); ``[k_nope | v] = c W_kv_b`` a head; RoPE on ``q_pe`` and the
  shared ``k_pe`` after the published de-interleave of the rotary dims;
  softmax scale 192^-0.5; ``o_proj``;
- MLP: layer 0 a SiLU-gated MLP; every other layer routes: fp32 logits,
  ``s = sigmoid``, the top-k of ``s + e_score_correction_bias``, weights
  ``s[idx] / (sum + 1e-20) * routed_scaling_factor``, the chosen experts'
  SwiGLU summed with them, plus the shared experts' MLP.

One sequence at a time, with no cache layout: ``forward`` runs an unpadded
causal sequence and hands back each layer's normalised latent and roped
key; ``step`` runs M masked streams a row over those earlier rows, each
decompressed again.  The bf16 tree (32 GB) and an fp32 copy of the whole
model (64 GB) do not fit one card together, so a layer's weights are upcast
when it runs, and of the experts only those the routing chose; the tower,
the projector and the head are upcast once.

For the comparison, ``forward`` and ``step`` take the program's expert
choices (``routes``, [rows, k] a routed layer): the experts then are the
program's, their weights the reference's own (its sigmoid scores of the
chosen experts), so that a near-tie that bf16 broke otherwise does not
carry a different expert through every later layer.  ``routing`` records,
a routed layer of the last call, the reference's own choice scores
(sigmoid + bias, [rows, E]) and its own top-k, against which the program's
choices are judged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .model import Reference, _f32, _rms_norm, fp32_matmuls

KV_A_NORM_EPS = 1e-6
ROUTE_EPS = 1e-20


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """The published ``apply_rotary_pos_emb`` on x [..., S, heads, d] at
    integer positions pos [..., S]: the dims de-interleaved ([2i, 2i+1] ->
    [evens | odds]), then rotated by halves."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = pos.to(torch.float64)[..., None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[..., None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[..., None, :]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + rot * sin


def _swiglu(x, gate, up, down):
    return (F.silu(x @ gate.float()) * (x @ up.float())) @ down.float()


class MlaMoeReference(Reference):
    """fp32 forward passes of a ``deepseek_v3`` text config behind the
    LLaVA-1.5 tower; weights as the benchmark made them ([in, out], layers
    stacked; ``lm["moe"]`` the routed layers' leaves)."""

    def __init__(self, config: dict, weights: dict):
        fp32_matmuls()
        self.config = config
        self.t, self.v = config["text_config"], config["vision_config"]
        self.vision = _f32(weights["vision"])
        self.projector = _f32(weights["projector"])
        self.newline = None
        lm = weights["lm"]
        self.lm = lm
        self.embed = lm["embed_tokens"]  # bf16: rows upcast where read
        self.norm = lm["norm"].float()
        self.head_w = lm["lm_head"].float()
        self.layers = range(self.t["num_hidden_layers"])
        self.routing = []

    def merge(self, ids, visual: torch.Tensor) -> tuple:
        ids = torch.as_tensor(ids, dtype=torch.long, device=visual.device)
        pos = int((ids == self.config["image_token_index"]).nonzero()[0, 0])
        text = self.embed[torch.where(ids == self.config["image_token_index"], 0, ids)].float()
        return torch.cat([text[:pos], visual, text[pos + 1:]]), pos, visual.shape[0]

    # --- one layer's weights, upcast when it runs -----------------------------------

    def _attn_weights(self, i: int) -> dict:
        return {k: w[i].float() for k, w in self.lm["layers"].items()}

    def _mlp(self, i: int, h: torch.Tensor, routes) -> torch.Tensor:
        """The layer's MLP of rows h [N, D]; ``routes`` the program's choices
        by routed layer, or None."""
        t = self.t
        Ld = t["first_k_dense_replace"]
        if i < Ld:
            d = self.lm["dense"]
            return _swiglu(h, d["gate_proj"][i], d["up_proj"][i], d["down_proj"][i])
        m, j = self.lm["moe"], i - Ld
        scores = torch.sigmoid(h @ m["router"][j].float())
        k = t["num_experts_per_tok"]
        choice = scores + m["router_bias"][j].float()
        own = torch.topk(choice, k, dim=-1).indices
        self.routing.append((choice, own))
        idx = own if routes is None else routes[j].to(own.device)
        w = scores.gather(1, idx)
        if t["norm_topk_prob"]:
            w = w / (w.sum(-1, keepdim=True) + ROUTE_EPS)
        w = w * t["routed_scaling_factor"]
        y = torch.zeros_like(h)
        for e in torch.unique(idx).tolist():
            tok, slot = (idx == e).nonzero(as_tuple=True)
            out = _swiglu(h[tok], m["gate_proj"][j, e], m["up_proj"][j, e], m["down_proj"][j, e])
            y.index_add_(0, tok, out * w[tok, slot][:, None])
        return y + _swiglu(h, m["shared_gate_proj"][j], m["shared_up_proj"][j],
                           m["shared_down_proj"][j])

    def _heads(self):
        t = self.t
        return (t["num_attention_heads"], t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                t["v_head_dim"], t["kv_lora_rank"])

    def _project(self, lp, h, pos):
        """(q_nope, roped q_pe, normalised latent c, roped k_pe) of rows h
        [..., S, D] at positions pos [..., S]."""
        H, dn, dr, _, R = self._heads()
        q = (h @ lp["q_proj"]).unflatten(-1, (H, dn + dr))
        q_nope, q_pe = q.split([dn, dr], -1)
        c, k_pe = (h @ lp["kv_a_proj"]).split([R, dr], -1)
        c = _rms_norm(c, lp["kv_a_ln"], KV_A_NORM_EPS)
        theta = self.t["rope_theta"]
        return q_nope, _rope(q_pe, pos, theta), c, _rope(k_pe[..., None, :], pos, theta)[..., 0, :]

    def _decompress(self, lp, c):
        """(k_nope, v) [..., H, 128] each of latents c [..., 512]."""
        H, dn, _, dv, _ = self._heads()
        return (c @ lp["kv_b_proj"]).unflatten(-1, (H, dn + dv)).split([dn, dv], -1)

    def _scale(self) -> float:
        _, dn, dr, _, _ = self._heads()
        return 1.0 / math.sqrt(dn + dr)

    # --- the decoder ----------------------------------------------------------------

    def forward(self, x: torch.Tensor, routes=None):
        """One unpadded causal sequence [S, D] -> (final-norm hidden [S, D],
        per layer (c [S, 512], k_pe [S, 64])); ``routes``: the experts of
        each routed layer, [S, k], or None for the reference's own."""
        t = self.t
        S = x.shape[0]
        H, dn, dr, dv, _ = self._heads()
        pos = torch.arange(S, device=x.device)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        self.routing = []
        rows = []
        for i in self.layers:
            lp = self._attn_weights(i)
            h = _rms_norm(x, lp["input_ln"], t["rms_norm_eps"])
            q_nope, q_pe, c, k_pe = self._project(lp, h, pos)
            k_nope, v = self._decompress(lp, c)
            s = (torch.einsum("qhd,khd->hqk", q_nope, k_nope)
                 + torch.einsum("qhd,kd->hqk", q_pe, k_pe)) * self._scale()
            p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            x = x + torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * dv) @ lp["o_proj"]
            x = x + self._mlp(i, _rms_norm(x, lp["post_attn_ln"], t["rms_norm_eps"]), routes)
            rows.append((c, k_pe))
        return _rms_norm(x, self.norm, t["rms_norm_eps"]), rows

    def step(self, x: torch.Tensor, pos: torch.Tensor, cache: list, mask: torch.Tensor,
             routes=None):
        """One token of M streams a row over earlier rows.

        Args:
          x: [R, M, D] the rows' current-token embeddings, every stream alike.
          pos: [R] the token's position.
          cache: per layer (c [R, S, 512], k_pe [R, S, 64]) of earlier rows.
          mask: [R, M, S] bool, True = the stream attends that row; every
            stream attends its own token besides.
          routes: the experts of each routed layer, [R * M, k] (row-major),
            or None for the reference's own.
        Returns:
          (final-norm hidden [R, M, D], per layer (c, k_pe) [R, M, ...]).
        """
        t = self.t
        H, dn, dr, dv, _ = self._heads()
        R, M, D = x.shape
        p_ = pos[:, None].expand(R, M)
        self.routing = []
        out = []
        for i, (ch, kh) in zip(self.layers, cache):
            lp = self._attn_weights(i)
            h = _rms_norm(x, lp["input_ln"], t["rms_norm_eps"])
            q_nope, q_pe, c, k_pe = self._project(lp, h, p_)
            k_old, v_old = self._decompress(lp, ch)  # [R, S, H, 128]
            k_new, v_new = self._decompress(lp, c)  # [R, M, H, 128]
            s = (torch.einsum("rmhd,rshd->rmhs", q_nope, k_old)
                 + torch.einsum("rmhd,rsd->rmhs", q_pe, kh)) * self._scale()
            s = s.masked_fill(~mask[:, :, None, :], float("-inf"))
            own = ((q_nope * k_new).sum(-1) + (q_pe * k_pe[:, :, None]).sum(-1)) * self._scale()
            prob = torch.softmax(torch.cat([s, own[..., None]], -1), dim=-1)
            o = torch.einsum("rmhs,rshd->rmhd", prob[..., :-1], v_old) + prob[..., -1:] * v_new
            x = x + o.reshape(R, M, H * dv) @ lp["o_proj"]
            hm = _rms_norm(x, lp["post_attn_ln"], t["rms_norm_eps"]).reshape(R * M, D)
            x = x + self._mlp(i, hm, routes).reshape(R, M, D)
            out.append((c, k_pe))
        return _rms_norm(x, self.norm, t["rms_norm_eps"]), out
