"""The two configurations' forward passes in fp32, TF32 off.

- CLIP ViT (pre-LN, quick GELU) to the feature layer, CLS dropped, then the
  2-layer GELU projector;
- the merge: the prompt's text embeddings with the image's features in
  place of its one image token (LLaVA-NeXT: the anyres-packed features,
  only the real ones, so no padding exists here);
- the Mistral decoder: RMSNorm, rotary positions, grouped-query attention,
  a SiLU-gated MLP, over one unpadded sequence with a causal mask; or one
  decode step of M masked streams over a cache of earlier rows.

Weights come as the benchmark made them ([in, out] matrices, layers
stacked) and are upcast to fp32 once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .anyres import image_geometry, pack


def fp32_matmuls() -> None:
    """No TF32 anywhere in the reference's products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """x [..., S, heads, Dh] at integer positions pos [..., S]."""
    Dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float64, device=x.device) / Dh)
    ang = pos.to(torch.float64)[..., None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[..., None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[..., None, :]
    half = Dh // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


class Reference:
    """fp32 copies of a configuration's weights and its forward passes."""

    def __init__(self, config: dict, weights: dict):
        fp32_matmuls()
        self.config = config
        self.t, self.v = config["text_config"], config["vision_config"]
        self.vision = _f32(weights["vision"])
        self.projector = _f32(weights["projector"])
        self.newline = weights["image_newline"].float() if "image_newline" in weights else None
        lm = weights["lm"]
        self.embed = lm["embed_tokens"].float()
        L = self.t["num_hidden_layers"]
        self.layers = [{k: w[i].float() for k, w in lm["layers"].items()} for i in range(L)]
        self.norm = lm["norm"].float()
        self.head_w = lm["lm_head"].float()

    # --- vision ---------------------------------------------------------------

    def image_features(self, crops: torch.Tensor) -> torch.Tensor:
        """[n, 3, s, s] crops -> [n, patches, D_lm] projected features."""
        v, p = self.v, self.vision
        n, P, D = crops.shape[0], v["patch_size"], v["hidden_size"]
        H = v["num_attention_heads"]
        g = crops.shape[-1] // P
        x = crops.float().reshape(n, 3, g, P, g, P).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(n, g * g, 3 * P * P) @ p["patch_embedding"]
        x = torch.cat([p["class_embedding"].expand(n, 1, D), x], dim=1)
        x = x + p["position_embedding"][None, : x.shape[1]]
        eps = v["layer_norm_eps"]
        x = _layer_norm(x, p["pre_ln_w"], p["pre_ln_b"], eps)
        layer = self.config.get("vision_feature_layer", -2)
        run = v["num_hidden_layers"] + 1 + layer if layer < 0 else layer
        lp = p["layers"]
        T = x.shape[1]
        for i in range(run):
            r = _layer_norm(x, lp["ln1_w"][i], lp["ln1_b"][i], eps)
            q = (r @ lp["q_w"][i] + lp["q_b"][i]).reshape(n, T, H, D // H).transpose(1, 2)
            k = (r @ lp["k_w"][i] + lp["k_b"][i]).reshape(n, T, H, D // H).transpose(1, 2)
            val = (r @ lp["v_w"][i] + lp["v_b"][i]).reshape(n, T, H, D // H).transpose(1, 2)
            att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D // H), dim=-1) @ val
            x = x + att.transpose(1, 2).reshape(n, T, D) @ lp["out_w"][i] + lp["out_b"][i]
            r = _layer_norm(x, lp["ln2_w"][i], lp["ln2_b"][i], eps)
            h = r @ lp["fc1_w"][i] + lp["fc1_b"][i]
            x = x + (h * torch.sigmoid(1.702 * h)) @ lp["fc2_w"][i] + lp["fc2_b"][i]
        x = x[:, 1:]  # CLS dropped
        pj = self.projector
        return F.gelu(x @ pj["fc1_w"] + pj["fc1_b"]) @ pj["fc2_w"] + pj["fc2_b"]

    def visual_tokens(self, crops: torch.Tensor, size) -> torch.Tensor:
        """One image's visual tokens [N, D_lm]: the crop's features, or the
        anyres-packed features of its crops."""
        feats = self.image_features(crops)
        if self.newline is None:
            return feats[0]
        return pack(feats, self.newline, image_geometry(size, self.config), self.config)

    def merge(self, ids, visual: torch.Tensor) -> tuple:
        """(embeddings [S, D], image position, visual count) of one prompt's
        ids with its one image token replaced by ``visual``."""
        ids = torch.as_tensor(ids, dtype=torch.long, device=visual.device)
        pos = int((ids == self.config["image_token_index"]).nonzero()[0, 0])
        text = self.embed[torch.where(ids == self.config["image_token_index"], 0, ids)]
        return torch.cat([text[:pos], visual, text[pos + 1:]]), pos, visual.shape[0]

    # --- the decoder ------------------------------------------------------------

    def _heads(self):
        t = self.t
        return t["num_attention_heads"], t["num_key_value_heads"], t["head_dim"]

    def _block(self, lp, x, pos, attend):
        t = self.t
        H, KH, Dh = self._heads()
        h = _rms_norm(x, lp["input_ln"], t["rms_norm_eps"])
        lead = h.shape[:-1]
        q = _rope((h @ lp["q_proj"]).reshape(*lead, H, Dh), pos, t["rope_theta"])
        k = _rope((h @ lp["k_proj"]).reshape(*lead, KH, Dh), pos, t["rope_theta"])
        v = (h @ lp["v_proj"]).reshape(*lead, KH, Dh)
        x = x + attend(q, k, v).reshape(*lead, H * Dh) @ lp["o_proj"]
        h = _rms_norm(x, lp["post_attn_ln"], t["rms_norm_eps"])
        x = x + (F.silu(h @ lp["gate_proj"]) * (h @ lp["up_proj"])) @ lp["down_proj"]
        return x, k, v

    def forward(self, x: torch.Tensor):
        """One unpadded causal sequence [S, D] -> (final-norm hidden [S, D],
        per layer (k, v) [S, KH, Dh])."""
        S = x.shape[0]
        H, KH, Dh = self._heads()
        pos = torch.arange(S, device=x.device)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()

        def attend(q, k, v):
            qg = q.reshape(S, KH, H // KH, Dh).permute(1, 2, 0, 3)  # [KH, G, S, Dh]
            s = torch.einsum("kgqd,skd->kgqs", qg, k) / math.sqrt(Dh)
            p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            return torch.einsum("kgqs,skd->qkgd", p, v)

        kv = []
        for lp in self.layers:
            x, k, v = self._block(lp, x, pos, attend)
            kv.append((k, v))
        return _rms_norm(x, self.norm, self.t["rms_norm_eps"]), kv

    def step(self, x: torch.Tensor, pos: torch.Tensor, cache: list, mask: torch.Tensor):
        """One token of M streams a row over a cache.

        Args:
          x: [R, M, D] the rows' current-token embeddings, every stream alike.
          pos: [R] the token's position (the rows' cache fill).
          cache: per layer (k, v) [R, S, KH, Dh].
          mask: [R, M, S] bool, True = the stream attends that slot; every
            stream attends its own token besides.
        Returns:
          (final-norm hidden [R, M, D], per layer (k, v) [R, M, KH, Dh]).
        """
        H, KH, Dh = self._heads()
        R, M, _ = x.shape
        p = pos[:, None].expand(R, M)
        out = []
        for lp, (kc, vc) in zip(self.layers, cache):
            def attend(q, k, v, kc=kc, vc=vc):
                qg = q.reshape(R, M, KH, H // KH, Dh)
                s = torch.einsum("rmkgd,rskd->rmkgs", qg, kc) / math.sqrt(Dh)
                s = s.masked_fill(~mask[:, :, None, None, :], float("-inf"))
                own = torch.einsum("rmkgd,rmkd->rmkg", qg, k)[..., None] / math.sqrt(Dh)
                prob = torch.softmax(torch.cat([s, own], dim=-1), dim=-1)
                o = torch.einsum("rmkgs,rskd->rmkgd", prob[..., :-1], vc)
                return o + prob[..., -1:] * v[:, :, :, None, :]

            x, k, v = self._block(lp, x, p, attend)
            out.append((k, v))
        return _rms_norm(x, self.norm, self.t["rms_norm_eps"]), out

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ self.head_w
