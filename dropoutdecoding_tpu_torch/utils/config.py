"""Frozen configuration dataclasses of the LLaVA-1.5, LLaVA-NeXT and
InstructBLIP Dropout Decoding paths.

A copy of the matching dataclasses in ``dropoutdecoding_tpu/utils/config.py``
with the same fields and defaults (LLaVA-1.5-7B, LLaVA-v1.6-Mistral-7B,
InstructBLIP-Vicuna-7B and CLIP ViT-L/336 widths).
The port cannot import that module: ``dropoutdecoding_tpu.utils`` imports
JAX from its package ``__init__`` (through ``utils/prng.py``).
``tests/test_torch_imports.py`` holds the two copies equal field by field.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LlamaConfig:
    """Llama-family decoder config (Llama-7B, Vicuna-7B, Mistral-7B)."""

    vocab_size: int = 32064
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32  # < num_attention_heads => GQA
    head_dim: int = 128
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False

    @classmethod
    def from_hf_dict(cls, d: dict) -> "LlamaConfig":
        """A core dim the dict leaves out (vocab, width, FFN, depth, heads)
        takes transformers' LlamaConfig / MistralConfig default, as
        ``from_pretrained`` does: the published llava-hf configs
        (llava-1.5-7b-hf, llava-v1.6-mistral-7b-hf) leave them out of their
        ``text_config``.  The JAX package's copy requires them."""
        heads = d.get("num_attention_heads", 32)
        hidden = d.get("hidden_size", 4096)
        return cls(
            vocab_size=d.get("vocab_size", 32000),
            hidden_size=hidden,
            intermediate_size=d.get("intermediate_size", 11008),
            num_hidden_layers=d.get("num_hidden_layers", 32),
            num_attention_heads=heads,
            num_key_value_heads=d.get("num_key_value_heads", heads),
            head_dim=d.get("head_dim") or hidden // heads,
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            attention_bias=d.get("attention_bias", False),
            mlp_bias=d.get("mlp_bias", False),
        )


@dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP ViT vision tower (LLaVA uses ViT-L/14 at 336 px)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    projection_dim: int = 768

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1  # + CLS

    @classmethod
    def from_hf_dict(cls, d: dict) -> "ClipVisionConfig":
        return cls(
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            image_size=d["image_size"],
            patch_size=d["patch_size"],
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
            hidden_act=d.get("hidden_act", "quick_gelu"),
            projection_dim=d.get("projection_dim", 768),
        )


@dataclass(frozen=True)
class QFormerConfig:
    """InstructBLIP Q-Former (BERT encoder with periodic cross-attention)."""

    vocab_size: int = 30523
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    cross_attention_frequency: int = 2
    encoder_hidden_size: int = 1408  # InstructBLIP EVA-ViT hidden size
    layer_norm_eps: float = 1e-12
    max_position_embeddings: int = 512
    num_query_tokens: int = 32

    @classmethod
    def from_hf_dict(cls, d: dict, num_query_tokens: int = 32) -> "QFormerConfig":
        """A core dim the dict leaves out takes transformers'
        ``InstructBlipQFormerConfig`` default (vocabulary 30522), as
        ``from_pretrained`` does; the JAX package's copy requires them."""
        return cls(
            vocab_size=d.get("vocab_size", 30522),
            hidden_size=d.get("hidden_size", 768),
            num_hidden_layers=d.get("num_hidden_layers", 12),
            num_attention_heads=d.get("num_attention_heads", 12),
            intermediate_size=d.get("intermediate_size", 3072),
            cross_attention_frequency=d.get("cross_attention_frequency", 2),
            encoder_hidden_size=d.get("encoder_hidden_size", 1408),
            layer_norm_eps=d.get("layer_norm_eps", 1e-12),
            max_position_embeddings=d.get("max_position_embeddings", 512),
            num_query_tokens=num_query_tokens,
        )


@dataclass(frozen=True)
class BlipVisionConfig:
    """InstructBLIP vision tower (EVA ViT-g/14): pre-norm ViT with a final
    post-layernorm, learned position embeddings and bias on q and v."""

    hidden_size: int = 1408
    intermediate_size: int = 6144
    num_hidden_layers: int = 39
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu"
    qkv_bias: bool = True

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @classmethod
    def from_hf_dict(cls, d: dict) -> "BlipVisionConfig":
        """A core dim the dict leaves out takes transformers'
        ``InstructBlipVisionConfig`` default (EVA ViT-g/14 at 224 px), as
        ``from_pretrained`` does; the JAX package's copy requires them."""
        return cls(
            hidden_size=d.get("hidden_size", 1408),
            intermediate_size=d.get("intermediate_size", 6144),
            num_hidden_layers=d.get("num_hidden_layers", 39),
            num_attention_heads=d.get("num_attention_heads", 16),
            image_size=d.get("image_size", 224),
            patch_size=d.get("patch_size", 14),
            layer_norm_eps=d.get("layer_norm_eps", 1e-6),
            hidden_act=d.get("hidden_act", "gelu"),
            qkv_bias=d.get("qkv_bias", True),
        )


@dataclass(frozen=True)
class LlavaConfig:
    """LLaVA-1.5 composition."""

    text: LlamaConfig = LlamaConfig()
    vision: ClipVisionConfig = ClipVisionConfig()
    image_token_index: int = 32000
    pad_token_id: int = 32001
    vision_feature_layer: int = -2
    vision_feature_select_strategy: str = "default"  # drop CLS
    projector_hidden_act: str = "gelu"

    @classmethod
    def from_hf_dict(cls, d: dict) -> "LlavaConfig":
        return cls(
            text=LlamaConfig.from_hf_dict(d["text_config"]),
            vision=ClipVisionConfig.from_hf_dict(d["vision_config"]),
            image_token_index=d.get("image_token_index", 32000),
            pad_token_id=d.get("pad_token_id", 32001) or 32001,
            vision_feature_layer=d.get("vision_feature_layer", -2),
            vision_feature_select_strategy=d.get(
                "vision_feature_select_strategy", "default"
            ),
        )


@dataclass(frozen=True)
class LlavaNextConfig:
    """LLaVA-NeXT (v1.6) composition: Mistral-7B (GQA, 8 KV heads) with
    multi-tile anyres visual tokens (HF ``llava-hf/llava-v1.6-mistral-7b-hf``
    defaults)."""

    text: LlamaConfig = LlamaConfig(
        num_key_value_heads=8, intermediate_size=14336, rope_theta=1000000.0
    )
    vision: ClipVisionConfig = ClipVisionConfig()
    image_token_index: int = 32000
    pad_token_id: int = 32001
    vision_feature_layer: int = -2
    vision_feature_select_strategy: str = "default"
    projector_hidden_act: str = "gelu"
    image_grid_pinpoints: Tuple[Tuple[int, int], ...] = (
        (336, 672),
        (672, 336),
        (672, 672),
        (1008, 336),
        (336, 1008),
    )

    @classmethod
    def from_hf_dict(cls, d: dict) -> "LlavaNextConfig":
        return cls(
            text=LlamaConfig.from_hf_dict(d["text_config"]),
            vision=ClipVisionConfig.from_hf_dict(d["vision_config"]),
            image_token_index=d.get("image_token_index", 32000),
            pad_token_id=d.get("pad_token_id", 32001) or 32001,
            vision_feature_layer=d.get("vision_feature_layer", -2),
            vision_feature_select_strategy=d.get(
                "vision_feature_select_strategy", "default"
            ),
            image_grid_pinpoints=tuple(
                tuple(p) for p in d.get("image_grid_pinpoints", [])
            )
            or cls.image_grid_pinpoints,
        )


@dataclass(frozen=True)
class InstructBlipConfig:
    """InstructBLIP composition: EVA-ViT -> Q-Former -> projection -> Vicuna
    (``Salesforce/instructblip-vicuna-7b`` widths)."""

    text: LlamaConfig = LlamaConfig(vocab_size=32001)
    vision: BlipVisionConfig = BlipVisionConfig()
    qformer: QFormerConfig = QFormerConfig()
    num_query_tokens: int = 32

    @classmethod
    def from_hf_dict(cls, d: dict) -> "InstructBlipConfig":
        return cls(
            text=LlamaConfig.from_hf_dict(d["text_config"]),
            vision=BlipVisionConfig.from_hf_dict(d["vision_config"]),
            qformer=QFormerConfig.from_hf_dict(
                d["qformer_config"], d.get("num_query_tokens", 32)
            ),
            num_query_tokens=d.get("num_query_tokens", 32),
        )


@dataclass(frozen=True)
class EnsembleConfig:
    """Dropout-decoding ensemble parameters (see the JAX package's
    ``EnsembleConfig`` docstring for what each field reproduces).

    The port runs both modes (``fused_step``) with every mask policy
    (``decoding/masks.py`` ``POLICIES``).
    """

    voting_probs: Tuple[float, ...] = (0.3, 0.5, 0.7)
    use_avg: bool = False
    use_random: bool = False
    mask_policy: str = "epis"
    mask_accumulate: bool = True
    topk: int = 5
    prob_floor: float = 0.1
    fused_step: bool = False

    @property
    def k(self) -> int:
        return len(self.voting_probs)

    @staticmethod
    def voting_probs_for(n: int) -> Tuple[float, ...]:
        """CLI ``--voting-numbers`` -> probability caps."""
        table = {
            1: (0.3,),
            2: (0.5, 0.3),
            3: (0.3, 0.5, 0.7),
            4: (0.1, 0.3, 0.5, 0.7),
            5: (0.1, 0.3, 0.5, 0.7, 0.9),
        }
        return table.get(n, table[3])


@dataclass(frozen=True)
class GenerationConfig:
    """Decode-loop parameters.  The port decodes greedily, or samples under
    ``do_sample`` with ``temperature`` / ``top_p`` / ``top_k``; the beam
    and VCD fields are carried for config parity only."""

    max_new_tokens: int = 512
    eos_token_id: int = 2
    pad_token_id: int = 2
    num_beams: int = 1
    length_penalty: float = 1.0
    early_stopping: object = False  # False | True | "never"
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: Optional[int] = None
    use_cd: bool = False
    cd_alpha: float = 0.5
    cd_beta: float = 0.1
    cd_noise_step: int = 500
