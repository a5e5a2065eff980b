"""HF checkpoint loading of the port (``utils/hf_io.py``, each model's
``params_from_hf``, ``models.llava.load`` / ``models.llavanext.load``,
``utils/cache.py``), against the ``safetensors`` package, the JAX package's
``params_from_hf`` and the HF models themselves.

- The port's own safetensors reader equals ``safetensors.numpy.load_file``
  bit for bit, for every dtype a checkpoint holds.
- A tiny HF LLaVA (and LLaVA-NeXT) built from config objects, written to
  disk in both HF key layouts, loads into leaves exactly equal to the JAX
  ``params_from_hf`` of the same state dict carried across by
  ``utils/convert.py``.
- The HF goldens the JAX package keeps (``tests/test_vision_parity.py``,
  ``tests/test_llama_parity.py``, ``tests/test_llavanext_parity.py``): the
  port's CLIP hidden states, Llama and LLaVA prefill logits within 5e-4
  (fp32; the JAX tests' own tolerances: 2e-4 for one tower, 5e-4 through
  the three), and LLaVA-NeXT's greedy tokens equal to HF ``generate``'s.
"""
import json
import os

import ml_dtypes  # noqa: F401  (gives numpy the bfloat16 that safetensors.numpy reads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dropoutdecoding_tpu.models import llava as jllava
from dropoutdecoding_tpu.models import llavanext as jnext
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu.utils.hf_io import state_dict_from_torch_module as jax_state_dict
from dropoutdecoding_tpu_torch.models import clip_vit, llama, llava, llavanext
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import (
    llava_params_from_numpy,
    llavanext_params_from_numpy,
)
from dropoutdecoding_tpu_torch.utils.hf_io import load_state_dict, read_safetensors

HF_TOL = dict(rtol=5e-4, atol=5e-4)
NEXT_PINPOINTS = [[28, 56], [56, 28], [56, 56]]


def _leaves(tree, prefix=""):
    """{path: tensor} of a params NamedTuple / nested dict."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _assert_same_leaves(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _write_checkpoint(path, model, keys="module"):
    """``model`` as an HF checkpoint directory: ``save_pretrained``'s own
    layout (``keys="saved"``, the pre-4.52 'language_model.model.*' names)
    or the module's state-dict names ('model.language_model.*') in one
    safetensors file."""
    from safetensors.torch import save_file

    if keys == "saved":
        model.save_pretrained(str(path))
        return
    os.makedirs(path, exist_ok=True)
    sd = {k: v.contiguous() for k, v in model.state_dict().items()}
    save_file(sd, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(model.config.to_dict()))


# --- the reader --------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.int32]
)
def test_reader_matches_safetensors(tmp_path, dtype):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "w": torch.randn(5, 7, generator=g),
        "b": torch.randn(7, generator=g),
        "s": torch.randn((), generator=g),
        "e": torch.zeros(0, 3),
    }
    if dtype.is_floating_point:
        tensors = {k: v.to(dtype) for k, v in tensors.items()}
    else:
        tensors = {k: (v * 50).to(dtype) for k, v in tensors.items()}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, ref = read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(ref)
    for k, want in ref.items():
        t = got[k]
        assert t.dtype == dtype and tuple(t.shape) == want.shape
        bits = t.view(torch.int16) if dtype == torch.bfloat16 else t
        want_bits = want.view(np.int16) if dtype == torch.bfloat16 else want
        np.testing.assert_array_equal(bits.numpy(), want_bits)


def test_reader_rejects_a_header_past_the_end(tmp_path):
    path = tmp_path / "bad.safetensors"
    path.write_bytes((1 << 20).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="overruns"):
        read_safetensors(str(path))


# --- sharded checkpoints -------------------------------------------------------


@pytest.fixture
def sharded_ckpt(tmp_path, tiny_llava):
    """tiny HF LLaVA as a 3-shard bf16 checkpoint with the HF index, split
    mid-tower like the real 7B's 3 files."""
    from safetensors.torch import save_file

    model = tiny_llava[0]
    sd = {k: v.to(torch.bfloat16).contiguous() for k, v in model.state_dict().items()}
    names = sorted(sd)
    third = len(names) // 3
    shards = {
        "model-00001-of-00003.safetensors": names[:third],
        "model-00002-of-00003.safetensors": names[third : 2 * third],
        "model-00003-of-00003.safetensors": names[2 * third :],
    }
    weight_map = {}
    for shard, keys in shards.items():
        save_file({k: sd[k] for k in keys}, str(tmp_path / shard))
        weight_map.update({k: shard for k in keys})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": 0}, "weight_map": weight_map})
    )
    (tmp_path / "config.json").write_text(json.dumps(model.config.to_dict()))
    return tmp_path, sd


def test_index_resolved_and_bf16_kept(sharded_ckpt):
    ckpt_dir, sd = sharded_ckpt
    got = load_state_dict(str(ckpt_dir))
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k], v), k


def test_missing_shard_fails_loudly(sharded_ckpt):
    ckpt_dir, _ = sharded_ckpt
    os.remove(ckpt_dir / "model-00002-of-00003.safetensors")
    with pytest.raises(FileNotFoundError, match="00002"):
        load_state_dict(str(ckpt_dir))


def test_index_with_missing_tensor_fails_loudly(tmp_path):
    from safetensors.torch import save_file

    save_file({"a.weight": torch.zeros(2, 2)}, str(tmp_path / "model-00001-of-00001.safetensors"))
    shard = "model-00001-of-00001.safetensors"
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": {"a.weight": shard, "b.weight": shard}})
    )
    with pytest.raises(ValueError, match="absent"):
        load_state_dict(str(tmp_path))


def test_bin_checkpoint_keeps_bf16(tmp_path):
    sd = {"x": torch.randn(3, 4).bfloat16(), "y": torch.arange(5)}
    torch.save(sd, tmp_path / "pytorch_model.bin")
    got = load_state_dict(str(tmp_path))
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"], sd["x"]) and torch.equal(got["y"], sd["y"])


# --- LLaVA-1.5 ---------------------------------------------------------------


@pytest.mark.parametrize("keys", ["saved", "module"])
def test_llava_load_matches_jax_params_from_hf(tmp_path, tiny_llava, keys):
    model = tiny_llava[0]
    _write_checkpoint(tmp_path, model, keys)
    cfg, params = llava.load(str(tmp_path), torch.float32, "cpu", cache=False)
    jcfg = jax_config.LlavaConfig.from_hf_dict(model.config.to_dict())
    assert cfg == torch_config.LlavaConfig.from_hf_dict(model.config.to_dict())
    ref = jllava.params_from_hf(jcfg, jax_state_dict(model), jnp.float32)
    _assert_same_leaves(params, llava_params_from_numpy(ref, "cpu", torch.float32))


def test_llava_load_through_the_cache(tmp_path, tiny_llava, monkeypatch):
    """The converted tree, stored on the first load, is what the second
    load returns; a bf16 load keeps bf16 leaves."""
    from dropoutdecoding_tpu_torch.utils import cache

    monkeypatch.setenv("DROPOUTDECODING_CACHE", str(tmp_path / "cache"))
    ckpt = tmp_path / "ckpt"
    _write_checkpoint(ckpt, tiny_llava[0], "saved")
    _, first = llava.load(str(ckpt), torch.bfloat16, "cpu", cache=True)
    assert os.path.isfile(cache._cache_dir(str(ckpt), "bfloat16") + ".pt")
    calls = []
    monkeypatch.setattr(llava, "params_from_hf", lambda *a: calls.append(a))
    _, second = llava.load(str(ckpt), torch.bfloat16, "cpu", cache=True)
    assert calls == []  # read from the cache, not converted again
    _assert_same_leaves(second, first)
    assert first.lm["embed_tokens"].dtype == torch.bfloat16


def test_llava_prefill_logits_match_hf(tmp_path, tiny_llava):
    """vision -> projector -> merge -> LM logits of the loaded port against
    HF LlavaForConditionalGeneration's forward (the image token expanded
    to one per patch on the HF side)."""
    model, _, _, input_ids, expanded_ids, pixels = tiny_llava
    _write_checkpoint(tmp_path, model, "saved")
    cfg, params = llava.load(str(tmp_path), torch.float32, "cpu", cache=False)
    with torch.no_grad():
        ref = model(
            input_ids=torch.from_numpy(expanded_ids),
            pixel_values=torch.from_numpy(pixels),
            attention_mask=torch.ones_like(torch.from_numpy(expanded_ids)),
        ).logits.numpy()
        ids = torch.from_numpy(input_ids)
        image_pos = llava.find_image_pos(ids, cfg.image_token_index).long()
        feats = llava.image_features(cfg, params, torch.from_numpy(pixels))
        text = llama.embed(params.lm, torch.where(ids == cfg.image_token_index, 0, ids))
        merged = llava.merge_image_features(text, feats, image_pos)
        S = merged.shape[1]
        hidden, _ = llama.prefill(params.lm, cfg.text, merged, torch.arange(S)[None])
        ours = llama.lm_head(params.lm, hidden).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **HF_TOL)


def test_clip_hidden_states_match_hf(rng):
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(0)
    hf_cfg = CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=4, num_attention_heads=4,
        image_size=28, patch_size=7, attn_implementation="eager",
    )
    model = CLIPVisionModel(hf_cfg).eval().float()
    cfg = torch_config.ClipVisionConfig.from_hf_dict(hf_cfg.to_dict())
    params = clip_vit.params_from_hf(cfg, model.state_dict(), torch.float32, "cpu")
    pixels = torch.from_numpy(rng.normal(size=(2, 3, 28, 28)).astype(np.float32))
    with torch.no_grad():
        out = model(pixels, output_hidden_states=True)
        for layer in (-2, -1):
            ours = clip_vit.apply(cfg, params, pixels, layer)
            np.testing.assert_allclose(
                ours.numpy(), out.hidden_states[layer].numpy(), rtol=2e-4, atol=2e-4
            )


@pytest.mark.parametrize("num_kv_heads", [8, 4])
def test_llama_prefill_logits_match_hf(rng, num_kv_heads):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    hf_cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=8, num_key_value_heads=num_kv_heads, max_position_embeddings=256,
        rms_norm_eps=1e-5, rope_theta=10000.0, attn_implementation="eager",
    )
    model = LlamaForCausalLM(hf_cfg).eval().float()
    cfg = torch_config.LlamaConfig.from_hf_dict(hf_cfg.to_dict())
    params = llama.params_from_hf(cfg, model.state_dict(), torch.float32, "cpu")
    B, S = 2, 13
    ids = torch.from_numpy(rng.integers(0, 128, size=(B, S)))
    with torch.no_grad():
        ref = model(ids).logits.numpy()
        hidden, kv = llama.prefill(params, cfg, llama.embed(params, ids), torch.arange(S)[None].expand(B, S))
        ours = llama.lm_head(params, hidden).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)
    assert tuple(kv.k.shape) == (3, B, S, num_kv_heads, 8)


def test_llama_decode_step_matches_hf_incremental(rng):
    """The JAX package's HF golden (``tests/test_llama_parity.py:57``),
    inherited: greedy decoding through the port's cache and
    ``decode_step`` gives HF's cache-based incremental logits, step by
    step."""
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    hf_cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=256,
        rms_norm_eps=1e-5, rope_theta=10000.0, attn_implementation="eager",
    )
    model = LlamaForCausalLM(hf_cfg).eval().float()
    cfg = torch_config.LlamaConfig.from_hf_dict(hf_cfg.to_dict())
    params = llama.params_from_hf(cfg, model.state_dict(), torch.float32, "cpu")
    B, S, Smax = 1, 9, 32
    ids = torch.from_numpy(rng.integers(0, 128, size=(B, S)))
    with torch.no_grad():
        out = model(ids, use_cache=True)
        past, tok = out.past_key_values, out.logits[:, -1].argmax(-1)
        ref = []
        for _ in range(4):
            out = model(tok[:, None], past_key_values=past, use_cache=True)
            past = out.past_key_values
            ref.append(out.logits[:, -1].numpy())
            tok = out.logits[:, -1].argmax(-1)

        hidden, kv = llama.prefill(params, cfg, llama.embed(params, ids), torch.arange(S)[None].expand(B, S))
        cache = llama.cache_seed(llama.empty_cache(cfg, B, Smax, torch.float32, "cpu"), kv)
        tok = llama.lm_head(params, hidden[:, -1]).argmax(-1)
        for t in range(4):
            cur = torch.full((B,), S + t)
            mask = (torch.arange(Smax) < S + t)[None, None].expand(B, 1, Smax)
            h, k_new, v_new = llama.decode_step(
                params, cfg, llama.embed(params, tok)[:, None], cur, cache, mask
            )
            logits = llama.lm_head(params, h)[:, 0]
            np.testing.assert_allclose(logits.numpy(), ref[t], rtol=2e-4, atol=2e-4)
            llama.cache_set_rows(cache, cur, k_new[:, :, 0], v_new[:, :, 0])
            tok = logits.argmax(-1)


def test_tied_embeddings_make_the_head():
    cfg = torch_config.LlamaConfig(
        vocab_size=8, hidden_size=4, intermediate_size=8, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=2, head_dim=2,
    )
    g = torch.Generator().manual_seed(0)
    sd = {"model.embed_tokens.weight": torch.randn(8, 4, generator=g), "model.norm.weight": torch.ones(4)}
    p = "model.layers.0."
    for name, shape in [
        ("input_layernorm.weight", (4,)), ("post_attention_layernorm.weight", (4,)),
        ("self_attn.q_proj.weight", (4, 4)), ("self_attn.k_proj.weight", (4, 4)),
        ("self_attn.v_proj.weight", (4, 4)), ("self_attn.o_proj.weight", (4, 4)),
        ("mlp.gate_proj.weight", (8, 4)), ("mlp.up_proj.weight", (8, 4)),
        ("mlp.down_proj.weight", (4, 8)),
    ]:
        sd[p + name] = torch.randn(shape, generator=g)
    params = llama.params_from_hf(cfg, sd, torch.float32, "cpu")
    assert torch.equal(params["lm_head"], sd["model.embed_tokens.weight"].t())
    assert torch.equal(params["layers"]["gate_proj"][0], sd[p + "mlp.gate_proj.weight"].t())


# --- LLaVA-NeXT ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_next():
    """A tiny HF LLaVA-NeXT (Mistral, GQA 4/2), as tests/test_llavanext_parity.py
    builds it."""
    from transformers import CLIPVisionConfig, LlavaNextConfig, LlavaNextForConditionalGeneration
    from transformers import MistralConfig

    torch.manual_seed(21)
    hf_cfg = LlavaNextConfig(
        vision_config=CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
            image_size=28, patch_size=7,
        ).to_dict(),
        text_config=MistralConfig(
            vocab_size=64, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        ).to_dict(),
        image_token_index=32,
        image_grid_pinpoints=NEXT_PINPOINTS,
        vision_feature_layer=-2,
        vision_feature_select_strategy="default",
        attn_implementation="eager",
    )
    return LlavaNextForConditionalGeneration(hf_cfg).eval().float()


@pytest.mark.parametrize("keys", ["saved", "module"])
def test_llavanext_load_matches_jax_params_from_hf(tmp_path, tiny_next, keys):
    _write_checkpoint(tmp_path, tiny_next, keys)
    names = load_state_dict(str(tmp_path))
    assert ("image_newline" in names) == (keys == "saved")  # either key is read
    cfg, params = llavanext.load(str(tmp_path), torch.float32, "cpu", cache=False)
    d = tiny_next.config.to_dict()
    assert cfg == torch_config.LlavaNextConfig.from_hf_dict(d)
    jcfg = jax_config.LlavaNextConfig.from_hf_dict(d)
    ref = jnext.params_from_hf(jcfg, jax_state_dict(tiny_next), jnp.float32)
    _assert_same_leaves(params, llavanext_params_from_numpy(ref, "cpu", torch.float32))


def test_llavanext_greedy_matches_hf(tmp_path, tiny_next):
    """The loaded port's greedy ``generate`` on a 40 x 50 image through the
    port's anyres preprocessor equals HF ``generate``'s tokens."""
    from PIL import Image

    from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
    from dropoutdecoding_tpu_torch.utils.processor import LlavaNextImagePreprocessor

    _write_checkpoint(tmp_path, tiny_next, "saved")
    cfg, params = llavanext.load(str(tmp_path), torch.float32, "cpu", cache=False)
    rng = np.random.default_rng(9)
    img = Image.fromarray((rng.random((40, 50, 3)) * 255).astype(np.uint8), "RGB")
    tiles, orig = LlavaNextImagePreprocessor(NEXT_PINPOINTS, tile_size=28)(img)
    n_tokens = llavanext.image_geometry(orig, cfg)["n_tokens"]
    input_ids = np.array([[1, 5, 9, 32, 11, 13]])
    hf_ids = torch.from_numpy(np.array([[1, 5, 9] + [32] * n_tokens + [11, 13]]))
    with torch.no_grad():
        ref = tiny_next.generate(
            input_ids=hf_ids, pixel_values=torch.from_numpy(tiles[None]),
            image_sizes=torch.tensor([list(orig)]), attention_mask=torch.ones_like(hf_ids),
            max_new_tokens=6, do_sample=False,
        )[0, hf_ids.shape[1] :].numpy()
    eng = LlavaNextEngine(
        cfg=cfg, params=params, ensemble=False,
        gen=torch_config.GenerationConfig(max_new_tokens=6, eos_token_id=63, pad_token_id=63),
        max_len=llavanext.max_image_tokens(cfg) + 32,
    )
    out = eng.generate(input_ids, tiles, orig)
    n = min(len(ref), int(out.num_tokens[0]))
    assert n >= 1
    np.testing.assert_array_equal(out.tokens[0, :n], ref[:n])


# --- the published config and chip_smoke.py's checkpoint writer -----------------


def test_published_llava_config_reads_as_the_7b():
    """llava-1.5-7b-hf's config.json as published leaves the Vicuna-7B core
    dims to transformers' defaults; the port reads it as LLaVA-1.5-7B, as
    transformers does."""
    from transformers import LlavaConfig as HFLlavaConfig

    from chip_smoke import LLAVA_7B_HF_CONFIG

    assert torch_config.LlavaConfig.from_hf_dict(LLAVA_7B_HF_CONFIG) == torch_config.LlavaConfig()
    hf = HFLlavaConfig(**LLAVA_7B_HF_CONFIG).to_dict()
    assert torch_config.LlavaConfig.from_hf_dict(hf) == torch_config.LlavaConfig()


def test_chip_smoke_writer_round_trips(tmp_path, tiny_llava):
    """``chip_smoke.write_hf_checkpoint`` (the inverse key map the card's
    CLI phase writes 7B with) gives three shards and an index that
    transformers loads with no key missing or unexpected, and that the
    port loads back bit for bit."""
    from transformers import LlavaForConditionalGeneration

    from chip_smoke import llava_hf_tensors, write_hf_checkpoint
    from dropoutdecoding_tpu_torch.utils.convert import synthetic_llava_params

    config = tiny_llava[0].config.to_dict()
    cfg = torch_config.LlavaConfig.from_hf_dict(config)
    params = synthetic_llava_params(cfg, "cpu", torch.bfloat16, seed=4)
    write_hf_checkpoint(str(tmp_path), llava_hf_tensors(cfg, params), {"config.json": config})
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert len(set(index["weight_map"].values())) == 3
    _, info = LlavaForConditionalGeneration.from_pretrained(str(tmp_path), output_loading_info=True)
    assert info["missing_keys"] == [] and info["unexpected_keys"] == []
    got_cfg, got = llava.load(str(tmp_path), torch.bfloat16, "cpu", cache=False)
    assert got_cfg == cfg
    _assert_same_leaves(got, params)
