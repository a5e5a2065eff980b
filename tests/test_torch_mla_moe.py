"""The MLA + MoE decoder (``models/mla_moe.py``; Kimi-VL-A3B's language model
behind the LLaVA-1.5 tower) against the benchmark's plain fp32 reference
(``benchmark/reference/mla_moe.py``, the published DeepseekV3 equations in
the decompressed form) at a tiny size on the CPU: the prefill, decoding
through the latent cache, the engine's greedy / exact / fused steps, the
routing rule, K7's twin, the HF loader and what the decoder refuses."""
from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from benchmark.reference.mla_moe import MlaMoeReference
from dropoutdecoding_tpu_torch.engine import generate
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.models import llava as llava_mod
from dropoutdecoding_tpu_torch.models import mla_moe
from dropoutdecoding_tpu_torch.ops import cuda_moe
from dropoutdecoding_tpu_torch.utils.config import (
    ClipVisionConfig,
    EnsembleConfig,
    GenerationConfig,
    LlavaConfig,
    MlaMoeConfig,
    text_config_from_hf,
)
from dropoutdecoding_tpu_torch.utils.convert import synthetic_llava_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = MlaMoeConfig(
    vocab_size=97, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
    num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, n_shared_experts=2,
    num_experts_per_tok=3,
)
VISION = ClipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=4, image_size=28, patch_size=7)
IMAGE = 96
CFG = LlavaConfig(text=TEXT, vision=VISION, image_token_index=IMAGE, pad_token_id=0)
# fp32 program against the fp32 reference: summation order only
RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny tensors: a pool of one per
    core, spinning beside the other test workers, made such tests tens of
    times slower under load than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sharpen(tree, factor):
    for k, v in tree.items():
        if isinstance(v, dict):
            _sharpen(v, factor)
        elif not k.endswith("_ln") and k != "norm":
            v.mul_(factor)


@pytest.fixture(scope="module")
def params():
    p = synthetic_llava_params(CFG, "cpu", torch.float32, seed=3)
    _sharpen(p.lm, 5.0)  # logits far apart, so the comparisons separate faults from rounding
    return p


@pytest.fixture(scope="module")
def ref(params):
    config = {"text_config": dataclasses.asdict(TEXT), "vision_config": dataclasses.asdict(VISION),
              "image_token_index": IMAGE, "vision_feature_layer": -2}
    return MlaMoeReference(config, {"vision": params.vision, "projector": params.projector,
                                    "lm": params.lm})


def _prompt(B=2, S=8, seed=0):
    ids = np.random.default_rng(seed).integers(3, IMAGE, size=(B, S))
    ids[:, 2] = IMAGE
    pixels = torch.from_numpy(np.random.default_rng(seed + 1).uniform(-1.8, 2.1, (B, 3, 28, 28)))
    return ids, pixels.float()


def _close(got, want, what):
    err = (got - want).abs().max().item()
    assert err <= RTOL * want.abs().max().item() + 1e-6, f"{what}: {err}"


# --- the forward ------------------------------------------------------------------


def test_prefill_last_logits_match_the_reference(params, ref):
    lm = params.lm
    x = lm["embed_tokens"][torch.randint(0, IMAGE, (2, 11), generator=torch.Generator().manual_seed(5))]
    pos = torch.arange(11)[None].expand(2, 11)
    hidden, kv = mla_moe.prefill(lm, TEXT, x, pos)
    assert kv.ckv.shape == (TEXT.num_hidden_layers, 2, 11, TEXT.latent_dim)
    for b in range(2):
        rh, rows = ref.forward(x[b])
        _close(mla_moe.lm_head(lm, hidden[b]), ref.logits(rh), f"row {b} logits")
        for i, (c, k) in enumerate(rows):  # the cache rows: normalised latent, roped key
            _close(kv.ckv[i, b], torch.cat([c, k], -1), f"layer {i} cache rows")


def test_decode_through_the_latent_cache_matches_the_full_forward(params, ref):
    """Prefill of 9 tokens, then 3 decode steps through the cache (each
    appending its row): each step's logits against the reference's full
    forward over the tokens so far."""
    lm = params.lm
    x = lm["embed_tokens"][torch.randint(0, IMAGE, (2, 12), generator=torch.Generator().manual_seed(6))]
    pos = torch.arange(12)[None].expand(2, 12)
    cache = mla_moe.empty_cache(TEXT, 2, 16, torch.float32, "cpu")
    _, kv = mla_moe.prefill(lm, TEXT, x[:, :9], pos[:, :9])
    mla_moe.cache_seed(cache, kv)
    for t in range(9, 12):
        mask = (torch.arange(16) < t)[None, None].expand(2, 1, 16)
        h, c, kpe = mla_moe.decode_step(lm, TEXT, x[:, t:t + 1], torch.full((2,), t), cache, mask)
        mla_moe.cache_set_rows(cache, torch.full((2,), t), c[:, :, 0], kpe[:, :, 0])
        for b in range(2):
            rh, _ = ref.forward(x[b, :t + 1])
            _close(mla_moe.lm_head(lm, h[b, 0]), ref.logits(rh[-1]), f"step {t} row {b}")


def test_a_member_reads_the_cache_under_its_own_mask(params, ref):
    """M = 3 members with different key masks in one decode step against the
    reference's masked streams."""
    lm = params.lm
    x = lm["embed_tokens"][torch.randint(0, IMAGE, (2, 10), generator=torch.Generator().manual_seed(7))]
    pos = torch.arange(10)[None].expand(2, 10)
    cache = mla_moe.empty_cache(TEXT, 2, 12, torch.float32, "cpu")
    _, kv = mla_moe.prefill(lm, TEXT, x[:, :9], pos[:, :9])
    mla_moe.cache_seed(cache, kv)
    g = torch.Generator().manual_seed(8)
    mask = (torch.rand(2, 3, 12, generator=g) < 0.6) & (torch.arange(12) < 9)
    h, c, kpe = mla_moe.decode_step(lm, TEXT, x[:, 9:10].expand(2, 3, -1), torch.full((2,), 9), cache,
                                    mask)
    hist = [(kv.ckv[i, :, :, :TEXT.kv_lora_rank], kv.ckv[i, :, :, TEXT.kv_lora_rank:])
            for i in range(TEXT.num_hidden_layers)]
    rh, rows = ref.step(x[:, 9:10].expand(2, 3, -1), torch.full((2,), 9), hist, mask[..., :9])
    _close(mla_moe.lm_head(lm, h), ref.logits(rh), "member logits")
    for i, (rc, rk) in enumerate(rows):
        _close(c[i], rc, f"layer {i} new latents")
        _close(kpe[i], rk, f"layer {i} new keys")


@pytest.mark.parametrize("mode", ["greedy", "exact", "fused"])
def test_engine_steps_match_the_reference_streams(params, ref, mode):
    """``LlavaEngine`` on the decoder, each decode forward (its masks,
    positions and member logits) against the reference's streams over a
    history that appends the vote winner's rows, as the engine's cache
    does."""
    eng = LlavaEngine(CFG, params, ens=EnsembleConfig(fused_step=mode == "fused"),
                      gen=GenerationConfig(max_new_tokens=6, eos_token_id=-1), max_len=32,
                      ensemble=mode != "greedy")
    calls, orig = [], eng._decode_forward

    def recorded(x, cur_len, cache, mask):
        out = orig(x, cur_len, cache, mask)
        calls.append((x.clone(), cur_len.clone(), mask.clone(), out[0].clone()))
        return out

    eng._decode_forward = recorded
    ids, pixels = _prompt()
    state = eng.prefill(ids, pixels)
    winners = []
    eng.decode(state, winners)
    B, S = ids.shape[0], int(state.cur_len[0])
    R = TEXT.kv_lora_rank
    hist = [[state.cache.ckv[i, b, :S].clone() for b in range(B)] for i in range(TEXT.num_hidden_layers)]
    per_step = 2 if mode == "exact" else 1
    assert len(calls) == per_step * 5
    for step in range(5):
        for x, cur_len, mask, logits in calls[step * per_step:(step + 1) * per_step]:
            cur = int(cur_len[0])
            layers = [(torch.stack([r[:, :R] for r in rows]), torch.stack([r[:, R:] for r in rows]))
                      for rows in hist]
            M = mask.shape[1]
            rh, new = ref.step(x[:, None].expand(B, M, -1), cur_len, layers, mask[..., :cur])
            _close(logits, ref.logits(rh), f"{mode} step {step + 1}")
        member = 0 if mode == "greedy" else winners[step] + (1 if mode == "fused" else 0)
        for i, (c, k) in enumerate(new):
            for b in range(B):
                row = torch.cat([c[b, member[b] if torch.is_tensor(member) else member],
                                 k[b, member[b] if torch.is_tensor(member) else member]])
                hist[i][b] = torch.cat([hist[i][b], row[None]])
    # the engine's cache holds the same appended rows
    for i in range(TEXT.num_hidden_layers):
        for b in range(B):
            _close(state.cache.ckv[i, b, :S + 5], hist[i][b], f"{mode} cache layer {i}")


def test_generate_runs_every_mode_and_probe(params):
    ids, pixels = _prompt(seed=3)
    for mode in ("greedy", "exact", "fused"):
        eng = LlavaEngine(CFG, params, ens=EnsembleConfig(fused_step=mode == "fused"),
                          gen=GenerationConfig(max_new_tokens=4, eos_token_id=-1), max_len=32,
                          ensemble=mode != "greedy")
        assert eng.lm_mod is mla_moe
        out = eng.generate(ids, pixels)
        assert out.tokens.shape == (2, 4)
    probe = eng.probe(ids, pixels)
    state = eng.prefill(ids, pixels)
    assert torch.equal(probe.first_token, state.first_token)
    _close(probe.last_logits, state.last_logits, "probe")


# --- the routing rule ---------------------------------------------------------------


def _router(E=8, D=4):
    """A router layer whose scores are set by hand: h = e_0 picks row 0 of
    the matrix, so sigmoid(router[0]) are the scores."""
    return {"router": torch.zeros(D, E), "router_bias": torch.zeros(E)}


def test_the_bias_picks_the_experts_and_stays_out_of_the_weights():
    cfg = dataclasses.replace(TEXT, num_experts_per_tok=2, routed_scaling_factor=2.446)
    lp = _router()
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, -1.5, -2.0])
    lp["router"][0] = logits
    lp["router_bias"] = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    h = torch.zeros(1, 4)
    h[0, 0] = 1.0
    idx, w, choice = mla_moe.route(cfg, lp, h)
    s = torch.sigmoid(logits)
    assert sorted(idx[0].tolist()) == [0, 7]  # expert 7 chosen by its bias alone
    torch.testing.assert_close(choice[0], s + lp["router_bias"])
    want = torch.stack([s[i] for i in idx[0].tolist()])
    torch.testing.assert_close(w[0], want / (want.sum() + 1e-20) * 2.446)  # no bias in them
    assert abs(w[0].sum().item() - 2.446) < 1e-6
    no_norm = dataclasses.replace(cfg, norm_topk_prob=False)
    torch.testing.assert_close(mla_moe.route(no_norm, lp, h)[1][0], want * 2.446)


def test_top_k_at_a_forced_near_tie():
    """Two experts 1e-6 apart in choice score: the higher is picked, by
    ``route`` and by the reference's rule alike."""
    cfg = dataclasses.replace(TEXT, num_experts_per_tok=3)
    lp = _router()
    lp["router"][0] = torch.tensor([3.0, 2.0, 0.0, 0.0, -1.0, -2.0, -3.0, -4.0])
    lp["router_bias"] = torch.tensor([0.0, 0.0, 1e-6, 0.0, 0.0, 0.0, 0.0, 0.0])
    h = torch.zeros(1, 4)
    h[0, 0] = 1.0
    idx = mla_moe.route(cfg, lp, h)[0][0].tolist()
    assert sorted(idx) == [0, 1, 2]
    lp["router_bias"][2], lp["router_bias"][3] = 0.0, 1e-6
    assert sorted(mla_moe.route(cfg, lp, h)[0][0].tolist()) == [0, 1, 3]


def test_the_routing_matches_the_references(params, ref):
    lm = params.lm
    x = lm["embed_tokens"][torch.randint(0, IMAGE, (1, 12), generator=torch.Generator().manual_seed(9))]
    got = []
    orig = mla_moe.route

    def route(cfg, lp, h):
        out = orig(cfg, lp, h)
        got.append(out)
        return out

    mla_moe.route = route
    try:
        mla_moe.prefill(lm, TEXT, x, torch.arange(12)[None])
    finally:
        mla_moe.route = orig
    ref.forward(x[0])
    assert len(got) == len(ref.routing) == TEXT.n_moe_layers
    for (idx, _, choice), (ref_choice, own) in zip(got, ref.routing):
        assert torch.equal(idx.sort(-1).values, own.sort(-1).values)
        _close(choice, ref_choice, "choice scores")


def test_sort_by_expert_offsets_bound_each_group():
    idx = torch.tensor([[3, 0, 5], [5, 3, 1], [0, 3, 7]])
    order, offsets = mla_moe.sort_by_expert(idx, 8)
    assert offsets.dtype == torch.int32
    assert offsets.tolist() == [0, 2, 3, 3, 6, 6, 8, 8, 9]
    flat = idx.reshape(-1)
    for e in range(8):
        assert (flat[order[offsets[e]:offsets[e + 1]]] == e).all()


# --- K7's twin ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_twin_against_a_per_row_loop(dtype):
    """Rows sorted by expert, experts 0, 3 and 7 with no row: each row's
    SwiGLU by its own expert, h rounded to the operands' dtype once."""
    g = torch.Generator().manual_seed(11)
    E, D, I = 8, 64, 128
    wg, wu, wd = (torch.randn(E, D, I, generator=g).to(dtype), torch.randn(E, D, I, generator=g).to(dtype),
                  torch.randn(E, I, D, generator=g).to(dtype))
    experts = torch.tensor([1, 1, 2, 4, 4, 4, 5, 6, 6, 6, 6])
    xs = torch.randn(len(experts), D, generator=g).to(dtype)
    offsets = torch.searchsorted(experts, torch.arange(E + 1)).to(torch.int32)
    got = cuda_moe.moe_experts(xs, offsets, wg, wu, wd)
    assert got.dtype == torch.float32 and got.shape == (len(experts), D)
    want = torch.stack([
        (torch.nn.functional.silu(x @ wg[e].float()) * (x @ wu[e].float())).to(dtype).float()
        @ wd[e].float() for x, e in zip(xs.float(), experts.tolist())])
    # fp32: summation order; bf16: an h may round to the neighbouring value
    tol = (1e-5 if dtype == torch.float32 else 1e-2) * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def test_k7_constants_are_the_sources():
    src = open(os.path.join(ROOT, "dropoutdecoding_tpu_torch", "csrc", "moe_grouped.cu")).read()
    for name in ("kTileN", "kKC"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == cuda_moe.TILE


def test_the_decode_forward_reads_nothing_back(params, monkeypatch):
    """No host read of the routing in a decode forward (what a CUDA graph
    cannot hold): with K7 stood in by a gather of each row's expert weights
    (fixed shapes), ``tolist``, ``item`` and a tensor's truth value raise."""
    def gathered(xs, offsets, wg, wu, wd):
        e = torch.searchsorted(offsets[1:].long(), torch.arange(xs.shape[0]), right=True)
        x = xs.float()[:, None]
        h = (torch.nn.functional.silu(x @ wg[e].float()) * (x @ wu[e].float())).to(xs.dtype)
        return (h.float() @ wd[e].float())[:, 0]

    monkeypatch.setattr(mla_moe, "moe_experts", gathered)
    lm = params.lm
    cache = mla_moe.empty_cache(TEXT, 2, 12, torch.float32, "cpu")
    x = lm["embed_tokens"][:2, None].expand(2, 3, -1)
    mask = torch.ones(2, 3, 12, dtype=torch.bool)
    want = mla_moe.decode_step(lm, TEXT, x, torch.full((2,), 4), cache, mask)

    def refuse(*a, **k):
        raise AssertionError("a host read inside the decode forward")

    for name in ("tolist", "item", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = mla_moe.decode_step(lm, TEXT, x, torch.full((2,), 4), cache, mask)
    monkeypatch.undo()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --- the HF loader and the config -----------------------------------------------------


def _hf_state_dict(lm: dict, prefix: str = "") -> dict:
    """The decoder's params under the published DeepseekV3 module names,
    linear weights [out, in]."""
    sd = {f"{prefix}model.embed_tokens.weight": lm["embed_tokens"],
          f"{prefix}model.norm.weight": lm["norm"], f"{prefix}lm_head.weight": lm["lm_head"].T}
    names = {"q_proj": "self_attn.q_proj", "kv_a_proj": "self_attn.kv_a_proj_with_mqa",
             "kv_b_proj": "self_attn.kv_b_proj", "o_proj": "self_attn.o_proj"}
    Ld = TEXT.first_k_dense_replace
    for i in range(TEXT.num_hidden_layers):
        base = f"{prefix}model.layers.{i}."
        lay = lm["layers"]
        sd[base + "input_layernorm.weight"] = lay["input_ln"][i]
        sd[base + "post_attention_layernorm.weight"] = lay["post_attn_ln"][i]
        sd[base + "self_attn.kv_a_layernorm.weight"] = lay["kv_a_ln"][i]
        for ours, theirs in names.items():
            sd[base + theirs + ".weight"] = lay[ours][i].T
        if i < Ld:
            for n in ("gate_proj", "up_proj", "down_proj"):
                sd[base + f"mlp.{n}.weight"] = lm["dense"][n][i].T
            continue
        m, j = lm["moe"], i - Ld
        sd[base + "mlp.gate.weight"] = m["router"][j].T
        sd[base + "mlp.gate.e_score_correction_bias"] = m["router_bias"][j]
        for n in ("gate_proj", "up_proj", "down_proj"):
            sd[base + f"mlp.shared_experts.{n}.weight"] = m[f"shared_{n}"][j].T
            for e in range(TEXT.n_routed_experts):
                sd[base + f"mlp.experts.{e}.{n}.weight"] = m[n][j, e].T
    return sd


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_the_hf_loader_reads_the_published_names(params):
    got = mla_moe.params_from_hf(TEXT, _hf_state_dict(params.lm), torch.float32, "cpu")
    _equal_trees(got, params.lm)
    assert got["moe"]["router_bias"].dtype == torch.float32


def test_a_llava_checkpoint_with_this_decoder_loads_through_llava(params):
    from dropoutdecoding_tpu_torch.models import clip_vit, projector

    sd = _hf_state_dict(params.lm, prefix="language_model.")
    sd.update({k: v for k, v in _clip_sd(params).items()})
    got = llava_mod.params_from_hf(CFG, sd, torch.float32, "cpu")
    _equal_trees(got.lm, params.lm)
    assert clip_vit and projector


def _clip_sd(params) -> dict:
    """The tower and projector in HF names, by the port's own converters'
    inverse (``chip_smoke.llava_hf_tensors``' layout)."""
    v, p = params.vision, params.projector
    pre = "vision_tower.vision_model."
    sd = {pre + "embeddings.class_embedding": v["class_embedding"],
          pre + "embeddings.patch_embedding.weight":
              v["patch_embedding"].T.reshape(VISION.hidden_size, 3, 7, 7),
          pre + "embeddings.position_embedding.weight": v["position_embedding"],
          pre + "pre_layrnorm.weight": v["pre_ln_w"], pre + "pre_layrnorm.bias": v["pre_ln_b"],
          "multi_modal_projector.linear_1.weight": p["fc1_w"].T,
          "multi_modal_projector.linear_1.bias": p["fc1_b"],
          "multi_modal_projector.linear_2.weight": p["fc2_w"].T,
          "multi_modal_projector.linear_2.bias": p["fc2_b"]}
    L = v["layers"]
    names = {"q_w": "self_attn.q_proj", "k_w": "self_attn.k_proj", "v_w": "self_attn.v_proj",
             "out_w": "self_attn.out_proj", "fc1_w": "mlp.fc1", "fc2_w": "mlp.fc2"}
    for i in range(VISION.num_hidden_layers):
        base = f"{pre}encoder.layers.{i}."
        for ours, theirs in names.items():
            sd[base + theirs + ".weight"] = L[ours][i].T
            sd[base + theirs + ".bias"] = L[ours[:-1] + "b"][i]
        for ln in ("1", "2"):
            sd[base + f"layer_norm{ln}.weight"] = L[f"ln{ln}_w"][i]
            sd[base + f"layer_norm{ln}.bias"] = L[f"ln{ln}_b"][i]
    return sd


def test_the_benchmark_config_is_kimi_vl_a3b():
    with open(os.path.join(ROOT, "benchmark", "configs", "kimi-vl-a3b.clip336.json")) as f:
        config = json.load(f)
    cfg = LlavaConfig.from_hf_dict(config)
    assert cfg.text == MlaMoeConfig()  # the defaults are the published widths
    assert (cfg.text.latent_dim, cfg.text.qk_head_dim, cfg.text.n_moe_layers) == (576, 192, 26)
    assert cfg.vision == ClipVisionConfig() and cfg.image_token_index < cfg.text.vocab_size
    assert config["reduced"] == []


@pytest.mark.parametrize("key, value", [("q_lora_rank", 1536), ("rope_scaling", {"type": "yarn"}),
                                        ("n_group", 8), ("scoring_func", "softmax"),
                                        ("attention_bias", True), ("hidden_act", "gelu")])
def test_a_config_this_decoder_cannot_run_raises(key, value):
    d = {"model_type": "deepseek_v3", **dataclasses.asdict(TEXT), key: value}
    with pytest.raises(ValueError, match="does not run"):
        text_config_from_hf(d)


# --- what the decoder refuses ------------------------------------------------------------


def _engine(params, **fields):
    return LlavaEngine(CFG, params, gen=GenerationConfig(max_new_tokens=3), max_len=32, **fields)


def _refusals():
    def int8_kv(p):
        _engine(p, int8_kv=True)

    def w8a8(p):
        _engine(p, w8a8_decode=True)

    def int8_tier(p):
        from dropoutdecoding_tpu_torch.utils.quantize import quantize_llama_params

        quantize_llama_params(p.lm)

    def int4_tier(p):
        from dropoutdecoding_tpu_torch.utils.quantize import quantize_llama_params_int4

        quantize_llama_params_int4(p.lm)

    def tp_sharding(p):
        from dropoutdecoding_tpu_torch.parallel.mesh import shard_llama_params

        shard_llama_params(p.lm, mesh=None)  # refused before any mesh is read

    def tp_mesh(p):
        from dropoutdecoding_tpu_torch.parallel.mesh import ShardedParams

        lm = ShardedParams(p.lm)
        lm.mesh = object()  # params a mesh was cut for: the engine finds it
        _engine(type(p)(p.vision, p.projector, lm))

    def next_engine(p):
        from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
        from dropoutdecoding_tpu_torch.models.llavanext import LlavaNextParams
        from dropoutdecoding_tpu_torch.utils.config import LlavaNextConfig

        cfg = LlavaNextConfig(text=TEXT, vision=VISION, image_token_index=IMAGE)
        LlavaNextEngine(cfg, LlavaNextParams(p.vision, p.projector, torch.zeros(64), p.lm))

    def speculation(p):
        from dropoutdecoding_tpu_torch.engine.speculative import SpeculativeGreedy

        SpeculativeGreedy(_engine(p, ensemble=False), None, draft="ngram")

    def chunked_prefill(p):
        _engine(p).prefill_chunked(*_prompt(B=1))

    def prefix_cache(p):
        ids, pixels = _prompt(B=1)
        _engine(p).probe_prefix(ids, pixels)

    def decode_server(p):
        from dropoutdecoding_tpu_torch.engine.serving import DecodeServer

        DecodeServer(_engine(p))

    def vcd(p):
        from dropoutdecoding_tpu_torch.engine.baselines import vcd_generate

        vcd_generate(_engine(p, ensemble=False), *_prompt(B=1))

    return [int8_kv, w8a8, int8_tier, int4_tier, tp_sharding, tp_mesh, next_engine, speculation,
            chunked_prefill, prefix_cache, decode_server, vcd]


@pytest.mark.parametrize("case", _refusals(), ids=lambda f: f.__name__)
def test_an_unsupported_combination_raises(params, case):
    with pytest.raises(ValueError, match="not supported with the MLA \\+ MoE decoder"):
        case(params)


def test_the_decoder_module_follows_the_text_config():
    assert generate.decoder_module(TEXT) is mla_moe
    assert generate.decoder_module(LlavaConfig().text).__name__.endswith("models.llama")
