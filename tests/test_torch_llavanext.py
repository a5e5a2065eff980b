"""The LLaVA-NeXT slice: the port's anyres geometry, packing, merge, the
``epis_no_overlap`` policy and ``LlavaNextEngine`` against the JAX package.

The narrow model has 112 px tiles in 7 px patches (256 per tile) on the
pinpoints (112, 224), (224, 112) and (224, 224), so N_max = 256 + 32 * 33 =
1312 visual slots and the merged prompt is over 1024 tokens: the LM
prefill takes the K5 switch (its CPU twin here, JAX's query-chunked
attention there).  Its LM is 2 layers x 64 wide, 4 heads over 2 KV heads.
Weights are numpy from a seed, at std 0.2 so that argmax decisions are
stable against fp32 summation order, and go to both packages.  The JAX
engine's own mask draws are injected into the port, so tokens must be
equal; epis agrees to 1e-5 (the port takes K2's exact-entropy form, the JAX
CPU path log(p + 1e-10); both fp32).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.decoding import masks as jmasks
from dropoutdecoding_tpu.engine.llavanext_engine import LlavaNextEngine as JaxNextEngine
from dropoutdecoding_tpu.models import llavanext as jnext
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.decoding import masks as tmasks
from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
from dropoutdecoding_tpu_torch.models import llavanext as tnext
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import llavanext_params_from_numpy
from test_torch_engine import jax_uniform

SEED = 506  # the reference's LLaVA-NeXT seed
IMAGE = 120  # <image> token id of the narrow model
INPUT_IDS = np.array([[1, 5, 9, IMAGE, 11, 13, 17, 19, 23]])
SIZE = (150, 220)  # 2 x 2 grid, unpadded to 22 of 32 cell rows: 982 of 1312 slots
TINY_PINPOINTS = ((28, 56), (56, 28), (56, 56))  # tests/test_llavanext_parity.py


def narrow_config(C):
    """The narrow LLaVA-NeXT config, from config module ``C`` (either
    package's)."""
    return C.LlavaNextConfig(
        text=C.LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            max_position_embeddings=4096,
        ),
        vision=C.ClipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=4, image_size=112, patch_size=7,
        ),
        image_token_index=IMAGE,
        image_grid_pinpoints=((112, 224), (224, 112), (224, 224)),
    )


def tiny_config(C):
    return C.LlavaNextConfig(
        vision=C.ClipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=4, image_size=28, patch_size=7,
        ),
        image_grid_pinpoints=TINY_PINPOINTS,
    )


def narrow_tree(seed=0, std=0.2):
    """Numpy LlavaNextParams of the narrow config."""
    r = np.random.default_rng(seed)

    def n(*shape, sc=std):
        return (sc * r.normal(size=shape)).astype(np.float32)

    def one(*shape):
        return (1 + 0.1 * r.normal(size=shape)).astype(np.float32)

    D, I, L, P, E, L2, V, F = 32, 64, 3, 7, 64, 2, 128, 128
    H, KH, Dh = 4, 2, 16
    vision = {
        "class_embedding": n(D), "patch_embedding": n(3 * P * P, D),
        "position_embedding": n(257, D), "pre_ln_w": one(D), "pre_ln_b": n(D, sc=0.1),
        "layers": {
            "ln1_w": one(L, D), "ln1_b": n(L, D, sc=0.1),
            "ln2_w": one(L, D), "ln2_b": n(L, D, sc=0.1),
            "q_w": n(L, D, D), "q_b": n(L, D, sc=0.1),
            "k_w": n(L, D, D), "k_b": n(L, D, sc=0.1),
            "v_w": n(L, D, D), "v_b": n(L, D, sc=0.1),
            "out_w": n(L, D, D), "out_b": n(L, D, sc=0.1),
            "fc1_w": n(L, D, I), "fc1_b": n(L, I, sc=0.1),
            "fc2_w": n(L, I, D), "fc2_b": n(L, D, sc=0.1),
        },
    }
    projector = {"fc1_w": n(D, E), "fc1_b": n(E, sc=0.1), "fc2_w": n(E, E), "fc2_b": n(E, sc=0.1)}
    lm = {
        "embed_tokens": n(V, E, sc=1.0),
        "layers": {
            "input_ln": one(L2, E), "post_attn_ln": one(L2, E),
            "q_proj": n(L2, E, H * Dh), "k_proj": n(L2, E, KH * Dh),
            "v_proj": n(L2, E, KH * Dh), "o_proj": n(L2, H * Dh, E),
            "gate_proj": n(L2, E, F), "up_proj": n(L2, E, F), "down_proj": n(L2, F, E),
        },
        "norm": one(E),
        "lm_head": n(E, V, sc=0.5),
    }
    return jnext.LlavaNextParams(
        vision=vision, projector=projector, image_newline=n(E, sc=1.0), lm=lm
    )


def tiles_for(cfg, size, seed=1):
    n = tnext.image_geometry(size, cfg)["n_tiles"]
    s = cfg.vision.image_size
    return np.random.default_rng(seed).normal(size=(n, 3, s, s)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    tree = narrow_tree()
    jp = jax.tree.map(jnp.asarray, tree)
    return jp, llavanext_params_from_numpy(tree)


def _engines(weights, ensemble=True, max_new_tokens=6, **ens):
    jp, tp = weights
    ens = {"mask_accumulate": False, "topk": 10, **ens}  # the LLaVA-NeXT defaults
    kw = dict(max_new_tokens=max_new_tokens, eos_token_id=-1, pad_token_id=0)
    je = JaxNextEngine(
        cfg=narrow_config(jax_config), params=jp, ens=jax_config.EnsembleConfig(**ens),
        gen=jax_config.GenerationConfig(**kw), max_len=1344, seed=SEED, ensemble=ensemble,
    )
    je.param_dtype = jnp.float32
    te = LlavaNextEngine(
        cfg=narrow_config(torch_config), params=tp, ens=torch_config.EnsembleConfig(**ens),
        gen=torch_config.GenerationConfig(**kw), max_len=1344, seed=SEED, ensemble=ensemble,
        uniform=jax_uniform(SEED),
    )
    return je, te


# --- host-side geometry, packing and merge ----------------------------------


def _random_sizes(n=50, seed=3):
    r = np.random.default_rng(seed)
    return [(int(h), int(w)) for h, w in r.integers(10, 400, size=(n, 2))]


def test_geometry_matches_jax():
    jc, tc = tiny_config(jax_config), tiny_config(torch_config)
    assert tnext.max_image_tokens(tc) == jnext.max_image_tokens(jc) == 16 + 8 * 9
    assert tnext.max_image_tokens(torch_config.LlavaNextConfig()) == 2928
    for size in _random_sizes():
        assert tnext.image_geometry(size, tc) == jnext.image_geometry(size, jc), size


@pytest.mark.parametrize("pad_tiles", [None, 5])
def test_packing_indices_match_jax(pad_tiles):
    jc, tc = tiny_config(jax_config), tiny_config(torch_config)
    n_max = tnext.max_image_tokens(tc)
    for size in _random_sizes():
        geo = tnext.image_geometry(size, tc)
        got = tnext.packing_indices(tc, geo, n_max, pad_tiles=pad_tiles)
        ref = jnext.packing_indices(jc, geo, n_max, pad_tiles=pad_tiles)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_pack_and_merge_batched_match_jax(weights):
    """B = 2 with different tile counts (5 and 3) and text lengths."""
    jp, tp = weights
    jc, tc = narrow_config(jax_config), narrow_config(torch_config)
    n_max = tnext.max_image_tokens(tc)
    sizes = [SIZE, (100, 230)]
    geos = [tnext.image_geometry(s, tc) for s in sizes]
    assert [g["n_tiles"] for g in geos] == [5, 3]
    t_pad = 5
    tiles = np.zeros((2, t_pad, 3, 112, 112), np.float32)
    plans = [tnext.packing_indices(tc, g, n_max, pad_tiles=t_pad) for g in geos]
    for b, g in enumerate(geos):
        tiles[b, : g["n_tiles"]] = tiles_for(tc, sizes[b], seed=b)
    gather = np.stack([p[0] for p in plans])
    valid = np.stack([p[1] for p in plans])
    ref = jnext.pack_image_features_batched(jc, jp, jnp.asarray(tiles), jnp.asarray(gather))
    got = tnext.pack_image_features_batched(
        tc, tp, torch.from_numpy(tiles), torch.from_numpy(gather)
    )
    # atol 3e-5: the CLIP tower's fp32 sums run in another order, and its
    # O(5) features come out up to 8.1e-6 apart; the gather itself is exact
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=3e-5)
    one = tnext.pack_image_features(
        tc, tp, torch.from_numpy(tiles[1, :3]),
        torch.from_numpy(tnext.packing_indices(tc, geos[1], n_max)[0]),
    )
    np.testing.assert_allclose(one.numpy(), np.asarray(ref[1]), rtol=0, atol=3e-5)

    # the merge is a gather: the same packed features give the same rows
    packed = np.array(ref)

    rng = np.random.default_rng(4)
    embeds = rng.normal(size=(2, 9, 64)).astype(np.float32)
    image_pos = np.array([3, 1])
    text_lens = np.array([9, 6])
    for lens in (None, text_lens):
        r_out = jnext.merge_with_text_batched(
            jnp.asarray(embeds), jnp.asarray(packed), jnp.asarray(valid), jnp.asarray(image_pos),
            None if lens is None else jnp.asarray(lens),
        )
        t_out = tnext.merge_with_text_batched(
            torch.from_numpy(embeds), torch.from_numpy(packed), torch.from_numpy(valid),
            torch.from_numpy(image_pos),
            None if lens is None else torch.from_numpy(lens),
        )
        np.testing.assert_allclose(t_out[0].numpy(), np.asarray(r_out[0]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(r_out[1]))
        np.testing.assert_array_equal(t_out[2].numpy(), np.asarray(r_out[2]))
    r1 = jnext.merge_with_text(
        jnp.asarray(embeds[1]), jnp.asarray(packed[1]), jnp.asarray(valid[1]), 1
    )
    t1 = tnext.merge_with_text(
        torch.from_numpy(embeds[1]), torch.from_numpy(packed[1]), torch.from_numpy(valid[1]), 1
    )
    np.testing.assert_allclose(t1[0].numpy(), np.asarray(r1[0]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t1[1].numpy(), np.asarray(r1[1]))
    assert int(t1[2]) == int(r1[2])


# --- the epis_no_overlap policy ---------------------------------------------


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("with_valid", [False, True])
def test_epis_no_overlap_matches_jax(rng, accumulate, with_valid):
    N = 40
    epis = rng.gamma(2.0, 1.0, size=N).astype(np.float32)
    overlap = rng.random(N) > 0.5
    valid = np.arange(N) < 31 if with_valid else None
    prev_j = jnp.zeros((N,), bool)
    prev_t = torch.zeros(N, dtype=torch.bool)
    for m, cap in enumerate((0.3, 0.5, 0.7)):
        key = jax.random.fold_in(jax.random.key(9), m)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (N,))))
        ref = jmasks.build_member_drop_mask(
            key, "epis_no_overlap", jnp.asarray(epis), cap, jnp.asarray(overlap), prev_j,
            accumulate, valid=None if valid is None else jnp.asarray(valid),
        )
        got = tmasks.build_member_drop_mask(
            u, "epis_no_overlap", torch.from_numpy(epis), cap, torch.from_numpy(overlap),
            prev_t, accumulate, valid=None if valid is None else torch.from_numpy(valid),
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert (got.numpy() & overlap).any()  # the overlap set is not restored
        prev_j, prev_t = ref, got


# --- the slice: LlavaNextEngine against the JAX engine -----------------------


@pytest.mark.parametrize(
    "ensemble,ens",
    [
        (False, {}),  # greedy
        (True, {}),  # exact K=3, epis, no accumulation, topk 10 (the NeXT defaults)
        (True, {"mask_policy": "epis_no_overlap"}),  # the NeXT use_random ablation
    ],
    ids=["greedy", "exact-epis", "exact-no-overlap"],
)
def test_generate_matches_jax_engine(weights, ensemble, ens):
    je, te = _engines(weights, ensemble=ensemble, **ens)
    tiles = tiles_for(te.cfg, SIZE)
    ref = je.generate(INPUT_IDS, tiles, SIZE)
    got = te.generate(INPUT_IDS, tiles, SIZE)
    assert got.tokens.shape == (1, 6)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)


def test_ensemble_masks_change_the_output(weights):
    """Exact K=3 departs from greedy within the 6 tokens the parity above
    compares, so that parity is not vacuous."""
    _, greedy = _engines(weights, ensemble=False)
    _, exact = _engines(weights, ensemble=True)
    tiles = tiles_for(greedy.cfg, SIZE)
    assert not np.array_equal(
        greedy.generate(INPUT_IDS, tiles, SIZE).tokens, exact.generate(INPUT_IDS, tiles, SIZE).tokens
    )


def test_prefill_state_matches_jax(weights):
    """B = 2, images of 5 and 3 tiles: per-row real lengths, visual masks
    and image positions; the merged prompt is 8 + 1312 = 1320 tokens."""
    je, te = _engines(weights)
    ids = np.array([[1, 5, 9, IMAGE, 11, 13, 17, 19, 23], [1, IMAGE, 7, 8, 9, 10, 11, 12, 13]])
    sizes = [SIZE, (100, 230)]
    tiles = [tiles_for(te.cfg, s, seed=b) for b, s in enumerate(sizes)]
    js, ts = je.prefill(ids, tiles, sizes), te.prefill(ids, tiles, sizes)
    np.testing.assert_array_equal(ts.cur_len.numpy(), np.asarray(js.cur_len))
    np.testing.assert_array_equal(ts.image_pos.numpy(), np.asarray(js.image_pos))
    np.testing.assert_array_equal(ts.visual_mask.numpy(), np.asarray(js.visual_mask))
    np.testing.assert_array_equal(ts.topk_ids.numpy(), np.asarray(js.topk_ids))
    np.testing.assert_array_equal(ts.first_token.numpy(), np.asarray(js.first_token))
    valid = ts.visual_mask.numpy()
    np.testing.assert_allclose(
        ts.epis.numpy()[valid], np.asarray(js.epis)[valid], rtol=0, atol=1e-5
    )
    for key in ("epis_uncert", "alea_uncert", "variance"):
        np.testing.assert_allclose(
            ts.uncertainty[key].numpy(), np.asarray(js.uncertainty[key]), rtol=1e-5, atol=1e-5
        )
    np.testing.assert_allclose(
        ts.last_logits.numpy(), np.asarray(js.last_logits), rtol=1e-5, atol=1e-4
    )
    for b, n in enumerate(ts.cur_len.tolist()):
        np.testing.assert_allclose(
            ts.cache.k[:, b, :n].numpy(), np.asarray(js.cache.k[:, b, :n]), rtol=1e-5, atol=1e-4
        )


def test_masks_stay_inside_the_real_span(weights):
    """Drop slots fall only on real visual tokens: none past the span's
    real end, although its padded tail holds the same epis range."""
    _, te = _engines(weights)
    tiles = tiles_for(te.cfg, SIZE)
    state = te.prefill(INPUT_IDS, tiles, SIZE)
    n_img = int(state.visual_mask.sum())
    assert n_img == 982 < te.n_visual == 1312
    drops = te._member_drop_slots(state, state.first_token, step=1)  # [1, K, Smax]
    slots = torch.nonzero(drops[0].any(dim=0))[:, 0]
    start = int(state.image_pos[0])
    assert len(slots) > 0
    assert int(slots.min()) >= start and int(slots.max()) < start + n_img


def test_kv_capacity_guard_runs_before_any_work(weights):
    """The guard counts the real length (9 - 1 + 982 = 990), as the JAX
    engine's ``cur_len``: 990 + 356 - 1 > 1344, a budget JAX refuses too."""
    je, te = _engines(weights, max_new_tokens=356)
    with pytest.raises(ValueError, match="exceeds the KV capacity"):
        te.generate(INPUT_IDS, None, SIZE)  # no tiles: the guard fires first
    with pytest.raises(ValueError, match="exceeds max_len"):
        je.generate(INPUT_IDS, tiles_for(je.cfg, SIZE), SIZE)


def test_kv_capacity_guard_keeps_the_padded_prompt_in_the_cache(weights):
    """The padded prompt (9 - 1 + 1312 = 1320 slots) must fit the cache for
    its seeding, whatever the budget."""
    jp, tp = weights
    te = LlavaNextEngine(
        cfg=narrow_config(torch_config), params=tp, max_len=1300, ensemble=False,
        gen=torch_config.GenerationConfig(max_new_tokens=1, eos_token_id=-1, pad_token_id=0),
    )
    with pytest.raises(ValueError, match="merged prompt \\(1320 slots\\) exceeds"):
        te.generate(INPUT_IDS, None, SIZE)


def test_generates_up_to_the_real_length_as_jax(weights):
    """40 greedy tokens where the padded prompt would not leave room for
    them (1320 + 39 > 1344) but the real one does (990 + 39): both packages
    generate, token for token."""
    je, te = _engines(weights, ensemble=False, max_new_tokens=40)
    tiles = tiles_for(te.cfg, SIZE)
    ref = je.generate(INPUT_IDS, tiles, SIZE)
    got = te.generate(INPUT_IDS, tiles, SIZE)
    assert got.tokens.shape == (1, 40)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)


@pytest.mark.parametrize("chunk", [256, 500])
def test_prefill_chunked_matches_jax(weights, chunk):
    """``prefill_chunked`` of the 1320-slot merge (990 real) in pieces that
    do not divide it, against the JAX engine's: the cache's real slots, the
    logits at rtol 1e-5 / atol 1e-4 (fp32 sums in another order over two
    layers), epis (values 1-5) at rtol 1e-5 / atol 1e-5 on the real visual
    tokens (the pieces' extend attention sums in another order than the
    one-shot prefill's; 1.5e-5 apart at 4.2 measured), the table and the
    first token equal; the pieces past the real length run over masked pad
    slots."""
    TOL = dict(rtol=1e-5, atol=1e-4)
    je, te = _engines(weights)
    tiles = tiles_for(te.cfg, SIZE)
    js = je.prefill_chunked(INPUT_IDS, tiles, SIZE, chunk=chunk)
    ts = te.prefill_chunked(INPUT_IDS, tiles, SIZE, chunk=chunk)
    n = int(ts.cur_len[0])
    assert n == int(js.cur_len[0]) == 990
    np.testing.assert_allclose(ts.cache.k[:, :, :n].numpy(), np.asarray(js.cache.k[:, :, :n]),
                               **TOL)
    np.testing.assert_allclose(ts.cache.v[:, :, :n].numpy(), np.asarray(js.cache.v[:, :, :n]),
                               **TOL)
    np.testing.assert_allclose(ts.last_logits.numpy(), np.asarray(js.last_logits), **TOL)
    valid = ts.visual_mask.numpy()
    np.testing.assert_allclose(ts.epis.numpy()[valid], np.asarray(js.epis)[valid], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ts.topk_ids.numpy()[valid], np.asarray(js.topk_ids)[valid])
    assert int(ts.first_token[0]) == int(js.first_token[0])
