"""Port models against the JAX package on one set of weights.

Tiny LLaVA at the widths of ``conftest.tiny_llava`` (vision 32 wide, 3
layers, 28 px images in 7 px patches; LM 48 wide, 2 layers, vocab 64), with
numpy weights shared through ``llava_params_from_numpy``.  Tolerance atol
1e-4 (rtol 1e-5): fp32 on both sides, with a few layers of summation-order
differences compounding.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.models import clip_vit as jclip
from dropoutdecoding_tpu.models import llama as jllama
from dropoutdecoding_tpu.models import llava as jllava
from dropoutdecoding_tpu.models import projector as jproj
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.models import clip_vit as tclip
from dropoutdecoding_tpu_torch.models import llama as tllama
from dropoutdecoding_tpu_torch.models import llava as tllava
from dropoutdecoding_tpu_torch.models import projector as tproj
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import llava_params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-4)
INPUT_IDS = np.array([[1, 5, 9, 32, 11, 13, 17]])  # image token 32 at 3


def tiny_config(C):
    """The tiny LLaVA config, built from config module ``C`` (either
    package's)."""
    return C.LlavaConfig(
        text=C.LlamaConfig(
            vocab_size=64, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, head_dim=12,
            max_position_embeddings=128,
        ),
        vision=C.ClipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=4, image_size=28, patch_size=7,
        ),
        image_token_index=32,
    )


def tiny_tree(seed=0, std=0.2):
    """(numpy LlavaParams, pixels [1, 3, 28, 28]).  Weights at std 0.2 with
    non-trivial norms and biases, so the tiny LM's logits are sharp enough
    for argmax decisions to be stable against fp32 rounding."""
    r = np.random.default_rng(seed)

    def n(*shape, sc=std):
        return (sc * r.normal(size=shape)).astype(np.float32)

    def one(*shape):
        return (1 + 0.1 * r.normal(size=shape)).astype(np.float32)

    D, I, L, P, E, L2, V = 32, 64, 3, 7, 48, 2, 64
    vision = {
        "class_embedding": n(D), "patch_embedding": n(3 * P * P, D),
        "position_embedding": n(17, D), "pre_ln_w": one(D), "pre_ln_b": n(D, sc=0.1),
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
            "q_proj": n(L2, E, E), "k_proj": n(L2, E, E), "v_proj": n(L2, E, E),
            "o_proj": n(L2, E, E), "gate_proj": n(L2, E, 96), "up_proj": n(L2, E, 96),
            "down_proj": n(L2, 96, E),
        },
        "norm": one(E),
        "lm_head": n(E, V),
    }
    pixels = r.normal(size=(1, 3, 28, 28)).astype(np.float32)
    return jllava.LlavaParams(vision, projector, lm), pixels


@pytest.fixture(scope="module")
def tiny():
    tree, pixels = tiny_tree()
    return {
        "jcfg": tiny_config(jax_config),
        "tcfg": tiny_config(torch_config),
        "jp": jax.tree.map(jnp.asarray, tree),
        "tp": llava_params_from_numpy(tree),
        "pixels": pixels,
    }


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **(tol or TOL))


def test_params_convert_as_copies(tiny):
    for part in ("vision", "projector", "lm"):
        jt = getattr(tiny["jp"], part)
        tt = getattr(tiny["tp"], part)
        flat_j = jax.tree_util.tree_leaves_with_path(jt)
        assert len(flat_j) == len(jax.tree_util.tree_leaves(tt))
        for path, leaf in flat_j:
            t = tt
            for key in path:
                t = t[key.key]
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_patchify(rng):
    x = rng.normal(size=(2, 3, 28, 28)).astype(np.float32)
    got = tclip.patchify(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jclip.patchify(jnp.asarray(x), 7)))


@pytest.mark.parametrize("feature_layer", [-2, -1, 1])
def test_clip_tower(tiny, feature_layer):
    cfg_t, cfg_j = tiny["tcfg"].vision, tiny["jcfg"].vision
    got = tclip.apply(cfg_t, tiny["tp"].vision, torch.from_numpy(tiny["pixels"]), feature_layer)
    ref = jclip.apply(cfg_j, tiny["jp"].vision, jnp.asarray(tiny["pixels"]), feature_layer)
    assert got.shape == (1, 17, 32)
    _close(got, ref)


def test_projector(tiny, rng):
    x = rng.normal(size=(1, 16, 32)).astype(np.float32)
    got = tproj.apply(tiny["tp"].projector, torch.from_numpy(x), "gelu")
    _close(got, jproj.apply(tiny["jp"].projector, jnp.asarray(x), "gelu"))


def test_image_features_and_merge(tiny, rng):
    got = tllava.image_features(tiny["tcfg"], tiny["tp"], torch.from_numpy(tiny["pixels"]))
    ref = jllava.image_features(tiny["jcfg"], tiny["jp"], jnp.asarray(tiny["pixels"]))
    assert got.shape == (1, 16, 48)
    _close(got, ref)

    ids = np.array([[1, 32, 4, 5, 6], [7, 8, 9, 10, 32]])
    pos_t = tllava.find_image_pos(torch.from_numpy(ids), 32)
    pos_j = jllava.find_image_pos(jnp.asarray(ids), 32)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    emb = rng.normal(size=(2, 5, 6)).astype(np.float32)
    feats = rng.normal(size=(2, 3, 6)).astype(np.float32)
    merged = tllava.merge_image_features(torch.from_numpy(emb), torch.from_numpy(feats), pos_t.long())
    ref = jllava.merge_image_features(jnp.asarray(emb), jnp.asarray(feats), pos_j)
    assert merged.shape == (2, 7, 6)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(ref))


def _prefill_both(tiny, rng, S=10):
    x = rng.normal(size=(1, S, 48)).astype(np.float32)
    pos = np.arange(S)[None]
    ht, kvt = tllama.prefill(tiny["tp"].lm, tiny["tcfg"].text, torch.from_numpy(x), torch.from_numpy(pos))
    hj, kvj = jllama.prefill(tiny["jp"].lm, tiny["jcfg"].text, jnp.asarray(x), jnp.asarray(pos))
    return (ht, kvt), (hj, kvj)


def test_prefill(tiny, rng):
    (ht, kvt), (hj, kvj) = _prefill_both(tiny, rng)
    _close(ht, hj)
    _close(kvt.k, kvj.k)
    _close(kvt.v, kvj.v)
    _close(tllama.lm_head(tiny["tp"].lm, ht), jllama.lm_head(tiny["jp"].lm, hj))


def test_decode_step_members_share_cache(tiny, rng):
    S0, Smax, M = 10, 32, 3
    (ht, kvt), (hj, kvj) = _prefill_both(tiny, rng, S=S0)
    tcfg, jcfg = tiny["tcfg"].text, tiny["jcfg"].text
    ct = tllama.cache_seed(tllama.empty_cache(tcfg, 1, Smax, torch.float32, "cpu"), kvt)
    cj = jllama.cache_seed(jllama.empty_cache(jcfg, 1, Smax, jnp.float32), kvj)
    _close(ct.k, cj.k)

    x = np.repeat(rng.normal(size=(1, 1, 48)).astype(np.float32), M, axis=1)
    cur = np.array([S0])
    mask = (np.arange(Smax)[None, None] < S0) & (rng.random((1, M, Smax)) > 0.3)
    mask[0, 2] = False  # a member with a fully masked cache
    hjd, kj, vj = jllama.decode_step(
        tiny["jp"].lm, jcfg, jnp.asarray(x), jnp.asarray(cur), cj, jnp.asarray(mask)
    )
    htd, kt, vt = tllama.decode_step(
        tiny["tp"].lm, tcfg, torch.from_numpy(x), torch.from_numpy(cur), ct, torch.from_numpy(mask)
    )
    assert htd.shape == (1, M, 48) and kt.shape == (2, 1, M, 4, 12)
    _close(htd, hjd)
    _close(kt, kj)
    _close(vt, vj)

    # the winner's K/V append, in place on the port's side
    winner = 1
    cj = jllama.cache_set_rows(cj, jnp.asarray(cur), kj[:, :, winner], vj[:, :, winner])
    out = tllama.cache_set_rows(ct, torch.from_numpy(cur), kt[:, :, winner], vt[:, :, winner])
    assert out.k is ct.k
    _close(ct.k, cj.k)
    _close(ct.v, cj.v)


def test_unported_branches_raise(tiny):
    """int8 weights and the int8 cache (``test_torch_quantize.py``), packed
    int4 weights (``test_torch_int4.py``), w8a8 (``test_torch_w8a8.py``)
    and tensor parallelism (``test_torch_tp.py``) are ported: nothing
    raises.  ``decode_step(tp_mesh=...)`` runs; over a one-rank model axis
    it is the unsharded step, bit for bit."""
    from dropoutdecoding_tpu_torch.parallel.mesh import Mesh

    cfg = tiny["tcfg"].text
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.normal(size=(1, 2, 48)).astype(np.float32))
    cache = tllama.empty_cache(cfg, 1, 8, torch.float32, "cpu")
    tllama.cache_seed(cache, tllama.KVCache(
        *(torch.from_numpy(r.normal(size=(2, 1, 5, 4, 12)).astype(np.float32)) for _ in "kv")))
    mask = torch.ones(1, 2, 8, dtype=torch.bool)
    mask[:, 1, 2] = False
    pos = torch.full((1,), 5, dtype=torch.long)
    plain = tllama.decode_step(tiny["tp"].lm, cfg, x, pos, cache, mask)
    got = tllama.decode_step(tiny["tp"].lm, cfg, x, pos, cache, mask, tp_mesh=Mesh(1, 1))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_w8a8_on_dense_weights_matches_jax(tiny):
    """w8a8 on dense weights is the dense path in both packages (JAX
    ``_mm_w8a8`` takes ``_mm``): ``prefill`` and ``decode_step`` with
    ``w8a8=True`` equal the port's own runs without, bit for bit, and JAX's
    within ``TOL``."""
    cfg, jcfg, lm = tiny["tcfg"].text, tiny["jcfg"].text, tiny["tp"].lm
    x = np.random.default_rng(3).normal(size=(1, 5, 48)).astype(np.float32)
    pos = np.arange(5)[None]
    ht, kvt = tllama.prefill(lm, cfg, torch.from_numpy(x), torch.from_numpy(pos), w8a8=True)
    hj, _ = jllama.prefill(tiny["jp"].lm, jcfg, jnp.asarray(x), jnp.asarray(pos), w8a8=True)
    assert torch.equal(ht, tllama.prefill(lm, cfg, torch.from_numpy(x), torch.from_numpy(pos))[0])
    _close(ht, hj)
    cache = tllama.empty_cache(cfg, 1, 8, torch.float32, "cpu")
    tllama.cache_seed(cache, kvt)
    mask = torch.arange(8)[None, None] < 5
    step = (lm, cfg, torch.from_numpy(x[:, :1]), torch.tensor([5]), cache, mask)
    assert torch.equal(tllama.decode_step(*step, w8a8=True)[0], tllama.decode_step(*step)[0])
