"""The port's OPERA (``decoding/opera.py``, ``models/llama.decode_step_attn``,
``engine/opera.py``) against the JAX package's, fp32 on the CPU.

The math on the hand-built cases of ``tests/test_opera.py`` (exact to
1e-5), and on random rows against the JAX functions (1e-5);
``decode_step_attn`` against JAX's on dense and int8 caches (hidden, K/V
and the attention row within 2e-5: fp32 sums in another order) and its
hidden state against ``decode_step``'s at M = 1 in the port (1e-5); the
search token-exact against ``opera_generate`` of the JAX package, with the
fan-out (nc > 1), rollbacks and an int8 cache (K4's twin).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.decoding import opera as jop
from dropoutdecoding_tpu.engine import opera as jeng
from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.models import llama as jllama
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.decoding import opera as top
from dropoutdecoding_tpu_torch.engine import baselines as tbase
from dropoutdecoding_tpu_torch.engine import opera as teng
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.models import llama as tllama
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import llava_params_from_numpy
from test_torch_models import INPUT_IDS, tiny_config, tiny_tree

# --- the math ------------------------------------------------------------------


def _hand_log_rows():
    M = np.zeros((4, 4), np.float32)
    M[1, 0], M[2, 0], M[3, 0] = math.log(2.0), math.log(0.5), math.log(3.0)  # product 3
    M[2, 1], M[3, 1] = math.log(4.0), math.log(0.5)  # product 2
    M[3, 2] = math.log(1.5)
    return M


@pytest.mark.parametrize("step,phi,loc", [(3, 3.0, 0), (1, 2.0, 0), (0, 0.0, 0)])
def test_overtrust_phi_hand_computed(step, phi, loc):
    got_phi, got_loc = top.overtrust_phi(torch.from_numpy(_hand_log_rows()), step)
    ref_phi, ref_loc = jop.overtrust_phi(jnp.asarray(_hand_log_rows()), jnp.int32(step))
    assert math.isclose(float(got_phi), phi, rel_tol=1e-5) and int(got_loc) == loc
    assert math.isclose(float(got_phi), float(ref_phi), rel_tol=1e-5) and int(ref_loc) == loc


def test_overtrust_phi_picks_the_largest_column():
    M = np.zeros((4, 4), np.float32)
    M[2, 1] = M[3, 1] = math.log(10.0)  # column 1: 100
    M[1, 0] = math.log(5.0)  # column 0: 5
    phi, loc = top.overtrust_phi(torch.from_numpy(M), 3)
    assert int(loc) == 1 and math.isclose(float(phi), 100.0, rel_tol=1e-5)


@pytest.mark.parametrize(
    "hist,step,threshold,want",
    [([0, 2, 2, 2, -1, -1], 3, 3, (True, 2)), ([0, 2, 2, 2, -1, -1], 3, 4, (False, 2)),
     ([0, 2, 2, 2, -1, -1], 1, 3, (False, 2)), ([1, 1, 3, 1, 1], 4, 3, (False, 1)),
     ([1, 1, 3, 1, 1], 4, 2, (True, 1))],
)
def test_rollback_trigger_hand_cases(hist, step, threshold, want):
    got = top.rollback_trigger(torch.tensor(hist), step, threshold)
    ref = jop.rollback_trigger(jnp.asarray(np.array(hist, np.int32)), jnp.int32(step), threshold)
    assert got == want == (bool(ref[0]), int(ref[1]))


def test_attn_log_row_and_phi_match_jax_on_random_rows():
    rng = np.random.default_rng(4)
    row = rng.random((3, 9)).astype(np.float32) * 0.2
    row[0, 2] = 0.0  # log of the floor
    for step in (0, 4, 9):
        ref = np.asarray(jop.attn_log_row(jnp.asarray(row), 5.0, 0, jnp.int32(step)))
        got = top.attn_log_row(torch.from_numpy(row), 5.0, step).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    M = np.tril(rng.normal(size=(9, 9)).astype(np.float32), -1)
    for step in range(9):
        ref = jop.overtrust_phi(jnp.asarray(M), jnp.int32(step))
        got = top.overtrust_phi(torch.from_numpy(M), step)
        np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
        assert int(got[1]) == int(ref[1])


def test_cand_phi_equals_overtrust_phi_with_the_row_put_in():
    rng = np.random.default_rng(6)
    T, step = 7, 4
    attn_log = torch.from_numpy(np.tril(rng.normal(size=(2, T, T)).astype(np.float32), -1))
    attn_log[:, step:] = 0.0
    cand = top.attn_log_row(torch.from_numpy(rng.random((2, 3, T)).astype(np.float32)), 5.0, step)
    phi, loc = teng.cand_phi(attn_log, cand, step)
    for b in range(2):
        for c in range(3):
            full = attn_log[b].clone()
            full[step] = cand[b, c]
            want_phi, want_loc = top.overtrust_phi(full, step)
            assert math.isclose(float(phi[b, c]), float(want_phi), rel_tol=1e-5)
            assert int(loc[b, c]) == int(want_loc)


# --- decode_step_attn --------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    """A 2-layer LM with 4 heads over 2 KV heads, numpy weights in both
    packages."""
    cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
    params = jllama.init_params(jax_config.LlamaConfig(**cfg), jax.random.key(0), jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    return jax_config.LlamaConfig(**cfg), torch_config.LlamaConfig(**cfg), params, tp


def _caches(B, S, KH, Dh, seed):
    rng = np.random.default_rng(seed)
    kq = rng.integers(-127, 128, (2, B, S, KH * Dh)).astype(np.int8)
    vq = rng.integers(-127, 128, (2, B, S, KH * Dh)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (2, B, KH, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (2, B, KH, S)).astype(np.float32)
    k = kq.reshape(2, B, S, KH, Dh) * ks.transpose(0, 1, 3, 2)[..., None]
    v = vq.reshape(2, B, S, KH, Dh) * vs.transpose(0, 1, 3, 2)[..., None]
    dense = (k.astype(np.float32), v.astype(np.float32))
    return dense, ({"q": kq, "s": ks}, {"q": vq, "s": vs})


@pytest.mark.parametrize("layout", ["dense", "int8"])
def test_decode_step_attn_matches_jax(lm, layout):
    jcfg, tcfg, jp, tp = lm
    B, S, Dh = 3, 10, jcfg.head_dim
    dense, int8 = _caches(B, S, 2, Dh, seed=1)
    leaves = dense if layout == "dense" else int8
    tok = np.array([3, 5, 7])
    pos = np.array([6, 6, 4])
    mask = np.arange(S)[None, :] < pos[:, None]
    jcache = jllama.KVCache(*jax.tree.map(jnp.asarray, leaves))
    tcache = tllama.KVCache(*(
        {k: torch.from_numpy(a) for k, a in leaf.items()} if isinstance(leaf, dict)
        else torch.from_numpy(leaf) for leaf in leaves))
    ref = jllama.decode_step_attn(jp, jcfg,
                                  jllama.embed(jp, jnp.asarray(tok)), jnp.asarray(pos), jcache,
                                  jnp.asarray(mask))
    got = tllama.decode_step_attn(tp, tcfg, tllama.embed(tp, torch.from_numpy(tok)),
                                  torch.from_numpy(pos), tcache, torch.from_numpy(mask))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=2e-5)
    attn = got[3].numpy()
    assert attn.shape == (B, S) and (attn[~mask] == 0).all() and (attn.sum(-1) < 1).all()
    if layout == "dense":  # the same forward as decode_step's at M = 1
        h, k, v = tllama.decode_step(tp, tcfg, tllama.embed(tp, torch.from_numpy(tok))[:, None],
                                     torch.from_numpy(pos), tcache, torch.from_numpy(mask)[:, None])
        for a, b in ((got[0], h[:, 0]), (got[1], k[:, :, 0]), (got[2], v[:, :, 0])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_decode_step_attn_reads_a_cache_prefix(lm):
    """Over ``cache_live``'s views of the filled slots the rows are those of
    the whole cache, cut: the masked slots weigh nothing."""
    _, tcfg, _, tp = lm
    dense, _ = _caches(2, 12, 2, tcfg.head_dim, seed=2)
    cache = tllama.KVCache(*(torch.from_numpy(a) for a in dense))
    x, pos = tllama.embed(tp, torch.tensor([4, 9])), torch.tensor([7, 7])
    whole = tllama.decode_step_attn(tp, tcfg, x, pos, cache, torch.arange(12)[None, :] < 7)
    cut = tllama.decode_step_attn(tp, tcfg, x, pos, tllama.cache_live(cache, 7),
                                  torch.ones(2, 7, dtype=torch.bool))
    for a, b in zip(cut[:3], whole[:3]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(cut[3], whole[3][:, :7], rtol=1e-6, atol=1e-6)


# --- the search ------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    tree, pixels = tiny_tree()
    return jax.tree.map(jnp.asarray, tree), llava_params_from_numpy(tree), pixels


def _engines(weights, max_new=8, int8_kv=False):
    jp, tp, _ = weights
    kw = dict(max_new_tokens=max_new, eos_token_id=-1, pad_token_id=0)
    je = JaxEngine(cfg=tiny_config(jax_config), params=jp, gen=jax_config.GenerationConfig(**kw),
                   max_len=64, ensemble=False, int8_kv=int8_kv)
    je.param_dtype = jnp.float32
    te = LlavaEngine(cfg=tiny_config(torch_config), params=tp,
                     gen=torch_config.GenerationConfig(**kw), max_len=64, ensemble=False,
                     int8_kv=int8_kv)
    return je, te


OPERA_CASES = {  # the CLI's defaults; the fan-out with rollbacks; threshold 1; eight beams' pool
    "cli defaults": dict(num_beams=3, scale_factor=5.0, threshold=15, num_attn_candidates=1),
    "nb 3 nc 2 rollbacks": dict(num_beams=3, scale_factor=50.0, threshold=3,
                                num_attn_candidates=2, max_rollbacks=4),
    "nb 2 nc 4 threshold 1": dict(num_beams=2, num_attn_candidates=4, threshold=1,
                                  max_rollbacks=3, penalty_weights=2.0),
    "length penalty 2": dict(num_beams=3, num_attn_candidates=3, threshold=4,
                             length_penalty=2.0, scale_factor=20.0),
}


@pytest.mark.parametrize("case", list(OPERA_CASES))
def test_opera_matches_jax(weights, case):
    je, te = _engines(weights)
    kw = OPERA_CASES[case]
    ref = jeng.opera_generate(je, INPUT_IDS, weights[2], **kw)
    stats = {}
    got = teng.opera_generate(te, INPUT_IDS, weights[2], stats=stats, **kw)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)
    if kw["threshold"] <= 3:
        assert stats["rollbacks"] >= 1


def test_opera_on_an_int8_cache_matches_jax(weights):
    """An int8 cache: ``decode_step_attn`` reads it, the commit is K4's twin."""
    je, te = _engines(weights, int8_kv=True)
    kw = OPERA_CASES["nb 3 nc 2 rollbacks"]
    ref = jeng.opera_generate(je, INPUT_IDS, weights[2], **kw)
    got = teng.opera_generate(te, INPUT_IDS, weights[2], **kw)
    np.testing.assert_array_equal(got.tokens, ref.tokens)


def test_opera_without_penalty_is_beam_search(weights):
    """penalty_weights 0 and nc >= 2 nb: each beam's pool covers HF's top
    2 nb, so OPERA is beam search."""
    _, te = _engines(weights)
    beam = tbase.beam_generate(te, INPUT_IDS, weights[2], num_beams=3)
    op = teng.opera_generate(te, INPUT_IDS, weights[2], num_beams=3, penalty_weights=0.0,
                             num_attn_candidates=6, threshold=10**6)
    np.testing.assert_array_equal(op.tokens, beam.tokens)
    np.testing.assert_array_equal(op.num_tokens, beam.num_tokens)


def test_opera_rollback_bans_the_token_and_terminates(weights):
    _, te = _engines(weights, max_new=6)
    kw = dict(num_beams=2, penalty_weights=0.0, num_attn_candidates=4)
    no_rb = teng.opera_generate(te, INPUT_IDS, weights[2], threshold=10**6, **kw)
    stats = {}
    rb = teng.opera_generate(te, INPUT_IDS, weights[2], threshold=1, max_rollbacks=3,
                             stats=stats, **kw)
    assert rb.tokens.shape == no_rb.tokens.shape and rb.num_tokens[0] >= 1
    assert stats["rollbacks"] == 3 and stats["iterations"] <= 6 * (1 + 3)
    assert not np.array_equal(rb.tokens, no_rb.tokens)


def test_opera_refuses_a_batch(weights):
    _, te = _engines(weights)
    with pytest.raises(ValueError, match="B=1"):
        teng.opera_generate(te, np.repeat(INPUT_IDS, 2, axis=0), None)  # before any work
    state = te.prefill(np.repeat(INPUT_IDS, 2, axis=0), np.repeat(weights[2], 2, axis=0))
    with pytest.raises(ValueError, match="B=1"):
        teng.opera_generate(te, state=state)
    with pytest.raises(ValueError, match="num_attn_candidates"):
        teng.opera_generate(te, INPUT_IDS, weights[2], num_attn_candidates=0)
