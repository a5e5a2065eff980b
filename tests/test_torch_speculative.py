"""Speculative greedy decoding of the port (``engine/speculative.py``,
``models/llama.cache_write_span``, ``utils/convert.synthetic_llava_dual_lm``)
against the JAX package, fp32 on the CPU.

The tiny LLaVA of ``test_torch_models`` carries one set of numpy weights to
both packages.  Speculation is exact in fp32, so every draft mode must give
the JAX greedy engine's tokens and the port's own greedy tokens, equal:
an unrelated random draft, the int4 self-draft (group 8), draft == target,
an int8-KV target and the ngram draft.  The cache writes are bit-equal (the
same quantizer on the same fp32 values).  JAX's per-cycle and fused
programs are called a few times only: its while_loop is slow to compile on
the CPU.  ``max_len`` is a multiple of 32, which the JAX engine rounds up
to; one case shows the departure where it is not.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.engine.speculative import SpeculativeGreedy as JaxSpec
from dropoutdecoding_tpu.models import llama as jllama
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.engine.instructblip_engine import InstructBlipEngine
from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
from dropoutdecoding_tpu_torch.engine.speculative import SpeculativeGreedy
from dropoutdecoding_tpu_torch.models import llama as tllama
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import (
    _dual_base,
    instructblip_params_from_numpy,
    llava_params_from_numpy,
    llavanext_params_from_numpy,
    synthetic_llava_dual_lm,
)
from dropoutdecoding_tpu_torch.utils.quantize import (
    _fit_group,
    quantize_llama_params_int4,
    quantize_matrix,
    quantize_matrix_int4,
)
from test_torch_models import INPUT_IDS, tiny_config, tiny_tree

GAMMA = 3


@pytest.fixture(scope="module")
def weights():
    tree, pixels = tiny_tree()
    other, _ = tiny_tree(seed=99)  # an unrelated draft tower
    return (jax.tree.map(jnp.asarray, tree), llava_params_from_numpy(tree), pixels,
            llava_params_from_numpy(other).lm, jax.tree.map(jnp.asarray, other.lm))


def _gen(C, T, eos=-1):
    return C.GenerationConfig(max_new_tokens=T, eos_token_id=eos, pad_token_id=0)


def _port(weights, T=12, eos=-1, int8_kv=False, max_len=64):
    return LlavaEngine(cfg=tiny_config(torch_config), params=weights[1], gen=_gen(torch_config, T, eos),
                       max_len=max_len, ensemble=False, int8_kv=int8_kv)


def _jax(weights, T=12, eos=-1, int8_kv=False, max_len=64):
    e = JaxEngine(cfg=tiny_config(jax_config), params=weights[0], gen=_gen(jax_config, T, eos),
                  max_len=max_len, ensemble=False, int8_kv=int8_kv)
    e.param_dtype = jnp.float32
    return e


@pytest.fixture(scope="module")
def jax_greedy(weights):
    """The JAX greedy engine's tokens, by (T, int8_kv)."""
    pixels = weights[2]
    return {(T, kv): _jax(weights, T, int8_kv=kv).generate(INPUT_IDS, pixels).tokens[0]
            for T, kv in ((12, False), (12, True), (30, False))}


# --- cache_write_span -----------------------------------------------------------------


def _caches(int8: bool, seed=0, L=2, B=1, S=24, KH=4, D=12):
    """(port cache, JAX cache) holding the same random contents."""
    r = np.random.default_rng(seed)
    if int8:
        leaf = lambda: {"q": r.integers(-127, 128, (L, B, S, KH * D)).astype(np.int8),  # noqa: E731
                        "s": r.uniform(0.01, 0.03, (L, B, KH, S)).astype(np.float32)}
        k, v = leaf(), leaf()
        port = tllama.KVCache(*({n: torch.from_numpy(a.copy()) for n, a in x.items()} for x in (k, v)))
        ref = jllama.KVCache(*({n: jnp.asarray(a) for n, a in x.items()} for x in (k, v)))
        return port, ref
    k, v = (r.normal(size=(L, B, S, KH, D)).astype(np.float32) for _ in range(2))
    return (tllama.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())),
            jllama.KVCache(jnp.asarray(k), jnp.asarray(v)))


def _block(T, seed=1, L=2, B=1, KH=4, D=12):
    r = np.random.default_rng(seed)
    return [r.normal(size=(L, B, T, KH, D)).astype(np.float32) for _ in range(2)]


def _leaves(cache):
    return [np.asarray(t) for leaf in cache for t in (leaf.values() if isinstance(leaf, dict) else [leaf])]


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("start", [0, 7, 20])
def test_cache_write_span_matches_jax(int8, start):
    """The block at ``start`` bit-equal to JAX's, every other slot kept."""
    port, ref = _caches(int8)
    k, v = _block(4)
    tllama.cache_write_span(port, start, tllama.KVCache(torch.from_numpy(k), torch.from_numpy(v)))
    ref = jllama.cache_write_span(ref, start, jllama.KVCache(jnp.asarray(k), jnp.asarray(v)))
    for got, want in zip(_leaves(port), _leaves(ref)):
        np.testing.assert_array_equal(got, want)


def test_int8_cache_write_span_equals_sequential_appends():
    """On an int8 cache the block equals T ``cache_set_rows`` appends, bit
    for bit (on the card those appends are K4)."""
    block, seq = _caches(True)[0], _caches(True)[0]
    k, v = _block(5)
    tllama.cache_write_span(block, 9, tllama.KVCache(torch.from_numpy(k), torch.from_numpy(v)))
    for t in range(5):
        tllama.cache_set_rows(seq, torch.tensor([9 + t]), torch.from_numpy(k[:, :, t]),
                              torch.from_numpy(v[:, :, t]))
    for got, want in zip(_leaves(block), _leaves(seq)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_cache_seed_is_the_span_at_slot_0(int8):
    port, ref = _caches(int8)
    k, v = _block(6)
    tllama.cache_seed(port, tllama.KVCache(torch.from_numpy(k), torch.from_numpy(v)))
    ref = jllama.cache_seed(ref, jllama.KVCache(jnp.asarray(k), jnp.asarray(v)))
    for got, want in zip(_leaves(port), _leaves(ref)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start", [21, 24, -1])
def test_cache_write_span_raises_past_the_end(start):
    """JAX clamps a start past S - T (and so overwrites earlier rows); the
    port raises and writes nothing."""
    port, _ = _caches(False)
    before = [t.clone() for t in port]
    k, v = _block(4)
    with pytest.raises(ValueError, match="outside a cache of 24"):
        tllama.cache_write_span(port, start, tllama.KVCache(torch.from_numpy(k), torch.from_numpy(v)))
    assert all(torch.equal(a, b) for a, b in zip(port, before))


# --- the dual towers ------------------------------------------------------------------


def test_dual_towers_quantize_one_base():
    """Both towers are the port's quantizers (bit-equal to JAX's) of one
    bf16 base, matrix by matrix; the head, embeddings and norms are shared."""
    cfg = torch_config.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, head_dim=16)
    lm8, lm4 = synthetic_llava_dual_lm(cfg, "cpu", seed=5)
    gen = torch.Generator().manual_seed(5)
    n = 0
    for name, layer, col, w in _dual_base(cfg, "cpu", gen):
        assert torch.equal(w, w.to(torch.bfloat16).float())  # bf16 values
        cols = slice(col, col + w.shape[1])
        for got, want in ((lm8["layers"][name], quantize_matrix(w)),
                          (lm4["layers"][name], quantize_matrix_int4(w, _fit_group(w.shape[0], 128)))):
            for key in want:
                assert torch.equal(got[key][layer][:, cols], want[key]), (name, layer, key)
        n += 1
    assert n == 2 * 7
    assert lm8["lm_head"] is lm4["lm_head"] and set(lm8["lm_head"]) == {"q", "s"}
    assert lm8["embed_tokens"] is lm4["embed_tokens"]
    assert set(lm8["layers"]["qkv_proj"]) == {"q", "s"}
    assert set(lm4["layers"]["gate_up_proj"]) == {"q4", "s4"}


# --- SpeculativeGreedy against JAX's greedy engine -----------------------------------


def _draft(weights, kind):
    return {"random": weights[3], "target": weights[1].lm, "ngram": None,
            "int4": quantize_llama_params_int4(weights[1].lm, group_size=8)}[kind]


@pytest.mark.parametrize(
    "kind,int8_kv",
    [("random", False), ("int4", False), ("target", False), ("target", True), ("ngram", False),
     ("ngram", True)],
    ids=["random-draft", "int4-draft", "target-draft", "target-draft-int8-kv", "ngram",
         "ngram-int8-kv"],
)
def test_spec_tokens_equal_jax_greedy(weights, jax_greedy, kind, int8_kv):
    """``generate`` and ``generate_fused`` give the JAX greedy engine's
    tokens and the port's own greedy tokens, whatever the draft."""
    eng = _port(weights, int8_kv=int8_kv)
    pixels = weights[2]
    ref = jax_greedy[12, int8_kv]
    np.testing.assert_array_equal(eng.generate(INPUT_IDS, pixels).tokens[0], ref)
    spec = SpeculativeGreedy(engine=eng, draft_lm=_draft(weights, kind), gamma=GAMMA,
                             draft="ngram" if kind == "ngram" else "lm")
    tokens, cycles, accepted = spec.generate(INPUT_IDS, pixels)
    np.testing.assert_array_equal(tokens, ref)
    fused, fused_cycles = spec.generate_fused(INPUT_IDS, pixels)
    np.testing.assert_array_equal(fused, ref)
    assert fused_cycles == cycles >= 1
    if kind == "target":  # every draft accepted: (12 - 1) / 4 cycles, rounded up
        assert (cycles, accepted) == (3, 3 * GAMMA)


def test_spec_per_cycle_stats_equal_jax(weights):
    """The unrelated draft through JAX's per-cycle ``generate``: the same
    tokens, cycles and accepted count."""
    jspec = JaxSpec(engine=_jax(weights), draft_lm=weights[4], gamma=GAMMA)
    spec = SpeculativeGreedy(engine=_port(weights), draft_lm=weights[3], gamma=GAMMA)
    want = jspec.generate(INPUT_IDS, weights[2])
    got = spec.generate(INPUT_IDS, weights[2])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == tuple(int(x) for x in want[1:])


def test_full_acceptance_every_cycle_with_the_target_draft(weights, jax_greedy):
    """draft == target: every cycle accepts gamma over a longer generation
    (the alpha = 1 bound holds), the JAX greedy tokens still."""
    spec = SpeculativeGreedy(engine=_port(weights, T=30), draft_lm=weights[1].lm, gamma=GAMMA)
    tokens, cycles, accepted = spec.generate(INPUT_IDS, weights[2])
    np.testing.assert_array_equal(tokens, jax_greedy[30, False])
    assert (cycles, accepted) == (8, 8 * GAMMA)  # 1 + 8 x 4 >= 30


def test_f6_the_draft_row_after_full_acceptance(weights):
    """ROADMAP Queue 3 F6.  After a cycle that accepts every draft, the
    draft cache's row at cur + gamma (d_gamma's) equals the target's: the
    next cycle's first draft step writes it.  JAX's draft never writes that
    row (it stays 0)."""
    pixels = weights[2]
    eng = _port(weights)
    spec = SpeculativeGreedy(engine=eng, draft_lm=weights[1].lm, gamma=GAMMA)
    state = eng.prefill(INPUT_IDS, pixels)
    cur = int(state.cur_len[0])
    dcache = spec._draft_prefill(INPUT_IDS, pixels)
    g, _, n = spec._cycle(state.cache, dcache, cur, state.first_token)
    assert n == GAMMA
    row = cur + GAMMA
    assert not dcache.k[:, :, row].any()  # the hole, before the next cycle
    _, _, n2 = spec._cycle(state.cache, dcache, cur + GAMMA + 1, g[GAMMA:], refill=g[GAMMA - 1:GAMMA])
    assert n2 == GAMMA
    for d, t in zip(dcache, state.cache):
        np.testing.assert_allclose(d[:, :, row].numpy(), t[:, :, row].numpy(), rtol=1e-5, atol=1e-5)
        assert d[:, :, row].abs().max() > 0.1

    je = _jax(weights)
    jspec = JaxSpec(engine=je, draft_lm=weights[0].lm, gamma=GAMMA)
    st = je.prefill(INPUT_IDS, pixels)
    dc = jspec._draft_prefill(je.params, jspec.draft_lm, jnp.asarray(INPUT_IDS), pixels)
    tc, dc, new_cur, _, _, n_acc = jspec._cycle(je.params, jspec.draft_lm, st.cache, dc,
                                                st.cur_len, st.first_token)
    assert int(n_acc) == GAMMA and int(new_cur[0]) == cur + GAMMA + 1
    assert float(jnp.abs(dc.k[:, :, row]).max()) == 0.0
    assert float(jnp.abs(tc.k[:, :, row]).max()) > 0.1


@pytest.mark.parametrize("draft", ["lm", "ngram"])
def test_eos_inside_the_accepted_prefix(weights, jax_greedy, draft):
    """EOS at the greedy run's third token: both bookkeepings stop after it,
    as JAX's fused program does (called once, on the lm draft)."""
    eos = int(jax_greedy[12, False][2])
    spec = SpeculativeGreedy(engine=_port(weights, eos=eos), gamma=GAMMA, draft=draft,
                             draft_lm=weights[1].lm if draft == "lm" else None)
    tokens, _, _ = spec.generate(INPUT_IDS, weights[2])
    fused, _ = spec.generate_fused(INPUT_IDS, weights[2])
    np.testing.assert_array_equal(tokens, jax_greedy[12, False][:3])
    np.testing.assert_array_equal(fused, tokens)
    if draft == "lm":
        jspec = JaxSpec(engine=_jax(weights, eos=eos), draft_lm=weights[0].lm, gamma=GAMMA)
        np.testing.assert_array_equal(jspec.generate_fused(INPUT_IDS, weights[2])[0], fused)


@pytest.mark.parametrize("draft", ["lm", "ngram"])
def test_first_token_eos_or_one_token_returns_at_once(weights, jax_greedy, draft):
    """T = 1, or the first token EOS: the prefill's token, no cycle."""
    first = int(jax_greedy[12, False][0])
    for T, eos in ((1, -1), (12, first)):
        spec = SpeculativeGreedy(engine=_port(weights, T=T, eos=eos), gamma=GAMMA, draft=draft,
                                 draft_lm=weights[1].lm if draft == "lm" else None)
        assert spec.generate_fused(INPUT_IDS, weights[2])[1] == 0
        tokens, cycles, _ = spec.generate(INPUT_IDS, weights[2])
        assert tokens.tolist() == [first] and cycles == 0


# --- the ngram draft --------------------------------------------------------------------


NGRAM_CASES = [  # tests/test_speculative.py:139
    ([5, 1, 2, 9, 1, 2], 3, 0),
    ([1, 2, 7, 1, 2, 8, 1, 2], 3, 0),
    ([1, 2, 1, 2], 3, 0),
    ([3, 4, 5], 3, 0),
    ([3], 2, 0),
    ([], 2, 9),
]


@pytest.mark.parametrize("hist,gamma,pad", NGRAM_CASES)
def test_ngram_propose_np_matches_jax(hist, gamma, pad):
    np.testing.assert_array_equal(SpeculativeGreedy.ngram_propose_np(hist, gamma, pad),
                                  JaxSpec.ngram_propose_np(hist, gamma, pad))


def test_ngram_device_matcher_mirrors_host(weights):
    spec = SpeculativeGreedy(engine=_port(weights), draft_lm=None, gamma=4, draft="ngram")
    r = np.random.default_rng(0)
    for trial in range(60):
        n = int(r.integers(1, 18))
        hist = r.integers(1, 5, size=n)  # a small alphabet: bigrams repeat often
        buf = torch.zeros(24, dtype=torch.long)
        buf[:n] = torch.from_numpy(hist)
        got = spec._ngram_drafts(buf, n, torch.from_numpy(hist[-1:]))
        np.testing.assert_array_equal(got.numpy(), spec.ngram_propose_np(hist, 4, 0),
                                      err_msg=f"trial {trial}")


def test_ngram_matches_greedy_on_narrow_next_and_instructblip():
    """The ngram draft on the two other families: their greedy tokens."""
    from test_torch_instructblip import INPUT_IDS as IB_IDS
    from test_torch_instructblip import QFORMER_IDS, pixels_for
    from test_torch_instructblip import narrow_config as ib_config
    from test_torch_instructblip import narrow_tree as ib_tree
    from test_torch_llavanext import INPUT_IDS as NEXT_IDS
    from test_torch_llavanext import SIZE, tiles_for
    from test_torch_llavanext import narrow_config as next_config
    from test_torch_llavanext import narrow_tree as next_tree

    gen = _gen(torch_config, 14)
    nxt = LlavaNextEngine(cfg=next_config(torch_config), params=llavanext_params_from_numpy(next_tree()),
                          gen=gen, max_len=1344, ensemble=False)
    ib = InstructBlipEngine(cfg=ib_config(torch_config), params=instructblip_params_from_numpy(ib_tree()),
                            gen=gen, max_len=64, ensemble=False)
    for eng, args in ((nxt, (NEXT_IDS, tiles_for(nxt.cfg, SIZE), SIZE)),
                      (ib, (IB_IDS, pixels_for(1), QFORMER_IDS))):
        ref = eng.generate(*args).tokens[0]
        spec = SpeculativeGreedy(engine=eng, draft_lm=None, gamma=GAMMA, draft="ngram")
        np.testing.assert_array_equal(spec.generate(*args)[0], ref)
        np.testing.assert_array_equal(spec.generate_fused(*args)[0], ref)
        with pytest.raises(NotImplementedError, match="draft='ngram' for LLaVA-NeXT"):
            SpeculativeGreedy(engine=eng, draft_lm=eng.params.lm, gamma=GAMMA)


# --- guards ------------------------------------------------------------------------------


def test_guards_raise_with_the_jax_messages(weights):
    ens = LlavaEngine(cfg=tiny_config(torch_config), params=weights[1], max_len=64)
    with pytest.raises(ValueError, match="GREEDY"):
        SpeculativeGreedy(engine=ens, draft_lm=weights[1].lm)
    eng = _port(weights)
    with pytest.raises(ValueError, match="draft_lm"):
        SpeculativeGreedy(engine=eng, draft_lm=None, gamma=3, draft="lm")
    with pytest.raises(ValueError, match="ngram"):
        SpeculativeGreedy(engine=eng, draft_lm=None, gamma=3, draft="bogus")
    spec = SpeculativeGreedy(engine=eng, draft_lm=None, gamma=3, draft="ngram")
    two = np.concatenate([INPUT_IDS, INPUT_IDS])
    with pytest.raises(ValueError, match="one image per call"):
        spec.generate(two, np.concatenate([weights[2]] * 2))
    with pytest.raises(ValueError, match="one image per call"):
        spec.generate_fused(two, np.concatenate([weights[2]] * 2))


def test_headroom_guard_and_the_max_len_departure(weights):
    """prompt (22 slots) + max_new_tokens + gamma must fit ``max_len``.  At
    max_len 40 both packages raise for T = 16; at max_len 36 (not a multiple
    of 32) the port raises where the JAX engine, rounded up to 64 slots,
    runs (ROADMAP Queue 1 item 17)."""
    pixels = weights[2]
    for max_len, T in ((40, 16), (36, 12)):
        spec = SpeculativeGreedy(engine=_port(weights, T=T, max_len=max_len), draft_lm=None,
                                 gamma=GAMMA, draft="ngram")
        with pytest.raises(ValueError, match="lacks speculative headroom"):
            spec.generate(INPUT_IDS, pixels)
    spec = SpeculativeGreedy(engine=_port(weights, T=15, max_len=40), draft_lm=None, gamma=GAMMA,
                             draft="ngram")
    assert len(spec.generate(INPUT_IDS, pixels)[0]) == 15  # 22 + 15 + 3 = 40 fits
    jspec = JaxSpec(engine=_jax(weights, T=12, max_len=36), draft_lm=None, gamma=GAMMA,
                    draft="ngram")
    assert jspec.engine.max_len == 64
    assert len(jspec.generate(INPUT_IDS, pixels)[0]) == 12


def test_cycle_clock(weights):
    """``cycle_ms`` takes one (draft, verify, wall) a cycle."""
    times = []
    spec = SpeculativeGreedy(engine=_port(weights), draft_lm=weights[3], gamma=GAMMA, cycle_ms=times)
    _, cycles, _ = spec.generate(INPUT_IDS, weights[2])
    assert len(times) == cycles and all(len(t) == 3 and t[2] >= t[0] + t[1] >= 0 for t in times)


def test_spec_bench_rehearses_on_the_cpu(capsys):
    """``cli/spec_bench.py`` on the tiny config: its JSON line, every run
    with its numbers, the target draft accepting every draft."""
    import json

    from dropoutdecoding_tpu_torch.cli import spec_bench

    out = spec_bench.main(["--tokens", "10", "--prompts", "2"], device="cpu",
                          cfg=tiny_config(torch_config))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(json.dumps(out))
    assert [r["label"] for r in out["runs"]] == ["int4-draft", "ngram-draft",
                                                 "target-draft (alpha=1)"]
    assert out["runs"][-1]["alpha"] == 1.0
    for r in out["runs"]:
        assert r["tps"] > 0 and r["cycles"] >= 2 and set(r["ms_per_cycle"]) == {
            "draft", "verify", "host", "wall"}
