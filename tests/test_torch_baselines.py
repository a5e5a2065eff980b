"""The port's baselines, VCD and beam search (``engine/baselines.py``),
against the JAX package's on one set of numpy weights, fp32 on the CPU.

VCD samples: the JAX package's own noised pixels (``diffusion_noise`` with
``vcd_generate``'s noise key) and Gumbel draws (its sampling key, folded by
step) are injected into the port's engine (``cd_noise``, ``cd_gumbel``), so
tokens must be equal.  Beam search has no draw: tokens must be equal, and
the HF goldens of ``tests/test_baselines.py`` hold the port directly
against ``transformers``' beam search on the tiny random HF LLaVA.
Tolerances: the VCD math elementwise within 1e-6 of its values (XLA may
fuse a multiply-add); the noise schedule's coefficients within 1e-6
(torch's cumprod runs in another order than XLA's, as the reference's
own torch schedule does); tokens exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.decoding import vcd as jvcd
from dropoutdecoding_tpu.engine import baselines as jbase
from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.engine.llavanext_engine import LlavaNextEngine as JaxNextEngine
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.decoding import vcd as tvcd
from dropoutdecoding_tpu_torch.engine import baselines as tbase
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import llava_params_from_numpy
from test_torch_llavanext import INPUT_IDS as NEXT_IDS
from test_torch_llavanext import SIZE, narrow_config, tiles_for
from test_torch_llavanext import weights as next_weights  # noqa: F401 (fixture)
from test_torch_models import INPUT_IDS, tiny_config, tiny_tree


def jax_cd_noise(seed=0, step=500):
    """The JAX package's VCD noised pixels (``vcd_generate``'s noise key,
    which is also ``decoding/vcd.noise_key``), as the port's ``cd_noise``."""
    k_noise = jax.random.split(jax.random.key(seed))[0]

    def noise(pixels):
        out = jvcd.diffusion_noise(k_noise, jnp.asarray(pixels.cpu().numpy()), step)
        return torch.from_numpy(np.array(out)).to(pixels.device)

    return noise


def jax_cd_gumbel(seed=0):
    """The JAX package's VCD sampling noise: the first token's from
    ``fold_in(k_sample, 0)``, step s's from ``fold_in(fold_in(k_sample, 1),
    s)``; ``jax.random.categorical`` adds it to the logits."""
    k_sample = jax.random.split(jax.random.key(seed))[1]

    def gumbel(step, n):
        if step == 0:
            key = jax.random.fold_in(k_sample, 0)
        else:
            key = jax.random.fold_in(jax.random.fold_in(k_sample, 1), step)
        return torch.from_numpy(np.array(jax.random.gumbel(key, (n,), jnp.float32)))

    return gumbel


@pytest.fixture(scope="module")
def weights():
    tree, pixels = tiny_tree()
    rng = np.random.default_rng(11)
    pixels2 = (pixels * 0.6 + 0.2 * rng.random(pixels.shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), llava_params_from_numpy(tree), pixels, pixels2


def _engines(weights, max_new_tokens=8, eos=-1, int8_kv=False, **gen):
    jp, tp = weights[:2]
    kw = dict(max_new_tokens=max_new_tokens, eos_token_id=eos, pad_token_id=0, **gen)
    je = JaxEngine(cfg=tiny_config(jax_config), params=jp, gen=jax_config.GenerationConfig(**kw),
                   max_len=64, ensemble=False, int8_kv=int8_kv)
    je.param_dtype = jnp.float32
    te = LlavaEngine(cfg=tiny_config(torch_config), params=tp,
                     gen=torch_config.GenerationConfig(**kw), max_len=64, ensemble=False,
                     int8_kv=int8_kv, cd_noise=jax_cd_noise(), cd_gumbel=jax_cd_gumbel())
    return je, te


# --- VCD --------------------------------------------------------------------


def test_contrastive_logits_match_jax():
    rng = np.random.default_rng(0)
    logits, logits_cd = rng.normal(size=(2, 3, 50)).astype(np.float32) * 3
    for alpha, beta in ((0.5, 0.1), (1.0, 0.3)):
        ref = np.asarray(jvcd.contrastive_logits(jnp.asarray(logits), jnp.asarray(logits_cd),
                                                 alpha, beta))
        got = tvcd.contrastive_logits(torch.from_numpy(logits), torch.from_numpy(logits_cd),
                                      alpha, beta).numpy()
        assert np.isinf(ref).any() and (np.isinf(got) == np.isinf(ref)).all()  # the cutoff fires
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)


def test_noise_schedule_matches_jax():
    """Step 500 of the sigmoid-beta schedule in fp32, and the noised pixels
    of one Gaussian draw."""
    a_t, om_t = tvcd.noise_coefficients(500)
    ones = jnp.ones((3, 4, 4))
    k = jax.random.key(3)
    noise = jax.random.normal(k, ones.shape)
    ref = np.asarray(jvcd.diffusion_noise(k, ones, 500))  # a_t + om_t * noise
    np.testing.assert_allclose(a_t + om_t * np.asarray(noise), ref, rtol=1e-6, atol=1e-6)
    assert abs(a_t - 0.863017) < 1e-6 and abs(om_t - 0.505175) < 1e-6
    rng = np.random.default_rng(2)
    px = rng.normal(size=(3, 4, 4)).astype(np.float32)
    got = tvcd.diffusion_noise(torch.from_numpy(np.array(noise)), torch.from_numpy(px), 500)
    np.testing.assert_allclose(got.numpy(), np.asarray(jvcd.diffusion_noise(k, px, 500)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "gen",
    [{}, {"temperature": 0.7, "top_k": 5, "top_p": 0.9}],
    ids=["plain", "warped"],
)
def test_vcd_generate_matches_jax(weights, gen):
    je, te = _engines(weights, **gen)
    pixels = weights[2]
    ref = jbase.vcd_generate(je, INPUT_IDS, pixels, seed=0)
    got = tbase.vcd_generate(te, INPUT_IDS, pixels)
    assert got.tokens.shape == (1, 8)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)


def test_vcd_stops_at_eos_as_jax(weights):
    _, te = _engines(weights)
    eos = int(tbase.vcd_generate(te, INPUT_IDS, weights[2]).tokens[0, 3])
    je, te = _engines(weights, eos=eos)
    ref = jbase.vcd_generate(je, INPUT_IDS, weights[2], seed=0)
    got = tbase.vcd_generate(te, INPUT_IDS, weights[2])
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)
    assert got.num_tokens[0] <= 4 and (got.tokens[0, got.num_tokens[0]:] == 0).all()


def test_vcd_batched_equals_serial(weights):
    """Every row noises and samples with the draws a B = 1 call makes."""
    _, te = _engines(weights)
    ids2 = np.concatenate([INPUT_IDS] * 2)
    px2 = np.concatenate([weights[2], weights[3]])
    batched = tbase.vcd_generate(te, ids2, px2)
    for b in range(2):
        serial = tbase.vcd_generate(te, INPUT_IDS, px2[b : b + 1])
        np.testing.assert_array_equal(batched.tokens[b], serial.tokens[0])
    assert not np.array_equal(batched.tokens[0], batched.tokens[1])


def test_vcd_respects_the_cutoff(weights):
    """A token below the plausibility cutoff is never drawn, however much
    noise it gets: here the first token's draw puts 1e6 on the clean
    context's least likely token."""
    _, te = _engines(weights)
    state = te.prefill(INPUT_IDS, weights[2])
    worst = int(state.last_logits[0].argmin())
    draws = te.cd_gumbel

    def rigged(step, n):
        g = draws(step, n)
        g[worst] += 1e6 if step == 0 else 0.0
        return g

    te.cd_gumbel = rigged
    assert tbase.vcd_generate(te, INPUT_IDS, weights[2]).tokens[0, 0] != worst
    te.cd_gumbel = lambda step, n: torch.zeros(n)  # no noise: the first token is the argmax
    cd = tvcd.contrastive_logits(state.last_logits, te.prefill(
        INPUT_IDS, tbase.noised_pixels(te, weights[2][0])[None]).last_logits)
    assert tbase.vcd_generate(te, INPUT_IDS, weights[2]).tokens[0, 0] == int(cd.argmax())


def test_vcd_production_draws_are_shared_by_rows(weights):
    """Without injected draws, torch Philox at the seed: deterministic, the
    same noise for every image of one shape, another seed other tokens."""
    _, te = _engines(weights)
    te.cd_noise = te.cd_gumbel = None
    px = torch.from_numpy(weights[2][0])
    a, b = tbase.noised_pixels(te, px), tbase.noised_pixels(te, px * 0)
    torch.testing.assert_close(a - b, tvcd.noise_coefficients(500)[0] * px, rtol=1e-6, atol=1e-6)
    ids2, px2 = np.concatenate([INPUT_IDS] * 2), np.concatenate([weights[2]] * 2)
    out = tbase.vcd_generate(te, ids2, px2, seed=7)
    np.testing.assert_array_equal(out.tokens[0], out.tokens[1])
    np.testing.assert_array_equal(out.tokens, tbase.vcd_generate(te, ids2, px2, seed=7).tokens)


def test_vcd_next_through_states_matches_jax(next_weights):  # noqa: F811
    """LLaVA-NeXT: the tiles noised as the JAX CLI noises them, two
    prefills passed as ``states``."""
    jp, tp = next_weights
    kw = dict(max_new_tokens=6, eos_token_id=-1, pad_token_id=0)
    je = JaxNextEngine(cfg=narrow_config(jax_config), params=jp, max_len=1344, ensemble=False,
                       gen=jax_config.GenerationConfig(**kw))
    je.param_dtype = jnp.float32
    te = LlavaNextEngine(cfg=narrow_config(torch_config), params=tp, max_len=1344,
                         ensemble=False, gen=torch_config.GenerationConfig(**kw),
                         cd_noise=jax_cd_noise(), cd_gumbel=jax_cd_gumbel())
    tiles = tiles_for(te.cfg, SIZE)
    noised = np.asarray(jvcd.diffusion_noise(jvcd.noise_key(), jnp.asarray(tiles), 500))
    ref = jbase.vcd_generate(je, states=(je.prefill(NEXT_IDS, tiles, SIZE),
                                         je.prefill(NEXT_IDS, noised, SIZE)))
    got = tbase.vcd_generate(te, states=(te.prefill(NEXT_IDS, tiles, SIZE),
                                         te.prefill(NEXT_IDS, tbase.noised_pixels(te, tiles), SIZE)))
    np.testing.assert_array_equal(got.tokens, ref.tokens)


@pytest.mark.parametrize("method", ["vcd", "beam"])
def test_int8_kv_engine_raises_before_any_work(weights, method):
    _, te = _engines(weights, int8_kv=True)
    call = {"vcd": tbase.vcd_generate, "beam": tbase.beam_generate}[method]
    with pytest.raises(NotImplementedError, match="dense-KV engine"):
        call(te, INPUT_IDS, None)  # no pixels: the guard fires first


# --- beam search --------------------------------------------------------------


def test_beam1_equals_greedy(weights):
    _, te = _engines(weights)
    greedy = te.generate(INPUT_IDS, weights[2])
    beam = tbase.beam_generate(te, INPUT_IDS, weights[2], num_beams=1)
    np.testing.assert_array_equal(beam.tokens, greedy.tokens)


BEAM_KNOBS = [(1.0, False), (2.0, False), (0.5, True), (2.0, "never"), (0.5, "never")]


@pytest.mark.parametrize("lp,es", BEAM_KNOBS)
def test_beam_matches_jax(weights, lp, es):
    je, te = _engines(weights)
    ref = jbase.beam_generate(je, INPUT_IDS, weights[2], num_beams=3, length_penalty=lp,
                              early_stopping=es)
    got = tbase.beam_generate(te, INPUT_IDS, weights[2], num_beams=3, length_penalty=lp,
                              early_stopping=es)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)


@pytest.mark.parametrize("lp,es", [(1.0, False), (2.0, False), (0.5, True)])
def test_beam_eos_mid_search_matches_jax(weights, lp, es):
    """eos is a token the greedy caption emits at step 2, so hypotheses are
    stored before the search ends (JAX ``tests/test_baselines.py:91``)."""
    _, te = _engines(weights)
    eos = int(te.generate(INPUT_IDS, weights[2]).tokens[0, 2])
    je, te = _engines(weights, eos=eos)
    ref = jbase.beam_generate(je, INPUT_IDS, weights[2], num_beams=3, length_penalty=lp,
                              early_stopping=es)
    got = tbase.beam_generate(te, INPUT_IDS, weights[2], num_beams=3, length_penalty=lp,
                              early_stopping=es)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)


@pytest.mark.parametrize("lp,es", [(1.0, False), (2.0, True), (0.5, "never")])
def test_beam_batched_equals_serial(weights, lp, es):
    """B images in one search, each row token-equal to its own B = 1
    search, also when their searches stop at different steps."""
    _, te = _engines(weights)
    eos = int(te.generate(INPUT_IDS, weights[2]).tokens[0, 2])
    _, te = _engines(weights, eos=eos)
    ids2, px2 = np.concatenate([INPUT_IDS] * 2), np.concatenate([weights[2], weights[3]])
    batched = tbase.beam_generate(te, state=te.prefill(ids2, px2), num_beams=3,
                                  length_penalty=lp, early_stopping=es)
    serial = [tbase.beam_generate(te, INPUT_IDS, px2[b : b + 1], num_beams=3, length_penalty=lp,
                                  early_stopping=es) for b in range(2)]
    for b in range(2):
        np.testing.assert_array_equal(batched.tokens[b], serial[b].tokens[0])
        assert batched.num_tokens[b] == serial[b].num_tokens[0]


def test_beam_prebuilt_state_and_bad_knob(weights):
    _, te = _engines(weights)
    direct = tbase.beam_generate(te, INPUT_IDS, weights[2], num_beams=2)
    via = tbase.beam_generate(te, state=te.prefill(INPUT_IDS, weights[2]), num_beams=2)
    np.testing.assert_array_equal(direct.tokens, via.tokens)
    with pytest.raises(ValueError, match="early_stopping"):
        tbase.beam_generate(te, INPUT_IDS, weights[2], early_stopping="bogus")


def test_beam_next_through_state_matches_jax(next_weights):  # noqa: F811
    jp, tp = next_weights
    kw = dict(max_new_tokens=6, eos_token_id=-1, pad_token_id=0)
    je = JaxNextEngine(cfg=narrow_config(jax_config), params=jp, max_len=1344, ensemble=False,
                       gen=jax_config.GenerationConfig(**kw))
    je.param_dtype = jnp.float32
    te = LlavaNextEngine(cfg=narrow_config(torch_config), params=tp, max_len=1344,
                         ensemble=False, gen=torch_config.GenerationConfig(**kw))
    tiles = tiles_for(te.cfg, SIZE)
    ref = jbase.beam_generate(je, state=je.prefill(NEXT_IDS, tiles, SIZE), num_beams=3)
    got = tbase.beam_generate(te, state=te.prefill(NEXT_IDS, tiles, SIZE), num_beams=3)
    np.testing.assert_array_equal(got.tokens, ref.tokens)


def test_cache_reorder_moves_only_filled_slots_of_moved_rows():
    from dropoutdecoding_tpu_torch.models import llama as tllama

    k = torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6, 1, 1)
    cache = tllama.KVCache(k.clone(), k.clone() + 1000)
    tllama.cache_reorder_rows(cache, np.array([0, 0, 3, 1]), 4)
    for leaf, base in ((cache.k, k), (cache.v, k + 1000)):
        want = base.clone()
        want[:, 1:, :4] = base[:, [0, 3, 1], :4]  # row 0 keeps its own
        torch.testing.assert_close(leaf, want, rtol=0, atol=0)


# --- the HF goldens of tests/test_baselines.py, held against the port ---------


def _hf_engine(tiny_llava, **gen):
    _, cfg, params, *_ = tiny_llava
    kw = {"max_new_tokens": 8, "eos_token_id": 2, "pad_token_id": 2, **gen}
    return LlavaEngine(
        cfg=torch_config.LlavaConfig.from_hf_dict(tiny_llava[0].config.to_dict()),
        params=llava_params_from_numpy(jax.tree.map(np.asarray, params)),
        gen=torch_config.GenerationConfig(**kw), max_len=64, ensemble=False,
    )


def _hf_beams(tiny_llava, **kw):
    model, _, _, _, expanded_ids, pixels = tiny_llava
    with torch.no_grad():
        ref = model.generate(
            input_ids=torch.from_numpy(expanded_ids), pixel_values=torch.from_numpy(pixels),
            attention_mask=torch.ones_like(torch.from_numpy(expanded_ids)), max_new_tokens=8,
            num_beams=3, do_sample=False, **kw,
        )
    return ref[0, expanded_ids.shape[1]:].numpy()


@pytest.mark.parametrize("lp,es", [(1.0, False), (2.0, False), (0.5, True), (2.0, "never")])
def test_beam_matches_hf_beam_search(tiny_llava, lp, es):
    _, _, _, input_ids, _, pixels = tiny_llava
    ref = _hf_beams(tiny_llava, length_penalty=lp, early_stopping=es)
    out = tbase.beam_generate(_hf_engine(tiny_llava), input_ids, pixels, num_beams=3,
                              length_penalty=lp, early_stopping=es)
    n = min(len(ref), out.num_tokens[0])
    np.testing.assert_array_equal(out.tokens[0, :n], ref[:n])


@pytest.mark.parametrize("lp,es", [(1.0, False), (2.0, False), (0.5, True)])
def test_beam_eos_hypotheses_mid_search_match_hf(tiny_llava, lp, es):
    _, _, _, input_ids, _, pixels = tiny_llava
    eos = int(_hf_engine(tiny_llava).generate(input_ids, pixels).tokens[0, 2])
    ref = _hf_beams(tiny_llava, length_penalty=lp, early_stopping=es, eos_token_id=eos)
    eng = _hf_engine(tiny_llava, eos_token_id=eos)
    out = tbase.beam_generate(eng, input_ids, pixels, num_beams=3, length_penalty=lp,
                              early_stopping=es)
    n = min(len(ref), out.num_tokens[0])
    np.testing.assert_array_equal(out.tokens[0, :n], ref[:n])
