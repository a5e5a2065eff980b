"""The slice as a whole: the port's ``LlavaEngine`` against the JAX engine,
plus the mask policies, the vote and the draw source.

The JAX engine draws each member's mask uniforms from
``jax.random.uniform(fold_in(fold_in(fold_in(key(seed), step), row),
member), (N,))``; the test computes those same draws and injects them into
the port, so generated tokens must be equal.  ``epis`` agrees to 1e-5: the
port takes K2's exact-entropy form and the JAX CPU path the reference's
log(p + 1e-10); both are fp32.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.decoding import aggregate as jagg
from dropoutdecoding_tpu.decoding import masks as jmasks
from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.decoding import aggregate as tagg
from dropoutdecoding_tpu_torch.decoding import masks as tmasks
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import llava_params_from_numpy
from dropoutdecoding_tpu_torch.utils.prng import PhiloxUniform, leaf_seed
from test_torch_models import INPUT_IDS, tiny_config, tiny_tree

SEED = 24


def jax_uniform(seed):
    """The JAX engine's own mask draws, as the port's draw source."""
    base = jax.random.key(seed)

    def uniform(step, row, member, n):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(base, step), row), member)
        return torch.from_numpy(np.array(jax.random.uniform(key, (n,))))

    return uniform


def jax_text_uniform(seed, length=None):
    """The JAX engine's text-mask draws (stream 7919), as the port's
    ``text_uniform``.  The JAX engine draws ``max_len`` rounded up to 32
    values; ``length`` is that count where the port's ``max_len`` differs,
    and the port takes the first ``n``."""
    base = jax.random.key(seed)

    def text_uniform(step, row, n):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(base, step), 7919), row)
        return torch.from_numpy(np.array(jax.random.uniform(key, (length or n,))))[:n]

    return text_uniform


def jax_gumbel(seed):
    """The JAX engine's sampling noise (stream 104729): the Gumbel draw
    ``jax.random.categorical`` adds to the logits, as the port's ``gumbel``."""
    base = jax.random.fold_in(jax.random.key(seed), 104729)

    def gumbel(step, row, n):
        key = jax.random.fold_in(jax.random.fold_in(base, step), row)
        return torch.from_numpy(np.array(jax.random.gumbel(key, (n,), jnp.float32)))

    return gumbel


@pytest.fixture(scope="module")
def weights():
    tree, pixels = tiny_tree()
    return jax.tree.map(jnp.asarray, tree), llava_params_from_numpy(tree), pixels


def _engines(weights, ensemble=True, max_new_tokens=6, **ens):
    jp, tp, _ = weights
    kw = dict(max_new_tokens=max_new_tokens, eos_token_id=-1, pad_token_id=0)
    je = JaxEngine(
        cfg=tiny_config(jax_config), params=jp, ens=jax_config.EnsembleConfig(**ens),
        gen=jax_config.GenerationConfig(**kw), max_len=64, seed=SEED, ensemble=ensemble,
    )
    je.param_dtype = jnp.float32
    te = LlavaEngine(
        cfg=tiny_config(torch_config), params=tp, ens=torch_config.EnsembleConfig(**ens),
        gen=torch_config.GenerationConfig(**kw), max_len=64, seed=SEED, ensemble=ensemble,
        uniform=jax_uniform(SEED),
    )
    return je, te


@pytest.mark.parametrize(
    "ensemble,ens",
    [
        (False, {}),  # greedy
        (True, {}),  # exact K=3, epis masks, vote (the defaults)
        (True, {"use_avg": True}),
        (True, {"mask_policy": "random_image"}),
    ],
    ids=["greedy", "exact-vote", "exact-avg", "random-image"],
)
def test_generate_matches_jax_engine(weights, ensemble, ens):
    je, te = _engines(weights, ensemble=ensemble, **ens)
    pixels = weights[2]
    ref = je.generate(INPUT_IDS, pixels)
    got = te.generate(INPUT_IDS, pixels)
    assert got.tokens.shape == (1, 6)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.num_tokens, ref.num_tokens)


def test_prefill_state_matches_jax(weights):
    je, te = _engines(weights)
    pixels = weights[2]
    js, ts = je.prefill(INPUT_IDS, pixels), te.prefill(INPUT_IDS, pixels)
    np.testing.assert_allclose(ts.epis.numpy(), np.asarray(js.epis), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        ts.last_logits.numpy(), np.asarray(js.last_logits), rtol=1e-5, atol=1e-4
    )
    np.testing.assert_array_equal(ts.topk_ids.numpy(), np.asarray(js.topk_ids))
    np.testing.assert_array_equal(ts.image_pos.numpy(), np.asarray(js.image_pos))
    np.testing.assert_array_equal(ts.cur_len.numpy(), np.asarray(js.cur_len))
    assert int(ts.first_token[0]) == int(js.first_token[0])
    S = INPUT_IDS.shape[1] + 16 - 1
    np.testing.assert_allclose(
        ts.cache.k[:, :, :S].numpy(), np.asarray(js.cache.k[:, :, :S]), rtol=1e-5, atol=1e-4
    )


@pytest.mark.parametrize("topk", [1, 5, 10])
def test_prefill_makes_one_uncertainty_call_with_the_table(weights, monkeypatch, topk):
    """The engine asks for the uncertainty and the top-k table in one call;
    the table is the JAX engine's and ``exact_top_k_ids``' of the same
    logits, handed to ``on_prefill`` with the state."""
    from dropoutdecoding_tpu_torch.engine import generate as tgen
    from dropoutdecoding_tpu_torch.ops.uncertainty import exact_top_k_ids

    je, te = _engines(weights, topk=topk)
    calls, seen = [], []
    auto = tgen.vision_uncertainty_auto
    monkeypatch.setattr(
        tgen, "vision_uncertainty_auto",
        lambda logits, valid=None, top_k=None: calls.append(top_k) or auto(logits, valid, top_k),
    )
    te.on_prefill = lambda logits, state: seen.append((logits, state))
    ts = te.prefill(INPUT_IDS, weights[2])
    assert calls == [topk] and len(seen) == 1 and seen[0][1] is ts
    assert ts.topk_ids.shape == (1, 16, topk) and ts.topk_ids.dtype == torch.int32
    assert "topk_ids" not in ts.uncertainty
    assert torch.equal(ts.topk_ids, exact_top_k_ids(seen[0][0], topk))
    js = je.prefill(INPUT_IDS, weights[2])
    np.testing.assert_array_equal(ts.topk_ids.numpy(), np.asarray(js.topk_ids))


def test_ensemble_masks_change_the_output(weights):
    """The tiny model is sensitive enough that masking matters: exact K=3
    decoding departs from greedy (so the parity above is not vacuous)."""
    _, greedy = _engines(weights, ensemble=False, max_new_tokens=6)
    _, exact = _engines(weights, ensemble=True, max_new_tokens=6)
    pixels = weights[2]
    assert not np.array_equal(
        greedy.generate(INPUT_IDS, pixels).tokens, exact.generate(INPUT_IDS, pixels).tokens
    )


def test_eos_stops_and_pads(weights):
    _, te = _engines(weights, ensemble=True, max_new_tokens=12)
    pixels = weights[2]
    first = te.generate(INPUT_IDS, pixels).tokens[0]
    eos = int(first[2])
    stop = int(np.where(first == eos)[0][0])
    te.gen = dataclasses.replace(te.gen, eos_token_id=eos, pad_token_id=63)
    out = te.generate(INPUT_IDS, pixels)
    assert out.num_tokens[0] == stop + 1
    np.testing.assert_array_equal(out.tokens[0, : stop + 1], first[: stop + 1])
    assert (out.tokens[0, stop + 1 :] == 63).all()


def test_kv_capacity_guard(weights):
    _, te = _engines(weights, max_new_tokens=44)  # 22 + 44 - 1 > 64
    with pytest.raises(ValueError, match="exceeds the KV capacity"):
        te.generate(INPUT_IDS, weights[2])


def test_philox_draws_follow_the_key_tree():
    u = PhiloxUniform(SEED, "cpu")
    a = u(3, 0, 1, 16)
    assert a.shape == (16,) and a.dtype == torch.float32
    assert ((a >= 0) & (a < 1)).all()
    np.testing.assert_array_equal(a.numpy(), u(3, 0, 1, 16).numpy())
    leaves = {leaf_seed(SEED, s, r, m) for s in range(4) for r in range(3) for m in range(3)}
    assert len(leaves) == 36  # every (step, row, member) has its own stream
    assert all(0 <= x < 2**63 for x in leaves)


def test_default_draws_are_deterministic(weights):
    jp, tp, pixels = weights
    make = lambda: LlavaEngine(  # noqa: E731
        cfg=tiny_config(torch_config), params=tp, max_len=64,
        gen=torch_config.GenerationConfig(max_new_tokens=6, eos_token_id=-1),
    )
    np.testing.assert_array_equal(
        make().generate(INPUT_IDS, pixels).tokens, make().generate(INPUT_IDS, pixels).tokens
    )


# --- masks and aggregation on random inputs --------------------------------


@pytest.mark.parametrize("with_valid", [False, True])
def test_epis_mask_probs(rng, with_valid):
    epis = rng.gamma(2.0, 1.0, size=(3, 37)).astype(np.float32)
    valid = rng.random((3, 37)) > 0.2 if with_valid else None
    for cap in (0.3, 0.7):
        ref = jax.vmap(lambda e, v: jmasks.epis_mask_probs(e, cap, 0.1, v))(
            jnp.asarray(epis), jnp.asarray(valid if with_valid else np.ones((3, 37), bool))
        )
        got = tmasks.epis_mask_probs(
            torch.from_numpy(epis), cap, 0.1, torch.from_numpy(valid) if with_valid else None
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    flat = tmasks.epis_mask_probs(torch.ones(2, 8), 0.7, 0.1)  # degenerate: nothing drops
    assert (flat == 0).all()


def test_overlap_keep_mask(rng):
    topk = rng.integers(0, 20, size=(2, 30, 5))
    argmax = np.array([3, 11])
    ref = jax.vmap(jmasks.overlap_keep_mask)(jnp.asarray(argmax), jnp.asarray(topk))
    got = tmasks.overlap_keep_mask(torch.from_numpy(argmax), torch.from_numpy(topk))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("policy", ["epis", "random_image", "none"])
@pytest.mark.parametrize("accumulate", [True, False])
def test_member_drop_masks(rng, policy, accumulate):
    N = 40
    epis = rng.gamma(2.0, 1.0, size=N).astype(np.float32)
    overlap = rng.random(N) > 0.8
    prev_j = jnp.zeros((N,), bool)
    prev_t = torch.zeros(N, dtype=torch.bool)
    for m, cap in enumerate((0.3, 0.5, 0.7)):
        key = jax.random.fold_in(jax.random.key(5), m)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (N,))))
        ref = jmasks.build_member_drop_mask(
            key, policy, jnp.asarray(epis), cap, jnp.asarray(overlap), prev_j, accumulate
        )
        got = tmasks.build_member_drop_mask(
            u, policy, torch.from_numpy(epis), cap, torch.from_numpy(overlap), prev_t, accumulate
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        prev_j, prev_t = ref, got


def test_unported_mask_policy_raises():
    """An unknown policy's name raises ``ValueError``, when the mask is
    built and when an ensemble engine is."""
    z = torch.zeros(4)
    b = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown mask policy"):
        tmasks.build_member_drop_mask(z, "bogus", z, 0.5, b, b, True)
    with pytest.raises(ValueError):
        LlavaEngine(cfg=tiny_config(torch_config), params=None,
                    ens=torch_config.EnsembleConfig(mask_policy="bogus"))


def test_vote_and_average(rng):
    V = 10
    logits = rng.normal(size=(6, 3, V)).astype(np.float32)
    # planted vote patterns: a 2-1 majority, a three-way tie, a tie at 1-1-1
    # where the first member must win, and unanimity
    for row, winners in zip(range(4), ([4, 7, 7], [1, 2, 3], [5, 5, 5], [9, 0, 9])):
        logits[row] = 0.0
        logits[row, np.arange(3), winners] = 5.0
    logits[4, :, :] = 1.0  # all-tied logits: argmax picks index 0
    for fn_t, fn_j in ((tagg.select_by_vote, jagg.select_by_vote),
                       (tagg.select_by_average, jagg.select_by_average)):
        w_t, tok_t = fn_t(torch.from_numpy(logits))
        w_j, tok_j = jax.vmap(fn_j)(jnp.asarray(logits))
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
