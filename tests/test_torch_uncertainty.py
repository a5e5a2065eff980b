"""K2's plain twin and the port's uncertainty ops against the JAX package.

- twin vs the TPU kernel (``vision_uncertainty_fused``, interpret mode):
  rtol 1e-5 -- the same exact-entropy formulas, fp32 on both sides;
- twin vs the reference ``vision_uncertainty``: atol 1e-4 -- the reference
  takes log(p + 1e-10) where the kernel takes the exact entropy;
- ``exact_top_k_ids``: equal, planted ties included; the twin's ``top_k``
  table equal to it and to ``jax.lax.top_k``;
- ``topk_token_ids``, ``kl_to_current`` (fp32, rtol 1e-6 beside an atol of
  1e-6 for KLs near 0) and ``lowest_percent_kl_indices_mask`` (equal).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.ops import uncertainty as juq
from dropoutdecoding_tpu.ops.pallas_uncertainty import (
    vision_uncertainty_fused as tpu_kernel,
)
from dropoutdecoding_tpu_torch.ops import uncertainty as tuq
from dropoutdecoding_tpu_torch.ops.cuda_uncertainty import (
    vision_uncertainty_fused,
    vision_uncertainty_twin,
)


def _logits(rng, B=2, L=12, V=300):
    return (3 * rng.normal(size=(B, L, V))).astype(np.float32)


def _valid(rng, B=2, L=12):
    v = rng.random((B, L)) > 0.3
    v[1] = False  # an image with no valid row: n_valid clamps to 1
    return v


def _compare(got: dict, ref: dict, **tol):
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(ref[key]), err_msg=key, **tol
        )


@pytest.mark.parametrize("with_valid", [False, True])
def test_twin_matches_tpu_kernel(rng, with_valid):
    x = _logits(rng)
    valid = _valid(rng) if with_valid else None
    ref = tpu_kernel(jnp.asarray(x), None if valid is None else jnp.asarray(valid), interpret=True)
    # CPU tensors: the K2 wrapper computes its plain twin
    got = vision_uncertainty_fused(
        torch.from_numpy(x), None if valid is None else torch.from_numpy(valid)
    )
    _compare(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("with_valid", [False, True])
def test_twin_matches_reference_formula(rng, with_valid):
    x = _logits(rng)
    valid = _valid(rng) if with_valid else None
    ref = juq.vision_uncertainty(jnp.asarray(x), None if valid is None else jnp.asarray(valid))
    got = vision_uncertainty_twin(
        torch.from_numpy(x), None if valid is None else torch.from_numpy(valid)
    )
    _compare(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_valid", [False, True])
def test_reference_formula_matches_jax(rng, with_valid):
    x = _logits(rng)
    valid = _valid(rng) if with_valid else None
    ref = juq.vision_uncertainty(jnp.asarray(x), None if valid is None else jnp.asarray(valid))
    got = tuq.vision_uncertainty(
        torch.from_numpy(x), None if valid is None else torch.from_numpy(valid)
    )
    _compare(got, ref, rtol=1e-5, atol=1e-7)


def test_auto_takes_the_wrapper_on_cpu(rng):
    x = torch.from_numpy(_logits(rng))
    _compare(tuq.vision_uncertainty_auto(x), vision_uncertainty_twin(x), rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 5])
def test_exact_top_k_ids_with_ties(rng, k):
    x = rng.integers(0, 6, size=(2, 9, 40)).astype(np.float32)  # many ties
    x[0, 0, [3, 17, 30]] = 50.0  # a planted three-way tie at the top
    got = tuq.exact_top_k_ids(torch.from_numpy(x), k)
    ref = juq.exact_top_k_ids(jnp.asarray(x), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if k == 5:
        np.testing.assert_array_equal(got[0, 0, :3].numpy(), [3, 17, 30])
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.lax.top_k(x, k)[1]))


def _tied_logits(rng, B=2, L=12, V=300):
    """bf16-valued logits (many natural ties) with planted ones: the row's
    maximum at two far columns, the next value at three neighbours."""
    x = torch.from_numpy(_logits(rng, B, L, V)).bfloat16().float().numpy()
    top = x.max(axis=-1, keepdims=True)
    x[..., [100, V - 7]] = top + 1.5
    x[..., [47, 48, 51]] = top + 1.0
    return x


@pytest.mark.parametrize("k", [1, 5, 10])
@pytest.mark.parametrize("with_valid", [False, True])
def test_twin_top_k_matches_jax(rng, k, with_valid):
    """The twin's table against ``exact_top_k_ids`` of the JAX package and
    ``jax.lax.top_k``: equal ids, B = 2, an image with no valid row."""
    x = _tied_logits(rng)
    valid = _valid(rng) if with_valid else None
    got = vision_uncertainty_twin(
        torch.from_numpy(x), None if valid is None else torch.from_numpy(valid), top_k=k
    )
    ids = got.pop("topk_ids")
    assert ids.dtype == torch.int32 and ids.shape == (2, 12, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(juq.exact_top_k_ids(jnp.asarray(x), k)))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax.lax.top_k(x, k)[1]))
    want = [100, 293, 47, 48, 51][:k]
    np.testing.assert_array_equal(ids[1, 3, :5].numpy(), want)
    # the other fields are what they are without the table
    plain = vision_uncertainty_twin(
        torch.from_numpy(x), None if valid is None else torch.from_numpy(valid)
    )
    _compare(got, plain, rtol=0, atol=0)


@pytest.mark.parametrize("with_valid", [False, True])
def test_wrapper_with_top_k_matches_tpu_kernel_and_xla_table(rng, with_valid):
    """One call of the port's wrapper (the twin, on CPU tensors) against the
    two the JAX engine makes: the TPU kernel in interpret mode (rtol 1e-5
    beside an atol of 1e-5: with the planted maxima epis is a small
    difference of two terms near 6) and ``exact_top_k_ids`` (equal)."""
    x = _tied_logits(rng)
    valid = _valid(rng) if with_valid else None
    jv = None if valid is None else jnp.asarray(valid)
    ref = tpu_kernel(jnp.asarray(x), jv, interpret=True)
    got = tuq.vision_uncertainty_auto(
        torch.from_numpy(x), None if valid is None else torch.from_numpy(valid), top_k=10
    )
    ids = got.pop("topk_ids")
    _compare(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(juq.exact_top_k_ids(jnp.asarray(x), 10)))


@pytest.mark.parametrize("k", [1, 5, 10])
def test_topk_token_ids(rng, k):
    x = _tied_logits(rng)
    values, ids = tuq.topk_token_ids(torch.from_numpy(x), k)
    ref_v, ref_i = juq.topk_token_ids(jnp.asarray(x), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_v))


def test_kl_to_current(rng):
    image = _logits(rng, B=1, L=20, V=64)[0]
    cur = 3 * rng.normal(size=64).astype(np.float32)
    cur[[5, 9]] = -np.inf  # p = 0 there: the guarded terms
    got = tuq.kl_to_current(torch.from_numpy(image), torch.from_numpy(cur))
    ref = juq.kl_to_current(jnp.asarray(image), jnp.asarray(cur))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("L,percent", [(20, 0.1), (20, 0.26), (7, 0.1), (40, 0.5)])
def test_lowest_percent_kl_indices_mask(rng, L, percent):
    image = _logits(rng, B=1, L=L, V=64)[0]
    image[3] = image[1]  # two visual tokens with one KL
    cur = 3 * rng.normal(size=64).astype(np.float32)
    got = tuq.lowest_percent_kl_indices_mask(torch.from_numpy(image), torch.from_numpy(cur), percent)
    ref = juq.lowest_percent_kl_indices_mask(jnp.asarray(image), jnp.asarray(cur), percent)
    assert got.dtype == torch.bool and int(got.sum()) == int(percent * L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_entropy_varentropy(rng):
    x = _logits(rng, B=1, L=6, V=50)[0]
    ent, vent = tuq.entropy_varentropy(torch.from_numpy(x))
    ref_e, ref_v = jax.vmap(juq.entropy_varentropy)(jnp.asarray(x))
    np.testing.assert_allclose(ent.numpy(), np.asarray(ref_e), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vent.numpy(), np.asarray(ref_v), rtol=1e-5, atol=1e-5)


def test_wrapper_never_falls_back(rng):
    x = torch.from_numpy(_logits(rng)).to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        vision_uncertainty_fused(x)

