"""K2's plain twin and the port's uncertainty ops against the JAX package.

- twin vs the TPU kernel (``vision_uncertainty_fused``, interpret mode):
  rtol 1e-5 -- the same exact-entropy formulas, fp32 on both sides;
- twin vs the reference ``vision_uncertainty``: atol 1e-4 -- the reference
  takes log(p + 1e-10) where the kernel takes the exact entropy;
- ``exact_top_k_ids``: equal, planted ties included.
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

