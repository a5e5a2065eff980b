"""K5's plain twin (``ops.attention.chunked_prefill_attention``), its
wrapper, and the Llama prefill that runs it, against the JAX package.

The TPU kernel ``flash_prefill_attention`` runs in interpret mode, as the
JAX package's own tests run it (``tests/test_pallas_kernels.py``).
Tolerance 2e-5, that test's own: fp32 on both sides, sums in another order.
The twin holds rows with no attendable key to the -1e30 rule (uniform over
all S keys); the TPU kernel averages over its padded columns there, so the
comparison with it keeps key 0 attendable, as every LLaVA-NeXT row is.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.models import llama as jllama
from dropoutdecoding_tpu.ops import attention as jattn
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu_torch.models import llama as tllama
from dropoutdecoding_tpu_torch.ops import attention as tattn
from dropoutdecoding_tpu_torch.ops import cuda_flash_prefill as k5
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import _to_torch

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _qkv_mask(rng, B, S, H, KH, D, tail=80, lead=0):
    """Random q, k, v and a key mask with holes, a padded tail of ``tail``
    masked keys, and ``lead`` masked leading keys."""
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    mask = rng.random((B, S)) > 0.1
    mask[:, 0] = True
    mask[:, S - tail :] = False
    mask[:, :lead] = False
    return q, k, v, mask


@pytest.mark.parametrize("KH", [4, 2])
def test_twin_matches_the_tpu_kernel(rng, interpret_pallas, KH):
    from dropoutdecoding_tpu.ops.pallas_attention import flash_prefill_attention

    q, k, v, mask = _qkv_mask(rng, 1, 1100, 4, KH, 32)
    ref = flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), causal=True
    )
    t = torch.from_numpy
    got = tattn.chunked_prefill_attention(t(q), t(k), t(v), t(mask), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("lead", [0, 3], ids=["key0-real", "rows-without-keys"])
@pytest.mark.parametrize("with_mask", [True, False])
def test_twin_matches_dense_and_jax_chunked(rng, lead, with_mask):
    """Against the port's dense ``prefill_attention`` and JAX's chunked
    attention; with ``lead`` masked leading keys, rows 0 .. lead-1 have no
    attendable key and are uniform over all S keys in all three."""
    q, k, v, mask = _qkv_mask(rng, 2, 600, 4, 2, 16, tail=40, lead=lead)
    t = torch.from_numpy
    m = mask if with_mask else None
    got = tattn.chunked_prefill_attention(
        t(q), t(k), t(v), None if m is None else t(m), causal=True, chunk=128
    )
    dense = tattn.prefill_attention(t(q), t(k), t(v), causal=True, key_mask=None if m is None else t(m))
    ref = jattn.chunked_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None if m is None else jnp.asarray(m),
        causal=True, chunk=256,
    )
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if lead and with_mask:
        uniform = np.repeat(v, 2, axis=2).mean(axis=1)  # head h reads group h // 2
        np.testing.assert_allclose(got.numpy()[:, 0], uniform, **TOL)


def test_twin_in_bf16_matches_jax_chunked(rng):
    """bf16 operands: both sides round the probabilities to bf16 before PV
    and sum in fp32; atol 2e-2 covers a probability rounding apart after
    the two sides' fp32 sums differ in order."""
    q, k, v, mask = _qkv_mask(rng, 1, 300, 4, 2, 32, tail=20)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = tattn.chunked_prefill_attention(bf(q), bf(k), bf(v), torch.from_numpy(mask))
    ref = jattn.chunked_prefill_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(mask), causal=True
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=0, atol=2e-2
    )


def test_twin_at_head_dim_128_matches_jax_chunked(rng):
    """The shape class of the card's wgmma kernel: D = 128, S = 300 (not a
    multiple of its 128-row tiles), a masked key tail, and 3 masked leading
    keys, so rows 0-2 have no attendable key and are uniform over all S
    keys on both sides.  fp32 on both sides, sums in another order: 2e-5,
    as the cases above."""
    q, k, v, mask = _qkv_mask(rng, 2, 300, 4, 2, 128, tail=30, lead=3)
    t = torch.from_numpy
    got = k5.flash_prefill_attention(t(q), t(k), t(v), t(mask))  # CPU tensors: the twin
    ref = jattn.chunked_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), causal=True, chunk=256
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    uniform = np.repeat(v, 2, axis=2).mean(axis=1)  # head h reads group h // 2
    np.testing.assert_allclose(got.numpy()[:, 2], uniform, **TOL)
    assert k5.prefill_route(torch.bfloat16, 300, 128) == "wgmma"


def test_wrapper_takes_the_twin_on_the_cpu_only(rng):
    q, k, v, mask = (torch.from_numpy(a) for a in _qkv_mask(rng, 1, 200, 4, 2, 32, tail=10))
    k5.flash_prefill_attention.launches = 0
    got = k5.flash_prefill_attention(q, k, v, mask)
    torch.testing.assert_close(got, tattn.chunked_prefill_attention(q, k, v, mask), rtol=0, atol=0)
    assert k5.flash_prefill_attention.launches == 0  # the twin is no launch
    with pytest.raises(ValueError, match="no kernel for device meta"):
        k5.flash_prefill_attention(q.to("meta"), k.to("meta"), v.to("meta"), mask.to("meta"))


@pytest.mark.parametrize(
    "change,error",
    [
        ({}, None),  # G = 3, S not a multiple of the tiles: taken
        ({"D": 48}, ValueError),  # head dim not instantiated
        ({"KH": 4}, ValueError),  # KH does not divide H
        ({"dtype": torch.float16}, TypeError),
        ({"mask_dtype": torch.float32}, TypeError),
        ({"transpose": True}, ValueError),  # not contiguous
    ],
    ids=["taken", "head-dim", "groups", "dtype", "mask-dtype", "layout"],
)
def test_kernel_operand_checks(change, error):
    """What the wrapper refuses before a launch (checked on CPU tensors:
    the checks read only shapes, types and strides)."""
    B, S, H = 1, 70, 6
    KH, D = change.get("KH", 2), change.get("D", 32)
    dtype = change.get("dtype", torch.bfloat16)
    q = torch.zeros(B, S, H, D, dtype=dtype)
    k = torch.zeros(B, S, KH, D, dtype=dtype)
    v = torch.zeros(B, S, KH, D, dtype=dtype)
    if change.get("transpose"):
        q = torch.zeros(B, H, S, D, dtype=dtype).transpose(1, 2)
    mask = torch.ones(B, S, dtype=change.get("mask_dtype", torch.bool))
    if error is None:
        k5._check(q, k, v, mask)
    else:
        with pytest.raises(error):
            k5._check(q, k, v, mask)


def _lm_config(C):
    return C.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=1e6,
    )


@pytest.mark.parametrize(
    "S,real", [(40, 30), (1100, 1000)], ids=["S40-jax-dense", "S1100-jax-chunked"]
)
def test_long_prefill_matches_jax(rng, monkeypatch, S, real):
    """``llama.prefill`` with a padded key mask, below and above the JAX
    package's 1024-token switch: the port runs K5 in every layer at both
    lengths (its twin on the CPU), JAX its dense attention at S = 40 and its
    chunked attention at S = 1100.  Each layer calls K5's wrapper once; on
    the CPU the wrapper computes the twin and launches nothing, so
    ``prefill.k5_layers`` (a count of launches) stays 0.  atol 1e-4 as the
    other LM parity tests: two layers of fp32 sums."""
    from dropoutdecoding_tpu_torch.engine import trace

    E, L, H, KH, Dh, F = 64, 2, 4, 2, 16, 128

    def n(*shape, sc=0.2):
        return (sc * rng.normal(size=shape)).astype(np.float32)

    lm = {
        "embed_tokens": n(128, E, sc=1.0),
        "layers": {
            "input_ln": 1 + n(L, E, sc=0.1), "post_attn_ln": 1 + n(L, E, sc=0.1),
            "q_proj": n(L, E, H * Dh), "k_proj": n(L, E, KH * Dh), "v_proj": n(L, E, KH * Dh),
            "o_proj": n(L, H * Dh, E), "gate_proj": n(L, E, F), "up_proj": n(L, E, F),
            "down_proj": n(L, F, E),
        },
        "norm": 1 + n(E, sc=0.1),
        "lm_head": n(E, 128),
    }
    x = rng.normal(size=(1, S, E)).astype(np.float32)
    pos = np.arange(S)[None]
    mask = np.arange(S)[None] < real
    ref_h, ref_kv = jllama.prefill(
        jax.tree.map(jnp.asarray, lm), _lm_config(jax_config), jnp.asarray(x), jnp.asarray(pos),
        key_mask=jnp.asarray(mask),
    )
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return k5.flash_prefill_attention(*args, **kwargs)

    monkeypatch.setattr(tllama, "flash_prefill_attention", counted)
    with trace.recording() as rec:
        got_h, got_kv = tllama.prefill(
            _to_torch(lm, "cpu", torch.float32), _lm_config(torch_config), torch.from_numpy(x),
            torch.from_numpy(pos), key_mask=torch.from_numpy(mask),
        )
    assert calls == [(1, S, H, Dh)] * L
    assert rec.counters["prefill.k5_layers"] == 0
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_kv.k.numpy(), np.asarray(ref_kv.k), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_kv.v.numpy(), np.asarray(ref_kv.v), rtol=1e-5, atol=1e-4)
