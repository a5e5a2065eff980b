"""The port's ``cli/fused_gap.py`` against the JAX package's.

The JAX tool's tiny studies run as they are (``init_params`` weights, its
own engines); the port's run on those weights, carried across by
``llava_params_from_numpy`` (``_build`` swapped), with JAX's mask draws
injected (``test_torch_engine.jax_uniform``), so the two reports must be
equal key for key.  Model seed 6 gives reports in which exact and fused
part and the vote winners differ, at hidden 64, 2 layers, vocab 128, one
prompt x one seed x 6 tokens, fp32.  Then every study of the port once on
the CPU (the production studies on a narrow LLaVA through ``cfg``), the
engine's winners, and each arm on its own copy of the prefill's cache.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from dropoutdecoding_tpu.cli import fused_gap as jfg
from dropoutdecoding_tpu_torch.cli import fused_gap as tfg
from dropoutdecoding_tpu_torch.utils.convert import (
    llava_params_from_numpy,
    synthetic_llava_7b,
    synthetic_llava_7b_dual,
)
from test_torch_engine import jax_uniform
from test_torch_serving_tools import one_thread  # noqa: F401 (autouse)

H, L, V, T = 64, 2, 128, 6
MODEL_SEED = 6


@pytest.fixture(scope="module")
def jax_weights():
    _, params = jfg._build(H, L, V, MODEL_SEED)
    return llava_params_from_numpy(jax.tree.map(np.asarray, params))


@pytest.fixture
def port_on_jax_weights(monkeypatch, jax_weights):
    monkeypatch.setattr(tfg, "_build", lambda h, l, v, seed, device: (
        tfg._tiny_config(h, l, v), jax_weights))


@pytest.mark.parametrize("study, kw", [
    ("run_study", {"mask_policy": "epis"}),
    ("run_study", {"mask_policy": "epis_kl"}),
    ("run_int4_study", {}),
], ids=["fused-epis", "fused-epis_kl", "int4"])
def test_report_equals_jax(port_on_jax_weights, study, kw):
    want = getattr(jfg, study)(H, L, V, 1, 1, T, model_seed=MODEL_SEED, **kw)
    got = getattr(tfg, study)(H, L, V, 1, 1, T, model_seed=MODEL_SEED, device="cpu",
                              uniform=jax_uniform, **kw)
    assert got == want


def _rates_in_range(report):
    T = report["config"]["tokens"]
    summaries = [v for v in report.values() if isinstance(v, dict) and "mean_match_rate" in v]
    assert summaries
    for v in summaries:
        assert 0.0 <= v["mean_match_rate"] <= 1.0 and 0.0 <= v["mean_prefix_len"] <= T
    assert 0.0 <= report.get("winner_tv_distance", 0.0) <= 1.0


@pytest.mark.parametrize("study", list(tfg.TINY_STUDIES))
def test_tiny_study_runs(study):
    report = tfg.main(["--study", study, "--hidden", "64", "--layers", "2", "--vocab", "128",
                       "--prompts", "1", "--seeds", "1", "--tokens", "4", "--json"], device="cpu")
    _rates_in_range(report)
    assert report["config"]["tokens"] == 4


def _narrow(hidden=64):
    cfg = tfg._tiny_config(hidden, 2, 256)
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, image_size=28))


@pytest.mark.parametrize("argv", [
    ["--study", "production"],
    ["--study", "production", "--k", "8", "--policy", "epis_kl"],
    ["--study", "int4prod"],
], ids=["production", "production-k8-epis_kl", "int4prod"])
def test_production_studies_run(argv):
    # the 7B builders at a narrow config
    report = tfg.main(argv + ["--prompts", "2", "--tokens", "4", "--json"], device="cpu",
                      cfg=_narrow())
    _rates_in_range(report)
    K = 8 if "8" in argv else 3
    assert report["config"]["K"] == K and report["config"]["prompts"] == 2
    for key, v in report.items():
        if key.startswith("winner_dist"):
            assert len(v) == K and abs(sum(v) - 1.0) < 1e-3


def _arms(cfg, params):
    kw = dict(T=T, uniform=jax_uniform)
    return (tfg._engine(cfg, params, fused=False, seed=24, **kw),
            tfg._engine(cfg, params, fused=True, seed=24, **kw),
            tfg._engine(cfg, params, fused=False, seed=31, **kw),
            tfg._engine(cfg, params, fused=False, ensemble=False, seed=24, T=T))


def test_arms_in_reverse_order_and_the_cache_kept(jax_weights):
    """Each arm decodes its own copy of the prefill's cache: the arms give
    the same tokens in either order, and the state's cache is untouched."""
    cfg = tfg._tiny_config(H, L, V)
    exact, fused, exact2, greedy = _arms(cfg, jax_weights)
    (ids, px), = tfg._tiny_prompts(np.random.default_rng(MODEL_SEED), 1, cfg)
    st = exact.prefill(ids, px)
    before = [t.clone() for t in (st.cache.k, st.cache.v)]
    arms = [
        lambda: tfg._run_with_winners(exact, st)[0],
        lambda: tfg._run_with_winners(fused, st)[0],
        lambda: tfg._decode(exact2, st),
        lambda: tfg._decode(greedy, st),
    ]
    forward = [arm() for arm in arms]
    backward = [arm() for arm in reversed(arms)][::-1]
    for a, b in zip(forward, backward):
        np.testing.assert_array_equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(before, (st.cache.k, st.cache.v)))


def test_decode_hands_out_the_winners(jax_weights):
    """``LlavaEngine.decode(state, winners=[])`` gives the tokens of a
    plain decode and one winner [B] a step, a member index, in exact and
    fused mode."""
    cfg = tfg._tiny_config(H, L, V)
    exact, fused, _, _ = _arms(cfg, jax_weights)
    (ids, px), = tfg._tiny_prompts(np.random.default_rng(MODEL_SEED), 1, cfg)
    st = exact.prefill(ids, px)
    for eng in (exact, fused):
        tokens, winners = tfg._run_with_winners(eng, st)
        np.testing.assert_array_equal(tokens, tfg._decode(eng, st))
        assert winners.shape == (T - 1,) and ((winners >= 0) & (winners < eng.ens.k)).all()


def test_synthetic_7b_builders_at_a_narrow_config():
    cfg = _narrow(hidden=256)  # int4's in-dims: multiples of 2 x its group
    got_cfg, params = synthetic_llava_7b("cpu", cfg)
    assert got_cfg == cfg and "q" in params.lm["layers"]["qkv_proj"]
    assert params.vision["layers"]["q_w"].dtype == torch.bfloat16
    _, p8, p4 = synthetic_llava_7b_dual("cpu", cfg)
    assert p8.lm["lm_head"] is p4.lm["lm_head"] and p8.vision is p4.vision
    assert "q" in p8.lm["layers"]["qkv_proj"] and "q4" in p4.lm["layers"]["qkv_proj"]
