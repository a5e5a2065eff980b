"""The serving path of the port against the JAX package: per-row decode
steps, ``prefill_chunked`` and ``DecodeServer`` (``engine/serving.py``).

Requests join a server mid-flight (``_drive``: staggered joins, more
requests than slots, a slot reused), so rows decode at different steps in
one batch.  Each mode runs one JAX ``DecodeServer`` (module fixture
``jax_runs``, one compile a mode) and the port's, with JAX's three draw
streams injected into the port (``test_torch_engine.jax_uniform``,
``jax_text_uniform``, ``jax_gumbel``).

Tolerances:
- the server: tokens **equal** to the JAX server's and to the port's solo
  ``generate`` of each request;
- ``prefill_chunked`` against the one-shot ``prefill`` and JAX's
  ``prefill_chunked``: the cache's real slots and the logits at rtol 1e-5 /
  atol 1e-4 (fp32: the pieces' extend attention sums in another order than
  the one-shot attention, over two layers), epis at rtol 1e-5 / atol 1e-5,
  the table and the first token equal;
- ``cache_copy_slot(s)``: bit-equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.engine import generate as jgen
from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.engine.instructblip_engine import InstructBlipEngine as JaxIbEngine
from dropoutdecoding_tpu.engine.serving import DecodeServer as JaxServer
from dropoutdecoding_tpu.models import llama as jllama
from dropoutdecoding_tpu.models.llava import LlavaParams as JaxParams
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu.utils import quantize as jq
from dropoutdecoding_tpu_torch.engine.generate import LlavaEngine
from dropoutdecoding_tpu_torch.engine.instructblip_engine import InstructBlipEngine
from dropoutdecoding_tpu_torch.engine.llavanext_engine import LlavaNextEngine
from dropoutdecoding_tpu_torch.engine.serving import DecodeServer
from dropoutdecoding_tpu_torch.models import llama as tllama
from dropoutdecoding_tpu_torch.models import llavanext as tnext
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import (
    llava_params_from_numpy,
    llavanext_params_from_numpy,
)
from test_torch_engine import SEED, jax_gumbel, jax_text_uniform, jax_uniform
from test_torch_llavanext import INPUT_IDS as NEXT_IDS
from test_torch_llavanext import SIZE, narrow_config, narrow_tree, tiles_for
from test_torch_models import tiny_config, tiny_tree

T = 8  # new tokens a request
MAX_LEN = 64  # a multiple of 32: the JAX engine keeps it, and draws its text uniforms at it
STATE_TOL = dict(rtol=1e-5, atol=1e-4)
EPIS_TOL = dict(rtol=1e-5, atol=1e-5)

# mode -> (ensemble, EnsembleConfig fields, GenerationConfig fields, engine
# fields, weights); the server runs each against the JAX server's
MODES = {
    "exact": (True, {}, {}, {}, "dense"),
    "fused": (True, {"fused_step": True}, {}, {}, "dense"),
    "int8-kv": (True, {}, {}, {"int8_kv": True}, "dense"),
    "epis_kl exact": (True, {"mask_policy": "epis_kl"}, {}, {}, "dense"),
    "epis_kl fused (lagged)": (True, {"mask_policy": "epis_kl", "fused_step": True}, {}, {},
                               "dense"),
    "int4": (True, {}, {}, {"int8_kv": True}, "int4"),
    "sampled, entropy text mask": (
        True, {}, {"do_sample": True, "temperature": 0.7, "top_k": 5, "top_p": 0.9},
        {"text_mask_policy": "entropy"}, "dense"),
}


def _requests(n=4):
    """n requests of one prompt length (one JAX prefill compile), each its
    own tail id and image."""
    r = np.random.default_rng(42)
    return {f"r{i}": (np.array([[1, 5, 9, 32, 11, 13 + i]]),
                      r.normal(size=(1, 3, 28, 28)).astype(np.float32)) for i in range(n)}


@pytest.fixture(scope="module")
def params():
    """{"dense" | "int4": (JAX LlavaParams, port LlavaParams)}: the tiny
    tree, its int4 tier quantized by JAX and carried across as numpy."""
    tree, _ = tiny_tree()
    lm4 = jq.fuse_projections(jq.quantize_llama_params_int4(jax.tree.map(jnp.asarray, tree.lm)))
    tree4 = tree._replace(lm=jax.tree.map(np.asarray, lm4))
    return {
        "dense": (jax.tree.map(jnp.asarray, tree), llava_params_from_numpy(tree)),
        "int4": (JaxParams(*jax.tree.map(jnp.asarray, (tree.vision, tree.projector)), lm4),
                 llava_params_from_numpy(tree4)),
    }


def _engines(params, mode, max_new_tokens=T, max_len=MAX_LEN):
    ensemble, ens, gen, fields, weights = MODES[mode]
    jp, tp = params[weights]
    kw = dict(max_new_tokens=max_new_tokens, eos_token_id=-1, pad_token_id=0, **gen)
    je = JaxEngine(cfg=tiny_config(jax_config), params=jp, ens=jax_config.EnsembleConfig(**ens),
                   gen=jax_config.GenerationConfig(**kw), max_len=max_len, seed=SEED,
                   ensemble=ensemble, **fields)
    je.param_dtype = jnp.float32
    te = LlavaEngine(cfg=tiny_config(torch_config), params=tp,
                     ens=torch_config.EnsembleConfig(**ens),
                     gen=torch_config.GenerationConfig(**kw), max_len=max_len, seed=SEED,
                     ensemble=ensemble, uniform=jax_uniform(SEED),
                     text_uniform=jax_text_uniform(SEED), gumbel=jax_gumbel(SEED), **fields)
    return je, te


def _drive(server, reqs, step_n=1, step=None):
    """Staggered joins on 3 slots: r0 alone for 2 steps, r1 joins, a step
    later r2, then r3 when the first slot frees; a harvest after every
    ``step(server)`` (``server.step(step_n)`` by default).  Returns ({rid:
    tokens}, {rid: the step of the server at which it joined})."""
    order = list(reqs)
    results, joined, steps = {}, {}, 0
    step = step or (lambda s: s.step(step_n))

    def submit(rid):
        joined[rid] = steps
        server.submit(rid, *reqs[rid])

    submit(order[0])
    server.step(2)
    steps += 2
    submit(order[1])
    server.step()
    steps += 1
    pending = order[2:]
    while pending or server.active():
        while pending and server.free_slots():
            submit(pending.pop(0))
        step(server)
        steps += step_n
        results.update(server.harvest())
        assert steps < 100
    return results, joined


@pytest.fixture(scope="module")
def jax_runs(params):
    """mode -> the JAX server's tokens of ``_drive`` (computed on first use)."""
    runs = {}

    def run(mode):
        if mode not in runs:
            je, _ = _engines(params, mode)
            runs[mode] = _drive(JaxServer(engine=je, n_slots=3), _requests())[0]
        return runs[mode]

    return run


@pytest.mark.parametrize("mode", list(MODES))
def test_server_with_staggered_joins_matches_jax_and_solo(params, jax_runs, mode):
    reqs = _requests()
    _, te = _engines(params, mode)
    got, joined = _drive(DecodeServer(engine=te, n_slots=3), reqs)
    assert sorted(got) == sorted(reqs) and len(set(joined.values())) == 4  # four join steps
    ref = jax_runs(mode)
    for rid, args in reqs.items():
        solo = te.generate(*args).tokens[0]
        assert got[rid].dtype == np.int32 and len(got[rid]) == T
        np.testing.assert_array_equal(got[rid], ref[rid], err_msg=f"{mode} {rid} vs JAX")
        np.testing.assert_array_equal(got[rid], solo, err_msg=f"{mode} {rid} vs solo")
    if mode == "exact":  # the requests' captions differ, so the parity is not vacuous
        assert len({tuple(t) for t in got.values()}) > 1


def test_server_keeps_the_kl_logits_only_under_epis_kl(params):
    _, te = _engines(params, "exact")
    _, kl = _engines(params, "epis_kl exact")
    assert DecodeServer(engine=te, n_slots=3)._state.image_logits.shape == (3, 16, 1)
    assert DecodeServer(engine=kl, n_slots=3)._state.image_logits.shape == (3, 16, 64)


def test_rows_keep_their_own_steps(params):
    """A row that joins later keeps its own generation index; a done row
    stops at its own (eos here is the token a first run shows at step 3 of
    r0): JAX's per-row ``steps``."""
    reqs = _requests(2)
    _, te = _engines(params, "exact")
    free_run = te.generate(*reqs["r0"]).tokens[0]
    eos = int(free_run[3])
    stop = int(np.argmax(free_run == eos))  # its first step, 3 or before
    te.gen = torch_config.GenerationConfig(max_new_tokens=T, eos_token_id=eos, pad_token_id=0)
    server = DecodeServer(engine=te, n_slots=2)
    server.submit("r0", *reqs["r0"])
    server.step(2)
    server.submit("r1", *reqs["r1"])
    server.step(3)
    steps = server._carry["steps"].tolist()
    assert steps[1] == 4 and server._carry["draw_steps"] == [6, 4]
    assert steps[0] == stop + 1 and bool(server._carry["done"][0])  # r0 stopped at its eos
    out = server.harvest()
    solo = te.generate(*reqs["r0"])
    np.testing.assert_array_equal(out["r0"], solo.tokens[0, : solo.num_tokens[0]])


def test_budgets_cut_each_request_to_its_prefix(params):
    """``max_new_tokens`` a request: it is harvested at its budget with its
    solo tokens' prefix; budgets past T raise before any work."""
    reqs = _requests(3)
    _, te = _engines(params, "fused")
    server = DecodeServer(engine=te, n_slots=3)
    budgets = {"r0": 2, "r1": T, "r2": 5}
    for rid, args in reqs.items():
        server.submit(rid, *args, max_new_tokens=budgets[rid])
    results = {}
    for _ in range(T):
        server.step()
        results.update(server.harvest())
    for rid, args in reqs.items():
        np.testing.assert_array_equal(results[rid], te.generate(*args).tokens[0][: budgets[rid]])
    with pytest.raises(ValueError, match="outside"):
        server.submit("r9", *reqs["r0"], max_new_tokens=T + 1)
    assert server.free_slots() == [0, 1, 2]


def test_cancel_frees_the_slot_and_leaves_the_others(params):
    reqs = _requests(3)
    _, te = _engines(params, "exact")
    server = DecodeServer(engine=te, n_slots=2)
    server.submit("r0", *reqs["r0"])
    server.submit("r1", *reqs["r1"])
    server.step(2)
    assert server.cancel("r1") and not server.cancel("r1") and not server.cancel("nope")
    assert server.free_slots() == [1]
    server.submit("r2", *reqs["r2"])  # into the cancelled slot
    results = {}
    while server.active():
        server.step()
        results.update(server.harvest())
    assert sorted(results) == ["r0", "r2"]
    for rid in results:
        np.testing.assert_array_equal(results[rid], te.generate(*reqs[rid]).tokens[0])


@pytest.mark.parametrize("mode", ["exact", "sampled, entropy text mask"])
def test_step_n_is_n_single_steps(params, mode):
    """``step(3)`` leaves every buffer as three ``step()`` calls do."""
    reqs = _requests()
    _, te = _engines(params, mode)
    a, b = DecodeServer(engine=te, n_slots=3), DecodeServer(engine=te, n_slots=3)
    out_a, _ = _drive(a, reqs, step_n=3)
    out_b, _ = _drive(b, reqs, step_n=3, step=lambda s: [s.step() for _ in range(3)])
    assert sorted(out_a) == sorted(out_b) == sorted(reqs)
    for rid in reqs:
        np.testing.assert_array_equal(out_a[rid], out_b[rid])
    assert torch.equal(a._carry["tokens_buf"], b._carry["tokens_buf"])
    assert torch.equal(a._state.cache.k, b._state.cache.k)


def test_submit_many_matches_submit(params):
    """One batched prefill (rows of two lengths, right-padded to 8 and
    pinned to stream 0) places what ``submit`` places, one by one."""
    reqs = _requests(3)
    reqs["r2"] = (np.array([[1, 5, 9, 32, 11, 13, 17, 19, 23]]), reqs["r2"][1])  # a longer prompt
    _, te = _engines(params, "fused")
    many, one = DecodeServer(engine=te, n_slots=3), DecodeServer(engine=te, n_slots=3)
    assert many.submit_many(list(reqs.items())) == [0, 1, 2]
    for rid, args in reqs.items():
        one.submit(rid, *args)
    out_many, out_one = {}, {}
    for _ in range(T):
        many.step()
        one.step()
        out_many.update(many.harvest())
        out_one.update(one.harvest())
    for rid in reqs:
        np.testing.assert_array_equal(out_many[rid], out_one[rid])
        np.testing.assert_array_equal(out_many[rid], te.generate(*reqs[rid]).tokens[0])
    assert many._state.rng_id.tolist() == [0, 0, 0]


def test_run_feeds_every_request_through_the_slots(params):
    """``run`` with more requests than slots, batched and one by one."""
    reqs = _requests()
    _, te = _engines(params, "exact")
    solo = {rid: te.generate(*args).tokens[0] for rid, args in reqs.items()}
    for batch_prefill in (True, False):
        out = DecodeServer(engine=te, n_slots=2).run(list(reqs), reqs.__getitem__,
                                                     batch_prefill=batch_prefill, step_chunk=2)
        assert sorted(out) == sorted(reqs)
        for rid in reqs:
            np.testing.assert_array_equal(out[rid], solo[rid])


def test_capacity_guard_raises_at_submit_with_the_jax_message(params):
    """Prompt 21 + budget 8 - 1 = 28 > max_len 27 (the engine's own guard
    would say the same): raised before the prefill, no slot taken; a budget
    that fits passes."""
    reqs = _requests(1)
    _, te = _engines(params, "exact", max_len=27)
    server = DecodeServer(engine=te, n_slots=2)
    with pytest.raises(ValueError, match=r"slot 0: prompt \(21 tokens\) \+ budget \(8\) - 1 "
                                         r"exceeds max_len=27"):
        server.submit("r0", *reqs["r0"])
    assert server.free_slots() == [0, 1]
    server.submit("r0", *reqs["r0"], max_new_tokens=7)
    assert server.free_slots() == [1]


# --- chunked prefill -------------------------------------------------------


def _state_close(got, ref, n=None):
    """Two prefill states (port's or JAX's): the cache's first ``n`` slots,
    the logits, epis on the real visual tokens, the table and the first
    token."""
    n = int(np.asarray(ref.cur_len)[0]) if n is None else n
    for a, b in ((got.cache.k, ref.cache.k), (got.cache.v, ref.cache.v)):
        np.testing.assert_allclose(np.asarray(a)[:, :, :n], np.asarray(b)[:, :, :n], **STATE_TOL)
    np.testing.assert_allclose(np.asarray(got.last_logits), np.asarray(ref.last_logits),
                               **STATE_TOL)
    valid = np.asarray(got.visual_mask)
    np.testing.assert_allclose(np.asarray(got.epis)[valid], np.asarray(ref.epis)[valid],
                               **EPIS_TOL)
    np.testing.assert_array_equal(np.asarray(got.topk_ids)[valid],
                                  np.asarray(ref.topk_ids)[valid])
    np.testing.assert_array_equal(np.asarray(got.first_token), np.asarray(ref.first_token))
    np.testing.assert_array_equal(np.asarray(got.cur_len), np.asarray(ref.cur_len))


@pytest.mark.parametrize("chunk", [8, 5, 64])  # 21 merged tokens: 3, 5 pieces, or one
def test_prefill_chunked_matches_one_shot_and_jax(params, chunk):
    ids, pixels = _requests(1)["r0"]
    je, te = _engines(params, "exact")
    got = te.prefill_chunked(ids, pixels, chunk=chunk)
    _state_close(got, te.prefill(ids, pixels))
    _state_close(got, je.prefill_chunked(ids, pixels, chunk=chunk))
    pumped = []
    te.prefill_chunked(ids, pixels, chunk=chunk, pump=lambda: pumped.append(1))
    assert len(pumped) == -(-21 // chunk) - 1  # between two pieces


@pytest.fixture(scope="module")
def next_engine():
    return LlavaNextEngine(
        cfg=narrow_config(torch_config), params=llavanext_params_from_numpy(narrow_tree()),
        ens=torch_config.EnsembleConfig(mask_accumulate=False, topk=10),
        gen=torch_config.GenerationConfig(max_new_tokens=16, eos_token_id=-1, pad_token_id=0),
        max_len=1344, seed=506, uniform=jax_uniform(506),
    )


def test_next_prefill_chunked_matches_one_shot(next_engine):
    """The narrow NeXT (1320 merged slots, 990 real) in pieces of 256: the
    last two run over the padding, masked."""
    tiles = tiles_for(next_engine.cfg, SIZE)
    got = next_engine.prefill_chunked(NEXT_IDS, tiles, SIZE, chunk=256)
    _state_close(got, next_engine.prefill(NEXT_IDS, tiles, SIZE))


def test_next_submit_chunked_pumps_the_active_slot(next_engine):
    """F4 (ROADMAP Queue 3): a NeXT request joining by ``submit_chunked``
    (1320 slots in pieces of 256: 6 pieces) advances the active slot by
    (6 - 1) x ``pump_steps`` = 10 steps during its join, and both requests'
    tokens are their solo tokens."""
    eng = next_engine
    other = tiles_for(eng.cfg, SIZE, seed=7)
    tiles = tiles_for(eng.cfg, SIZE)
    server = DecodeServer(engine=eng, n_slots=2)
    server.submit("a", NEXT_IDS, other, SIZE)
    server.step()
    before = server._carry["steps"].tolist()[0]
    server.submit_chunked("b", NEXT_IDS, tiles, SIZE, chunk=256, pump_steps=2)
    assert server._carry["steps"].tolist() == [before + 10, 1]
    out = {}
    while server.active():
        server.step(2)
        out.update(server.harvest())
    np.testing.assert_array_equal(out["a"], eng.generate(NEXT_IDS, other, SIZE).tokens[0])
    np.testing.assert_array_equal(out["b"], eng.generate(NEXT_IDS, tiles, SIZE).tokens[0])


def test_jax_next_engine_passes_the_pump_on_too(monkeypatch):
    """The JAX NeXT engine hands ``pump`` to the base ``prefill_chunked``
    (``engine/llavanext_engine.py:381``), as the port does: F4's check of
    the reference, with the base call recorded instead of run."""
    from dropoutdecoding_tpu.engine.llavanext_engine import LlavaNextEngine as JaxNextEngine

    seen = {}
    monkeypatch.setattr(jgen.LlavaEngine, "prefill_chunked",
                        lambda self, *a, chunk=256, pump=None: seen.update(chunk=chunk, pump=pump))
    eng = JaxNextEngine.__new__(JaxNextEngine)
    eng.cfg = narrow_config(jax_config)
    eng._n_max = tnext.max_image_tokens(narrow_config(torch_config))  # the host prep reads both

    def pump():
        pass

    eng.prefill_chunked(NEXT_IDS, tiles_for(narrow_config(torch_config), SIZE), SIZE, chunk=128,
                        pump=pump)
    assert seen == {"chunk": 128, "pump": pump}


def test_prefill_chunked_rejects_batches_and_instructblip(params):
    ids, pixels = _requests(1)["r0"]
    _, te = _engines(params, "exact")
    with pytest.raises(ValueError, match="B=1"):
        te.prefill_chunked(np.concatenate([ids, ids]), np.concatenate([pixels, pixels]))
    with pytest.raises(NotImplementedError) as got:
        InstructBlipEngine.prefill_chunked(None, ids)
    with pytest.raises(NotImplementedError) as ref:
        JaxIbEngine.prefill_chunked(None, ids)
    assert "chunked prefill" in str(got.value) and str(got.value) == str(ref.value)


# --- slot placement ----------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_cache_copy_slots_bit_equal_to_jax(rng, quantized):
    tcfg, jcfg = tiny_config(torch_config).text, tiny_config(jax_config).text
    kv = rng.normal(size=(2, 2, 10, 4, 12)).astype(np.float32)  # [L, B, S0, KH, D]
    jsrc = jllama.cache_seed(jllama.empty_cache(jcfg, 2, 16, jnp.float32, quantized=quantized),
                             jllama.KVCache(jnp.asarray(kv), jnp.asarray(-kv)))
    tsrc = tllama.cache_seed(tllama.empty_cache(tcfg, 2, 16, torch.float32, "cpu",
                                                quantized=quantized),
                             tllama.KVCache(torch.from_numpy(kv), torch.from_numpy(-kv)))
    jdst = jllama.empty_cache(jcfg, 4, 16, jnp.float32, quantized=quantized)
    tdst = tllama.empty_cache(tcfg, 4, 16, torch.float32, "cpu", quantized=quantized)
    jdst = jllama.cache_copy_slots(jdst, jsrc, jnp.asarray([3, 1]))
    jdst = jllama.cache_copy_slot(jdst, jsrc, 0, 1)
    assert tllama.cache_copy_slots(tdst, tsrc, [3, 1]) is tdst
    tllama.cache_copy_slot(tdst, tsrc, 0, 1)
    for t, j in zip(jax.tree_util.tree_leaves(tuple(tdst)), jax.tree_util.tree_leaves(tuple(jdst))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match="int8"):
        tllama.cache_copy_slot(tdst, tllama.empty_cache(tcfg, 1, 16, torch.float32, "cpu",
                                                        quantized=not quantized), 0)


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_appends_past_the_cache_are_dropped_as_in_jax(rng, quantized):
    """A row whose fill is the cache's length (a server row decoding past
    its budget until harvest) writes nothing; the other rows append as
    always: bit-equal to JAX's scatter, which drops such a row."""
    tcfg, jcfg = tiny_config(torch_config).text, tiny_config(jax_config).text
    new = rng.normal(size=(2, 3, 4, 12)).astype(np.float32)  # [L, B, KH, D]
    cur = np.array([5, 16, 15])
    cj = jllama.cache_set_rows(jllama.empty_cache(jcfg, 3, 16, jnp.float32, quantized=quantized),
                               jnp.asarray(cur), jnp.asarray(new), jnp.asarray(-new))
    ct = tllama.cache_set_rows(
        tllama.empty_cache(tcfg, 3, 16, torch.float32, "cpu", quantized=quantized),
        torch.from_numpy(cur), torch.from_numpy(new), torch.from_numpy(-new))
    for t, j in zip(jax.tree_util.tree_leaves(tuple(ct)), jax.tree_util.tree_leaves(tuple(cj))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    k = ct.k["q"] if quantized else ct.k
    assert k[:, 1].abs().sum() == 0 and k[:, 2, 15].abs().sum() > 0
