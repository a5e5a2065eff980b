"""Tensor and data parallelism of the port (``parallel/``) with two real
ranks on the CPU, against the unsharded port and the JAX package's mesh
runs: the counterpart of ``tests/test_mesh.py``.

The two ranks are spawned once for the file (``ranks``): they join a gloo
group through a ``file://`` rendezvous under ``tmp_path`` (no port, so parallel
test workers cannot collide), run every case of ``tests/torch_tp_ranks.py``
with one intra-op thread each, and hand their results back in a pickle.
TP is the (1 data x 2 model) mesh, DP (2 x 1).  Rank 0 also runs each call
unsharded, the reference.  Meanwhile this process, which has JAX on the
8-device virtual CPU mesh of ``conftest.py``, runs the JAX side: the same
numpy weights under ``make_mesh(n_data=2, n_model=4)`` (LLaVA-1.5,
InstructBLIP) or ``(4, 2)`` (LLaVA-NeXT, whose 2 KV heads split at most
twice).  The JAX engine's mask draws are injected into the ranks as a
table, so the exact ensemble's tokens must be equal.

Tolerances: prefill logits atol = rtol = 1e-4 and epis atol 1e-4, rtol
1e-3, as ``tests/test_mesh.py:115`` holds its JAX mesh run (fp32; the TP
all-reduce adds the two ranks' partial sums in another order than one
dot), and so the POPE path's probe logits; the winner's K/V rows 1e-4
(``tests/test_mesh.py:196``); OPERA's
head-mean row 1e-6 (probabilities of order 1e-1 summed over 4 of 8 heads
and all-reduced); the w8a8 row-parallel product bit-equal (its int32 sums
are exact once the row max is the all-reduced one).  Tokens equal.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dropoutdecoding_tpu.engine.generate import LlavaEngine as JaxEngine
from dropoutdecoding_tpu.engine.instructblip_engine import InstructBlipEngine as JaxIbEngine
from dropoutdecoding_tpu.engine.llavanext_engine import LlavaNextEngine as JaxNextEngine
from dropoutdecoding_tpu.parallel import mesh as jmesh
from dropoutdecoding_tpu.utils import config as jax_config
from dropoutdecoding_tpu.utils.quantize import quantize_llama_params, quantize_llama_params_int4
from dropoutdecoding_tpu_torch.utils import config as torch_config
from test_torch_engine import jax_uniform
from test_torch_instructblip import narrow_config as ib_config
from test_torch_instructblip import narrow_tree as ib_tree
from test_torch_instructblip import pixels_for as ib_pixels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 24
T = 6  # tokens a generation
NEXT_PINPOINTS = ((28, 56), (56, 28), (56, 56))
NEXT_SIZE = (40, 90)


def llava_cfg(C):
    """``tests/test_mesh.py:_cfg``: 8 heads over 4 KV heads, 2 layers."""
    return C.LlavaConfig(
        text=C.LlamaConfig(
            vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=4, head_dim=16,
        ),
        vision=C.ClipVisionConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, image_size=28, patch_size=14,
        ),
        image_token_index=126,
        pad_token_id=127,
    )


def next_cfg(C):
    """A small LLaVA-NeXT: Mistral-style GQA (4 heads over 2 KV heads),
    28 px tiles of 7 px patches."""
    return C.LlavaNextConfig(
        text=C.LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        ),
        vision=C.ClipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=4, image_size=28, patch_size=7,
        ),
        image_token_index=120,
        image_grid_pinpoints=NEXT_PINPOINTS,
    )


def _tower(r, D, I, L, positions, patch, std):
    def n(*shape, sc=std):
        return (sc * r.normal(size=shape)).astype(np.float32)

    def one(*shape):
        return (1 + 0.1 * r.normal(size=shape)).astype(np.float32)

    return {
        "class_embedding": n(D), "patch_embedding": n(3 * patch * patch, D),
        "position_embedding": n(positions, D), "pre_ln_w": one(D), "pre_ln_b": n(D, sc=0.1),
        "layers": {
            "ln1_w": one(L, D), "ln1_b": n(L, D, sc=0.1), "ln2_w": one(L, D),
            "ln2_b": n(L, D, sc=0.1), "q_w": n(L, D, D), "q_b": n(L, D, sc=0.1),
            "k_w": n(L, D, D), "k_b": n(L, D, sc=0.1), "v_w": n(L, D, D), "v_b": n(L, D, sc=0.1),
            "out_w": n(L, D, D), "out_b": n(L, D, sc=0.1), "fc1_w": n(L, D, I),
            "fc1_b": n(L, I, sc=0.1), "fc2_w": n(L, I, D), "fc2_b": n(L, D, sc=0.1),
        },
    }


def _tree(cfg, seed, std=0.2):
    """Numpy params of a LLaVA-family config (the JAX layout), std ``std``
    with non-trivial norms and biases, so argmax decisions are stable
    against fp32 summation order."""
    r = np.random.default_rng(seed)

    def n(*shape, sc=std):
        return (sc * r.normal(size=shape)).astype(np.float32)

    def one(*shape):
        return (1 + 0.1 * r.normal(size=shape)).astype(np.float32)

    v, t = cfg.vision, cfg.text
    D, E, F = v.hidden_size, t.hidden_size, t.intermediate_size
    H, KH, Dh, L = t.num_attention_heads, t.num_key_value_heads, t.head_dim, t.num_hidden_layers
    vision = _tower(r, D, v.intermediate_size, v.num_hidden_layers, v.num_positions,
                    v.patch_size, std)
    projector = {"fc1_w": n(D, E), "fc1_b": n(E, sc=0.1), "fc2_w": n(E, E), "fc2_b": n(E, sc=0.1)}
    lm = {
        "embed_tokens": n(t.vocab_size, E, sc=1.0),
        "layers": {
            "input_ln": one(L, E), "post_attn_ln": one(L, E),
            "q_proj": n(L, E, H * Dh), "k_proj": n(L, E, KH * Dh), "v_proj": n(L, E, KH * Dh),
            "o_proj": n(L, H * Dh, E), "gate_proj": n(L, E, F), "up_proj": n(L, E, F),
            "down_proj": n(L, F, E),
        },
        "norm": one(E),
        "lm_head": n(E, t.vocab_size, sc=0.5),
    }
    return vision, projector, lm, r


def _llava_inputs(cfg, B, seed=0):
    """``tests/test_mesh.py:_inputs``: rows with different pixels and image
    positions."""
    r = np.random.default_rng(seed)
    img = cfg.image_token_index
    ids = []
    for b in range(B):
        p = 1 + (b % 3)
        row = [1] + [3 + b] * (p - 1) + [img] + [5, 7, 9, 11][: 5 - p]
        ids.append(row[:5])
    return np.asarray(ids, np.int32), r.normal(size=(B, 3, 28, 28)).astype(np.float32)


def _uniform_table(seed, rows, n):
    """The JAX engine's mask draws for ``rows`` rows, 3 members: the decode
    steps 1 .. T - 1, and as many past them, which a server draws for a row
    that waits for its harvest (their values reach no token)."""
    draw = jax_uniform(seed)
    return {(s, b, m): draw(s, b, m, n).numpy() for s in range(1, 2 * T) for b in range(rows)
            for m in range(3)}


@pytest.fixture(scope="module")
def data():
    from dropoutdecoding_tpu.models.llava import LlavaParams
    from dropoutdecoding_tpu.models.llavanext import LlavaNextParams
    from dropoutdecoding_tpu_torch.models import llavanext as tnext

    lcfg = llava_cfg(torch_config)
    vision, projector, lm, _ = _tree(lcfg, seed=0)
    ids, px = _llava_inputs(lcfg, 2)
    ids3, px3 = _llava_inputs(lcfg, 3, seed=1)
    ncfg = next_cfg(torch_config)
    nv, nproj, nlm, r = _tree(ncfg, seed=1)
    newline = r.normal(size=(64,)).astype(np.float32)
    n_tiles = tnext.image_geometry(NEXT_SIZE, ncfg)["n_tiles"]
    max_len = tnext.max_image_tokens(ncfg) + 32
    return {
        "llava": {
            "cfg": lcfg, "tree": LlavaParams(vision, projector, lm), "ids": ids, "pixels": px,
            "ids3": ids3, "pixels3": px3,
            "uniform": _uniform_table(SEED, 3, lcfg.vision.num_patches),
        },
        "next": {
            "cfg": ncfg, "tree": LlavaNextParams(nv, nproj, newline, nlm),
            "ids": np.array([[1, 5, 9, 120, 11, 13]]), "size": NEXT_SIZE, "max_len": max_len,
            "tiles": np.random.default_rng(2).normal(size=(n_tiles, 3, 28, 28)).astype(np.float32),
        },
        "ib": {
            "cfg": ib_config(torch_config), "tree": ib_tree(), "ids": np.array([[1, 5, 9, 11]]),
            "pixels": ib_pixels(1), "q_ids": np.array([[3, 7, 11]]),
        },
    }


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """Spawn the two ranks (they run while the JAX side computes); the
    fixture's value waits for them and returns (rank 0's, rank 1's)
    results."""
    tmp = tmp_path_factory.mktemp("tp")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(data, f)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_NUM_CPU_DEVICES")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    worker = os.path.join(ROOT, "tests", "torch_tp_ranks.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(tmp / "store"), str(r), "2", str(tmp / "in.pkl"),
             str(tmp / f"out{r}.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT,
        )
        for r in (0, 1)
    ]
    cache = {}

    def results():
        if not cache:
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=600)
                assert p.returncode == 0, (r, err.decode()[-3000:])
                with open(tmp / f"out{r}.pkl", "rb") as f:
                    cache[r] = pickle.load(f)
        return cache[0], cache[1]

    yield results
    for p in procs:
        if p.poll() is None:
            p.kill()


# --- the JAX side -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_dense(data):
    """JAX's dense mesh run, shared by the TP and the DP test."""
    return _jax_llava(data)


def _jax_llava(data, quantize=None, int8_kv=False):
    """JAX's mesh run of tests/test_mesh.py: (2 data x 4 model), exact
    K = 3, the cache placed by ``shard_cache``.  Returns (tokens, logits)."""
    d = data["llava"]
    params = jax.tree.map(jnp.asarray, d["tree"])
    if quantize is not None:
        params = params._replace(lm=quantize(params.lm))
    mesh = jmesh.make_mesh(n_data=2, n_model=4)
    eng = JaxEngine(
        cfg=llava_cfg(jax_config), params=jmesh.shard_llava_params(params, mesh),
        ens=jax_config.EnsembleConfig(),
        gen=jax_config.GenerationConfig(max_new_tokens=T, eos_token_id=-1, pad_token_id=0),
        max_len=64, seed=SEED, ensemble=True, int8_kv=int8_kv,
    )
    eng.param_dtype = jnp.float32
    with mesh:
        ids = jax.device_put(jnp.asarray(d["ids"]), NamedSharding(mesh, P("data")))
        px = jax.device_put(jnp.asarray(d["pixels"]), NamedSharding(mesh, P("data")))
        state = eng.prefill(ids, px)
        state = state._replace(cache=jmesh.shard_cache(state.cache, mesh))
        tokens, _ = eng._decode(eng.params, state)
        return np.asarray(tokens), np.asarray(state.last_logits)


def _both(res, case, key):
    """(rank 0's value, rank 1's) of a case's key."""
    return res[0][case][key], res[1][case][key]


def _tokens_agree(res, case, key):
    """Both ranks' TP tokens equal each other and rank 0's unsharded run."""
    a, b = _both(res, case, f"{key}/tp")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, res[0][case][f"{key}/ref"])
    return a


# --- the tests ----------------------------------------------------------------


def test_tp_generate_and_logits_match_unsharded_and_jax_mesh(jax_dense, ranks):
    """tests/test_mesh.py:115: TP prefill logits and exact tokens against
    the unsharded port and JAX's (2 x 4) mesh run; greedy and fused too."""
    jax_tokens, jax_logits = jax_dense
    res = ranks()
    for mode in ("greedy", "exact", "fused"):
        _tokens_agree(res, "llava_tiers", f"dense/{mode}")
    np.testing.assert_array_equal(res[0]["llava_tiers"]["dense/exact/tp"], jax_tokens)
    for r in (0, 1):
        case = res[r]["llava_tiers"]
        np.testing.assert_allclose(case["dense/logits/tp"], jax_logits, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(case["dense/logits/tp"], res[0]["llava_tiers"][
            "dense/logits/ref"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(case["dense/epis/tp"], res[0]["llava_tiers"]["dense/epis/ref"],
                                   atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_tp_quantized_generate(data, ranks, tier):
    """tests/test_mesh.py:257 (int8 weights, int8 KV cache) and :371 (packed
    int4: column shards through K6's twin, row-parallel leaves whole with
    their inputs gathered)."""
    if tier == "int8":
        jax_tokens, _ = _jax_llava(data, quantize_llama_params, int8_kv=True)
    else:
        jax_tokens, _ = _jax_llava(data, quantize_llama_params_int4)
    tokens = _tokens_agree(ranks(), "llava_tiers", f"{tier}/exact")
    np.testing.assert_array_equal(tokens, jax_tokens)


@pytest.mark.parametrize("path", ["probe", "extend", "extend/int8"])
def test_tp_pope_path_matches_unsharded(ranks, path):
    """The POPE path over TP params: ``probe`` and the prefix cache, dense
    and int8 (each rank's heads of the prefix): first tokens equal, logits
    within 1e-4 of the unsharded port's."""
    res = ranks()
    (ta, la), (tb, lb) = _both(res, "probe", f"{path}/tp")
    tr, lr = res[0]["probe"][f"{path}/ref"]
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(ta, tr)
    np.testing.assert_allclose(la, lr, atol=1e-4, rtol=1e-4)


def test_winner_kv_rows_under_a_sharded_cache(ranks):
    """tests/test_mesh.py:196: after one exact step, rank 0's local heads of
    every written row (the prefill's and the winner's) equal the unsharded
    cache's same heads; rank 1's cache holds as many heads."""
    res = ranks()
    case = res[0]["winner_kv"]
    cur = case["cur"]
    for b, s in enumerate(cur):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(case[f"{leaf}/tp"][:, b, : s + 1],
                                       case[f"{leaf}/ref"][:, b, : s + 1], atol=1e-4, rtol=1e-4)
    assert res[1]["winner_kv"]["k/tp"].shape == case["k/tp"].shape
    assert case["k/tp"].shape[3] == 2  # 4 KV heads over 2 model ranks


def test_dp_batched_equals_per_row(jax_dense, ranks):
    """tests/test_mesh.py:233: each data rank decodes its own row with its
    global rng_id; gathered in order, the batch equals the per-row runs (and
    the JAX mesh's exact tokens, themselves data-sharded)."""
    res = ranks()
    jax_tokens, _ = jax_dense
    a, b = _both(res, "dp", "gathered")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, res[0]["dp"]["ref"])
    np.testing.assert_array_equal(a, jax_tokens)
    np.testing.assert_array_equal(res[0]["dp"]["local"], a[:1])
    np.testing.assert_array_equal(res[1]["dp"]["local"], a[1:])


def test_tp_decode_server_matches_solo(ranks):
    """tests/test_mesh.py:398: the continuous-batching server over TP params
    (slot placement on each rank's local heads) equals solo generate."""
    res = ranks()
    for rid in ("r0", "r1", "r2"):
        a, b = _both(res, "server", f"{rid}/tp")
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, res[0]["server"][f"{rid}/ref"][: len(a)])


def test_tp_collective_budget(ranks):
    """tests/test_mesh.py:293, counted exactly at the helpers: a decode
    forward (decode_step + lm_head) makes 2 all-reduces a layer and one
    gather of the vocabulary blocks, at M = 1 and M = 3 alike; the vision
    path 2 a CLIP layer that runs plus 1 in the projector; a prefill adds
    the head's two gathers (last logits, visual-span logits).  Under DP
    (2 x 1) the "model" axis has one rank: a decode forward and a prefill
    issue no collective, as GSPMD emits none for a one-device axis."""
    for r in (0, 1):
        case = ranks()[r]["budget"]
        L, Lv, c = case["L"], case["vision_layers"], case["counts"]
        assert c["decode"] == (2 * L, 1)
        assert c["decode_m3"] == (2 * L, 1)
        assert c["vision"] == (2 * Lv + 1, 0)
        assert c["prefill"] == (2 * L + 2 * Lv + 1, 2)
        assert c["decode_dp"] == (0, 0)
        assert c["prefill_dp"] == (0, 0)


def test_tp_llavanext_matches_unsharded_and_jax(data, ranks):
    """tests/test_llavanext_parity.py:437: LLaVA-NeXT under TP (GQA split,
    image_newline whole), greedy against the JAX (4 x 2) mesh run; exact
    against the unsharded port."""
    d = data["next"]
    params = jax.tree.map(jnp.asarray, d["tree"])
    mesh = jmesh.make_mesh(n_data=4, n_model=2)
    eng = JaxNextEngine(
        cfg=next_cfg(jax_config), params=jmesh.shard_llavanext_params(params, mesh),
        ens=jax_config.EnsembleConfig(mask_accumulate=False, topk=10),
        gen=jax_config.GenerationConfig(max_new_tokens=5, eos_token_id=-1, pad_token_id=0),
        max_len=d["max_len"], seed=506, ensemble=False,
    )
    eng.param_dtype = jnp.float32
    with mesh:
        jax_tokens = np.asarray(eng.generate(d["ids"], d["tiles"], d["size"]).tokens)
    res = ranks()
    np.testing.assert_array_equal(_tokens_agree(res, "next", "greedy"), jax_tokens)
    _tokens_agree(res, "next", "exact")


def test_tp_instructblip_matches_unsharded_and_jax(data, ranks):
    """tests/test_instructblip_parity.py:310: the Vicuna LM split, EVA-ViT,
    Q-Former and projection whole; greedy against the JAX (2 x 4) mesh run,
    fused against the unsharded port."""
    d = data["ib"]
    params = jax.tree.map(jnp.asarray, d["tree"])
    mesh = jmesh.make_mesh(n_data=2, n_model=4)
    eng = JaxIbEngine(
        cfg=ib_config(jax_config), params=jmesh.shard_instructblip_params(params, mesh),
        gen=jax_config.GenerationConfig(max_new_tokens=5, eos_token_id=-1, pad_token_id=0),
        max_len=48, ensemble=False,
    )
    eng.param_dtype = jnp.float32
    with mesh:
        jax_tokens = np.asarray(eng.generate(d["ids"], d["pixels"], d["q_ids"]).tokens)
    res = ranks()
    np.testing.assert_array_equal(_tokens_agree(res, "instructblip", "greedy"), jax_tokens)
    _tokens_agree(res, "instructblip", "fused")


@pytest.mark.parametrize("arm", ["vcd", "beam", "opera"])
def test_tp_baselines_match_unsharded(ranks, arm):
    """VCD (its draws the same on every rank), beam search (the host scan
    reads the gathered logits, so both ranks pick the same beams) and OPERA
    (the head-mean attention summed over the model ranks; the JAX package
    never ran OPERA on a mesh) over TP params equal the unsharded port."""
    res = ranks()
    _tokens_agree(res, "baselines", arm)
    if arm == "opera":
        a, b = _both(res, "baselines", "attn/tp")
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, res[0]["baselines"]["attn/ref"], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("kind", ["lm", "ngram"])
def test_tp_speculative_matches_unsharded(ranks, kind):
    """Speculative greedy over a TP target (the int4 self-draft cut like
    the target; the n-gram draft): the unsharded speculative run's tokens,
    which are the greedy ones."""
    res = ranks()
    tokens = _tokens_agree(res, "speculative", kind)
    np.testing.assert_array_equal(tokens, res[0]["speculative"]["greedy/ref"][: len(tokens)])


def test_tp_w8a8_row_max_across_ranks(ranks):
    """w8a8 under TP: a row-parallel product whose row maxima lie in the
    other rank's shard equals the unsharded product bit for bit (the row
    max all-reduced, then the int32 sums); the rank-local max would not.
    Engines with w8a8 prefill and decode are token-equal to unsharded."""
    res = ranks()
    for r in (0, 1):
        case = res[r]["w8a8"]
        np.testing.assert_array_equal(case["mm/tp"], case["mm/ref"])
        assert not np.array_equal(case["mm/local_max"], case["mm/ref"])
    for mode in ("greedy", "exact"):
        _tokens_agree(res, "w8a8", mode)
