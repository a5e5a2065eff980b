"""The port's shard functions (``parallel/mesh.py``) against the JAX
package's placements, leaf by leaf, with no process group: a hand-built
``Mesh`` names the rank, and each of its local slices must be bit-equal to
the shard JAX puts on the device at that (data, model) coordinate of its
mesh on the 8-device virtual CPU mesh (``addressable_shards``), from the
same numpy params: dense, int8 and packed int4 leaves, the three model
families and the KV cache, dense and int8.  Also the spec tables as data,
the refusals, and ``shard_work``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropoutdecoding_tpu.models.llama import KVCache as JaxKVCache
from dropoutdecoding_tpu.parallel import mesh as jmesh
from dropoutdecoding_tpu.utils import quantize as jq
from dropoutdecoding_tpu_torch.models.llama import KVCache
from dropoutdecoding_tpu_torch.parallel import distributed as pd
from dropoutdecoding_tpu_torch.parallel import mesh as pm
from dropoutdecoding_tpu_torch.utils import config as torch_config
from dropoutdecoding_tpu_torch.utils.convert import (
    instructblip_params_from_numpy,
    llava_params_from_numpy,
    llavanext_params_from_numpy,
)
from test_torch_instructblip import narrow_tree as ib_tree
from test_torch_tp import _tree, llava_cfg, next_cfg

N_DEVICES = 8


def _leaves(tree, prefix=""):
    """{path: leaf} of a params tree (NamedTuple, dicts, the Q-Former's
    list of layers)."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _shard_on(arr, device) -> np.ndarray:
    for s in arr.addressable_shards:
        if s.device == device:
            return np.asarray(s.data)
    raise AssertionError(f"no shard on {device}")


def _assert_shards_equal(jax_tree, port_of, n_model):
    """Every leaf of every rank's port slices equals JAX's shard on the
    device at (data d, model r); ``port_of(mesh)`` cuts the port's tree."""
    n_data = N_DEVICES // n_model
    jm = jmesh.make_mesh(n_data=n_data, n_model=n_model)
    jl = _leaves(jax_tree(jm))
    for d in range(n_data):
        for r in range(n_model):
            pl = _leaves(port_of(pm.Mesh(n_data, n_model, data_rank=d, model_rank=r)))
            assert pl.keys() == jl.keys()
            for name, leaf in pl.items():
                want = _shard_on(jl[name], jm.devices[d, r])
                got = leaf.numpy()
                assert got.shape == want.shape, (name, d, r, got.shape, want.shape)
                np.testing.assert_array_equal(got, want, err_msg=f"{name} at ({d}, {r})")


_QUANTIZED = {}


def _quantized(tree, kind):
    """The tree with its LM as the JAX quantizer makes it (numpy leaves),
    made once a kind."""
    if kind == "dense":
        return tree
    if kind not in _QUANTIZED:
        quant = jq.quantize_llama_params if kind == "int8" else jq.quantize_llama_params_int4
        lm = jax.tree.map(np.array, quant(jax.tree.map(jnp.asarray, tree.lm)))
        _QUANTIZED[kind] = tree._replace(lm=lm)
    return _QUANTIZED[kind]


@pytest.fixture(scope="module")
def llava_tree():
    from dropoutdecoding_tpu.models.llava import LlavaParams

    vision, projector, lm, _ = _tree(llava_cfg(torch_config), seed=3)
    _QUANTIZED.clear()
    return LlavaParams(vision, projector, lm)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_llava_shards_equal_jax(llava_tree, kind, n_model):
    """LLaVA-1.5: the CLIP tower (q/k/v/fc1 and their biases split, out_b
    and fc2_b whole), the projector (fc1_b split, fc2_b whole) and the LM
    (lm_head on the vocabulary; an int8 scale split with a column split,
    whole with a row split; a row-parallel int4 leaf whole)."""
    tree = _quantized(llava_tree, kind)
    port = llava_params_from_numpy(tree)
    _assert_shards_equal(
        lambda m: jmesh.shard_llava_params(jax.tree.map(jnp.asarray, tree), m),
        lambda mesh: pm.shard_llava_params(port, mesh), n_model,
    )


def test_int4_row_parallel_leaf_stays_whole(llava_tree):
    tree = _quantized(llava_tree, "int4")
    port = llava_params_from_numpy(tree)
    sp = pm.shard_llava_params(port, pm.Mesh(1, 2, model_rank=1))
    layers, whole = sp.lm["layers"], port.lm["layers"]
    assert layers["o_proj"]["q4"] is whole["o_proj"]["q4"]
    assert layers["q_proj"]["q4"].shape[-1] == whole["q_proj"]["q4"].shape[-1] // 2


@pytest.mark.parametrize("n_model", [2])
def test_llavanext_shards_equal_jax(n_model):
    """LLaVA-NeXT: as LLaVA's, with image_newline whole (its 2 KV heads
    split at most twice)."""
    from dropoutdecoding_tpu.models.llavanext import LlavaNextParams

    v, proj, lm, r = _tree(next_cfg(torch_config), seed=4)
    tree = LlavaNextParams(v, proj, r.normal(size=(64,)).astype(np.float32), lm)
    port = llavanext_params_from_numpy(tree)
    _assert_shards_equal(
        lambda m: jmesh.shard_llavanext_params(jax.tree.map(jnp.asarray, tree), m),
        lambda mesh: pm.shard_llavanext_params(port, mesh), n_model,
    )


@pytest.mark.parametrize("n_model", [2, 4])
def test_instructblip_shards_equal_jax(n_model):
    """InstructBLIP: the LM split; the ViT, Q-Former and projection whole."""
    tree = ib_tree()
    port = instructblip_params_from_numpy(tree)
    _assert_shards_equal(
        lambda m: jmesh.shard_instructblip_params(jax.tree.map(jnp.asarray, tree), m),
        lambda mesh: pm.shard_instructblip_params(port, mesh), n_model,
    )


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_cache_shards_equal_jax(int8, n_model):
    """``shard_cache``: rows on "data", KV heads on "model"; the int8 "q"
    [L, B, S, KH*D] in whole head panels, its "s" [L, B, KH, S] on dim 2."""
    L, B, S, KH, D = 2, N_DEVICES // n_model, 6, 4, 8
    r = np.random.default_rng(5)
    if int8:
        def leaf():
            return {"q": r.integers(-127, 128, size=(L, B, S, KH * D)).astype(np.int8),
                    "s": r.random((L, B, KH, S)).astype(np.float32)}
    else:
        def leaf():
            return r.normal(size=(L, B, S, KH, D)).astype(np.float32)
    k, v = leaf(), leaf()

    def to_torch(x):
        return {n: torch.from_numpy(a) for n, a in x.items()} if int8 else torch.from_numpy(x)

    port = KVCache(to_torch(k), to_torch(v))
    _assert_shards_equal(
        lambda m: jmesh.shard_cache(JaxKVCache(jax.tree.map(jnp.asarray, k),
                                               jax.tree.map(jnp.asarray, v)), m),
        lambda mesh: pm.shard_cache(port, mesh), n_model,
    )


def test_spec_tables_equal_jax():
    def as_data(specs):
        if isinstance(specs, dict):
            return {k: as_data(v) for k, v in specs.items()}
        return tuple(specs)

    for name in ("llama_param_specs", "clip_param_specs", "projector_param_specs"):
        assert as_data(getattr(pm, name)()) == as_data(getattr(jmesh, name)()), name
    assert pm.llama_param_specs()["lm_head"] == (None, "model")  # the table, not the docstring


def test_fused_leaves_raise(llava_tree):
    from dropoutdecoding_tpu_torch.utils.quantize import fuse_projections

    port = llava_params_from_numpy(llava_tree)
    fused = port._replace(lm=fuse_projections(port.lm))
    with pytest.raises(ValueError, match="fused qkv/gate_up"):
        pm.shard_llava_params(fused, pm.Mesh(1, 2))
    jfused = jax.tree.map(jnp.asarray, llava_tree)
    jfused = jfused._replace(lm=jq.fuse_projections(jfused.lm))
    with pytest.raises(ValueError, match="fused qkv/gate_up"):
        jmesh.shard_llava_params(jfused, jmesh.make_mesh(n_data=4, n_model=2))


def test_indivisible_axis_raises_as_jax(llava_tree):
    """A vocabulary of 129 over 2 model ranks (InstructBLIP's 32001 cannot
    split either): ValueError in both packages."""
    lm = dict(llava_tree.lm, lm_head=np.zeros((128, 129), np.float32),
              embed_tokens=np.zeros((129, 128), np.float32))
    tree = llava_tree._replace(lm=lm)
    with pytest.raises(ValueError, match="not divisible"):
        pm.shard_llava_params(llava_params_from_numpy(tree), pm.Mesh(4, 2))
    with pytest.raises(ValueError):
        jmesh.shard_llava_params(jax.tree.map(jnp.asarray, tree),
                                 jmesh.make_mesh(n_data=4, n_model=2))


def test_mesh_of_finds_the_mesh(llava_tree):
    port = llava_params_from_numpy(llava_tree)
    assert pm.mesh_of(port) is None
    mesh = pm.Mesh(1, 2)
    sp = pm.shard_llava_params(port, mesh)
    assert pm.mesh_of(sp) is mesh and pm.mesh_of(sp.lm) is mesh and pm.mesh_of(sp.vision) is mesh


def test_data_split_blocks():
    rows = np.arange(6)
    blocks = [pm.data_split(rows, pm.Mesh(3, 1, data_rank=d)) for d in range(3)]
    np.testing.assert_array_equal(np.concatenate(blocks), rows)
    assert [b.tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="not divisible"):
        pm.data_split(np.arange(5), pm.Mesh(2, 1))


@pytest.mark.parametrize("backend, want", [("nccl", "cuda:0"), ("gloo", "cpu")])
def test_gather_device_follows_the_backend(monkeypatch, backend, want):
    """``gather_results`` needs no device: NCCL takes only CUDA tensors, so
    under it the host blocks go to the current card; gloo keeps them on
    the host."""
    group = object()
    monkeypatch.setattr(pm.dist, "get_backend", lambda g: backend if g is group else None)
    monkeypatch.setattr(pm.torch.cuda, "current_device", lambda: 0)
    mesh = pm.Mesh(2, 1, data_group=group)
    assert str(pm._collective_device(mesh, "data")) == want


def test_one_rank_axis_issues_no_collective():
    """An axis of one rank (a DP mesh's "model" axis) returns its input with
    no collective, even on a mesh without groups, and counts nothing; more
    than one rank and no group raises."""
    pm.reset_counts()
    x = torch.arange(4.0)
    mesh = pm.Mesh(2, 1)
    assert pm.all_reduce(x, mesh) is x and pm.all_gather(x, mesh) is x
    assert (pm.all_reduce.calls, pm.all_gather.calls) == (0, 0)
    with pytest.raises(ValueError, match="without process groups"):
        pm.all_gather(x, mesh, "data")


def test_shard_work_disjoint_and_complete():
    """tests/test_distributed.py:122: a stable round-robin; with no
    process group, the whole list."""
    items = list("abcdefg")
    shares = [pd.shard_work(items, process_index=i, process_count=3) for i in range(3)]
    assert sorted(sum(shares, [])) == sorted(items)
    assert all(set(a).isdisjoint(b) for i, a in enumerate(shares) for b in shares[i + 1:])
    assert shares[1] == ["b", "e"]
    assert pd.shard_work(items) == items
