"""The ("data", "model") process mesh, the sharding rules, and the
collectives the models issue (port of ``dropoutdecoding_tpu/parallel/mesh.py``).

The ranks of an initialized process group form a 2-D grid
``arange(world).reshape(n_data, n_model)``, as the JAX package lays its
devices out:

- "data": the batch of images, split into contiguous blocks (``data_split``,
  the counterpart of ``P("data")`` on axis 0); ``gather_results`` puts the
  blocks' tokens back in order.  The JAX package's ``data_sharding`` has no
  PyTorch meaning (a tensor has no sharding to annotate): ``data_split``
  takes its place.
- "model": megatron tensor parallelism inside each layer.  Attention heads
  and the MLP's intermediate width are split on "model" (column-parallel
  q/k/v, gate/up, CLIP fc1, projector fc1), and the projections back to the
  residual width are row-parallel (o/down, CLIP out/fc2, projector fc2),
  each followed by one all-reduce.  ``lm_head`` is split on the vocabulary
  (``P(None, "model")``, the spec table's rule; the JAX module's docstring
  calls it replicated, its table does not), and its logits are gathered
  whole on every rank, so the vote, the sampling and K2 see what an
  unsharded run sees.

The spec tables are the JAX package's, as data: a spec is a tuple with one
entry an axis, None or a mesh axis name.  The ``shard_*`` functions return
this rank's local slices, as new tensors, in parameter dicts of the class
``ShardedParams`` that carry the mesh; ``mesh_of`` finds it again, so an
engine built from sharded params knows its mesh from them alone, as in the
JAX package.  Where GSPMD inserts the collectives from the annotations, the
port issues each one itself: ``all_reduce`` and ``all_gather`` here are the
only collectives the models call, and they count the collectives they
issue (``all_reduce.calls``, ``all_gather.calls``).  Over an axis of one
rank (the "model" axis of a DP mesh) they issue none, as GSPMD emits none.

Both work on NCCL and on gloo, with CPU or CUDA tensors.  Gloo takes CUDA
tensors for ``all_reduce`` but not for ``all_gather``; so a gather is one
``all_reduce`` (a sum) into a zeroed full-width buffer in which each rank
has written its own block: adding zeros is exact.  Gloo stages a CUDA
tensor through host memory inside the collective; the tensors stay on the
card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on the ("data", "model") grid, and the two process
    groups it belongs to: the ranks that share its data coordinate
    (``model_group``, the tensor-parallel peers) and those that share its
    model coordinate (``data_group``).  A mesh built by hand without groups
    describes a rank for the shard functions alone; its collectives are
    then the identity, which only a one-rank axis allows."""

    n_data: int
    n_model: int
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def rank(self, axis: str) -> int:
        return self.data_rank if axis == "data" else self.model_rank

    def group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group


def make_mesh(n_data: int | None = None, n_model: int | None = None) -> Mesh:
    """The mesh over every rank of the initialized process group, with the
    JAX package's defaults: neither count given, all ranks on "data"; one
    given, the other is what is left.  Every rank must call it, in the same
    order as any other group it makes."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group (init_multihost)")
    n = dist.get_world_size()
    if n_data is None and n_model is None:
        n_data, n_model = n, 1
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    assert n_data * n_model == n, (n_data, n_model, n)
    rank = dist.get_rank()
    grid = np.arange(n).reshape(n_data, n_model)
    model_group = data_group = None
    for d in range(n_data):
        g = dist.new_group(grid[d].tolist())
        if rank in grid[d]:
            model_group = g
    for m in range(n_model):
        g = dist.new_group(grid[:, m].tolist())
        if rank in grid[:, m]:
            data_group = g
    return Mesh(n_data, n_model, rank // n_model, rank % n_model, data_group, model_group)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

_OPS = {"sum": "SUM", "max": "MAX"}


def all_reduce(x: torch.Tensor, mesh: Mesh | None, axis: str = "model", op: str = "sum"):
    """``x`` reduced over the mesh axis, in place; returned.  No mesh, or one
    rank on the axis: ``x`` as it is, with no collective and uncounted (as
    GSPMD emits nothing for a one-device axis)."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    group = mesh.group(axis)
    if group is None:
        raise ValueError(f"a mesh without process groups has {mesh.size(axis)} ranks on {axis!r}")
    all_reduce.calls += 1
    dist.all_reduce(x, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    return x


all_reduce.calls = 0


def all_gather(x: torch.Tensor, mesh: Mesh | None, axis: str = "model", dim: int = -1):
    """The axis's blocks of ``x`` concatenated along ``dim`` in rank order,
    on every rank: one sum over a zeroed buffer in which this rank wrote
    its block (gloo has no ``all_gather`` of CUDA tensors).  No mesh, or one
    rank on the axis: ``x``, with no collective and uncounted."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    group = mesh.group(axis)
    n, r = mesh.size(axis), mesh.rank(axis)
    if group is None:
        raise ValueError(f"a mesh without process groups has {n} ranks on {axis!r}")
    all_gather.calls += 1
    dim = dim % x.dim()
    w = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = w * n
    full = x.new_zeros(shape)
    full.narrow(dim, r * w, w).copy_(x)
    dist.all_reduce(full, group=group)
    return full


all_gather.calls = 0


def reset_counts() -> None:
    all_reduce.calls = 0
    all_gather.calls = 0


# ---------------------------------------------------------------------------
# the spec tables (the JAX package's, as data)
# ---------------------------------------------------------------------------


def P(*axes) -> tuple:
    """A partition spec: one entry an axis, None (whole) or a mesh axis."""
    return tuple(axes)


def _llama_layer_specs() -> dict:
    return {
        "input_ln": P(),
        "post_attn_ln": P(),
        "q_proj": P(None, None, "model"),
        "k_proj": P(None, None, "model"),
        "v_proj": P(None, None, "model"),
        "o_proj": P(None, "model", None),
        "gate_proj": P(None, None, "model"),
        "up_proj": P(None, None, "model"),
        "down_proj": P(None, "model", None),
    }


def llama_param_specs() -> dict:
    return {
        "embed_tokens": P(),
        "layers": _llama_layer_specs(),
        "norm": P(),
        "lm_head": P(None, "model"),
    }


def clip_param_specs() -> dict:
    layer = {
        "ln1_w": P(), "ln1_b": P(), "ln2_w": P(), "ln2_b": P(),
        "q_w": P(None, None, "model"), "q_b": P(None, "model"),
        "k_w": P(None, None, "model"), "k_b": P(None, "model"),
        "v_w": P(None, None, "model"), "v_b": P(None, "model"),
        "out_w": P(None, "model", None), "out_b": P(),
        "fc1_w": P(None, None, "model"), "fc1_b": P(None, "model"),
        "fc2_w": P(None, "model", None), "fc2_b": P(),
    }
    return {
        "class_embedding": P(),
        "patch_embedding": P(),
        "position_embedding": P(),
        "pre_ln_w": P(),
        "pre_ln_b": P(),
        "layers": layer,
    }


def projector_param_specs() -> dict:
    return {
        "fc1_w": P(None, "model"),
        "fc1_b": P("model"),
        "fc2_w": P("model", None),
        "fc2_b": P(),
    }


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


class ShardedParams(dict):
    """A parameter dict of this rank's slices; ``mesh`` is the mesh they
    were cut for (``mesh_of`` reads it)."""

    mesh: Mesh


def _local(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, as its own tensor in the
    source's layout (a column-major matrix stays column-major).  An axis the
    mesh axis does not divide raises ValueError, as JAX's ``device_put``
    does."""
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more axes than a {t.dim()}-D leaf")
    out = t
    for d, name in enumerate(spec):
        if name is None:
            continue
        n = mesh.size(name)
        if t.shape[d] % n:
            raise ValueError(
                f"axis {d} of a leaf of shape {tuple(t.shape)} is not divisible by "
                f"the {n} ranks of {name!r}"
            )
        w = t.shape[d] // n
        out = out.narrow(d, mesh.rank(name) * w, w)
    if out is t:
        return t
    if t.dim() >= 2 and not t.is_contiguous() and t.mT.is_contiguous():
        return out.mT.contiguous().mT
    return out.contiguous()


def _is_quantized(x) -> bool:
    return isinstance(x, dict) and set(x) in ({"q", "s"}, {"q4", "s4"})


def _put(a, s: tuple, mesh: Mesh):
    if isinstance(a, dict) and set(a) == {"q", "s"}:
        # int8 weight: "q" shards like the dense weight; the per-output-
        # channel scale [..., 1, E] shards with the output axis under a
        # column split and stays whole under a row split
        s_spec = P(*([None] * (a["s"].dim() - 1) + ["model"])) if s and s[-1] == "model" else P()
        return {"q": _local(a["q"], s, mesh), "s": _local(a["s"], s_spec, mesh)}
    if isinstance(a, dict) and set(a) == {"q4", "s4"}:
        # packed int4: byte d packs contraction rows d and d + D/2, so only
        # the output axis can be split; a row-parallel leaf (o_proj,
        # down_proj) stays whole and its input is gathered instead
        if s and s[-1] == "model":
            s4_spec = P(*([None] * (a["s4"].dim() - 1) + ["model"]))
            return {"q4": _local(a["q4"], s, mesh), "s4": _local(a["s4"], s4_spec, mesh)}
        return {"q4": a["q4"], "s4": a["s4"]}
    return _local(a, s, mesh)


def _apply_specs(tree: dict, specs: dict, mesh: Mesh) -> dict:
    out = {}
    for name, a in tree.items():
        s = specs[name]
        if isinstance(a, dict) and not _is_quantized(a):
            out[name] = _apply_specs(a, s, mesh)
        else:
            out[name] = _put(a, s, mesh)
    return out


def _sharded(tree: dict, specs: dict, mesh: Mesh) -> ShardedParams:
    out = ShardedParams(_apply_specs(tree, specs, mesh))
    out.mesh = mesh
    return out


def _reject_fused(lm: dict) -> None:
    if "moe" in lm:
        raise ValueError("tensor parallelism is not supported with the MLA + MoE decoder "
                         "(models/mla_moe.py)")
    if "qkv_proj" in lm.get("layers", {}):
        raise ValueError(
            "params carry fused qkv/gate_up leaves "
            "(utils/quantize.fuse_projections) — a single-device layout. "
            "TP shard specs are keyed on the split leaf names; shard the "
            "split params and skip fuse_projections on mesh runs."
        )


def shard_llama_params(lm: dict, mesh: Mesh) -> ShardedParams:
    """A Llama decoder's params (``models/llama.py``) cut to this rank: the
    megatron specs of ``llama_param_specs``.  A speculative draft tower is
    cut with it, like its target."""
    _reject_fused(lm)
    return _sharded(lm, llama_param_specs(), mesh)


def shard_llava_params(params, mesh: Mesh):
    """LlavaParams cut to this rank: the CLIP tower, the projector and the
    LM each by its spec table."""
    from ..models.llava import LlavaParams

    return LlavaParams(
        vision=_sharded(params.vision, clip_param_specs(), mesh),
        projector=_sharded(params.projector, projector_param_specs(), mesh),
        lm=shard_llama_params(params.lm, mesh),
    )


def shard_llavanext_params(params, mesh: Mesh):
    """LlavaNextParams cut to this rank: CLIP tower, projector and the
    Mistral LM as LLaVA's (the same module layouts); ``image_newline``, a
    [D] vector, stays whole."""
    from ..models.llavanext import LlavaNextParams

    return LlavaNextParams(
        vision=_sharded(params.vision, clip_param_specs(), mesh),
        projector=_sharded(params.projector, projector_param_specs(), mesh),
        image_newline=params.image_newline,
        lm=shard_llama_params(params.lm, mesh),
    )


def shard_instructblip_params(params, mesh: Mesh):
    """InstructBlipParams cut to this rank: the Vicuna LM (the decode path,
    where TP pays) by the megatron specs; EVA-ViT-g, the Q-Former and the
    projection run once a request and stay whole."""
    from ..models.instructblip import InstructBlipParams

    return InstructBlipParams(
        vision=params.vision,
        qformer=params.qformer,
        projection=params.projection,
        lm=shard_llama_params(params.lm, mesh),
    )


def shard_cache(cache, mesh: Mesh):
    """This rank's block of a KVCache: rows on "data", KV heads on "model".
    Dense leaves [L, B, S, KH, D]; int8 "q" [L, B, S, KH*D] splits its
    flattened minor axis into whole head panels (the same data as a KH
    split of the 5-D layout), "s" [L, B, KH, S] on its dim 2."""
    from ..models.llama import KVCache

    def put(leaf):
        if isinstance(leaf, dict):
            return {
                "q": _local(leaf["q"], P(None, "data", None, "model"), mesh),
                "s": _local(leaf["s"], P(None, "data", "model", None), mesh),
            }
        return _local(leaf, P(None, "data", None, "model", None), mesh)

    return KVCache(put(cache.k), put(cache.v))


def mesh_of(params) -> Mesh | None:
    """The mesh a parameter tree was cut for by a ``shard_*`` function, or
    None (unsharded params).  Engines read it at construction and the
    models at every forward, so sharded params are all a caller passes."""
    if isinstance(params, ShardedParams):
        return params.mesh
    if hasattr(params, "_fields"):  # a params NamedTuple
        for part in params:
            m = mesh_of(part)
            if m is not None:
                return m
    return None


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------


def data_split(x, mesh: Mesh | None):
    """This data rank's contiguous block of a batch-leading array, tensor or
    list (``P("data")`` on axis 0); the whole batch without a mesh."""
    if mesh is None:
        return x
    n = len(x)
    if n % mesh.n_data:
        raise ValueError(f"a batch of {n} rows is not divisible by the {mesh.n_data} data ranks")
    b = n // mesh.n_data
    return x[mesh.data_rank * b: (mesh.data_rank + 1) * b]


def _collective_device(mesh: Mesh, axis: str) -> torch.device:
    """Where a collective over the axis must run for host data: the current
    card under NCCL (which takes only CUDA tensors), the host under gloo."""
    group = mesh.group(axis)
    if group is not None and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_results(result, mesh: Mesh | None):
    """The data ranks' ``GenerationResult`` blocks joined back in batch
    order, on every rank.  The blocks are host arrays; the sum-gather runs
    where the data group's backend takes them (``_collective_device``)."""
    if mesh is None:
        return result
    device = _collective_device(mesh, "data")
    tokens = all_gather(torch.as_tensor(result.tokens, device=device), mesh, "data", dim=0)
    num = all_gather(torch.as_tensor(result.num_tokens, device=device), mesh, "data", dim=0)
    return type(result)(
        tokens=tokens.cpu().numpy().astype(result.tokens.dtype),
        num_tokens=num.cpu().numpy().astype(np.asarray(result.num_tokens).dtype),
    )
