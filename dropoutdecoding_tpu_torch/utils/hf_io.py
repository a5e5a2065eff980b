"""HF checkpoint IO: a checkpoint directory of ``.safetensors`` or
``pytorch_model*.bin`` files -> a flat state dict {name: torch.Tensor} on
the CPU (port of ``dropoutdecoding_tpu/utils/hf_io.py``).

``.safetensors`` files are read by ``read_safetensors``, a reader of the
format itself (an 8-byte little-endian header length, a JSON header, then
the raw tensor bytes), with no ``safetensors`` package: each tensor is a
``torch.frombuffer`` view of a copy-on-write ``mmap`` of its file, so
nothing is read from disk until a leaf is converted, and bf16 stays bf16.
"""
from __future__ import annotations

import glob
import json
import mmap
import os
import struct

import torch

_ST_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict:
    """{name: tensor} of one ``.safetensors`` file, each tensor a view of
    the file's mapping (the mapping lives as long as its tensors)."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        (n,) = struct.unpack("<Q", f.read(8))
        if n > size - 8:
            raise ValueError(f"{path}: header of {n} bytes overruns the file ({size} bytes)")
        header = json.loads(f.read(n))
        # ACCESS_COPY: a private mapping, so the views are writable (as
        # torch.frombuffer wants) and no write ever reaches the file
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else None
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        dtype = _ST_DTYPES[info["dtype"]]
        shape = info["shape"]
        start, end = info["data_offsets"]
        numel = 1
        for d in shape:
            numel *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= start <= end <= size - base or end - start != numel * itemsize:
            raise ValueError(
                f"{path}: tensor {name!r} spans bytes [{start}, {end}) of a "
                f"{size - base}-byte body, for {numel} x {itemsize} bytes"
            )
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(mm, dtype=dtype, count=numel, offset=base + start)
        out[name] = flat.reshape(shape)
    return out


def load_state_dict(model_dir: str) -> dict:
    """Load all weights in a checkpoint directory into {name: tensor}.

    Multi-file checkpoints: when HF's ``model.safetensors.index.json`` is
    present (the real llava-1.5-7b layout: weight_map -> 3 shards), the
    shards named there are loaded and the result is checked against the
    full weight_map: a missing shard or tensor fails loudly instead of
    producing a silently partial tree.  Tensors keep their stored dtype."""
    sd = {}
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            weight_map = json.load(f)["weight_map"]
        for shard in sorted(set(weight_map.values())):
            path = os.path.join(model_dir, shard)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"index names shard {shard!r} but it is missing from {model_dir}"
                )
            sd.update(read_safetensors(path))
        missing = set(weight_map) - set(sd)
        if missing:
            raise ValueError(
                f"{len(missing)} tensors named in the index are absent "
                f"from their shards, e.g. {sorted(missing)[:3]}"
            )
        return sd
    st_files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if st_files:
        for path in st_files:
            sd.update(read_safetensors(path))
        return sd
    bin_files = sorted(glob.glob(os.path.join(model_dir, "pytorch_model*.bin")))
    if not bin_files:
        raise FileNotFoundError(f"no safetensors/bin weights in {model_dir}")
    for path in bin_files:
        sd.update(torch.load(path, map_location="cpu", weights_only=True))
    return sd


def hf_leaf(sd: dict, name: str, dtype, device, transpose: bool = False) -> torch.Tensor:
    """``sd[name]`` (a tensor or an array) as a contiguous leaf in ``dtype``
    on ``device``; ``transpose`` turns an HF linear weight [out, in] into the
    [in, out] of ``x @ W``.  The stored bytes go to the device first, so the
    cast and the transpose run there."""
    t = torch.as_tensor(sd[name]).to(device)
    if transpose:
        t = t.t()
    return t.to(dtype).contiguous()


def hf_stacked(sd: dict, names: list, dtype, device, transpose: bool = False) -> torch.Tensor:
    """The leaves ``names`` (one a layer) stacked on a leading [L] axis,
    made on ``device`` one layer at a time: no stacked copy in another
    dtype or on the host ever exists."""
    first = torch.as_tensor(sd[names[0]])
    shape = tuple(first.shape[::-1]) if transpose else tuple(first.shape)
    out = torch.empty((len(names), *shape), dtype=dtype, device=device)
    for i, name in enumerate(names):
        t = torch.as_tensor(sd[name]).to(device)
        out[i].copy_(t.t() if transpose else t)
    return out


def state_dict_from_torch_module(module) -> dict:
    """A live torch nn.Module's state dict, detached, on the CPU (the
    parity tests build tiny random HF models in-process)."""
    return {k: v.detach().to("cpu") for k, v in module.state_dict().items()}
