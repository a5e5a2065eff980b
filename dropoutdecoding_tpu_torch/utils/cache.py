"""Converted-parameter caching (port of ``dropoutdecoding_tpu/utils/cache.py``).

Converting an HF checkpoint (transposes, stacking, casts) is repeated work
on every run; the converted tree is stored once per (checkpoint, dtype)
with ``torch.save`` and read back with ``torch.load(mmap=True)``, straight
onto the device.  The key is the JAX package's ``_cache_dir``; the file is
``<key>.pt`` beside where the JAX package keeps its orbax directory, so the
two never read each other's format.
"""
from __future__ import annotations

import hashlib
import os
import pickle

import torch


def _cache_dir(model_dir: str, dtype_name: str) -> str:
    tag = hashlib.sha1(f"{os.path.abspath(model_dir)}:{dtype_name}".encode()).hexdigest()[:16]
    base = os.environ.get(
        "DROPOUTDECODING_CACHE", os.path.expanduser("~/.cache/dropoutdecoding_tpu")
    )
    return os.path.join(base, tag)


def load_or_convert(model_dir: str, convert_fn, dtype: torch.dtype, device, enable: bool = True):
    """``convert_fn()`` -> a tree (dicts of tensors); cached per
    (model_dir, dtype) when ``enable``, and returned on ``device``."""
    path = _cache_dir(model_dir, str(dtype).removeprefix("torch.")) + ".pt"
    if enable and os.path.isfile(path):
        try:
            return torch.load(path, map_location=device, mmap=True, weights_only=True)
        except (OSError, RuntimeError, pickle.UnpicklingError):
            pass  # an unreadable cache file: convert again and replace it
    tree = convert_fn()
    if enable:
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(tree, tmp)
            os.replace(tmp, path)
        except OSError:
            if os.path.exists(tmp):
                os.remove(tmp)
    return tree
