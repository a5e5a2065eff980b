"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, which is loaded with ``ctypes``.
No PyTorch header is compiled, so a build takes seconds.  The library is
named by a hash of the sources and flags and cached under
``dropoutdecoding_tpu_torch/_build/`` (ignored by git); it is built at the
first kernel call, never at import.

Each C entry returns ``cudaGetLastError()`` after its launches, and
``check`` raises when that is not 0: a refused launch never runs, and a
later synchronise would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # dtype, q, k_cache, v_cache, k_new, v_new, key_mask, out,
    # part_m, part_l, part_acc, B, M, H, KH, S, D, chunk, scale, stream
    "dd_ensemble_decode_attention": [_I] + [_P] * 10 + [_I] * 7 + [_F, _P],
    # x, w, m, z, a, b, scratch, c, B, L, V, stream
    "dd_vision_uncertainty": [_P] * 8 + [_I] * 3 + [_P],
}

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdd_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def build() -> Path:
    """Compile the sources unless a library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}); see {log}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process never loads a partial file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.dd_error_string.argtypes = [ctypes.c_int]
        lib.dd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().dd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as the C entries take it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
