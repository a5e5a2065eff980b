"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all of them at once, and the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes``.  No PyTorch
header is compiled, so a build takes seconds; the TMA kernels find
``libcuda``'s tensor-map encoder through the runtime, so nothing links
against it.  The library is named by a hash of the sources, the
``csrc/*.cuh`` headers they share and the flags, and cached under
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
# No --use_fast_math: K4's quantizer must divide in IEEE fp32 to stay
# bit-equal to its plain twin.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # dtype, q, k_cache, v_cache, k_new, v_new, key_mask, out, part_m, part_l,
    # part_acc, counters, B, M, H, KH, S, D, tiles_per_block, nsplit, scale, stream
    "dd_ensemble_decode_attention": [_I] + [_P] * 11 + [_I] * 8 + [_F, _P],
    # dtype, q, kq, ks, vq, vs, k_new, v_new, key_mask, out, part_m, part_l,
    # part_acc, counters, B, M, H, KH, S, D, tiles_per_block, nsplit, scale, stream
    "dd_ensemble_decode_attention_int8kv": [_I] + [_P] * 13 + [_I] * 8 + [_F, _P],
    # dtype, k_new, v_new, kq, ks, vq, vs, cur_len, L, B, KH, S, D, route, stream
    "dd_cache_append_int8": [_I] + [_P] * 7 + [_I] * 6 + [_P],
    # cur_len, out, L, B, KH, stream
    "dd_cache_append_floor": [_P] * 2 + [_I] * 3 + [_P],
    # x, w, n, stats, scratch, tok, img, topk, B, L, V, k, route, G, phases, stream
    "dd_vision_uncertainty": [_P] * 8 + [_I] * 7 + [_P],
    # dtype, q, k, v, key_mask, out, B, S, H, KH, D, scale, route, stream
    "dd_flash_prefill_attention": [_I] + [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    # x_dtype, out_f32, x, q4, s4, out, partial, R, D2, E, N, block_k, splits, route,
    # row_tile, stream
    "dd_int4_matmul": [_I] * 2 + [_P] * 5 + [_I] * 8 + [_P],
    # x, q4, words, R, D2, E, width, stages, mode, blocks, stream
    "dd_int4_stream_probe": [_P] * 3 + [_I] * 7 + [_P],
    # x, offsets, w_gate, w_up, w_down, h, y, A, D, I, E, stream
    "dd_moe_grouped": [_P] * 7 + [_I] * 4 + [_P],
}

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    """The ``*.cuh`` files the sources include; they name the library too."""
    return sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
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
    """Compile the sources unless a library for their hash exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = out.with_suffix(".log")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        jobs = [
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources(), objs)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cmd in jobs
        ]
        runs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in zip(jobs, procs)]
        if all(rc == 0 for _, _, rc in runs):
            lib = Path(tmp) / out.name
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            runs.append((cmd, proc.stdout, proc.returncode))
        log.write_text("".join(" ".join(cmd) + "\n" + text for cmd, text, _ in runs))
        failed = [run for run in runs if run[2] != 0]
        if failed:
            cmd, text, rc = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}; see {log}\n{text}")
        os.replace(lib, out)  # atomic: another process never loads a partial file
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
