"""Build and load the port's CUDA kernels (``speech2lip_tpu_torch/csrc``).

All ``.cu`` sources compile with ``nvcc`` into one shared library with a
plain C interface under ``<repo>/build/torch_kernels/``, named by a hash of
the sources so an edited source rebuilds, and load through ``ctypes``.  The
build runs at the first kernel launch of a process; nothing here runs at
import.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every pointer and the stream as void*)
SIGNATURES = {
    # (uv, b0, bs, w_ptrs[host array], b_ptrs[host array], w_out, b_out,
    #  out, n, frames, depth, skip_layer, stream)
    "fused_mlp_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_mlp_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (src, grid, out, b, hs, ws, c, p, y_off, x_off, height, width, stream)
    "window_sample_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    "window_sample_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # (x, c0, lo, c1, hl, wl, w, scale, bias, out, pool_out,
    #  b, h, wd, cout, stream)
    "conv3x3_bn_relu_bf16": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _P],
    "conv3x3_bn_relu_f32": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _P],
}

_lib = None


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    if _lib is not None:
        return _lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libs2l_kernels_{_digest()}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = ([_nvcc()] + NVCC_FLAGS + ["-o", str(tmp)]
               + [str(s) for s in _sources() if s.suffix == ".cu"])
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
