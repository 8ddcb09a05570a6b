"""Build and load the port's CUDA kernels (``speech2lip_tpu_torch/csrc``).

Each ``.cu`` source compiles with its own ``nvcc`` process, all started
together, and the objects link into one shared library with a plain C
interface under ``<repo>/build/torch_kernels/``, named by a hash of the
sources so an edited source rebuilds, and loaded through ``ctypes``.  The
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_B = ctypes.c_char_p  # a bytes block of packed arguments
# C entry points: name -> argtypes (every pointer and the stream as void*,
# out-parameters as int*)
SIGNATURES = {
    # (uv, b0, bs, w_ptrs[host array], b_ptrs[host array], w_out, b_out,
    #  out, n, frames, depth, skip_layer, stream)
    "fused_mlp_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_mlp_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (bf16, regs*, local_bytes*, smem_bytes*): the K1 kernel's
    # cudaFuncGetAttributes
    "fused_mlp_attrs": [_I, _IP, _IP, _IP],
    # (args: the packed int64 words of window_sample.cu's Args, their
    #  count, stream)
    "window_sample_bf16": [_B, _I, _P],
    "window_sample_f32": [_B, _I, _P],
    # (x, c0, lo, c1, hl, wl, w, scale, bias, out, pool_out,
    #  b, h, wd, cout, stream)
    "conv3x3_bn_relu_bf16": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _P],
    "conv3x3_bn_relu_f32": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _P],
    # (x, w, scale, bias, out, b, h, wd, cin, cout, relu, stream)
    "conv3x3_affine_bf16": [_P] * 5 + [_I] * 6 + [_P],
    "conv3x3_affine_f32": [_P] * 5 + [_I] * 6 + [_P],
    # (bf16, cout, regs*, local_bytes*, smem_bytes*): one conv3x3 (K3/K4/K6)
    # instance's cudaFuncGetAttributes
    "conv3x3_attrs": [_I, _I, _IP, _IP, _IP],
    # (x, w1, scale1, bias1, w2, scale2, bias2, out, b, h, wd, cin, cmid,
    #  cout, stream)
    "double_conv_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "double_conv_f32": [_P] * 8 + [_I] * 6 + [_P],
    # (bf16, cmid, cout, regs*, local_bytes*, smem_bytes*): one K5
    # instance's cudaFuncGetAttributes
    "double_conv_attrs": [_I, _I, _I, _IP, _IP, _IP],
    # (args: the packed int64 words of hat_sample.cu's Args, their count,
    #  stream)
    "hat_sample_dsrc_bf16": [_B, _I, _P],
    "hat_sample_dsrc_f32": [_B, _I, _P],
    "hat_sample_dgrid_bf16": [_B, _I, _P],
    "hat_sample_dgrid_f32": [_B, _I, _P],
    # (which: 0 dsrc, 1 dgrid; bf16, regs*, local_bytes*, smem_bytes*): one
    #  K7 instance's cudaFuncGetAttributes
    "hat_sample_attrs": [_I, _I, _IP, _IP, _IP],
    # (lhs, rhs, out, m, k, n, g, t, stream)
    "dot_probe_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (lhs, rhs, rhs_nk scratch, out, m, k, n, g, t, stream)
    "dot_probe_s8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (s8, regs*, local_bytes*, smem_bytes*): the K8 dot kernel's
    # cudaFuncGetAttributes
    "dot_probe_attrs": [_I, _IP, _IP, _IP],
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


def _run(cmds):
    """Run the commands in parallel; raise with the output of every one
    that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile(so: Path) -> None:
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = []
    cmds = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        cmds.append([nvcc] + NVCC_FLAGS + ["-c", "-o", str(obj), str(src)])
    try:
        _run(cmds)
        tmp = so.with_suffix(f".{tag}")
        _run([[nvcc] + ARCH + ["-shared", "-o", str(tmp)]
              + [str(o) for o in objs]])
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    if _lib is not None:
        return _lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libs2l_kernels_{_digest()}.so"
    if not so.exists():
        _compile(so)
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


def func_attrs(name: str, *args) -> dict:
    """Registers per thread, local-memory bytes per thread and shared-memory
    bytes per block of one kernel instance, from the C entry ``name`` (a
    ``cudaFuncGetAttributes`` behind ``*_attrs(args..., int*, int*, int*)``;
    builds the kernels, needs the CUDA runtime)."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    check(getattr(library(), name)(*args, *(ctypes.byref(v) for v in vals)),
          name)
    return dict(zip(("regs", "local_bytes", "smem_bytes"),
                    (v.value for v in vals)))


_raw_stream = None


def stream_ptr(t) -> int:
    """The raw handle of PyTorch's current stream on t's device (the
    capturing stream inside a CUDA graph capture), by the getter of a CUDA
    build of torch: it makes no Stream object, a fraction of the cost of
    ``torch.cuda.current_stream(...).cuda_stream``."""
    global _raw_stream
    if _raw_stream is None:
        import torch
        _raw_stream = torch._C._cuda_getCurrentRawStream
    return _raw_stream(t.get_device())
