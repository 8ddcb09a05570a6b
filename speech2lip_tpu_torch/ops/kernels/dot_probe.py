"""K8: the kernel-shaped dot probe (``csrc/dot_probe.cu``).

Replaces the Pallas kernel of ``tools/bench_int8_dot.py`` (``make``, the
``pallas_call`` at :44): t programs, each computing
out[t] = sum_g lhs @ rhs[g] for lhs [M, K] and rhs [G, K, N], in bfloat16
with float32 sums or in int8 with int32 sums.  It measures the tensor
cores' rate at the HCW conv's dot shapes in both types.  On the H100 both
run Hopper's mainloop: a TMA + mbarrier ring filled by one producer warp,
wgmma on two consumer warpgroups, persistent blocks; int8 first re-lays
rhs k-contiguous, since s8 wgmma takes B only that way.
``dot_probe_attrs`` reports the kernel's registers, local memory and
shared memory.
"""

from __future__ import annotations

import torch

from speech2lip_tpu_torch.ops.kernels import _build

# ``dot_probe`` calls that reached the card in this process; an int8 call
# launches two kernels, the re-layout of rhs and then the dot
launches = 0

_ACC = {torch.bfloat16: torch.float32, torch.int8: torch.int32}


def dot_probe_plain(lhs, rhs, t: int):
    """out [t, M, N], out[i] = sum_g lhs [M, K] @ rhs[g] ([G, K, N]), as
    PyTorch ops in float64, cast to float32 (bf16 inputs) or int32 (int8
    inputs).  For int8 both are exact while 128^2 * K * G < 2^31
    (K * G < 131072; the probe's is 6144), as the kernel's int32 sums
    are.  Every program of the TPU kernel computes the
    same tile, since its index maps are constant, so this computes [M, N]
    once and repeats it t times."""
    acc = (lhs.double() @ rhs.double()).sum(0)
    return acc.to(_ACC[lhs.dtype]).expand(t, *acc.shape).contiguous()


def dot_probe(lhs, rhs, t: int):
    """t programs of out[i] = sum_g lhs @ rhs[g]: lhs [M, K], rhs [G, K, N],
    both bfloat16 or both int8, contiguous.  Returns [t, M, N] float32 or
    int32.  On the card M must be a multiple of 128, N of 256 and K of
    256, in both types."""
    if lhs.device.type == "cpu":
        return dot_probe_plain(lhs, rhs, t)
    global launches
    if lhs.device.type != "cuda" or rhs.device != lhs.device:
        raise ValueError(f"dot_probe: lhs on {lhs.device}, rhs on "
                         f"{rhs.device}")
    if lhs.dtype not in _ACC or rhs.dtype != lhs.dtype:
        raise TypeError(f"dot_probe: dtypes {lhs.dtype}, {rhs.dtype}")
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[1] != lhs.shape[1]:
        raise ValueError("dot_probe: lhs [M, K] and rhs [G, K, N], got "
                         f"{tuple(lhs.shape)}, {tuple(rhs.shape)}")
    m, k = lhs.shape
    g, _, n = rhs.shape
    if m % 128 or n % 256 or k % 256 or not m or not n or not k or not g \
            or t < 1:
        raise ValueError(f"dot_probe: M {m}, N {n}, K {k} must be positive "
                         f"multiples of 128, 256, 256; G {g}, t {t} >= 1")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("dot_probe: inputs must be contiguous")
    out = torch.empty((t, m, n), dtype=_ACC[lhs.dtype], device=lhs.device)
    lib = _build.library()
    stream = _build.stream_ptr(lhs)
    if lhs.dtype == torch.int8:
        rhs_nk = torch.empty((g, n, k), dtype=torch.int8, device=lhs.device)
        err = lib.dot_probe_s8(lhs.data_ptr(), rhs.data_ptr(),
                               rhs_nk.data_ptr(), out.data_ptr(), m, k, n, g,
                               t, stream)
    else:
        err = lib.dot_probe_bf16(lhs.data_ptr(), rhs.data_ptr(),
                                 out.data_ptr(), m, k, n, g, t, stream)
    _build.check(err, "dot_probe")
    launches += 1
    return out


def dot_probe_attrs(dtype) -> dict:
    """Registers per thread, local-memory bytes per thread and shared-memory
    bytes per block of the dot kernel for dtype (bfloat16 or int8), from
    ``cudaFuncGetAttributes`` (builds the kernels; needs the CUDA
    runtime)."""
    if dtype not in _ACC:
        raise TypeError(f"dot_probe_attrs: dtype {dtype}")
    return _build.func_attrs("dot_probe_attrs", int(dtype == torch.int8))
