"""K1: the fused lip-MLP trunk (``csrc/fused_mlp.cu``).

Replaces ``speech2lip_tpu/ops/pallas/fused_mlp.py:fused_mlp_batched`` (K1)
and ``fused_mlp`` (K1b, one frame): B frames over N shared uv embeddings
through the 8-layer MLP-v2 trunk, the per-frame audio/time features folded
into the entry and skip biases.  On the H100 the bf16 kernel keeps a
128-row tile's activations in shared memory across all layers, in the
swizzled panels ``wgmma`` reads, and streams the L2-resident weights
through a TMA ring: one producer warp, two ``wgmma`` consumer warpgroups,
persistent blocks.  It is bound by the tensor cores, then by that weight
stream.  The float32 kernel is 3xTF32 WMMA on 64-row tiles.
``fused_mlp_attrs`` reports either kernel's registers, local memory and
shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from speech2lip_tpu_torch.ops.kernels import _build

launches = 0  # kernel launches by ``fused_mlp`` in this process

UV_DIM = 42
WIDTH = 256


def fused_mlp_plain(uv, b0, bs, w_uv, w_skip, trunk_w, trunk_b, w_out, b_out,
                    skip_layer: int = 4):
    """The trunk as PyTorch ops: matmuls in uv's dtype, biases added in
    float32, activations rounded to uv's dtype after every layer.
    Returns [B, N, 3] float32."""
    dt = uv.dtype
    h = (uv @ w_uv + b0[:, None, :]).to(dt)                  # [B, N, W]
    h_skip = None
    for i, (w, b) in enumerate(zip(trunk_w, trunk_b)):
        h = torch.relu(h @ w + b).to(dt)
        if i == skip_layer:
            h_skip = (uv @ w_skip + bs[:, None, :]).to(dt)
            h = torch.cat([h_skip, h], dim=-1)
    return h @ w_out + b_out


def fused_mlp(uv, b0, bs, w_uv, w_skip, trunk_w, trunk_b, w_out, b_out,
              skip_layer: int = 4):
    """MLP trunk of B frames over shared uv embeddings.

    uv [N, 42] and the weights (w_uv/w_skip [42, 256], trunk_w[i]
    [256 or 512, 256], w_out [256, 3]) in one dtype (bfloat16 or float32);
    b0/bs [B, 256] = entry/skip bias + per-frame feature, trunk_b[i] [256]
    and b_out [3] in float32.  Returns [B, N, 3] float32.
    """
    args = (uv, b0, bs, w_uv, w_skip, trunk_w, trunk_b, w_out, b_out)
    if uv.device.type == "cpu":
        return fused_mlp_plain(*args, skip_layer=skip_layer)
    global launches
    if uv.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {uv.device}")
    dt = uv.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_mlp: dtype {dt} (bfloat16 or float32)")
    n = uv.shape[0]
    frames = b0.shape[0]
    depth = len(trunk_w)
    weights = [w_uv, w_skip] + list(trunk_w) + [w_out]
    floats = [b0, bs] + list(trunk_b) + [b_out]
    for t in weights + [uv]:
        if t.dtype != dt or t.device != uv.device or not t.is_contiguous():
            raise ValueError("fused_mlp: weights must be contiguous "
                             f"{dt} on {uv.device}")
    if any(t.data_ptr() % 16 for t in weights) or uv.data_ptr() % 4:
        raise ValueError("fused_mlp: weights must start 16-byte aligned, "
                         "uv 4-byte aligned")
    for t in floats:
        if (t.dtype != torch.float32 or t.device != uv.device
                or not t.is_contiguous()):
            raise ValueError("fused_mlp: biases must be contiguous float32 "
                             f"on {uv.device}")
    shapes_ok = (uv.shape == (n, UV_DIM)
                 and b0.shape == (frames, WIDTH) and bs.shape == (frames, WIDTH)
                 and w_uv.shape == (UV_DIM, WIDTH)
                 and w_skip.shape == (UV_DIM, WIDTH)
                 and w_out.shape == (WIDTH, 3) and b_out.shape == (3,)
                 and 0 <= skip_layer < depth - 1 and len(trunk_b) == depth
                 and all(b.shape == (WIDTH,) for b in trunk_b)
                 and all(w.shape == ((2 * WIDTH if i == skip_layer + 1
                                      else WIDTH), WIDTH)
                         for i, w in enumerate(trunk_w)))
    if not shapes_ok:
        raise ValueError("fused_mlp: unsupported shapes "
                         f"uv {tuple(uv.shape)} b0 {tuple(b0.shape)} "
                         f"trunk {[tuple(w.shape) for w in trunk_w]}")
    out = torch.empty((frames, n, 3), dtype=torch.float32, device=uv.device)
    lib = _build.library()
    fn = lib.fused_mlp_bf16 if dt == torch.bfloat16 else lib.fused_mlp_f32
    w_ptrs = (ctypes.c_void_p * (2 + depth))(
        *[t.data_ptr() for t in [w_uv, w_skip] + list(trunk_w)])
    b_ptrs = (ctypes.c_void_p * depth)(*[t.data_ptr() for t in trunk_b])
    err = fn(uv.data_ptr(), b0.data_ptr(), bs.data_ptr(), w_ptrs, b_ptrs,
             w_out.data_ptr(), b_out.data_ptr(), out.data_ptr(), n, frames,
             depth, skip_layer, _build.stream_ptr(uv))
    _build.check(err, "fused_mlp")
    launches += 1
    return out


def fused_mlp_attrs(dtype) -> dict:
    """Registers per thread, local-memory bytes per thread and shared-memory
    bytes per block of the K1 kernel for dtype (bfloat16 or float32), from
    ``cudaFuncGetAttributes`` (builds the kernels; needs the CUDA
    runtime)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_mlp_attrs: dtype {dtype}")
    return _build.func_attrs("fused_mlp_attrs", int(dtype == torch.bfloat16))
