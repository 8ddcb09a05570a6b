"""K2: windowed bilinear sampling (``csrc/window_sample.cu``).

Replaces ``speech2lip_tpu/ops/pallas/window_sample.py:window_sample``: a
bilinear sample of a source crop at P points whose grid is normalised to
the full image, with hat-function weights, so a footprint outside the
crop reads zeros.  The TPU kernel's one-hot matmuls worked around slow
gathers; on the H100 one thread per point gathers its four taps, and the
kernel is bound by the latency of those gathers.
"""

from __future__ import annotations

import torch

from speech2lip_tpu_torch.ops.kernels import _build

launches = 0  # kernel launches by ``window_sample`` in this process


def window_sample_plain(src, grid, y_off: int, x_off: int, height: int,
                        width: int):
    """Zero-outside-the-crop bilinear sample as PyTorch ops.

    src [B, Hs, Ws, C]; grid [B, P, 2].  Returns [B, P, C] in src.dtype."""
    b, hs, ws, c = src.shape
    g = grid.float()  # crop-local coordinates, as the kernel rounds them
    ix = (g[..., 0] + 1.0) * (width * 0.5) - (0.5 + x_off)
    iy = (g[..., 1] + 1.0) * (height * 0.5) - (0.5 + y_off)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx1 = ix - x0
    wy1 = iy - y0
    x0 = x0.long()
    y0 = y0.long()
    flat = src.reshape(b, hs * ws, c).float()

    def tap(yi, xi, wt):
        ok = (xi >= 0) & (xi < ws) & (yi >= 0) & (yi < hs)
        idx = (yi.clamp(0, hs - 1) * ws + xi.clamp(0, ws - 1))
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * (wt * ok)[..., None]

    top = tap(y0, x0, 1.0 - wx1) + tap(y0, x0 + 1, wx1)
    bot = tap(y0 + 1, x0, 1.0 - wx1) + tap(y0 + 1, x0 + 1, wx1)
    out = (1.0 - wy1)[..., None] * top + wy1[..., None] * bot
    return out.to(src.dtype)


def window_sample(src, grid, y_off: int, x_off: int, height: int,
                  width: int):
    """Bilinear-sample the crop src [B, Hs, Ws, C] = image[y_off:, x_off:]
    at grid [B, P, 2] ((x, y) in [-1, 1] of the full (height, width)
    image, align_corners=False).  Returns [B, P, C] in src.dtype."""
    if src.device.type == "cpu":
        return window_sample_plain(src, grid, y_off, x_off, height, width)
    global launches
    if src.device.type != "cuda":
        raise ValueError(f"window_sample: unsupported device {src.device}")
    if src.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"window_sample: dtype {src.dtype}")
    b, hs, ws, c = src.shape
    if (grid.dim() != 3 or grid.shape[0] != b or grid.shape[2] != 2
            or grid.dtype != torch.float32 or grid.device != src.device):
        raise ValueError("window_sample: grid must be float32 [B, P, 2] on "
                         f"{src.device}, got {grid.dtype} {tuple(grid.shape)}")
    if not (src.is_contiguous() and grid.is_contiguous()):
        raise ValueError("window_sample: inputs must be contiguous")
    p = grid.shape[1]
    out = torch.empty((b, p, c), dtype=src.dtype, device=src.device)
    lib = _build.library()
    fn = (lib.window_sample_bf16 if src.dtype == torch.bfloat16
          else lib.window_sample_f32)
    err = fn(src.data_ptr(), grid.data_ptr(), out.data_ptr(), b, hs, ws, c,
             p, int(y_off), int(x_off), int(height), int(width),
             _build.stream_ptr(src))
    _build.check(err, "window_sample")
    launches += 1
    return out
