"""K2: windowed bilinear sampling (``csrc/window_sample.cu``).

Replaces ``speech2lip_tpu/ops/pallas/window_sample.py:window_sample``: a
bilinear sample of a source crop at P points whose grid is normalised to
the full image, with hat-function weights, so a footprint outside the
crop reads zeros.  The TPU kernel's one-hot matmuls worked around slow
gathers; on the H100 a thread gathers the four taps of four consecutive
points, and the kernel is bound by the latency of those gathers and by
its launch.  The wrapper reads a crop view of a larger frame and a window
view of a larger grid in place, so the composite copies neither, and
passes its arguments as one packed block: the host's dispatch is most of
a call at May geometry.
"""

from __future__ import annotations

import struct

import torch

from speech2lip_tpu_torch.ops.kernels import _build

launches = 0  # kernel launches by ``window_sample`` in this process

# the C entry's one block of arguments (``Args`` in csrc/window_sample.cu):
# src, grid, out pointers; src batch / row strides; grid batch / row /
# point strides; b, hs, ws, c, p, gw; y_off, x_off, height, width
_N_ARGS = 18
_ARGS = struct.Struct(f"<{_N_ARGS}q")


def grid_layout(grid, b: int, device: int):
    """(p, gw, batch stride, row stride, point stride) of a float32 grid
    [B, P, 2] or [B, wh, ww, 2] (P = wh * ww points in rows of gw) whose
    two coordinates are adjacent, on CUDA device ``device``; None for any
    other grid.  K2 and K7 read such a grid in place."""
    shape = grid.shape
    if len(shape) == 4:
        gb, gr, gp, gc = grid.stride()
        gw = shape[2]
        p = shape[1] * gw
    elif len(shape) == 3:
        gb, gp, gc = grid.stride()
        gw = p = shape[1]
        gr = p * gp
    else:
        return None
    if (gc != 1 or shape[0] != b or shape[-1] != 2
            or grid.dtype is not torch.float32
            or grid.get_device() != device):
        return None
    return p, gw, gb, gr, gp


def window_sample_plain(src, grid, y_off: int, x_off: int, height: int,
                        width: int):
    """Zero-outside-the-crop bilinear sample as PyTorch ops.

    src [B, Hs, Ws, C]; grid [B, P, 2] or [B, wh, ww, 2], views of any
    strides.  Returns [B, P, C] in src.dtype."""
    b, hs, ws, c = src.shape
    # crop-local coordinates, as the kernel rounds them
    g = grid.float().reshape(b, -1, 2)
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
    at grid [B, P, 2] or [B, wh, ww, 2] ((x, y) in [-1, 1] of the full
    (height, width) image, align_corners=False).  Returns [B, P, C] in
    src.dtype, P = wh * ww for a 4-D grid.

    On the card both are read in place: src may be a view of a larger
    frame (channel stride 1, pixel stride C, any row and batch stride) and
    grid a window of a larger grid (the two coordinates adjacent, any
    point, row and batch stride).  Anything else raises."""
    # the common case first and each attribute read once: the checks are a
    # fair share of a call at May geometry
    if not src.is_cuda:
        if src.device.type == "cpu":
            return window_sample_plain(src, grid, y_off, x_off, height, width)
        raise ValueError(f"window_sample: unsupported device {src.device}")
    global launches
    dtype = src.dtype
    if dtype is torch.bfloat16:
        fn = _build.library().window_sample_bf16
    elif dtype is torch.float32:
        fn = _build.library().window_sample_f32
    else:
        raise TypeError(f"window_sample: dtype {dtype}")
    b, hs, ws, c = src.shape
    layout = grid_layout(grid, b, src.get_device())
    if layout is None:
        raise ValueError("window_sample: grid must be float32 [B, P, 2] or "
                         f"[B, wh, ww, 2] with coordinate stride 1 on "
                         f"{src.device}, got {grid.dtype} "
                         f"{tuple(grid.shape)} strides {grid.stride()} on "
                         f"{grid.device}")
    p, gw, gb, gr, gp = layout
    sb, sr, sp, sc = src.stride()
    if sc != 1 or sp != c:
        raise ValueError("window_sample: src needs channel stride 1 and "
                         f"pixel stride C, got {src.stride()}")
    out = src.new_empty((b, p, c))
    err = fn(_ARGS.pack(src.data_ptr(), grid.data_ptr(), out.data_ptr(),
                        sb, sr, gb, gr, gp, b, hs, ws, c, p, gw, y_off, x_off,
                        height, width), _N_ARGS, _build.stream_ptr(src))
    _build.check(err, "window_sample")
    launches += 1
    return out
