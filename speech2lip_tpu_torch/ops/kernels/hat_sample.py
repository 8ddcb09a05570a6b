"""K7: the differentiable bilinear crop sampler (``csrc/hat_sample.cu``).

Replaces ``speech2lip_tpu/ops/pallas/hat_sample.py:hat_sample``, whose
custom VJP runs K2 (``window_sample``) forward and two Pallas kernels
backward, ``_dsrc`` and ``_dgrid``.  Here a ``torch.autograd.Function``
runs K2 forward and the two CUDA backward kernels, each only when its
cotangent is needed: the train step's window gather samples at a data
grid (dsrc only), its depth-loss points sample a data image (dgrid only).
The TPU kernels wrote both as dense hat-weight matmuls.  On the H100 a
thread per point scatters its four taps into a zeroed float32 buffer with
atomics (dsrc, cast to the source's dtype after) or gathers them (dgrid).
Both read the grid ([B, P, 2] or a [B, wh, ww, 2] window view) and the
cotangent in place and pass their arguments as one packed block, as K2
does.  The derivative follows the JAX convention hat'(u) = -sign(u) on
|u| < 1, so a coordinate that is exactly an integer gets 0 for that
component; the plain versions below compute the same thing and are a
custom backward, not autograd through ``window_sample_plain``.
"""

from __future__ import annotations

import struct

import torch

from speech2lip_tpu_torch.ops.kernels import _build
from speech2lip_tpu_torch.ops.kernels.window_sample import (
    grid_layout, window_sample, window_sample_plain)

dsrc_launches = 0   # ``hat_sample_dsrc`` calls that reached the card
dgrid_launches = 0  # kernel launches by ``hat_sample_dgrid`` in this process

# device launches of one ``hat_sample_dsrc`` call by dtype: the float32
# buffer's zero-fill, the scatter kernel, and in bfloat16 the cast
DSRC_DEVICE_LAUNCHES = {torch.bfloat16: 3, torch.float32: 2}

# the C entries' one block of arguments (``Args`` in csrc/hat_sample.cu):
# src, grid, g, out pointers; src batch / row strides; grid batch / row /
# point strides; g batch / point / channel strides; b, hs, ws, c, p, gw;
# y_off, x_off, height, width
_N_ARGS = 22
_ARGS = struct.Struct(f"<{_N_ARGS}q")


def _taps(grid, hs: int, ws: int, y_off: int, x_off: int, height: int,
          width: int):
    """The four taps of each point: (flat index [B, P], row weight, column
    weight, column derivative, row derivative, in-crop mask) per tap, all
    float32, coordinates rounded as the kernels round them."""
    g = grid.float()
    ix = (g[..., 0] + 1.0) * (width * 0.5) - (0.5 + x_off)
    iy = (g[..., 1] + 1.0) * (height * 0.5) - (0.5 + y_off)
    fx = torch.floor(ix)
    fy = torch.floor(iy)
    wx1 = ix - fx
    wy1 = iy - fy
    dx = (wx1 != 0).float()
    dy = (wy1 != 0).float()
    x0 = fx.long()
    y0 = fy.long()
    out = []
    for yi, wy, ddy in ((y0, 1.0 - wy1, -dy), (y0 + 1, wy1, dy)):
        for xi, wx, ddx in ((x0, 1.0 - wx1, -dx), (x0 + 1, wx1, dx)):
            ok = ((xi >= 0) & (xi < ws) & (yi >= 0) & (yi < hs)).float()
            idx = yi.clamp(0, hs - 1) * ws + xi.clamp(0, ws - 1)
            out.append((idx, wy, wx, ddx, ddy, ok))
    return out


def hat_sample_dsrc_plain(grid, g, hs: int, ws: int, y_off: int, x_off: int,
                          height: int, width: int):
    """dL/dsrc as PyTorch ops: the hat-weighted scatter of the cotangent
    g [B, P, C] (grid [B, P, 2] or [B, wh, ww, 2]) onto a zeroed float32
    [B, Hs, Ws, C] source, returned in g's dtype (the source's)."""
    b, _, c = g.shape
    grid = grid.reshape(b, -1, 2)
    gf = g.float()
    out = torch.zeros(b, hs * ws, c, dtype=torch.float32, device=g.device)
    for idx, wy, wx, _, _, ok in _taps(grid, hs, ws, y_off, x_off, height,
                                       width):
        val = (wy[..., None] * gf) * (wx * ok)[..., None]
        out.scatter_add_(1, idx[..., None].expand(-1, -1, c), val)
    return out.reshape(b, hs, ws, c).to(g.dtype)


def hat_sample_dgrid_plain(src, grid, g, y_off: int, x_off: int,
                           height: int, width: int):
    """dL/dgrid [B, P, 2] float32 as PyTorch ops (grid [B, P, 2] or
    [B, wh, ww, 2]): the four taps blended with hat-derivative weights,
    chained by width/2 and height/2."""
    b, hs, ws, c = src.shape
    grid = grid.reshape(b, -1, 2)
    flat = src.reshape(b, hs * ws, c).float()
    gf = g.float()
    dix = torch.zeros(grid.shape[:2], dtype=torch.float32, device=g.device)
    diy = torch.zeros_like(dix)
    for idx, wy, wx, ddx, ddy, ok in _taps(grid, hs, ws, y_off, x_off,
                                           height, width):
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        gv = (gf * v).sum(-1) * ok
        dix = dix + gv * wy * ddx
        diy = diy + gv * wx * ddy
    return torch.stack([dix * (width * 0.5), diy * (height * 0.5)], dim=-1)


def _layout(name, grid, g, b: int, c: int, device: int):
    """The grid's (p, gw, batch, row, point stride) for cotangent g
    [B, P, C] on the same device; raises on anything else."""
    layout = grid_layout(grid, b, device)
    if (layout is None or g.dim() != 3
            or tuple(g.shape) != (b, layout[0], c)
            or g.get_device() != device):
        raise ValueError(f"{name}: grid must be float32 [B, P, 2] or "
                         "[B, wh, ww, 2] with coordinate stride 1 and g "
                         f"[B, P, {c}] on one device, got grid {grid.dtype} "
                         f"{tuple(grid.shape)} strides {grid.stride()} on "
                         f"{grid.device}, g {tuple(g.shape)} on {g.device}")
    return layout


def hat_sample_dsrc(grid, g, hs: int, ws: int, y_off: int, x_off: int,
                    height: int, width: int):
    """dL/dsrc [B, Hs, Ws, C] in g's dtype of the crop sample at grid
    [B, P, 2] or [B, wh, ww, 2] for cotangent g [B, P, C].  CPU tensors run
    the plain version; CUDA tensors launch the kernel, which reads grid
    and g in place (coordinate stride 1, any other strides) and adds into
    a zeroed float32 buffer, cast to g's dtype after."""
    if not g.is_cuda:
        if g.device.type == "cpu":
            return hat_sample_dsrc_plain(grid, g, hs, ws, y_off, x_off,
                                         height, width)
        raise ValueError(f"hat_sample_dsrc: unsupported device {g.device}")
    global dsrc_launches
    dtype = g.dtype
    if dtype is torch.bfloat16:
        fn = _build.library().hat_sample_dsrc_bf16
    elif dtype is torch.float32:
        fn = _build.library().hat_sample_dsrc_f32
    else:
        raise TypeError(f"hat_sample_dsrc: dtype {dtype} (bfloat16 or "
                        "float32, the source's)")
    shape = g.shape
    b, c = shape[0], shape[-1]
    p, gw, gb, gr, gp = _layout("hat_sample_dsrc", grid, g, b, c,
                                g.get_device())
    acc = g.new_zeros((b, hs, ws, c), dtype=torch.float32)
    sb, sp, sc = g.stride()
    err = fn(_ARGS.pack(0, grid.data_ptr(), g.data_ptr(), acc.data_ptr(),
                        0, 0, gb, gr, gp, sb, sp, sc, b, hs, ws, c, p, gw,
                        y_off, x_off, height, width),
             _N_ARGS, _build.stream_ptr(g))
    _build.check(err, "hat_sample_dsrc")
    dsrc_launches += 1
    return acc.to(dtype)


def hat_sample_dgrid(src, grid, g, y_off: int, x_off: int, height: int,
                     width: int):
    """dL/dgrid [B, P, 2] float32 of the crop sample of src [B, Hs, Ws, C]
    at grid [B, P, 2] or [B, wh, ww, 2] for cotangent g [B, P, C] in src's
    dtype.  CPU tensors run the plain version; CUDA tensors launch the
    kernel, which reads all three in place (src: channel stride 1, pixel
    stride C; grid: coordinate stride 1)."""
    if not src.is_cuda:
        if src.device.type == "cpu":
            return hat_sample_dgrid_plain(src, grid, g, y_off, x_off,
                                          height, width)
        raise ValueError(f"hat_sample_dgrid: unsupported device "
                         f"{src.device}")
    global dgrid_launches
    dtype = src.dtype
    if dtype is torch.bfloat16:
        fn = _build.library().hat_sample_dgrid_bf16
    elif dtype is torch.float32:
        fn = _build.library().hat_sample_dgrid_f32
    else:
        raise TypeError(f"hat_sample_dgrid: dtype {dtype}")
    if g.dtype is not dtype:
        raise TypeError(f"hat_sample_dgrid: g {g.dtype}, src {dtype}")
    b, hs, ws, c = src.shape
    p, gw, gb, gr, gp = _layout("hat_sample_dgrid", grid, g, b, c,
                                src.get_device())
    sb, sr, spx, sch = src.stride()
    if sch != 1 or spx != c:
        raise ValueError("hat_sample_dgrid: src needs channel stride 1 and "
                         f"pixel stride C, got {src.stride()}")
    out = grid.new_empty((b, p, 2))
    sgb, sgp, sgc = g.stride()
    err = fn(_ARGS.pack(src.data_ptr(), grid.data_ptr(), g.data_ptr(),
                        out.data_ptr(), sb, sr, gb, gr, gp, sgb, sgp, sgc,
                        b, hs, ws, c, p, gw, y_off, x_off, height, width),
             _N_ARGS, _build.stream_ptr(src))
    _build.check(err, "hat_sample_dgrid")
    dgrid_launches += 1
    return out


def attrs(which: str, bf16: bool) -> dict:
    """Registers, local-memory bytes per thread and static shared bytes
    per block of one K7 kernel instance, ``which`` "dsrc" or "dgrid"
    (builds the kernels, needs the CUDA runtime)."""
    return _build.func_attrs("hat_sample_attrs",
                             ("dsrc", "dgrid").index(which), int(bf16))


class _HatSample(torch.autograd.Function):
    """K2 forward, K7 backward; ``kernels=False`` runs the plain versions
    on any device (the plain path a card run compares against)."""

    @staticmethod
    def forward(ctx, src, grid, y_off, x_off, height, width, kernels):
        # K2 and the backward kernels read src, grid and the cotangent in
        # place: no copy on either side
        ctx.save_for_backward(src, grid)
        ctx.geom = (y_off, x_off, height, width)
        ctx.kernels = kernels
        fwd = window_sample if kernels else window_sample_plain
        return fwd(src, grid, y_off, x_off, height, width)

    @staticmethod
    def backward(ctx, g):
        src, grid = ctx.saved_tensors
        y_off, x_off, height, width = ctx.geom
        dsrc = dgrid = None
        if ctx.needs_input_grad[0]:
            fn = hat_sample_dsrc if ctx.kernels else hat_sample_dsrc_plain
            dsrc = fn(grid, g, src.shape[1], src.shape[2], y_off, x_off,
                      height, width)
        if ctx.needs_input_grad[1]:
            fn = hat_sample_dgrid if ctx.kernels else hat_sample_dgrid_plain
            dgrid = fn(src, grid, g, y_off, x_off, height,
                       width).reshape(grid.shape).to(grid.dtype)
        return dsrc, dgrid, None, None, None, None, None


def border_clamp(grid, hs: int, ws: int, y_off: int, x_off: int,
                 height: int, width: int):
    """grid [..., 2] clamped to the pixel range of the crop [Hs, Ws] at
    (y_off, x_off) of a (height, width) image, in normalised coordinates:
    the sample then equals ``grid_sample(..., "border")`` of the crop."""
    lo_x = (2.0 * x_off + 1.0) / width - 1.0
    hi_x = (2.0 * (x_off + ws - 1) + 1.0) / width - 1.0
    lo_y = (2.0 * y_off + 1.0) / height - 1.0
    hi_y = (2.0 * (y_off + hs - 1) + 1.0) / height - 1.0
    return torch.stack([grid[..., 0].clamp(lo_x, hi_x),
                        grid[..., 1].clamp(lo_y, hi_y)], dim=-1)


def hat_sample(src, grid, y_off: int = 0, x_off: int = 0, height=None,
               width=None, border: bool = False, kernels: bool = True):
    """Differentiable bilinear sample of the crop src [B, Hs, Ws, C] =
    image[y_off:, x_off:] at grid [B, P, 2] or [B, wh, ww, 2] float32 ((x,
    y) in [-1, 1] of the full (height, width) image, default the crop's own
    size, align_corners=False; a window view of a larger grid is read in
    place).  ``border`` clamps the grid to the crop's pixel
    range first, outside the Function, so the clamp's zero gradient rides
    autograd; otherwise footprints outside the crop read zeros.  Returns
    [B, P, C] in src's dtype (P = wh * ww for a 4-D grid)."""
    _, hs, ws, _ = src.shape
    height = hs if height is None else height
    width = ws if width is None else width
    if border:
        grid = border_clamp(grid, hs, ws, y_off, x_off, height, width)
    return _HatSample.apply(src, grid, int(y_off), int(x_off), int(height),
                            int(width), kernels)
