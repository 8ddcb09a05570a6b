"""Bilinear sampling (counterpart of ``speech2lip_tpu/ops/grid_sample.py``).

Semantics are torch's ``grid_sample`` with ``align_corners=False``; images
are NHWC and grids carry (x, y) in [-1, 1] in the last axis.  Everything
here is plain autograd-differentiable PyTorch.
"""

from __future__ import annotations

import torch


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``img`` [B, H, W, C] at ``grid`` [B, Hg, Wg, 2], bilinear,
    ``zeros`` or ``border`` padding.  Returns [B, Hg, Wg, C]."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    b, h, w, c = img.shape
    ix = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = (ix - x0)[..., None].to(img.dtype)
    wy = (iy - y0)[..., None].to(img.dtype)
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(b, h * w, c)

    def gather(yi, xi):
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        vals = vals.reshape(*yi.shape, c)
        if padding_mode == "border":
            return vals
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        return vals * valid[..., None].to(img.dtype)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def grid_sample_onehot(src: torch.Tensor, grid: torch.Tensor, y_off: int,
                       x_off: int, height: int, width: int) -> torch.Tensor:
    """Bilinear sample of a crop ``src`` [B, Hs, Ws, C] =
    image[y_off:, x_off:] at ``grid`` [B, P, 2] normalised to the full
    (height, width) image, as two one-hot contractions.

    Returns [B, P, C], equal to ``grid_sample(full_image, grid)`` wherever
    all four bilinear neighbours fall inside the crop; elsewhere the
    neighbour indices are clamped to the crop edge (values callers mask)."""
    b, hs, ws, c = src.shape
    ix = ((grid[..., 0] + 1.0) * width - 1.0) * 0.5 - x_off
    iy = ((grid[..., 1] + 1.0) * height - 1.0) * 0.5 - y_off
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = (ix - x0)[..., None]
    wy = (iy - y0)[..., None]
    x0 = x0.long().clamp(0, ws - 2)
    y0 = y0.long().clamp(0, hs - 2)

    # weights and sums in float32 (the grid's dtype), result in src's
    rows = torch.arange(hs, device=src.device)
    onehot_y = ((rows == y0[..., None]) * (1.0 - wy)
                + (rows == y0[..., None] + 1) * wy)
    g = torch.einsum("bph,bhk->bpk", onehot_y,
                     src.reshape(b, hs, ws * c).float()).reshape(b, -1, ws, c)
    cols = torch.arange(ws, device=src.device)
    onehot_x = ((cols == x0[..., None]) * (1.0 - wx)
                + (cols == x0[..., None] + 1) * wx)
    return torch.einsum("bpw,bpwc->bpc", onehot_x, g).to(src.dtype)


def grid_sample_onehot_border(src: torch.Tensor,
                              grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``src`` [B, H, W, C] at ``grid`` [B, P, 2] with
    exact ``border`` padding for every grid value: the coordinate is
    clamped to [0, size - 1], floored into [0, size - 2], and the rows and
    columns are picked by one-hot contractions.  Returns [B, P, C]."""
    b, h, w, c = src.shape
    ix = torch.clamp(((grid[..., 0] + 1.0) * w - 1.0) * 0.5, 0.0, w - 1.0)
    iy = torch.clamp(((grid[..., 1] + 1.0) * h - 1.0) * 0.5, 0.0, h - 1.0)
    x0 = torch.floor(ix).long().clamp(0, w - 2)
    y0 = torch.floor(iy).long().clamp(0, h - 2)
    wx = (ix - x0.to(ix.dtype))[..., None]
    wy = (iy - y0.to(iy.dtype))[..., None]
    rows = torch.arange(h, device=src.device)
    onehot_y = ((rows == y0[..., None]) * (1.0 - wy)
                + (rows == y0[..., None] + 1) * wy)
    g = torch.einsum("bph,bhk->bpk", onehot_y,
                     src.reshape(b, h, w * c).float()).reshape(b, -1, w, c)
    cols = torch.arange(w, device=src.device)
    onehot_x = ((cols == x0[..., None]) * (1.0 - wx)
                + (cols == x0[..., None] + 1) * wx)
    return torch.einsum("bpw,bpwc->bpc", onehot_x, g).to(src.dtype)


def warp_box_mask(grid: torch.Tensor, box, height: int, width: int,
                  binarize: bool = True) -> torch.Tensor:
    """Closed-form bilinear sample of the indicator of the half-open pixel
    rectangle ``box`` = (x0, x1, y0, y1) at ``grid`` [..., 2].

    Returns [..., 1]: the binarized (!= 0 -> 1) coverage if ``binarize``,
    else the exact bilinear value."""
    x0b, x1b, y0b, y1b = box
    x_lo, x_hi = max(int(x0b), 0), min(int(x1b), width) - 1
    y_lo, y_hi = max(int(y0b), 0), min(int(y1b), height) - 1
    ix = ((grid[..., 0] + 1.0) * width - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * height - 1.0) * 0.5
    fx = torch.floor(ix)
    fy = torch.floor(iy)
    wx = ix - fx
    wy = iy - fy

    def cov(f, wt, lo, hi):
        in0 = ((f >= lo) & (f <= hi)).to(grid.dtype)
        in1 = ((f + 1 >= lo) & (f + 1 <= hi)).to(grid.dtype)
        return in0 * (1.0 - wt) + in1 * wt

    val = cov(fx, wx, x_lo, x_hi) * cov(fy, wy, y_lo, y_hi)
    if binarize:
        val = (val != 0).to(grid.dtype)
    return val[..., None]
