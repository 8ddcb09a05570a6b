"""Forward (splat) warping with a z-resolve (counterpart of
``speech2lip_tpu/ops/splat.py``).

Nearest-target scatter with a min-z collision resolve over a flattened
target with one overflow bucket at index h*w for out-of-range targets:
``scatter_reduce_`` 'amin' of z into an ``inf`` z-buffer, then 'amax' of
the winners' values (losers give 0) into a zero buffer.  Both reductions
ignore the order of their inputs, so the result is the same on the card
as on the CPU.  Off the serving hot path: pose editing and depth splats.
"""

from __future__ import annotations

from typing import Optional

import torch


def _flat_targets(tx, ty, h: int, w: int):
    """(flat target index with the overflow bucket h*w, in-range mask)."""
    valid = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    return torch.where(valid, ty * w + tx, h * w), valid


def forward_splat_nearest(src: torch.Tensor, flow: torch.Tensor,
                          z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Splat each source pixel to round(p + flow[p]).

    src [B, H, W, C]; flow [B, H, W, 2] (dx, dy) pixel displacements; z
    [B, H, W] depth for the collision resolve (the smallest z wins; a tie
    keeps every winner and the largest value of theirs); without z the
    lowest source index wins.  Rounds half to even.  Returns [B, H, W, C];
    pixels no source hits are 0."""
    b, h, w, c = src.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
    tx = torch.round(xs + flow[..., 0]).long()
    ty = torch.round(ys + flow[..., 1]).long()
    idx, valid = _flat_targets(tx, ty, h, w)
    idx = idx.reshape(b, -1)
    if z is None:
        z = torch.arange(h * w, dtype=torch.float32,
                         device=src.device).reshape(1, h, w).expand(b, h, w)
    z = torch.where(valid, z, torch.inf).reshape(b, -1)
    zbuf = torch.full((b, h * w + 1), torch.inf, dtype=z.dtype,
                      device=z.device).scatter_reduce_(1, idx, z, "amin")
    won = z == zbuf.gather(1, idx)
    vals = torch.where(won[..., None], src.reshape(b, -1, c),
                       torch.zeros((), dtype=src.dtype, device=src.device))
    out = torch.zeros((b, h * w + 1, c), dtype=src.dtype, device=src.device)
    out.scatter_reduce_(1, idx[..., None].expand(-1, -1, c), vals, "amax")
    return out[:, :h * w].reshape(b, h, w, c)


def splat_depth(points_xy: torch.Tensor, z: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    """Splat a point set's depth (points_xy [N, 2] pixels, z [N], only
    z > 0 counts) into a min-z [H, W] buffer; pixels no point hits are
    0."""
    x = torch.round(points_xy[:, 0]).long()
    y = torch.round(points_xy[:, 1]).long()
    idx, valid = _flat_targets(x, y, height, width)
    valid = valid & (z > 0)
    idx = torch.where(valid, idx, height * width)
    zv = torch.where(valid, z, torch.inf)
    zbuf = torch.full((height * width + 1,), torch.inf, dtype=zv.dtype,
                      device=zv.device).scatter_reduce_(0, idx, zv, "amin")
    zbuf = torch.where(torch.isfinite(zbuf), zbuf, 0.0)
    return zbuf[:height * width].reshape(height, width)
