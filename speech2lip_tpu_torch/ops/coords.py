"""Pixel-coordinate grid (counterpart of ``speech2lip_tpu/ops/coords.py``)."""

from __future__ import annotations

import torch


def _linspace01(num: int, dtype, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, num, dtype=dtype)`` rounded the way JAX rounds
    it: step = iota / (num - 1) in ``dtype``, then the exact endpoint.
    (``torch.linspace`` rounds differently in bf16.)"""
    if num == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    div = num - 1
    step = (torch.arange(div, dtype=torch.float32, device=device).to(dtype)
            / torch.tensor(div, dtype=dtype, device=device))
    one = torch.ones(1, dtype=dtype, device=device)
    return torch.cat([step, one])


def get_coords(width: int, height: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """[H*W, 2] grid of (u, v) in [0, 1]; u varies fastest along width.

    Built directly in ``dtype`` (as the renderer does) so a bf16 grid
    rounds the same way in both packages."""
    x = _linspace01(width, dtype, device)
    y = _linspace01(height, dtype, device)
    v, u = torch.meshgrid(y, x, indexing="ij")  # each [H, W]
    return torch.stack([u, v], dim=-1).reshape(-1, 2)
