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


def ensemble_coords(coords: torch.Tensor, width: int, height: int,
                    eps_shift: torch.Tensor):
    """The four shifted coordinate sets and blend weights of the LIIF
    local ensemble.

    coords [N, 2]; eps_shift: noise of any batch shape S (the train step
    passes one per frame), added to both axes.  Returns (shifted
    [*S, 4, N, 2] clamped to [0, 1], weights [*S, 4, N]); offsets in the
    order (-1,-1), (-1,+1), (+1,-1), (+1,+1), each weighted by the area of
    the opposite corner."""
    rx = 0.5 / width
    ry = 0.5 / height
    offsets = torch.tensor([[-rx, -ry], [-rx, ry], [rx, -ry], [rx, ry]],
                           dtype=coords.dtype, device=coords.device)
    eps = torch.as_tensor(eps_shift, dtype=coords.dtype,
                          device=coords.device)[..., None, None, None]
    shifted = torch.clamp(coords[None] + offsets[:, None] + eps, 0.0, 1.0)
    # areas against the unshifted coords, after clamping
    areas = ((shifted[..., 0] - coords[:, 0])
             * (shifted[..., 1] - coords[:, 1])).abs() + 1e-9
    tot = areas.sum(-2, keepdim=True)
    return shifted, areas.flip(-2) / tot
