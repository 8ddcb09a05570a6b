"""Positional encodings (counterpart of ``speech2lip_tpu/ops/embedders.py``)."""

from __future__ import annotations

import math

import torch


def fourier_embed(x: torch.Tensor, multires: int,
                  include_input: bool = True) -> torch.Tensor:
    """NeRF encoding [..., D] -> [..., D*(1 + 2*multires)]:
    [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...], each term spanning all D
    input dims before the next term starts."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    parts = [x] if include_input else []
    for i in range(multires):
        parts.append(torch.sin(x * freqs[i]))
        parts.append(torch.cos(x * freqs[i]))
    return torch.cat(parts, dim=-1)


def time_embed(position: torch.Tensor, out_dims: int = 20) -> torch.Tensor:
    """Transformer sin/cos embedding of frame indices, sin/cos interleaved.

    position: [B] (or scalar) -> [B, out_dims] (or [out_dims]), float32.
    """
    position = torch.as_tensor(position, dtype=torch.float32)
    div_term = torch.exp(
        torch.arange(0, out_dims, 2, dtype=torch.float32,
                     device=position.device)
        * (-(math.log(10000.0) / out_dims)))
    arg = position[..., None] * div_term
    pe = torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1)
    return pe.reshape(*position.shape, out_dims)
