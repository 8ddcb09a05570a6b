"""Training losses (counterpart of ``speech2lip_tpu/train/losses.py``).

Randomness enters as explicit tensors: the black-hole mask is made from a
normal draw the caller passes in (``train_step.draw_noise``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from speech2lip_tpu_torch.models import lpips as lpips_mod


def photometric_loss(pred, target, mask: Optional[torch.Tensor] = None,
                     weight: float = 1.0):
    """(Masked) MSE.

    Inside a ``parallel.mesh.on_mesh`` block of D > 1 data indices the
    masked loss is the JAX step's ratio over the global batch, sum(err) /
    (sum(mask) + 1e-6) with both sums over the data axis, on the
    rank-mean scale: each rank returns D * its own numerator over the
    global denominator (summed with no gradient; the mask is data), so
    the mean of the ranks' values, and of their gradients, is the global
    ratio's.  The pixel ranks of a data index compute the term whole and
    alike, so the sum leaves them out.  The plain mean needs nothing:
    over equal per-rank batches the mean of the ranks' means is the
    global mean.  The other terms of the step (LPIPS, the sync loss's
    BCE) are such means too."""
    if mask is not None:
        from speech2lip_tpu_torch.parallel.mesh import (DATA, active,
                                                        sum_no_grad)
        err = (pred - target) ** 2 * mask
        mesh = active()
        if mesh is None:
            return weight * err.sum() / (mask.sum() + 1e-6)
        den = sum_no_grad(mask.sum(), mesh, DATA)
        return weight * mesh.data * err.sum() / (den + 1e-6)
    return weight * ((pred - target) ** 2).mean()


def perceptual_loss(lpips_params, pred, target, weight: float = 1.0):
    """LPIPS on [0, 1] images, mapped to [-1, 1]."""
    x = (pred - 0.5) * 2.0
    y = (target - 0.5) * 2.0
    return weight * lpips_mod.lpips_distance(lpips_params, x, y).mean()


def black_hole_noise(normal: torch.Tensor) -> torch.Tensor:
    """Binary speckle mask from a standard-normal draw: normal >= 1e-6
    (about half holes), float32."""
    return (normal >= 1e-6).float()


def cosine_bce_loss(a, v, y):
    """BCE on the cosine similarity of L2-normalised embedding pairs
    a, v [B, D] against labels y [B]."""
    d = torch.clamp((a * v).sum(-1), 1e-7, 1.0 - 1e-7)
    return -(y * torch.log(d) + (1.0 - y) * torch.log(1.0 - d)).mean()


def sync_window_to_syncnet_input(rgb_window):
    """[B, T=5, 96, 96, 3] RGB crops -> [B, 48, 96, 15] SyncNet face input:
    RGB to BGR, the lower half of the rows, frames stacked along channels
    frame-major."""
    g = rgb_window.flip(-1)
    g = g[:, :, g.shape[2] // 2:]
    b, t, h, w, c = g.shape
    return g.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)


def psnr_from_mse(mse):
    return -10.0 * torch.log(mse) / math.log(10.0)
