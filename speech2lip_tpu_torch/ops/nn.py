"""Functional layers on tensors, in the JAX package's layouts.

Counterpart of ``speech2lip_tpu/ops/nn.py``: parameters are plain dicts of
tensors, activations NHWC / NLC, conv kernels HWIO / LIO, so the port's
tests compare like with like.  PyTorch's NCHW ops are reached through
permutes inside each function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(params, x):
    """w is [in, out]."""
    return x @ params["w"] + params["b"]


def conv2d(params, x, padding: int = 1):
    """x: [B, H, W, C]; kernel HWIO; stride 1, symmetric zero padding."""
    w = params["w"].permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, params.get("b"), padding=padding)
    return y.permute(0, 2, 3, 1)


def conv1d(params, x, stride: int = 1, padding: int = 0):
    """x: [B, L, C]; kernel LIO."""
    w = params["w"].permute(2, 1, 0)
    y = F.conv1d(x.permute(0, 2, 1), w, params.get("b"), stride=stride,
                 padding=padding)
    return y.permute(0, 2, 1)


def batchnorm(params, state, x, eps: float = 1e-5):
    """Eval-mode BatchNorm over the last (channel) axis."""
    inv = torch.rsqrt(state["var"] + eps) * params["scale"]
    return (x - state["mean"]) * inv + params["bias"]


def maxpool2d(x, window: int = 2):
    """NHWC max pool, VALID padding, stride = window."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, window)
    return y.permute(0, 2, 3, 1)


def _align_corners_matrix(out_size: int, in_size: int, dtype, device=None):
    """[out, in] bilinear interpolation matrix with align_corners=True."""
    if in_size == 1:
        return torch.ones((out_size, 1), dtype=dtype, device=device)
    pos = (torch.arange(out_size, dtype=torch.float32, device=device)
           * (in_size - 1) / (out_size - 1))
    lo = torch.clamp(torch.floor(pos).long(), 0, in_size - 2)
    w_hi = pos - lo
    m = torch.zeros((out_size, in_size), dtype=torch.float32, device=device)
    rows = torch.arange(out_size, device=device)
    m.index_put_((rows, lo), 1.0 - w_hi, accumulate=True)
    m.index_put_((rows, lo + 1), w_hi, accumulate=True)
    return m.to(dtype)


def upsample_bilinear(x, out_h: int, out_w: int):
    """NHWC bilinear resize, align_corners=True, as two interpolation
    matmuls in x's dtype (the JAX package's formulation)."""
    _, h, w, _ = x.shape
    mh = _align_corners_matrix(out_h, h, x.dtype, x.device)
    mw = _align_corners_matrix(out_w, w, x.dtype, x.device)
    y = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("pw,bowc->bopc", mw, y)


def leaky_relu(x, negative_slope: float = 0.02):
    return torch.where(x >= 0, x, negative_slope * x)


def relu(x):
    return torch.clamp_min(x, 0)
