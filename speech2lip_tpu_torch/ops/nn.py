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
    """w is [in, out].  Mixed dtypes promote as in JAX (a float32 input
    through bfloat16 weights computes in float32)."""
    w, b = params["w"], params["b"]
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w, b = x.to(dt), w.to(dt), b.to(dt)
    return x @ w + b


def conv2d(params, x, stride=1, padding=1):
    """x: [B, H, W, C]; kernel HWIO; ``stride`` an int or (sh, sw),
    symmetric zero ``padding`` an int or (ph, pw)."""
    w = params["w"].permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, params.get("b"), stride=stride,
                 padding=padding)
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


def batchnorm_train(params, state, x, momentum: float = 0.1,
                    eps: float = 1e-5):
    """Train-mode BatchNorm over the last axis, as torch's BatchNorm2d:
    normalises with the batch's biased variance and updates the running
    variance with the unbiased one.  Returns (y, new_state); the new state
    carries no gradient."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    var = x.var(dims, correction=0)
    with torch.no_grad():
        n = x.numel() // x.shape[-1]
        unbiased = var * n / max(n - 1, 1)
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean,
            "var": (1 - momentum) * state["var"] + momentum * unbiased}
    inv = torch.rsqrt(var + eps) * params["scale"]
    return (x - mean) * inv + params["bias"], new_state


def maxpool2d(x, window: int = 2, stride: int = 0):
    """NHWC max pool, VALID padding, stride = window unless given."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
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


def _resize_matrix(in_size: int, out_size: int, dtype, device=None):
    """[in, out] weights of ``jax.image.resize(..., "linear")`` along one
    axis: a triangle kernel widened by in/out when downscaling
    (antialiasing), columns normalised to sum 1, float32 then ``dtype``."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    w = torch.clamp_min(1.0 - (x / kernel_scale).abs(), 0.0)
    tot = w.sum(0, keepdim=True)
    eps32 = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(tot.abs() > eps32,
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(dtype)


def resize_linear(x, out_h: int, out_w: int):
    """NHWC resize as ``jax.image.resize(x, (B, out_h, out_w, C),
    "linear")`` computes it (antialiased when downscaling), in x's dtype;
    an axis whose size does not change is left alone."""
    _, h, w, _ = x.shape
    if h != out_h:
        x = torch.einsum("bhwc,ho->bowc", x,
                         _resize_matrix(h, out_h, x.dtype, x.device))
    if w != out_w:
        x = torch.einsum("bhwc,wo->bhoc", x,
                         _resize_matrix(w, out_w, x.dtype, x.device))
    return x


def leaky_relu(x, negative_slope: float = 0.02):
    return torch.where(x >= 0, x, negative_slope * x)


def relu(x):
    return torch.clamp_min(x, 0)
