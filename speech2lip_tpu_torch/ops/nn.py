"""Functional layers on tensors, in the JAX package's layouts.

Counterpart of ``speech2lip_tpu/ops/nn.py``: parameters are plain dicts of
tensors, activations NHWC / NLC, conv kernels HWIO / LIO, so the port's
tests compare like with like.  PyTorch's NCHW ops are reached through
permutes inside each function.
"""

from __future__ import annotations

import contextlib

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


def _same_padding(n: int, k: int, s: int, d: int):
    """XLA's ``padding="SAME"`` along one axis: (before, after), the odd
    pixel after."""
    total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def conv2d(params, x, stride=1, padding=1, dilation=1, band=None):
    """x: [B, H, W, C]; kernel HWIO; ``stride`` and ``dilation`` an int or
    (sh, sw).  ``padding``: symmetric zero padding as an int or (ph, pw),
    per side as ((top, bottom), (left, right)), or ``"SAME"`` as XLA pads
    it (uneven where a stride needs it).

    ``band`` (``parallel.mesh.Band``): x is this rank's band of the
    frame's rows, and a 3x3 conv with padding 1 reads one row of each
    neighbouring band (``parallel.mesh.halo_rows``): zero rows stand at
    the frame's top and bottom only."""
    if band is not None:
        from speech2lip_tpu_torch.parallel.mesh import halo_rows
        if (params["w"].shape[:2] != (3, 3) or padding != 1 or stride != 1
                or dilation != 1):
            raise ValueError("a band runs 3x3 convs of stride 1 and "
                             "padding 1 only")
        x, padding = halo_rows(x, band), ((0, 0), (1, 1))
    w = params["w"].permute(3, 2, 0, 1)
    st = (stride, stride) if isinstance(stride, int) else tuple(stride)
    dl = (dilation, dilation) if isinstance(dilation, int) else tuple(dilation)
    if isinstance(padding, str):
        if padding != "SAME":
            raise ValueError(f"unsupported padding {padding!r}")
        padding = tuple(_same_padding(n, k, s, d) for n, k, s, d in zip(
            x.shape[1:3], params["w"].shape[:2], st, dl))
    xc = x.permute(0, 3, 1, 2)
    if isinstance(padding, (tuple, list)) and not isinstance(padding[0], int):
        (pt, pb), (pl, pr) = padding
        if pt == pb and pl == pr:
            padding = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
            padding = 0
    y = F.conv2d(xc, w, params.get("b"), stride=st, padding=padding,
                 dilation=dl)
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


def _global_moments(x, dims, mesh, axis, n):
    """(mean, biased variance) of ``x`` over ``dims`` and over the ranks
    of ``axis``, whose rows number ``n`` in all: an all-reduced sum over
    n, then an all-reduced sum of squared deviations (two passes: E[x^2] -
    mean^2 cancels in float32).  Sums in float32, both differentiable."""
    from speech2lip_tpu_torch.parallel.mesh import all_sum
    xf = x.float()
    mean = all_sum(xf.sum(dims), mesh, axis) / n
    var = all_sum(((xf - mean) ** 2).sum(dims), mesh, axis) / n
    return mean.to(x.dtype), var.to(x.dtype)


def batchnorm_train(params, state, x, momentum: float = 0.1,
                    eps: float = 1e-5, band=None):
    """Train-mode BatchNorm over the last axis, as torch's BatchNorm2d:
    normalises with the batch's biased variance and updates the running
    variance with the unbiased one.  Returns (y, new_state); the new state
    carries no gradient.

    Inside a ``parallel.mesh.on_mesh`` block the batch is the global one,
    as under the JAX package's SPMD mesh: the statistics and the unbiased
    correction's count are taken over the rows of every data index, so
    every rank keeps the same running state.  With ``band`` (x [B, h, W,
    C] is this rank's band of a frame's rows) they are taken over every
    rank's band, on both axes, and the count sums the bands' rows."""
    from speech2lip_tpu_torch.parallel.mesh import (ALL, DATA, active,
                                                    axis_size)
    dims = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    mesh = active()
    if band is not None:
        n = n // x.shape[1] * band.height * band.mesh.data
        mean, var = _global_moments(x, dims, band.mesh, ALL, n)
    elif axis_size(mesh, DATA) > 1:
        n *= mesh.data
        mean, var = _global_moments(x, dims, mesh, DATA, n)
    else:
        mean = x.mean(dims)
        var = x.var(dims, correction=0)
    with torch.no_grad():
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


def upsample_bilinear(x, out_h: int, out_w: int, band=None):
    """NHWC bilinear resize, align_corners=True, as two interpolation
    matmuls in x's dtype (the JAX package's formulation).

    ``band`` (``parallel.mesh.Band``): x is this rank's band of the
    frame's rows, the output is its band of twice the rows, and output
    row i reads the input through the frame's mapping i (h - 1) / (H - 1):
    at H = 2h that reaches one row past each band edge and no further
    (checked), so one halo row each side (``parallel.mesh.halo_rows``)
    carries it."""
    _, h, w, _ = x.shape
    mw = _align_corners_matrix(out_w, w, x.dtype, x.device)
    if band is None:
        mh = _align_corners_matrix(out_h, h, x.dtype, x.device)
    else:
        from speech2lip_tpu_torch.parallel.mesh import halo_rows
        mh = _band_matrix(out_h, band.height, band.start, band.stop).to(
            x.device, x.dtype)
        x = halo_rows(x, band)
    y = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("pw,bowc->bopc", mw, y)


def _band_matrix(out_h: int, in_h: int, start: int, stop: int):
    """Rows [2 start, 2 stop) of the frame's align-corners matrix [out_h,
    in_h], over the input rows [start - 1, stop] (a zero column where that
    leaves the frame); float32.  Raises where a row reads further."""
    if out_h != 2 * in_h:
        raise ValueError(f"a band upsamples by 2 exactly, not {in_h} -> "
                         f"{out_h} rows")
    full = F.pad(_align_corners_matrix(out_h, in_h, torch.float32),
                 (1, 1))[2 * start:2 * stop]
    if bool(full[:, :start].any() or full[:, stop + 2:].any()):
        raise ValueError(f"output rows [{2 * start}, {2 * stop}) read input "
                         f"rows beyond one halo row of [{start}, {stop})")
    return full[:, start:stop + 2]


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


@contextlib.contextmanager
def full_float32():
    """Float32 convolutions and matmuls inside the block run without TF32
    (cuDNN and cuBLAS), as the CPU computes them; the previous settings are
    restored after it."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


# cuDNN's candidates a tuned conv times, its own pick first (H100, the May
# train step's 28 conv shapes): torch's default 10 adds ~13 s to the first
# step; 4 adds ~1.3 s for the same device time an iteration, repeated
# from process to process; 2 left that time varying by ~2%
TUNED_CANDIDATES = 4


@contextlib.contextmanager
def tuned_float32():
    """``full_float32``, with cuDNN timing its algorithms for each conv
    shape and direction on the shape's first call and keeping the fastest
    for the process (``torch.backends.cudnn.benchmark``): for a loop that
    repeats fixed shapes, as a train step does.  It times the first
    ``TUNED_CANDIDATES`` of cuDNN's heuristic order, whose own pick is
    among them.  The previous settings are restored after the block.  The
    process keeps one algorithm a conv shape, whichever call ran the shape
    first: a shape first run outside the block keeps its untimed pick in
    it, and a shape timed in it keeps the timed pick for later callers."""
    cudnn = torch.backends.cudnn
    prev = (cudnn.benchmark, cudnn.benchmark_limit)
    cudnn.benchmark, cudnn.benchmark_limit = True, TUNED_CANDIDATES
    try:
        with full_float32():
            yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = prev
