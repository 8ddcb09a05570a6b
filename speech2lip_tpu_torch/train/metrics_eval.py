"""Offline evaluation metrics: PSNR, SSIM, CPBD, LMD and the SyncNet
confidence (counterpart of ``speech2lip_tpu/train/metrics_eval.py``).

Functions on tensors, batched over frames: each runs on the device its
inputs lie on and computes in float64 (the SyncNet embeddings in float32,
as the JAX package takes them).  Images are [N, H, W] or [N, H, W, C] on
[0, 255]; a per-frame metric returns [N].
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_F64 = torch.float64


def psnr(original: torch.Tensor, contrast: torch.Tensor,
         pixel_max: float = 255.0) -> torch.Tensor:
    """PSNR of each frame, 100 where the frames are equal."""
    diff = original.to(_F64) - contrast.to(_F64)
    mse = (diff ** 2).flatten(1).mean(1)
    val = 20 * torch.log10(pixel_max / torch.sqrt(mse))
    return torch.where(mse == 0, torch.full_like(mse, 100.0), val)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None
                     ) -> torch.Tensor:
    ax = torch.arange(size, dtype=_F64, device=device) - size // 2
    k = torch.exp(-(ax ** 2) / (2 * sigma ** 2))
    k2 = torch.outer(k, k)
    return k2 / k2.sum()


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 255.0,
         k1: float = 0.01, k2: float = 0.02) -> torch.Tensor:
    """Mean SSIM of each frame: 11x1.5 Gaussian windows over the valid
    region, per channel, then averaged over the channels."""
    x, y = img1.to(_F64), img2.to(_F64)
    if x.dim() == 3:
        x, y = x[..., None], y[..., None]
    n, h, w, c = x.shape
    # every channel of every frame as one image of a batch
    x = x.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    y = y.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    kern = _gaussian_kernel(device=x.device)[None, None]
    filt = lambda t: F.conv2d(t, kern)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1, mu2 = filt(x), filt(y)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(x * x) - mu1_sq
    s2 = filt(y * y) - mu2_sq
    s12 = filt(x * y) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)
                / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return ssim_map.flatten(1).mean(1).reshape(n, c).mean(1)


def cpbd(image: torch.Tensor) -> torch.Tensor:
    """Cumulative Probability of Blur Detection (Narvekar & Karam 2009) of
    each frame, in [0, 1], higher = sharper.  A 3-channel frame is made
    gray with BT.601's weights in channel order 0, 1, 2 (a BGR frame, as
    the JAX CLI passes it, swaps the red and blue weights).  64x64 blocks,
    gradient-magnitude edges, JNB widths, beta 3.6; the ratio is taken
    over the widths of all the frame's edge blocks together."""
    if image.dim() == 4:
        image = (0.299 * image[..., 0] + 0.587 * image[..., 1]
                 + 0.114 * image[..., 2])
    image = image.to(_F64)
    n, h, w = image.shape
    block, beta = 64, 3.6

    gx = torch.zeros_like(image)
    gx[:, :, 1:-1] = (image[:, :, 2:] - image[:, :, :-2]) / 2
    gy = torch.zeros_like(image)
    gy[:, 1:-1, :] = (image[:, 2:, :] - image[:, :-2, :]) / 2
    mag = torch.hypot(gx, gy)
    edge = mag > (0.1 * mag.flatten(1).max(1).values[:, None, None] + 1e-12)
    widths = _edge_widths(image, edge)

    nby, nbx = h // block, w // block
    if nby == 0 or nbx == 0:
        return torch.zeros(n, dtype=_F64, device=image.device)

    def blocks(t):   # [N, nby * nbx, block * block]
        t = t[:, :nby * block, :nbx * block]
        t = t.reshape(n, nby, block, nbx, block).permute(0, 1, 3, 2, 4)
        return t.reshape(n, nby * nbx, block * block)

    wb, ib = blocks(widths), blocks(image)
    has = wb > 0
    count = has.sum(-1)
    keep = count >= 0.002 * block * block        # an edge block
    contrast = ib.max(-1).values - ib.min(-1).values
    w_jnb = torch.where(contrast <= 50, 5.0, 3.0).to(_F64)
    pblur = 1 - torch.exp(-torch.abs(wb / w_jnb[..., None]) ** beta)
    sharp = ((pblur <= 0.63) & has & keep[..., None]).sum((1, 2))
    total = (count * keep).sum(1)
    return torch.where(total > 0, sharp.to(_F64) / total.clamp_min(1),
                       torch.zeros((), dtype=_F64, device=image.device))


def _edge_widths(image: torch.Tensor, edge: torch.Tensor,
                 max_width: int = 16) -> torch.Tensor:
    """Horizontal JNB edge width of each edge pixel of [N, H, W] frames:
    pixels to the local extrema on each side along the row, walking at most
    ``max_width``.  The JAX package's prefix/suffix scans, as ``cummax`` /
    ``cummin`` over the rows of every frame at once."""
    n, h, w = image.shape
    widths = torch.zeros_like(image, dtype=_F64)
    if w < 2:
        return widths
    dev = image.device
    idx = torch.arange(w, device=dev).expand(n, h, w)
    inf = w + max_width + 10
    d = image[:, :, 1:] - image[:, :, :-1]       # d[..., j] = row[j+1]-row[j]
    ones = torch.ones((n, h, 1), dtype=torch.bool, device=dev)

    # hi side: the first j >= x that stops the forward walk
    stop_flat = torch.cat([d.abs() <= 1e-9, ones], dim=2)
    sc = torch.zeros((n, h, w), dtype=torch.bool, device=dev)
    if w >= 3:
        sc[:, :, 1:w - 1] = d[:, :, 1:] * d[:, :, :-1] < 0
    big = torch.full_like(idx, inf)
    a = torch.where(stop_flat, idx, big)
    b = torch.where(sc, idx, big)
    suffix_min = lambda t: torch.cummin(t.flip(2), dim=2).values.flip(2)
    a_suf, b_suf = suffix_min(a), suffix_min(b)
    b_next = torch.cat([b_suf[:, :, 1:], big[:, :, :1]], dim=2)
    hi = torch.minimum(torch.minimum(a_suf, b_next), idx + max_width)

    # lo side: the last j <= x that stops the backward walk
    e = torch.cat([torch.zeros((n, h, 1), dtype=d.dtype, device=dev), -d],
                  dim=2)
    flat2 = e.abs() <= 1e-9
    flat2[:, :, 0] = True
    stop_zero = flat2 | sc
    stop_pos = stop_zero | (e < 0)
    stop_neg = stop_zero | (e > 0)
    minus = torch.full_like(idx, -1)
    prefix_max = lambda stop: torch.cummax(torch.where(stop, idx, minus),
                                           dim=2).values
    p_zero, p_pos, p_neg = (prefix_max(stop_zero), prefix_max(stop_pos),
                            prefix_max(stop_neg))
    s = -torch.cat([d, torch.zeros((n, h, 1), dtype=d.dtype, device=dev)],
                   dim=2)
    lo = torch.where(s > 0, p_pos, torch.where(s < 0, p_neg, p_zero))
    lo = torch.maximum(lo, idx - max_width)

    return torch.where(edge, (hi - lo).to(_F64), widths)


def lmd(lms_pred: torch.Tensor, lms_gt: torch.Tensor,
        mouth_only: bool = True) -> torch.Tensor:
    """Landmark distance: the mean L2 distance between the (mouth)
    landmarks of [N, 68, 2] sets."""
    p, g = lms_pred.to(_F64), lms_gt.to(_F64)
    if mouth_only:
        p, g = p[:, 48:, :], g[:, 48:, :]
    return torch.linalg.vector_norm(p - g, dim=-1).mean()


def embed(params, state, mels: torch.Tensor, frame_windows: torch.Tensor,
          chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """SyncNet embeddings (audio, face) [T, 512] of mel windows [T, 80, 16]
    and face windows [T, 48, 96, 15], ``chunk`` windows at a time on the
    parameters' device (BatchNorm in eval mode, so chunks change
    nothing)."""
    from speech2lip_tpu_torch.models import syncnet
    dev = params["face"][0]["conv"]["w"].device
    a_out, v_out = [], []
    with torch.no_grad():
        for i in range(0, len(mels), chunk):
            m = mels[i:i + chunk].to(dev, torch.float32)[..., None]
            f = frame_windows[i:i + chunk].to(dev, torch.float32)
            a, v = syncnet.apply(params, state, m, f)
            a_out.append(a)
            v_out.append(v)
    return torch.cat(a_out), torch.cat(v_out)


def sync_confidence(params, state, mels: torch.Tensor,
                    frame_windows: torch.Tensor, max_offset: int = 15,
                    chunk: int = 64) -> Tuple[float, int]:
    """SyncNet-style AV confidence: for each audio offset in
    [-max_offset, max_offset] the mean cosine of the face windows with the
    shifted audio windows; returns (best mean - mean of the means, best
    offset).  An offset with no overlap scores -1, as in the JAX package."""
    a_emb, v_emb = embed(params, state, mels, frame_windows, chunk)
    t = len(a_emb)
    means = []
    for off in range(-max_offset, max_offset + 1):
        lo, hi = max(0, -off), min(t, t - off)
        if hi - lo < 1:
            means.append(-1.0)
            continue
        cos = (v_emb[lo:hi] * a_emb[lo + off:hi + off]).sum(1)
        means.append(float(cos.double().mean()))
    means_t = torch.tensor(means, dtype=_F64)
    best = int(torch.argmax(means_t))
    return float(means_t[best] - means_t.mean()), best - max_offset
