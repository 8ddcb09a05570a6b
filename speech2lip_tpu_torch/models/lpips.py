"""LPIPS perceptual distance, AlexNet backbone v0.1 (counterpart of
``speech2lip_tpu/models/lpips.py``).

Per-channel input scaling -> AlexNet conv features at relu1..relu5 ->
channel unit-normalise -> squared difference -> 1x1 linear heads (no bias)
-> spatial mean -> sum over layers.  Parameters are the JAX package's tree
{"convs": [{w HWIO, b}] x5, "lins": [{w [1, 1, C, 1]}] x5}; images NHWC.
"""

from __future__ import annotations

import torch

from speech2lip_tpu_torch.ops import nn as tnn

# (out_ch, kernel, stride, padding) of the five AlexNet feature convs
ALEX_SPEC = [
    (64, (11, 11), (4, 4), 2),
    (192, (5, 5), (1, 1), 2),
    (384, (3, 3), (1, 1), 1),
    (256, (3, 3), (1, 1), 1),
    (256, (3, 3), (1, 1), 1),
]
_POOL_AFTER = {0, 1}  # 3x3 stride-2 max pool after relu1 and relu2
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _features(params, x):
    feats = []
    h = x
    for i, ((_, _, stride, pad), conv) in enumerate(zip(ALEX_SPEC,
                                                        params["convs"])):
        h = tnn.relu(tnn.conv2d(conv, h, stride=stride, padding=pad))
        if h.shape[1] == 0 or h.shape[2] == 0:
            raise ValueError(f"LPIPS input {tuple(x.shape)} too small: "
                             f"feature layer {i} is empty")
        feats.append(h)
        if i in _POOL_AFTER:
            h = tnn.maxpool2d(h, 3, 2)
    return feats


def _unit_normalize(x, eps: float = 1e-10):
    return x / (torch.sqrt((x * x).sum(-1, keepdim=True)) + eps)


def lpips_distance(params, x, y):
    """Perceptual distance [B] between two [B, H, W, 3] images in
    [-1, 1]."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    fx = _features(params, (x - shift) / scale)
    fy = _features(params, (y - shift) / scale)
    total = 0.0
    for f1, f2, lin in zip(fx, fy, params["lins"]):
        d = (_unit_normalize(f1) - _unit_normalize(f2)) ** 2
        total = total + tnn.conv2d(lin, d, padding=0).mean(dim=(1, 2, 3))
    return total
