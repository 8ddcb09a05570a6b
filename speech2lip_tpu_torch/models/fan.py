"""2D-FAN face-alignment network, the 68-landmark detector (counterpart of
``speech2lip_tpu/models/fan.py``).

A conv stem and ``n_modules`` stacked depth-4 hourglasses of 3-branch
residual ConvBlocks, emitting 68 heatmaps at 64x64 per module; landmarks
decode as the first-index argmax plus face_alignment's quarter-pixel step
toward the larger neighbour.  Eval-mode BatchNorm (eps 1e-5), NHWC
activations, the JAX package's parameter tree (``weights.fan_from_jax``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from speech2lip_tpu_torch.ops import nn as tnn

N_LANDMARKS = 68
N_MODULES = 4
HG_DEPTH = 4
HG_FEATS = 256


def _bn_relu_conv(params, state, x, padding):
    x = tnn.relu(tnn.batchnorm(params["bn"], state["bn"], x))
    return tnn.conv2d(params["conv"], x, padding=padding)


def _conv_block(params, state, x):
    """Three chained BN-ReLU-convs (out/2, out/4, out/4 channels),
    concatenated, plus the input or its BN-ReLU-1x1 projection."""
    y1 = _bn_relu_conv(params["b1"], state["b1"], x, 1)
    y2 = _bn_relu_conv(params["b2"], state["b2"], y1, 1)
    y3 = _bn_relu_conv(params["b3"], state["b3"], y2, 1)
    out = torch.cat([y1, y2, y3], dim=-1)
    if "down" in params:
        r = tnn.batchnorm(params["down"]["bn"], state["down"]["bn"], x)
        r = tnn.conv2d(params["down"]["conv"], tnn.relu(r), padding=0)
    else:
        r = x
    return out + r


def _hourglass(params, state, x, depth):
    def recurse(level, inp):
        up1 = _conv_block(params[f"up1_{level}"], state[f"up1_{level}"], inp)
        low = tnn.maxpool2d(inp, 2)
        low = _conv_block(params[f"low1_{level}"], state[f"low1_{level}"],
                          low)
        if level > 1:
            low = recurse(level - 1, low)
        else:
            low = _conv_block(params["low2_1"], state["low2_1"], low)
        low = _conv_block(params[f"low3_{level}"], state[f"low3_{level}"],
                          low)
        up2 = low.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return up1 + up2
    return recurse(depth, x)


def apply(params, state, x: torch.Tensor) -> List[torch.Tensor]:
    """x: [B, 256, 256, 3] in [0, 1] -> one [B, 64, 64, 68] heatmap per
    hourglass module (the last is the prediction)."""
    y = tnn.conv2d(params["conv1"], x, stride=2, padding=3)
    y = tnn.relu(tnn.batchnorm(params["bn1"], state["bn1"], y))
    y = _conv_block(params["conv2"], state["conv2"], y)
    y = F.avg_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    y = _conv_block(params["conv3"], state["conv3"], y)
    y = _conv_block(params["conv4"], state["conv4"], y)

    outputs = []
    prev = y
    n = len(params["hg"])
    for m in range(n):
        hg = _hourglass(params["hg"][m], state["hg"][m], prev, HG_DEPTH)
        ll = _conv_block(params["top"][m], state["top"][m], hg)
        ll = tnn.conv2d(params["conv_last"][m], ll, padding=0)
        ll = tnn.relu(tnn.batchnorm(params["bn_end"][m], state["bn_end"][m],
                                    ll))
        hm = tnn.conv2d(params["pred"][m], ll, padding=0)
        outputs.append(hm)
        if m < n - 1:
            prev = (prev + tnn.conv2d(params["bl"][m], ll, padding=0)
                    + tnn.conv2d(params["al"][m], hm, padding=0))
    return outputs


def decode_heatmaps(heatmaps: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 68] heatmaps -> [B, 68, 2] (x, y) in heatmap pixels, the
    first maximum moved a quarter pixel toward its larger neighbour."""
    b, h, w, n = heatmaps.shape
    hm = heatmaps.permute(0, 3, 1, 2).reshape(b, n, h * w)
    idx = torch.argmax(hm, dim=-1)
    ys, xs = idx // w, idx % w

    def at(y, x):
        return torch.gather(hm, 2, (y * w + x)[..., None])[..., 0]

    dx = (at(ys, torch.clamp(xs + 1, 0, w - 1))
          - at(ys, torch.clamp(xs - 1, 0, w - 1)))
    dy = (at(torch.clamp(ys + 1, 0, h - 1), xs)
          - at(torch.clamp(ys - 1, 0, h - 1), xs))
    return torch.stack([xs.float() + 0.25 * torch.sign(dx),
                        ys.float() + 0.25 * torch.sign(dy)], dim=-1)
