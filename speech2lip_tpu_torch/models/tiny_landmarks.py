"""Tiny 68-point landmark regressor, LMD's detector (counterpart of
``speech2lip_tpu/models/tiny_landmarks.py``).

Four conv3x3 stride-2 + ReLU layers (16/32/64/96 channels) on a 96² RGB
input in [0, 1], then FC 3456 -> 256 -> 136: landmarks (x, y) in pixels of
the 96² input.  The trained weights are the repository's
``models/tiny_landmarks.ckpt`` (keys ``conv0/w`` ... ``fc2/b``, HWIO
convs).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict

import torch
import torch.nn.functional as F

from speech2lip_tpu_torch.ops import nn as tnn

SIZE = 96
N_LMS = 68
_CH = (16, 32, 64, 96)
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "models", "tiny_landmarks.ckpt")


def _shapes() -> Dict[str, tuple]:
    """{checkpoint key: shape} of the net's parameters."""
    out, cin = {}, 3
    for i, cout in enumerate(_CH):
        out[f"conv{i}/w"], out[f"conv{i}/b"] = (3, 3, cin, cout), (cout,)
        cin = cout
    feat = (SIZE // 16) ** 2 * _CH[-1]
    out.update({"fc1/w": (feat, 256), "fc1/b": (256,),
                "fc2/w": (256, N_LMS * 2), "fc2/b": (N_LMS * 2,)})
    return out


def load(path: str = CKPT, device="cpu") -> Dict[str, Any]:
    """The parameters in ``path`` as float32 tensors on ``device``; raises
    when a key is missing or a shape differs."""
    from speech2lip_tpu_torch.core import checkpoint as ckpt
    flat, _ = ckpt.load(path)
    params: Dict[str, Any] = {}
    for key, shape in _shapes().items():
        if key not in flat or tuple(flat[key].shape) != shape:
            raise ValueError(f"{path}: {key} missing or not of shape {shape}")
        layer, leaf = key.split("/")
        params.setdefault(layer, {})[leaf] = torch.from_numpy(
            flat[key]).to(device=device, dtype=torch.float32)
    return params


def _same_pad(n: int, k: int = 3, s: int = 2):
    """XLA's ``padding="SAME"`` along one axis: the odd pixel goes after,
    so a stride-2 conv on an even size pads (0, 1)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def apply(params: Dict[str, Any], imgs: torch.Tensor) -> torch.Tensor:
    """imgs [B, 96, 96, 3] in [0, 1] RGB -> [B, 68, 2] pixel coordinates
    (x, y) in the 96² input."""
    x = imgs - 0.5
    for i in range(len(_CH)):
        (ht, hb), (wl, wr) = _same_pad(x.shape[1]), _same_pad(x.shape[2])
        x = F.pad(x, (0, 0, wl, wr, ht, hb))
        x = tnn.relu(tnn.conv2d(params[f"conv{i}"], x, stride=2, padding=0))
    x = x.reshape(x.shape[0], -1)            # NHWC flattened, as the JAX net
    x = tnn.relu(tnn.linear(params["fc1"], x))
    out = tnn.linear(params["fc2"], x)
    return out.reshape(-1, N_LMS, 2) * SIZE


def detect(params: Dict[str, Any], frames: torch.Tensor) -> torch.Tensor:
    """frames [B, H, W, 3] in [0, 1] RGB, any size -> [B, 68, 2] landmarks
    in frame pixels, through the 96² net input (``jax.image.resize``'s
    linear resize, antialiased when it shrinks)."""
    h, w = frames.shape[1:3]
    lms = apply(params, tnn.resize_linear(frames, SIZE, SIZE))
    return lms * torch.tensor([w / SIZE, h / SIZE], dtype=torch.float32,
                              device=lms.device)
