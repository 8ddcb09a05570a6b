"""DSFD dual-shot face detector, ResNet-152 variant (counterpart of
``speech2lip_tpu/models/dsfd.py``).

The detector the reference builds for STEP1's face boxes: a ResNet-152
backbone, a product-merge low-level FPN over the four stages, a Feature
Enhance Module (three dilated-conv branches) on each of the six sources,
and SSD heads with a max-out background on the stride-4 level; the second
shot only, as at inference.  Outputs (x1, y1, x2, y2, confidence) rows.
``depths`` comes from the tree (``len`` of each stage's block list), so a
shallow test backbone runs the same code.  The parameter tree is the JAX
package's (``weights.dsfd_from_jax``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from speech2lip_tpu_torch.models.s3fd import decode_anchors, nms
from speech2lip_tpu_torch.ops import nn as tnn

RESNET152_DEPTHS = (3, 8, 36, 3)
STAGE_CH = (256, 512, 1024, 2048)       # bottleneck out channels C2..C5
_STEPS = (4, 8, 16, 32, 64, 128)        # anchor strides of the 6 sources
_SIZES = (16, 32, 64, 128, 256, 512)
FEM_CH = 512
SOURCE_CH = (256, 512, 1024, 2048, 512, 256)
# (name, cin, cmid, cout) of the two stages past C5
EXTRA = (("layer5", 2048, 512, 512), ("layer6", 512, 128, 256))
# (name, cin, cout) of the FPN's 1x1 convs
FPN = (("lat3", 2048, 1024), ("lat2", 1024, 512), ("lat1", 512, 256),
       ("smooth3", 1024, 1024), ("smooth2", 512, 512),
       ("smooth1", 256, 256))
# RGB mean subtraction (std 1)
_MEAN = (123.0, 117.0, 104.0)


def _cbr(params, state, x, stride=1, padding=0):
    x = tnn.conv2d(params["conv"], x, stride=stride, padding=padding)
    return tnn.relu(tnn.batchnorm(params["bn"], state["bn"], x))


def _bottleneck(params, state, x, stride):
    r = _cbr(params["c1"], state["c1"], x)
    r = _cbr(params["c2"], state["c2"], r, stride=stride, padding=1)
    r = tnn.conv2d(params["c3"]["conv"], r, padding="SAME")
    r = tnn.batchnorm(params["c3"]["bn"], state["c3"]["bn"], r)
    if "down" in params:
        x = tnn.conv2d(params["down"]["conv"], x, stride=stride,
                       padding="SAME")
        x = tnn.batchnorm(params["down"]["bn"], state["down"]["bn"], x)
    return tnn.relu(x + r)


def _fem(params, x):
    """Feature Enhance Module: three progressively deeper dilated
    branches, channel-concatenated (256 + 128 + 128)."""
    b1 = tnn.relu(tnn.conv2d(params["cpm1"], x, padding=1))
    mid = tnn.relu(tnn.conv2d(params["cpm2"], x, padding=2, dilation=2))
    b2 = tnn.relu(tnn.conv2d(params["cpm3"], mid, padding=1))
    mid2 = tnn.relu(tnn.conv2d(params["cpm4"], mid, padding=2, dilation=2))
    b3 = tnn.relu(tnn.conv2d(params["cpm5"], mid2, padding=1))
    return torch.cat([b1, b2, b3], dim=-1)


def _upsample_product(top, lateral):
    """The FPN merge: the deeper map upsampled (bilinear, align corners)
    to the shallower one's size, times it."""
    return tnn.upsample_bilinear(top, lateral.shape[1],
                                 lateral.shape[2]) * lateral


def apply(params, state, x: torch.Tensor
          ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """x: [B, H, W, 3] RGB in [0, 255] -> [(cls_prob [B, h, w, 2],
    reg [B, h, w, 4])] for the six sources, stride 4 ... 128."""
    h = x - torch.tensor(_MEAN, dtype=x.dtype, device=x.device)
    h = _cbr(params["stem"], state["stem"], h, stride=2, padding=3)
    h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, padding=1)
    h = h.permute(0, 2, 3, 1)
    feats = []
    for li in range(1, 5):
        for bi, (bp, bs) in enumerate(zip(params[f"layer{li}"],
                                          state[f"layer{li}"])):
            h = _bottleneck(bp, bs, h, 2 if (bi == 0 and li > 1) else 1)
        feats.append(h)
    c2, c3, c4, c5 = feats
    e5 = _cbr(params["layer5"]["a"], state["layer5"]["a"], h)
    e5 = _cbr(params["layer5"]["b"], state["layer5"]["b"], e5, stride=2,
              padding=1)
    e6 = _cbr(params["layer6"]["a"], state["layer6"]["a"], e5)
    e6 = _cbr(params["layer6"]["b"], state["layer6"]["b"], e6, stride=2,
              padding=1)
    conv = lambda name, t: tnn.conv2d(params[name], t, padding="SAME")
    lfpn3 = _upsample_product(conv("lat3", c5), conv("smooth3", c4))
    lfpn2 = _upsample_product(conv("lat2", lfpn3), conv("smooth2", c3))
    lfpn1 = _upsample_product(conv("lat1", lfpn2), conv("smooth1", c2))
    outs = []
    for i, f in enumerate([lfpn1, lfpn2, lfpn3, c5, e5, e6]):
        f = _fem(params[f"fem{i}"], f)
        cls = tnn.conv2d(params[f"cls{i}"], f, padding=1)
        reg = tnn.conv2d(params[f"reg{i}"], f, padding=1)
        if i == 0:  # max-in-out: 3 background logits, keep the max
            bg = cls[..., :3].max(dim=-1, keepdim=True).values
            cls = torch.cat([bg, cls[..., 3:]], dim=-1)
        outs.append((torch.softmax(cls, dim=-1), reg))
    return outs


def decode_detections(outs, threshold: float = 0.5,
                      variances=(0.1, 0.2)) -> np.ndarray:
    """Host anchor decode of frame 0: (x1, y1, x2, y2, conf) rows sorted
    by confidence."""
    return decode_anchors(outs, _STEPS, _SIZES, threshold, variances)


def detect_faces(params, state, image: torch.Tensor, threshold: float = 0.5,
                 nms_iou: float = 0.3) -> np.ndarray:
    """[H, W, 3] RGB in [0, 255] -> [N, 5] (x1, y1, x2, y2, conf) boxes,
    with the reference's detector thresholds."""
    with torch.no_grad():
        outs = apply(params, state, image[None])
    return nms(decode_detections(outs, threshold), nms_iou)
