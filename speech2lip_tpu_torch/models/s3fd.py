"""S3FD single-shot face detector (counterpart of
``speech2lip_tpu/models/s3fd.py``).

VGG-16 backbone, dilated-receptive fc6 / fc7, two extra strided stages,
L2-normalised shallow sources, a max-out background on the stride-4 head,
SSD anchor decoding on the host and greedy NMS.  Outputs
(x1, y1, x2, y2, confidence) rows, the ``face_bbox_dict`` contract.  The
parameter tree is the JAX package's (``weights.s3fd_from_jax``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from speech2lip_tpu_torch.ops import nn as tnn

# backbone convs (name, cin, cout), 'M' = 2x2 max pool
VGG = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), "M",
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), "M",
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), "M",
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), "M",
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512), "M",
]
# (name, cin, cout, kernel) of the convs after the backbone
EXTRA = [("fc6", 512, 1024, 3), ("fc7", 1024, 1024, 1),
         ("conv6_1", 1024, 256, 1), ("conv6_2", 256, 512, 3),
         ("conv7_1", 512, 128, 1), ("conv7_2", 128, 256, 3)]
SOURCES = ["conv3_3", "conv4_3", "conv5_3", "fc7", "conv6_2", "conv7_2"]
SOURCE_CH = {"conv3_3": 256, "conv4_3": 512, "conv5_3": 512, "fc7": 1024,
             "conv6_2": 512, "conv7_2": 256}
_STRIDES = [4, 8, 16, 32, 64, 128]
_ANCHOR_SIZES = [16, 32, 64, 128, 256, 512]
L2_SCALES = {"conv3_3": 10.0, "conv4_3": 8.0, "conv5_3": 5.0}
# mean subtraction in BGR order (face_alignment's s3fd preprocessing)
_MEAN = (104.0, 117.0, 123.0)


def _l2norm(x, scale, eps=1e-10):
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + eps
    return x / n * scale


def apply(params, x: torch.Tensor
          ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """x: [B, H, W, 3] RGB in [0, 255] -> [(cls_prob [B, h, w, 2],
    reg [B, h, w, 4])] per source scale."""
    x = x.flip(-1) - torch.tensor(_MEAN, dtype=x.dtype, device=x.device)
    feats = {}
    h = x
    for item in VGG:
        if item == "M":
            h = tnn.maxpool2d(h, 2)
            continue
        name = item[0]
        h = tnn.relu(tnn.conv2d(params[name], h, padding=1))
        feats[name] = h
    h = tnn.relu(tnn.conv2d(params["fc6"], h, padding=3))
    h = tnn.relu(tnn.conv2d(params["fc7"], h, padding=0))
    feats["fc7"] = h
    h = tnn.relu(tnn.conv2d(params["conv6_1"], h, padding=0))
    h = tnn.relu(tnn.conv2d(params["conv6_2"], h, stride=2, padding=1))
    feats["conv6_2"] = h
    h = tnn.relu(tnn.conv2d(params["conv7_1"], h, padding=0))
    h = tnn.relu(tnn.conv2d(params["conv7_2"], h, stride=2, padding=1))
    feats["conv7_2"] = h

    outs = []
    for i, s in enumerate(SOURCES):
        f = feats[s]
        if s in L2_SCALES:
            f = _l2norm(f, params[s + "_l2"]["scale"])
        cls = tnn.conv2d(params[f"cls_{s}"], f, padding=1)
        reg = tnn.conv2d(params[f"reg_{s}"], f, padding=1)
        if i == 0:  # max-out of 3 background channels
            bg = cls[..., :3].max(dim=-1, keepdim=True).values
            cls = torch.cat([bg, cls[..., 3:]], dim=-1)
        outs.append((torch.softmax(cls, dim=-1), reg))
    return outs


def decode_anchors(outs, steps, sizes, threshold: float,
                   variances=(0.1, 0.2)) -> np.ndarray:
    """SSD anchor decode of frame 0 on the host: centre-size anchors of
    side ``sizes[k]`` on a ``steps[k]`` grid.  Returns (x1, y1, x2, y2,
    conf) rows sorted by confidence (before NMS)."""
    boxes = []
    for (cls, reg), step, size in zip(outs, steps, sizes):
        prob = cls[0, :, :, 1].cpu().numpy()
        loc = reg[0].cpu().numpy()
        ys, xs = np.nonzero(prob > threshold)
        if not len(ys):
            continue
        acx, acy = (xs + 0.5) * step, (ys + 0.5) * step
        d = loc[ys, xs]
        cx = acx + d[:, 0] * variances[0] * size
        cy = acy + d[:, 1] * variances[0] * size
        w = size * np.exp(d[:, 2] * variances[1])
        hh = size * np.exp(d[:, 3] * variances[1])
        boxes.append(np.stack([cx - w / 2, cy - hh / 2, cx + w / 2,
                               cy + hh / 2, prob[ys, xs]], -1))
    if not boxes:
        return np.zeros((0, 5), np.float32)
    boxes = np.concatenate(boxes).astype(np.float32)
    return boxes[np.argsort(-boxes[:, 4])]


def decode_detections(outs, threshold: float = 0.5,
                      variances=(0.1, 0.2)) -> np.ndarray:
    return decode_anchors(outs, _STRIDES, _ANCHOR_SIZES, threshold,
                          variances)


def nms(boxes: np.ndarray, iou_threshold: float = 0.3) -> np.ndarray:
    """Greedy non-maximum suppression on (x1, y1, x2, y2, conf) rows, in
    their order: each kept row drops the later rows that overlap it by
    more than ``iou_threshold``."""
    keep = []
    remaining = np.arange(len(boxes))
    while len(remaining):
        i, rest = remaining[0], remaining[1:]
        keep.append(i)
        bi, bj = boxes[i], boxes[rest]
        area_i = (bi[2] - bi[0]) * (bi[3] - bi[1])
        ix1 = np.maximum(bi[0], bj[:, 0])
        iy1 = np.maximum(bi[1], bj[:, 1])
        ix2 = np.minimum(bi[2], bj[:, 2])
        iy2 = np.minimum(bi[3], bj[:, 3])
        inter = np.maximum(0, ix2 - ix1) * np.maximum(0, iy2 - iy1)
        area_j = (bj[:, 2] - bj[:, 0]) * (bj[:, 3] - bj[:, 1])
        iou = inter / np.maximum(area_i + area_j - inter, 1e-9)
        remaining = rest[iou <= iou_threshold]
    return boxes[keep]


def detect_faces(params, image: torch.Tensor, threshold: float = 0.5,
                 nms_iou: float = 0.3) -> np.ndarray:
    """[H, W, 3] RGB in [0, 255] -> [N, 5] (x1, y1, x2, y2, conf) boxes."""
    with torch.no_grad():
        outs = apply(params, image[None])
    return nms(decode_detections(outs, threshold), nms_iou)
