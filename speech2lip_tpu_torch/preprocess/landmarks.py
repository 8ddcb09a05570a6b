"""STEP1: face boxes and landmarks (counterpart of
``speech2lip_tpu/preprocess/landmarks.py``).

The FAN detects 68 landmarks on a 256^2 crop around the face box; the box
comes from DSFD (the reference's own detector), else S3FD, else the
BiSeNet parsing map, else the full frame.  Writes one ``.lms`` text file a
frame and ``face_bbox_dict.npy`` of (x1, y1, x2, y2, conf) rows.  The
crops of a run go through the FAN in batches of ``FAN_BATCH``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from speech2lip_tpu_torch.models import bisenet, dsfd as dsfd_mod, fan, s3fd

# crops a FAN forward takes at once
FAN_BATCH = 16


def bbox_from_parsing(class_map: np.ndarray,
                      face_classes=tuple(range(1, 16))
                      ) -> Tuple[int, int, int, int]:
    """Face box (x, y, x2, y2) of a BiSeNet class map [H, W]: the extent
    of classes 1..15 (the face and head regions); the full map if none."""
    mask = np.isin(class_map, face_classes)
    if not mask.any():
        h, w = class_map.shape
        return 0, 0, w, h
    ys, xs = np.nonzero(mask)
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


def _crop_resize(img: np.ndarray, bbox, out: int = 256):
    """Square crop of 1.3x the box's longer side around its centre,
    bilinear to out^2 (cv2).  Returns (crop, (scale, x0, y0)) mapping crop
    pixels back to image pixels."""
    import cv2
    x0, y0, x1, y1 = bbox
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    size = max(x1 - x0, y1 - y0) * 1.3
    half = size / 2.0
    sx0, sy0 = cx - half, cy - half
    m = np.float32([[out / size, 0, -sx0 * out / size],
                    [0, out / size, -sy0 * out / size]])
    crop = cv2.warpAffine(img, m, (out, out), flags=cv2.INTER_LINEAR)
    return crop, (size / out, sx0, sy0)


def _device_of(tree) -> torch.device:
    """The device of a parameter tree's first tensor."""
    while not isinstance(tree, torch.Tensor):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else \
            tree[0]
    return tree.device


def _fan_points(fan_params, fan_state, crops: np.ndarray,
                device) -> np.ndarray:
    """[N, 256, 256, 3] crops -> [N, 68, 2] points in 256-crop pixels."""
    out = []
    for s in range(0, len(crops), FAN_BATCH):
        x = torch.as_tensor(crops[s:s + FAN_BATCH], device=device)
        with torch.no_grad():
            hm = fan.apply(fan_params, fan_state, x)[-1]
        out.append(fan.decode_heatmaps(hm).cpu().numpy())
    pts = np.concatenate(out)            # 64x64 heatmap pixels
    return (pts + 0.5) * 4.0


def detect_landmarks(fan_params, fan_state, image: np.ndarray, bbox,
                     device=None) -> np.ndarray:
    """[H, W, 3] float RGB in [0, 1] + face box -> [68, 2] landmarks in
    image pixels."""
    device = device or _device_of(fan_params)
    crop, (scale, x0, y0) = _crop_resize(image, bbox)
    pts = _fan_points(fan_params, fan_state, crop[None], device)[0]
    return (pts * scale + np.array([x0, y0])).astype(np.float32)


def face_box(image: np.ndarray, dsfd=None, s3fd_params=None,
             bisenet_params=None, bisenet_state=None):
    """The face box and its confidence of one [H, W, 3] float RGB frame in
    [0, 1], by the first detector given: DSFD ((params, state)), S3FD,
    the BiSeNet parsing map, else the full frame (confidence 1)."""
    import cv2
    h, w = image.shape[:2]
    if dsfd is not None or s3fd_params is not None:
        dev = _device_of(dsfd[0] if dsfd is not None else s3fd_params)
        x = torch.as_tensor(image * 255.0, device=dev)
        dets = (dsfd_mod.detect_faces(dsfd[0], dsfd[1], x)
                if dsfd is not None else s3fd.detect_faces(s3fd_params, x))
        if len(dets):
            return tuple(int(v) for v in dets[0][:4]), float(dets[0][4])
        return (0, 0, w, h), 1.0
    if bisenet_params is not None:
        dev = _device_of(bisenet_params)
        classes = bisenet.parse_face(bisenet_params, bisenet_state,
                                     torch.as_tensor(image, device=dev))
        classes = cv2.resize(classes.cpu().numpy().astype(np.uint8), (w, h),
                             interpolation=cv2.INTER_NEAREST)
        return bbox_from_parsing(classes), 1.0
    return (0, 0, w, h), 1.0


def run_step1(frames_dir: str, out_lms_dir: str, out_bbox_path: str,
              fan_params, fan_state, bisenet_params=None,
              bisenet_state=None, s3fd_params=None,
              dsfd=None) -> Dict[str, np.ndarray]:
    """A directory of frames -> ``.lms`` files + ``face_bbox_dict.npy``
    (the STEP1 artifact contract); the nets run where their tensors lie.
    Returns {frame file: (x1, y1, x2, y2, conf)}."""
    import cv2
    os.makedirs(out_lms_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(frames_dir) if f.endswith(".jpg"))
    bbox_dict = {}
    for s in range(0, len(files), FAN_BATCH):
        crops, maps = [], []
        for fname in files[s:s + FAN_BATCH]:
            img = cv2.cvtColor(cv2.imread(os.path.join(frames_dir, fname)),
                               cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
            bbox, conf = face_box(img, dsfd, s3fd_params, bisenet_params,
                                  bisenet_state)
            crop, affine = _crop_resize(img, bbox)
            crops.append(crop)
            maps.append(affine)
            bbox_dict[fname] = np.array([*bbox, conf], np.float32)
        pts = _fan_points(fan_params, fan_state, np.stack(crops),
                          _device_of(fan_params))
        for fname, p, (scale, x0, y0) in zip(files[s:s + FAN_BATCH], pts,
                                             maps):
            lms = (p * scale + np.array([x0, y0])).astype(np.float32)
            np.savetxt(os.path.join(out_lms_dir,
                                    fname.replace(".jpg", ".lms")), lms)
    np.save(out_bbox_path, bbox_dict, allow_pickle=True)
    return bbox_dict
