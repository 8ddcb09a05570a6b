"""The plain reference of a training batch: a frame of a preprocessed
identity read from its files as the artifact tree defines them.

The tree (``audio/audio.npy``, ``images/%05d.jpg`` lip crops,
``ori_images_face/%05d.jpg`` observed faces, ``coords/%05d.npy``
canonical-to-observed grids, the canonical frame's landmarks, masks and
tracked poses) is the preprocessing's output; the training split is the
first 90% of the frames.  The static warps of the black-hole augmentation
(the canonical face and its > 0 mask warped by the frame's grid) are
recomputed here: bilinear, align_corners=False, zeros outside, in float32.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict

import numpy as np


def imread(path: str) -> np.ndarray:
    """RGB float32 in [0, 1] (OpenCV's decoder, the preprocessing's)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def mouth_box(lms: np.ndarray, w: int, h: int, ratio: float):
    """Top-left of the w x h lip crop: centred on the bounding rectangle of
    landmarks 48-67 (floored corner, ceiled span + 1), its centre's y
    scaled by ``ratio``."""
    pts = lms[48:, :2].astype(np.float32)
    x, y = (int(math.floor(v)) for v in pts.min(0))
    x2, y2 = pts.max(0)
    bw, bh = int(math.ceil(x2)) - x + 1, int(math.ceil(y2)) - y + 1
    return int(x + bw / 2.0 - w / 2.0), int((y + bh / 2.0) * ratio - h / 2.0)


def warp(img: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """img [H, W, C] sampled at grid [Hg, Wg, 2]."""
    h, w, c = img.shape
    ix = ((grid[..., 0] + 1.0) * np.float32(w) - 1.0) * np.float32(0.5)
    iy = ((grid[..., 1] + 1.0) * np.float32(h) - 1.0) * np.float32(0.5)
    x0, y0 = np.floor(ix), np.floor(iy)
    wx = (ix - x0)[..., None].astype(np.float32)
    wy = (iy - y0)[..., None].astype(np.float32)
    x0, y0 = x0.astype(np.int32), y0.astype(np.int32)

    def at(yi, xi):
        ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        return img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)] \
            * ok[..., None].astype(np.float32)

    top = at(y0, x0) * (1.0 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1.0 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


class Identity:
    """The reference's reader of one identity's tree."""

    def __init__(self, root: str, data_cfg: Dict[str, Any]):
        self.root = root
        self.can = int(data_cfg.get("canonical_idx", 0))
        self.aud = np.load(os.path.join(root, "audio", "audio.npy"))
        n_img = len([f for f in os.listdir(os.path.join(root, "images"))
                     if f.endswith(".jpg")])
        self.n_train = min(int(self.aud.shape[0] * 0.9),
                           min(self.aud.shape[0], n_img))
        cname = f"{self.can + 1:05d}.jpg"
        self.face_zero = imread(os.path.join(root, "ori_images_face", cname))
        self.rgb_zero = imread(os.path.join(root, "images", cname))
        self.lip_h, self.lip_w = self.rgb_zero.shape[:2]
        self.mask_lip = imread(os.path.join(root, "canonical_lip_mask.jpg"))
        self.head = imread(os.path.join(root,
                                        "canonical_head_mask.jpg"))[..., :1]
        self.face_mask = imread(os.path.join(root, "canonical_face_mask.jpg"))
        lms = np.loadtxt(os.path.join(root, "landmarks",
                                      f"{self.can + 1:05d}.lms"),
                         dtype=np.float32)
        self.lip_x, self.lip_y = mouth_box(
            lms, self.lip_w, self.lip_h,
            float(data_cfg.get("mouth_center_y_ratio", 1.02)))
        tp = np.load(os.path.join(root, "track_params.pt.npz"))
        self.euler = tp["euler"].astype(np.float32)
        self.trans = tp["trans"].astype(np.float32)
        self.face_pos = (self.face_zero > 0).astype(np.float32)

    def frame(self, pos: int) -> Dict[str, np.ndarray]:
        """The training sample of split position ``pos`` (the fields the
        stage-1 step reads)."""
        name = f"{pos + 1:05d}"
        coord = np.load(os.path.join(self.root, "coords",
                                     name + ".npy")).astype(np.float32)
        return {
            "audio": self.aud[pos].astype(np.float32),
            "index": np.int32(pos),
            "total_frame": np.int32(self.n_train),
            "rgb_face_zero": self.face_zero,
            "mask_lip_canonical": self.mask_lip,
            "lip_lefttop_x": np.int32(self.lip_x),
            "lip_lefttop_y": np.int32(self.lip_y),
            "rgb_zero": self.rgb_zero,
            "rgb": imread(os.path.join(self.root, "images", name + ".jpg")),
            "rgb_face_ori": imread(os.path.join(self.root, "ori_images_face",
                                                name + ".jpg")),
            "coord": coord,
            "height": np.int32(self.lip_h),
            "width": np.int32(self.lip_w),
            "canonical_euler": self.euler[self.can],
            "canonical_trans": self.trans[self.can],
            "euler": self.euler[pos],
            "trans": self.trans[pos],
            "mask_head_canonical": self.head,
            "mask_face_canonical": self.face_mask,
            "warped_base": warp(self.face_zero, coord),
            "blackaug_face_mask": (warp(self.face_pos, coord) == 1.0).astype(
                np.float32),
        }


def gap(program: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> float:
    """The largest |program - reference| over every field the reference
    builds (inf where a field is missing or its shape differs)."""
    worst = 0.0
    for k, r in ref.items():
        if k not in program:
            return math.inf
        p = np.asarray(program[k])
        r = np.asarray(r)
        if p.shape != r.shape:
            return math.inf
        d = float(np.max(np.abs(p.astype(np.float64) - r.astype(np.float64)))) \
            if r.size else 0.0
        if not math.isfinite(d):
            return math.inf
        worst = max(worst, d)
    return worst
