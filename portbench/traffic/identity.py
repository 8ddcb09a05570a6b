"""A preprocessed identity on disk for the training cells: the artifact tree
the port's ``data/dataset.LipDataset`` reads, written once per checkout
from a fixed seed and kept under ``build/portbench/``.

A frozen copy of the learnable synthetic identity of the JAX package and
the port (``data/synthetic.make_learnable_tree``), rewritten for the
benchmark: each frame has a smooth head-motion grid (scale, rotation,
shift), the mouth is a parametric shape driven by a smooth latent that the
audio windows and the wav encode, the canonical masks are ellipses, the
canonical depth has no holes.  Nothing here imports the program: it writes
the files with numpy, scipy and OpenCV.  The tree is written into a
temporary directory and renamed into place, keyed by its parameters, so a
run that is cut leaves no half tree behind.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict

import numpy as np

VERSION = 1  # bump when the generator's output changes


def key(params: Dict[str, Any]) -> str:
    blob = json.dumps({"v": VERSION, **params}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def ensure(params: Dict[str, Any], build_dir: Path) -> Path:
    """The identity's directory, written first if it is not there."""
    root = build_dir / f"identity-{key(params)}"
    if (root / "DONE").exists():
        return root
    tmp = build_dir / f"identity-{key(params)}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    write(params, tmp)
    (tmp / "DONE").write_text("ok\n")
    shutil.rmtree(root, ignore_errors=True)
    os.replace(tmp, root)
    return root


def face_margin(face: int) -> int:
    """The face box's margin: 8% of the face a side (40 px at 500), so the
    box stays inside the face at any size."""
    return int(round(0.08 * face))


def _latent(pos: np.ndarray) -> np.ndarray:
    """Smooth 3-d latent over frame positions: incommensurate sinusoids."""
    p = np.asarray(pos, np.float64)[..., None]
    return np.sin(p * (2 * np.pi / np.array([13.0, 19.0, 29.0]))
                  + np.array([0.0, 1.3, 2.1]))


def _mouth(lat, h: int, w: int) -> np.ndarray:
    """A parametric mouth [h, w, 3] in [0, 1]: an ellipse whose height,
    width and colour follow the latent, on a skin shade, with a lip ring."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    shade = 0.92 - 0.10 * (ys + 1) / 2
    img = np.stack([shade * 0.88, shade * 0.62, shade * 0.55], -1)
    ry = 0.18 + 0.38 * (0.5 + 0.5 * lat[0])
    rx = 0.55 + 0.15 * lat[1]
    d = (xs / rx) ** 2 + (ys / ry) ** 2
    a = 1.0 / (1.0 + np.exp((d - 1.0) * 12.0))
    col = np.array([0.35 + 0.08 * lat[2], 0.08, 0.10])
    img = img * (1 - a[..., None]) + col * a[..., None]
    ring = np.exp(-((d - 1.35) ** 2) * 6.0)
    img = img * (1 - 0.6 * ring[..., None]) \
        + np.array([0.65, 0.25, 0.28]) * 0.6 * ring[..., None]
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _face(face: int, rng) -> np.ndarray:
    import cv2
    low = rng.uniform(0, 1, (12, 12, 3)).astype(np.float32)
    img = cv2.resize(low, (face, face), interpolation=cv2.INTER_CUBIC)
    ys = np.linspace(0, 1, face, dtype=np.float32)[:, None, None]
    base = np.array([0.85, 0.62, 0.55], np.float32)
    return np.clip(0.6 * base * (1 - 0.2 * ys) + 0.4 * img, 0, 1)


def _grid(face: int, t: float, m: Dict[str, Any], phase) -> np.ndarray:
    amp, per = m["amplitude"], m["period_s"]
    v = {k: amp[k] * np.sin(2 * np.pi * t / per[k] + phase[i])
         for i, k in enumerate(("scale", "rotate", "shift_x", "shift_y"))}
    lin = np.linspace(-1, 1, face)
    y, x = np.meshgrid(lin, lin, indexing="ij")
    s, c, sn = 1 + v["scale"], np.cos(v["rotate"]), np.sin(v["rotate"])
    gx = s * (c * x - sn * y) + v["shift_x"]
    gy = s * (sn * x + c * y) + v["shift_y"]
    return np.stack([gx, gy], -1).astype(np.float32)


def _sample(img: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Bilinear sample (align_corners=False, zeros outside) of [H, W, 3]."""
    h, w = img.shape[:2]
    x = ((grid[..., 0] + 1) * w - 1) * 0.5
    y = ((grid[..., 1] + 1) * h - 1) * 0.5
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    out = np.zeros(grid.shape[:2] + (3,), np.float32)
    for dy, dx, wgt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                        (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        yi, xi = y0 + dy, x0 + dx
        ok = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        out += wgt * ok * img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
    return out


def _ellipse(face: int, cy, cx, ry, rx) -> np.ndarray:
    lin = np.arange(face)
    y, x = np.meshgrid(lin, lin, indexing="ij")
    m = (((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2) <= 1.0
    return np.repeat((m * 255).astype(np.uint8)[..., None], 3, -1)


def _imwrite(path: Path, rgb01: np.ndarray, quality: int) -> None:
    import cv2
    bgr = (np.clip(rgb01, 0, 1) * 255).round().astype(np.uint8)[..., ::-1]
    if not cv2.imwrite(str(path), np.ascontiguousarray(bgr),
                       [cv2.IMWRITE_JPEG_QUALITY, quality]):
        raise OSError(f"could not write {path}")


def write(p: Dict[str, Any], root: Path) -> None:
    """Write the tree of parameters ``p`` under ``root``."""
    import cv2
    from scipy.io import wavfile
    rng = np.random.default_rng(int(p["seed"]))
    n, face, fps, sr = (int(p["n_frames"]), int(p["face"]), int(p["fps"]),
                        int(p["sample_rate"]))
    lip, q = p["lip"], int(p["jpeg_quality"])
    for d in ("audio", "images", "ori_images_face", "coords", "landmarks"):
        (root / d).mkdir(parents=True, exist_ok=True)

    proj = rng.standard_normal((3, 29)) * 0.8
    bias = rng.standard_normal(29) * 0.1
    aud = np.stack([_latent(i + (np.arange(16) - 8) / 2.0) @ proj + bias
                    + 0.02 * rng.standard_normal((16, 29))
                    for i in range(n)]).astype(np.float32)
    np.save(root / "audio" / "audio.npy", aud)
    t = np.arange(int((n / fps + 1.0) * sr)) / sr
    lat = _latent(t * fps)
    f0 = 220.0 * 2.0 ** (0.6 * lat[:, 1])
    wav = ((0.18 + 0.14 * lat[:, 0]) * np.sin(2 * np.pi * np.cumsum(f0) / sr)
           + (0.06 + 0.04 * lat[:, 2]) * np.sin(2 * np.pi * 2800.0 * t))
    wavfile.write(root / "audio" / "audio.wav", sr,
                  (wav * 32767).astype(np.int16))

    base = _face(face, rng)
    phase = 2 * np.pi * rng.uniform(0, 1, 4)
    # landmarks 48-67 span the mouth so that the dataset's mouth box
    # (centre y scaled by 1.02) lands on the lip rectangle
    lw, lh = lip["w"], lip["h"]
    mouth_pts = np.stack([np.linspace(lip["x"] + lw / 12,
                                      lip["x"] + lw - lw / 12, 20),
                          np.linspace(lip["y"] + lh / 4,
                                      lip["y"] + 0.575 * lh, 20)], -1)
    for i in range(n):
        name = f"{i + 1:05d}"
        mouth = _mouth(_latent(np.array(float(i))), lip["h"], lip["w"])
        can = base.copy()
        can[lip["y"]:lip["y"] + lip["h"], lip["x"]:lip["x"] + lip["w"]] = mouth
        grid = _grid(face, i / fps, p["motion"], phase)
        if i == 0:  # the canonical frame is the canonical pose
            lin = np.linspace(-1, 1, face)
            yy, xx = np.meshgrid(lin, lin, indexing="ij")
            grid = np.stack([xx, yy], -1).astype(np.float32)
        _imwrite(root / "images" / f"{name}.jpg", mouth, q)
        _imwrite(root / "ori_images_face" / f"{name}.jpg",
                 _sample(can, grid), q)
        np.save(root / "coords" / f"{name}.npy", grid)
        lms = rng.uniform(0, face, (68, 2)).astype(np.float32)
        lms[48:] = mouth_pts
        np.savetxt(root / "landmarks" / f"{name}.lms", lms)

    lipm = np.zeros((face, face, 3), np.uint8)
    lipm[lip["y"]:lip["y"] + lip["h"], lip["x"]:lip["x"] + lip["w"]] = 255
    c = face / 2.0
    for fname, img in (("canonical_lip_mask.jpg", lipm),
                       ("canonical_head_mask.jpg",
                        _ellipse(face, 0.52 * face, c, 0.46 * face,
                                 0.38 * face)),
                       ("canonical_face_mask.jpg",
                        _ellipse(face, 0.58 * face, c, 0.30 * face,
                                 0.26 * face))):
        if not cv2.imwrite(str(root / fname), img[..., ::-1].copy()):
            raise OSError(f"could not write {fname}")
    lin = np.linspace(-1, 1, face, dtype=np.float32)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    np.save(root / "depth_face_canonical.npy",
            (1.0 + 0.1 * np.exp(-(xx ** 2 + yy ** 2) / 0.5)).astype(
                np.float32))
    tt = np.arange(n) / fps
    euler = 0.02 * np.stack([np.sin(2 * np.pi * tt / pp + ph) for pp, ph in
                             ((4.1, 0.3), (5.3, 1.1), (6.7, 2.0))], -1)
    trans = 0.01 * np.stack([np.sin(2 * np.pi * tt / pp + ph) for pp, ph in
                             ((3.7, 0.5), (4.9, 1.7), (5.9, 2.3))], -1)
    euler[0] = 0.0
    trans[0] = 0.0
    trans[:, 2] += 2.0
    np.savez(root / "track_params.pt.npz", euler=euler.astype(np.float32),
             trans=trans.astype(np.float32), focal=np.float32(p["focal"]))
    m = face_margin(face)
    np.save(root / "face_bbox_dict.npy",
            {f"{i + 1:05d}.jpg": np.array([m, m, face - m, face - m, 1.0],
                                          np.float32) for i in range(n)},
            allow_pickle=True)
