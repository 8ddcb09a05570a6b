"""A raw identity for the preprocessing CLI, rendered from a known 3DMM
pose: the input tree ``cli/preprocess`` reads, and the truth to hold its
output against.

``make_raw_identity`` renders ``n`` frames of a mesh (the assets' blob,
drawn at ``focal`` with seeded pose and expression) through the port's
``render_mesh`` on the assets' device and writes

    ori_images_face/%05d.jpg   the frames (BGR JPEG)
    landmarks/%05d.lms         their true 68 landmarks
    audio/audio.wav            a 16 kHz tone as long as the clip

as the JAX package's preprocessing tests lay their world out.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from speech2lip_tpu_torch.preprocess import face_3dmm as bfm


def true_params(assets: bfm.BFMAssets, n: int, seed: int = 2
                ) -> Dict[str, np.ndarray]:
    """Seeded per-frame pose and expression around trans z = -7, identity
    0 (the JAX test worlds' draws: euler, trans xy, exp)."""
    rng = np.random.default_rng(seed)
    exp_dim = assets.base_exp.shape[0]
    euler = (0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    trans = np.tile(np.array([[0, 0, -7.0]], np.float32), (n, 1))
    trans[:, :2] += 0.05 * rng.standard_normal((n, 2))
    exp = (0.1 * rng.standard_normal((n, exp_dim))).astype(np.float32)
    return {"id": np.zeros((1, assets.base_id.shape[0]), np.float32),
            "exp": exp, "euler": euler, "trans": trans}


def render_world(assets: bfm.BFMAssets, truth: Dict[str, np.ndarray],
                 size: int, focal: float, chunk: int = 8, **raster_kwargs):
    """Frames [n, size, size, 3] in [0, 255] and landmarks [n, 68, 2] of
    the poses ``truth`` (texture and lighting 0), on the assets' device."""
    dev = assets.tris.device
    t = {k: torch.as_tensor(v, device=dev) for k, v in truth.items()}
    n = t["exp"].shape[0]
    cxy = (size / 2.0, size / 2.0)
    tex = bfm.forward_tex(assets, torch.zeros(
        (1, assets.base_tex.shape[0]), device=dev))
    imgs, lms = [], []
    with torch.no_grad():
        for s in range(0, n, chunk):
            sl = slice(s, s + chunk)
            b = t["exp"][sl].shape[0]
            idb = t["id"].expand(b, -1)
            geo = bfm.forward_geo(assets, idb, t["exp"][sl])
            rott = bfm.rot_trans_pts(geo, bfm.euler2rot(t["euler"][sl]),
                                     t["trans"][sl])
            img, _ = bfm.render_mesh(assets, rott, tex.expand(b, -1, -1),
                                     torch.zeros((b, 27), device=dev), focal,
                                     size, size, **raster_kwargs)
            imgs.append(img.cpu().numpy())
            geo_l = bfm.get_3dlandmarks(assets, idb, t["exp"][sl],
                                        t["euler"][sl], t["trans"][sl],
                                        focal, cxy)
            lms.append(bfm.forward_transform(
                geo_l, t["euler"][sl], t["trans"][sl], focal,
                cxy)[:, :, :2].cpu().numpy())
    return np.concatenate(imgs), np.concatenate(lms)


def write_lms(root: str, lms: np.ndarray):
    """landmarks/%05d.lms text files."""
    os.makedirs(os.path.join(root, "landmarks"), exist_ok=True)
    for i, pts in enumerate(lms):
        np.savetxt(os.path.join(root, "landmarks", f"{i + 1:05d}.lms"), pts)


def make_raw_identity(root: str, assets: bfm.BFMAssets, n: int, size: int,
                      focal: float, seed: int = 2, fps: float = 25.0,
                      **raster_kwargs) -> Dict[str, Any]:
    """Write the raw identity tree under ``root`` (see the module's
    docstring).  Returns {"truth", "frames" [n, size, size, 3] uint8 RGB
    as written, "lms" [n, 68, 2]}."""
    import cv2
    from scipy.io import wavfile

    truth = true_params(assets, n, seed)
    imgs, lms = render_world(assets, truth, size, focal, **raster_kwargs)
    if float(imgs.max()) < 1.0:
        raise RuntimeError("the world rendered black")
    frames = np.clip(imgs, 0, 255).astype(np.uint8)
    os.makedirs(os.path.join(root, "ori_images_face"), exist_ok=True)
    for i, img in enumerate(frames):
        cv2.imwrite(os.path.join(root, "ori_images_face", f"{i + 1:05d}.jpg"),
                    img[..., ::-1])
    write_lms(root, lms)
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    sr = 16000
    t = np.arange(int(sr * max(1.0, n / fps))) / sr
    wavfile.write(os.path.join(root, "audio", "audio.wav"), sr,
                  (0.2 * np.sin(2 * np.pi * 300 * t) * 32767).astype(
                      np.int16))
    return {"truth": truth, "frames": frames, "lms": lms}
