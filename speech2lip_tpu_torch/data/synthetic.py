"""Synthetic identities (counterpart of ``speech2lip_tpu/data/synthetic.py``):
artifact trees on disk in the preprocessed dataset's layout, in-memory
batches, and a config wired to a tree.

The same arguments give the JAX package's arrays: npy files and batches
byte for byte, JPEGs through the same codec (tests/test_torch_data.py,
tests/test_torch_dataset.py).  ``chip_smoke.py`` and the port's tests build
their inputs with it.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from speech2lip_tpu_torch.config import default_config
from speech2lip_tpu_torch.data.image_io import imwrite


def make_synthetic_tree(root: str, n_frames: int = 12, face: int = 64,
                        lip_h: int = 16, lip_w: int = 24,
                        seed: int = 0, fps: int = 25,
                        sample_rate: int = 16000) -> Dict[str, Any]:
    """Write a miniature dataset tree under ``root``; returns its geometry.
    Random per-frame pixels: a test of shapes and contracts."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    os.makedirs(os.path.join(root, "audio_test"), exist_ok=True)
    for d in ("images", "warp_images", "ori_images_face", "coords",
              "landmarks"):
        os.makedirs(os.path.join(root, d), exist_ok=True)

    # DeepSpeech windows [N, 16, 29]
    aud = rng.standard_normal((n_frames, 16, 29)).astype(np.float32)
    np.save(os.path.join(root, "audio", "audio.npy"), aud)
    np.save(os.path.join(root, "audio_test", "audio.npy"), aud[: n_frames // 2])

    # wav long enough for the mel windows: n_frames/fps seconds + pad
    dur = n_frames / fps + 1.0
    t = np.arange(int(dur * sample_rate)) / sample_rate
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    from scipy.io import wavfile
    wavfile.write(os.path.join(root, "audio", "audio.wav"), sample_rate,
                  (wav * 32767).astype(np.int16))
    half = len(wav) // 2
    wavfile.write(os.path.join(root, "audio_test", "audio.wav"),
                  sample_rate, (wav[:half] * 32767).astype(np.int16))

    # lip placed near the lower-middle of the face (kept in-bounds even
    # after the mouth-bbox center_y ratio shift)
    lip_x = (face - lip_w) // 2
    lip_y = min(int(face * 0.6), face - lip_h - 4)

    for i in range(n_frames):
        name = "{:05d}".format(i + 1)
        lip = (rng.uniform(0, 1, (lip_h, lip_w, 3)) * 255).astype(np.uint8)
        # the pixels are written as BGR bytes
        imwrite(os.path.join(root, "images", name + ".jpg"), lip[:, :, ::-1])
        f = (rng.uniform(0, 1, (face, face, 3)) * 255).astype(np.uint8)
        imwrite(os.path.join(root, "warp_images", name + ".jpg"),
                f[:, :, ::-1])
        imwrite(os.path.join(root, "ori_images_face", name + ".jpg"),
                f[:, :, ::-1])
        # near-identity canonical→observed grid with small jitter
        ys, xs = np.meshgrid(np.linspace(-1, 1, face),
                             np.linspace(-1, 1, face), indexing="ij")
        jitter = 0.02 * rng.standard_normal((2,))
        coord = np.stack([xs + jitter[0], ys + jitter[1]], -1).astype(np.float32)
        np.save(os.path.join(root, "coords", name + ".npy"), coord)
        # 68 landmarks; mouth points (48+) spread over the lip box
        lms = rng.uniform(0, face, (68, 2)).astype(np.float32)
        gx = np.linspace(lip_x + 2, lip_x + lip_w - 2, 20)
        gy = np.linspace(lip_y + 2, lip_y + lip_h - 2, 20)
        lms[48:] = np.stack([gx, gy], -1)
        np.savetxt(os.path.join(root, "landmarks", name + ".lms"), lms)

    lip_mask = np.zeros((face, face, 3), np.uint8)
    lip_mask[lip_y:lip_y + lip_h, lip_x:lip_x + lip_w] = 255
    imwrite(os.path.join(root, "canonical_lip_mask.jpg"), lip_mask)
    head = np.zeros((face, face, 3), np.uint8)
    head[4:-4, 4:-4] = 255
    imwrite(os.path.join(root, "canonical_head_mask.jpg"), head)
    fmask = np.zeros((face, face, 3), np.uint8)
    fmask[8:-8, 8:-8] = 255
    imwrite(os.path.join(root, "canonical_face_mask.jpg"), fmask)

    depth = rng.uniform(0.8, 1.2, (face, face)).astype(np.float32)
    depth[:4] = 0.0  # holes, exercising the hole-fill init
    np.save(os.path.join(root, "depth_face_canonical.npy"), depth)

    euler = (0.05 * rng.standard_normal((n_frames, 3))).astype(np.float32)
    trans = (0.05 * rng.standard_normal((n_frames, 3))).astype(np.float32)
    trans[:, 2] += 2.0
    np.savez(os.path.join(root, "track_params.pt.npz"),
             euler=euler, trans=trans, focal=np.float32(face * 2.0))

    bbox = {"{:05d}.jpg".format(i + 1):
            np.array([4, 4, face - 4, face - 4, 1.0], np.float32)
            for i in range(n_frames)}
    np.save(os.path.join(root, "face_bbox_dict.npy"), bbox, allow_pickle=True)

    return {"n_frames": n_frames, "face": face, "lip_h": lip_h,
            "lip_w": lip_w, "lip_x": lip_x, "lip_y": lip_y,
            "focal": face * 2.0}


def _latent_track(frame_pos: np.ndarray) -> np.ndarray:
    """Smooth 3-d "speech" latent over (fractional) frame positions:
    incommensurate sinusoids, so held-out tail frames sample the same
    process the training frames do (nothing to memorize, everything to
    learn).  Returns [..., 3] in [-1, 1]."""
    p = np.asarray(frame_pos, np.float64)[..., None]
    freqs = np.array([2 * np.pi / 13.0, 2 * np.pi / 19.0, 2 * np.pi / 29.0])
    phases = np.array([0.0, 1.3, 2.1])
    return np.sin(p * freqs + phases)


def _render_lip(latent: np.ndarray, lip_h: int, lip_w: int) -> np.ndarray:
    """Anti-aliased parametric mouth: an elliptical opening whose height /
    width / brightness are smooth functions of the latent.  float32 RGB
    [lip_h, lip_w, 3] in [0, 1]."""
    a0, a1, a2 = float(latent[0]), float(latent[1]), float(latent[2])
    ys, xs = np.meshgrid(np.linspace(-1, 1, lip_h), np.linspace(-1, 1, lip_w),
                         indexing="ij")
    # skin background with a vertical shade
    img = np.empty((lip_h, lip_w, 3), np.float32)
    shade = 0.92 - 0.10 * (ys + 1) / 2
    img[..., 0] = shade * 0.88
    img[..., 1] = shade * 0.62
    img[..., 2] = shade * 0.55
    # mouth opening: ellipse with audio-driven half-height
    ry = 0.18 + 0.38 * (0.5 + 0.5 * a0)          # 0.18 .. 0.56
    rx = 0.55 + 0.15 * a1                        # 0.40 .. 0.70
    d = (xs / rx) ** 2 + (ys / ry) ** 2
    alpha = 1.0 / (1.0 + np.exp((d - 1.0) * 12.0))   # soft edge
    mouth_col = np.array([0.35 + 0.08 * a2, 0.08, 0.10], np.float32)
    img = img * (1 - alpha[..., None]) + mouth_col * alpha[..., None]
    # lip ring just outside the opening
    ring = np.exp(-((d - 1.35) ** 2) * 6.0)
    lip_col = np.array([0.65, 0.25, 0.28], np.float32)
    img = img * (1 - 0.6 * ring[..., None]) + lip_col * 0.6 * ring[..., None]
    return np.clip(img, 0.0, 1.0)


def _canonical_face_base(face: int, lip_x: int, lip_y: int,
                         lip_h: int, lip_w: int, seed: int) -> np.ndarray:
    """Fixed structured canonical face: smooth blobs + gradient + an 'eye'
    pair, so PSNR on the full frame is meaningful."""
    rng = np.random.default_rng(seed + 1000)
    ys, xs = np.meshgrid(np.linspace(-1, 1, face), np.linspace(-1, 1, face),
                         indexing="ij")
    img = np.empty((face, face, 3), np.float32)
    base = 0.85 - 0.18 * (ys + 1) / 2 - 0.05 * np.abs(xs)
    img[..., 0] = base * 0.95
    img[..., 1] = base * 0.72
    img[..., 2] = base * 0.62
    for _ in range(6):  # fixed smooth blobs
        cx, cy = rng.uniform(-0.8, 0.8, 2)
        s = rng.uniform(0.08, 0.3)
        col = rng.uniform(-0.15, 0.15, 3)
        g = np.exp(-(((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * s * s)))
        img += g[..., None] * col[None, None, :]
    for ex in (-0.35, 0.35):  # eyes
        g = np.exp(-(((xs - ex) ** 2 + (ys + 0.35) ** 2) / (2 * 0.05 ** 2)))
        img *= (1 - 0.8 * g[..., None])
    return np.clip(img, 0.0, 1.0)


def _bilinear_sample(img: np.ndarray, coord: np.ndarray) -> np.ndarray:
    """grid_sample(align_corners=True, border) of [H, W, 3] at a [-1,1]
    coord grid [H, W, 2] (x, y) — matches ops/grid_sample semantics."""
    h, w = img.shape[:2]
    x = (coord[..., 0] + 1) * 0.5 * (w - 1)
    y = (coord[..., 1] + 1) * 0.5 * (h - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, w - 1)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 1)
    x1, y1 = np.clip(x0 + 1, 0, w - 1), np.clip(y0 + 1, 0, h - 1)
    fx = np.clip(x - x0, 0, 1)[..., None]
    fy = np.clip(y - y0, 0, 1)[..., None]
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def make_learnable_tree(root: str, n_frames: int = 120, face: int = 64,
                        lip_h: int = 16, lip_w: int = 24, seed: int = 0,
                        fps: int = 25, sample_rate: int = 16000,
                        jpeg_quality: int = 98) -> Dict[str, Any]:
    """A synthetic identity that can actually be LEARNED (not memorized).

    Unlike ``make_synthetic_tree`` (random per-frame pixels, good for shape
    contracts), every artifact here is a smooth deterministic function of a
    3-d latent "speech" trajectory:

    - ``audio/audio.npy`` windows encode the latent at each window step
      through a fixed random linear map (+ noise floor), so the audio
      encoder can recover it;
    - ``images/`` lip crops render a parametric mouth driven by the latent;
    - ``warp_images/`` paste that lip into a fixed structured canonical
      face; ``ori_images_face/`` backward-warp it by a smooth per-frame
      ``coords/`` grid (frame 0 = identity = canonical pose);
    - the val tail samples the same process, so rising val PSNR measures
      generalization of the audio→lip mapping.
    """
    rng = np.random.default_rng(seed)
    for d in ("audio", "audio_test", "images", "warp_images",
              "ori_images_face", "coords", "landmarks"):
        os.makedirs(os.path.join(root, d), exist_ok=True)

    # --- audio windows: [N, 16, 29], window step t covers frame i + (t-8)/2
    proj = rng.standard_normal((3, 29)).astype(np.float64) * 0.8
    bias = rng.standard_normal((29,)) * 0.1

    def window(i):
        steps = i + (np.arange(16) - 8) / 2.0
        lat = _latent_track(steps)                       # [16, 3]
        clean = lat @ proj + bias                        # [16, 29]
        return (clean + 0.02 * rng.standard_normal((16, 29))).astype(
            np.float32)

    aud = np.stack([window(i) for i in range(n_frames)])
    np.save(os.path.join(root, "audio", "audio.npy"), aud)
    np.save(os.path.join(root, "audio_test", "audio.npy"),
            aud[: max(2, n_frames // 4)])

    # --- wav: the SAME latent modulates amplitude/pitch/brightness, so the
    # mel sync windows (crop_audio_window) carry real audio↔lip
    # correspondence — a constant tone would make the SyncNet contrastive
    # task unlearnable by construction (every mel window identical).
    dur = n_frames / fps + 1.0
    t = np.arange(int(dur * sample_rate)) / sample_rate
    wav_lat = _latent_track(t * fps)                     # [T, 3]
    amp = 0.18 + 0.14 * wav_lat[:, 0]                    # a0 = mouth opening
    f0 = 220.0 * (2.0 ** (0.6 * wav_lat[:, 1]))          # a1 = pitch
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    wav = (amp * np.sin(phase)
           + (0.06 + 0.04 * wav_lat[:, 2])
           * np.sin(2 * np.pi * 2800.0 * t)).astype(np.float32)
    from scipy.io import wavfile
    wavfile.write(os.path.join(root, "audio", "audio.wav"), sample_rate,
                  (wav * 32767).astype(np.int16))
    wavfile.write(os.path.join(root, "audio_test", "audio.wav"), sample_rate,
                  (wav[: len(wav) // 2] * 32767).astype(np.int16))

    lip_x = (face - lip_w) // 2
    lip_y = min(int(face * 0.6), face - lip_h - 4)
    base = _canonical_face_base(face, lip_x, lip_y, lip_h, lip_w, seed)
    ys, xs = np.meshgrid(np.linspace(-1, 1, face), np.linspace(-1, 1, face),
                         indexing="ij")
    ident = np.stack([xs, ys], -1).astype(np.float32)

    for i in range(n_frames):
        name = "{:05d}".format(i + 1)
        lat = _latent_track(np.array(float(i)))
        lip = _render_lip(lat, lip_h, lip_w)
        canonical = base.copy()
        canonical[lip_y:lip_y + lip_h, lip_x:lip_x + lip_w] = lip
        # smooth in-plane shift; frame 0 (canonical_idx) = identity pose
        shift = 0.0 if i == 0 else 0.03
        s = shift * lat[:2] * np.array([1.0, 0.7])
        coord = (ident + s[None, None, :].astype(np.float32))
        observed = _bilinear_sample(canonical, coord)

        for d, img in (("images", lip), ("warp_images", canonical),
                       ("ori_images_face", observed)):
            imwrite(os.path.join(root, d, name + ".jpg"),
                    (img * 255).round().astype(np.uint8), jpeg_quality)
        np.save(os.path.join(root, "coords", name + ".npy"),
                coord.astype(np.float32))
        lms = rng.uniform(0, face, (68, 2)).astype(np.float32)
        gx = np.linspace(lip_x + 2, lip_x + lip_w - 2, 20)
        gy = np.linspace(lip_y + 2, lip_y + lip_h - 2, 20)
        lms[48:] = np.stack([gx, gy], -1)
        np.savetxt(os.path.join(root, "landmarks", name + ".lms"), lms)

    lip_mask = np.zeros((face, face, 3), np.uint8)
    lip_mask[lip_y:lip_y + lip_h, lip_x:lip_x + lip_w] = 255
    imwrite(os.path.join(root, "canonical_lip_mask.jpg"), lip_mask)
    head = np.zeros((face, face, 3), np.uint8)
    head[4:-4, 4:-4] = 255
    imwrite(os.path.join(root, "canonical_head_mask.jpg"), head)
    fmask = np.zeros((face, face, 3), np.uint8)
    fmask[8:-8, 8:-8] = 255
    imwrite(os.path.join(root, "canonical_face_mask.jpg"), fmask)

    depth = np.full((face, face), 1.0, np.float32) \
        + 0.1 * np.exp(-((xs ** 2 + ys ** 2) / 0.5)).astype(np.float32)
    np.save(os.path.join(root, "depth_face_canonical.npy"), depth)

    # all frames share the canonical pose: the in-plane motion lives in the
    # coord grids, so the canonical-depth photometric term is consistent
    np.savez(os.path.join(root, "track_params.pt.npz"),
             euler=np.zeros((n_frames, 3), np.float32),
             trans=np.tile(np.array([[0, 0, 2.0]], np.float32),
                           (n_frames, 1)),
             focal=np.float32(face * 2.0))
    bbox = {"{:05d}.jpg".format(i + 1):
            np.array([4, 4, face - 4, face - 4, 1.0], np.float32)
            for i in range(n_frames)}
    np.save(os.path.join(root, "face_bbox_dict.npy"), bbox, allow_pickle=True)

    return {"n_frames": n_frames, "face": face, "lip_h": lip_h,
            "lip_w": lip_w, "lip_x": lip_x, "lip_y": lip_y,
            "focal": face * 2.0}


def synthetic_batch(n: int, face: int = 64, lip_h: int = 32, lip_w: int = 32,
                    seed: int = 0, with_sync: bool = False,
                    total_frames: int = 100) -> Dict[str, Any]:
    """A batch of ``n`` frames with the full sample-dict contract (numpy
    arrays), and its geometry {face, lip_h, lip_w, lip_x, lip_y, focal}."""
    rng = np.random.default_rng(seed)
    lip_x = (face - lip_w) // 2
    lip_y = min(int(face * 0.6), face - lip_h - 4)
    mask = np.zeros((n, face, face, 3), np.float32)
    mask[:, lip_y:lip_y + lip_h, lip_x:lip_x + lip_w] = 1.0
    ys, xs = np.meshgrid(np.linspace(-1, 1, face), np.linspace(-1, 1, face),
                         indexing="ij")
    coord = np.broadcast_to(
        np.stack([xs, ys], -1)[None], (n, face, face, 2)).astype(np.float32)
    head = np.zeros((n, face, face, 1), np.float32)
    head[:, 4:-4, 4:-4] = 1.0
    fmask = np.zeros((n, face, face, 3), np.float32)
    fmask[:, 8:-8, 8:-8] = 1.0
    batch = {
        "audio": rng.standard_normal((n, 16, 29)).astype(np.float32),
        "index": np.arange(n, dtype=np.int32),
        "total_frame": np.full((n,), total_frames, np.int32),
        "rgb": rng.uniform(0, 1, (n, lip_h, lip_w, 3)).astype(np.float32),
        "rgb_face_zero": rng.uniform(0, 1, (n, face, face, 3)).astype(
            np.float32),
        "rgb_face_ori": rng.uniform(0, 1, (n, face, face, 3)).astype(
            np.float32),
        "mask_lip_canonical": mask,
        "coord": coord + 0.01 * rng.standard_normal((n, 1, 1, 2)).astype(
            np.float32),
        "euler": (0.05 * rng.standard_normal((n, 3))).astype(np.float32),
        "trans": np.concatenate([
            0.05 * rng.standard_normal((n, 2)),
            2 + 0.05 * rng.standard_normal((n, 1))], -1).astype(np.float32),
        "canonical_euler": np.zeros((n, 3), np.float32),
        "canonical_trans": np.tile(np.array([[0, 0, 2.0]], np.float32),
                                   (n, 1)),
        "mask_head_canonical": head,
        "mask_face_canonical": fmask,
    }
    if with_sync:
        batch.update({
            "mel": rng.standard_normal((n, 1, 80, 16)).astype(np.float32),
            "audio_window": rng.standard_normal((n, 5, 16, 29)).astype(
                np.float32),
            "coord_window": np.broadcast_to(
                coord[:, None], (n, 5, face, face, 2)).copy(),
            "rgb_window_neg": rng.uniform(0, 1, (n, 3, 5, 96, 96)).astype(
                np.float32),
        })
    geo = {"face": face, "lip_h": lip_h, "lip_w": lip_w,
           "lip_x": lip_x, "lip_y": lip_y, "focal": face * 2.0}
    return batch, geo


def synthetic_config(root: str, geo: Dict[str, Any]) -> Dict[str, Any]:
    """Config dict wired to a synthetic tree."""
    cfg = default_config()
    cfg["data"].update({
        "path": root,
        "width": geo["lip_w"],
        "height": geo["lip_h"],
        "face_img_focal": geo["focal"],
        "val_split_frames": max(1, geo["n_frames"] // 6),
    })
    cfg["model"].update({
        "canonical_depth_height": geo["face"],
        "canonical_depth_width": geo["face"],
        "canonical_depth_init_path": os.path.join(
            root, "depth_face_canonical.npy"),
    })
    cfg["training"]["batch_rays"] = geo["lip_h"] * geo["lip_w"]
    return cfg
