"""In-memory synthetic batches (counterpart of
``speech2lip_tpu/data/synthetic.py:synthetic_batch``).

numpy only; the same arguments give the JAX package's arrays byte for
byte (tests/test_torch_data.py).  ``chip_smoke.py`` and the port's tests
build their inputs with it.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


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
