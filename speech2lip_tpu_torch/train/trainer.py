"""Static helpers of the trainer (counterpart of the ones in
``speech2lip_tpu/train/trainer.py``): the K7 gate and the two forms of the
canonical-depth loss's support, computed with numpy from the identity's
canonical masks.  The trainer itself (dataset, loop, checkpoints) is not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def resolve_pallas_gather(tr: Dict[str, Any], device) -> bool:
    """``pallas_gather``: true | false | 'auto' (default).  'auto' turns the
    K7 gathers on for bfloat16 training on a CUDA device at a per-host
    batch of 4 or more (the JAX package's gate reads "not the CPU" where
    this one reads "CUDA")."""
    pg = tr.get("pallas_gather", "auto")
    if isinstance(pg, str):
        if pg != "auto":
            raise ValueError(f"pallas_gather must be a bool or 'auto', "
                             f"got {pg!r}")
        return (torch.device(device).type == "cuda"
                and str(tr.get("compute_dtype", "float32")) == "bfloat16"
                and int(tr.get("batch_size", 1)) >= 4)
    return bool(pg)


def _support(mask_head, mask_face):
    """The loss mask head * (1 - face), [H, W, C], and its support."""
    m = np.asarray(mask_head, np.float32) * (
        1.0 - np.asarray(mask_face, np.float32))
    ys, xs = np.nonzero(m.max(axis=-1) > 0)
    return m, ys, xs


def depth_loss_box(mask_head, mask_face, max_pixels: int = 16384
                   ) -> Optional[Tuple[int, int, int, int]]:
    """Static bbox (x0, x1, y0, y1) of the loss mask's support, from the
    canonical head [H, W, 1|3] and face [H, W, 3] masks; None when the
    mask is empty or the box holds more than ``max_pixels`` pixels (then
    the points or full-frame path serves)."""
    _, ys, xs = _support(mask_head, mask_face)
    if ys.size == 0:
        return None
    box = (int(xs.min()), int(xs.max()) + 1, int(ys.min()), int(ys.max()) + 1)
    if (box[1] - box[0]) * (box[3] - box[2]) > max_pixels:
        return None
    return box


def depth_loss_points(mask_head, mask_face, rgb_face_zero, device="cpu"
                      ) -> Optional[Dict[str, torch.Tensor]]:
    """``frozen['depth_pts']`` of the canonical-depth points path: the S
    support pixels of the loss mask (xs, ys [S] int64), its values there
    (w [S, 3]) and the canonical face there (rgb_zero_pts [S, 3]), float32
    tensors on ``device``; None when the mask is empty."""
    tgt = np.asarray(rgb_face_zero, np.float32)
    m, ys, xs = _support(mask_head, mask_face)
    if ys.size == 0:
        return None
    m = np.broadcast_to(m, tgt.shape)
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                        device=device)
    return {"xs": put(xs, torch.int64), "ys": put(ys, torch.int64),
            "w": put(m[ys, xs], torch.float32),
            "rgb_zero_pts": put(tgt[ys, xs], torch.float32)}
