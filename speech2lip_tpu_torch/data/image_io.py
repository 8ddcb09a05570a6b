"""Image I/O of the port: JPEG decode and encode, and the uint8 resize of
the sync-loss window (counterparts of ``speech2lip_tpu/data/dataset.py``
``_imread_float`` and the ``cv2.imwrite`` calls of ``core/metrics.py``,
``cli/infer.py`` and ``data/synthetic.py``).

The codec is OpenCV (``cv2``), the JAX package's own, on the CPU and on the
GPU machine alike, so the port decodes the same pixels.  ``cv2`` is
imported inside each function, never when this module is imported; where
it is missing the call raises ImportError, and no other decoder stands in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def imread_float(path: str, resize_hw: Optional[Tuple[int, int]] = None
                 ) -> np.ndarray:
    """The image at ``path`` as float32 RGB [H, W, 3] in [0, 1]; with
    ``resize_hw`` (h, w) resized bilinearly on uint8 first (cv2's
    INTER_LINEAR)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if resize_hw is not None:
        img = cv2.resize(img, (resize_hw[1], resize_hw[0]))
    return img.astype(np.float32) / 255.0


def imwrite(path: str, rgb: np.ndarray, quality: Optional[int] = None):
    """Write uint8 RGB [H, W, 3] (JPEG by the extension; ``quality`` is the
    JPEG quality, cv2's default 95 when None).  Raises when nothing was
    written."""
    import cv2
    params = [] if quality is None else [cv2.IMWRITE_JPEG_QUALITY,
                                         int(quality)]
    bgr = cv2.cvtColor(np.ascontiguousarray(rgb, np.uint8),
                       cv2.COLOR_RGB2BGR)
    if not cv2.imwrite(path, bgr, params):
        raise OSError(f"could not write {path}")


def to_uint8(img) -> np.ndarray:
    """A float image in [0, 1] as uint8, rounded as the writers of the JAX
    package's inference CLI round it."""
    return (np.clip(np.asarray(img, np.float32), 0, 1) * 255).round(
    ).astype(np.uint8)
