"""Host-side warp-window computation (counterpart of
``speech2lip_tpu/data/windows.py:compute_warp_window``).

numpy only.  Scans coord grids once to find the minimal observed-space
window whose backward warp can touch the expanded lip rectangle: the
validation behind the composite's static-window fast path.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np


def _round_window(y0, x0, y1, x1, h, w,
                  align: int = 8) -> Tuple[int, int, int, int]:
    y0 = max(0, (y0 // align) * align)
    x0 = max(0, (x0 // align) * align)
    wh = min(h - y0, -(-(y1 - y0) // align) * align)
    ww = min(w - x0, -(-(x1 - x0) // align) * align)
    return int(y0), int(x0), int(wh), int(ww)


def compute_warp_window(coords: Iterable[np.ndarray],
                        box: Tuple[int, int, int, int],
                        height: int, width: int,
                        margin: int = 4,
                        align: int = 8) -> Optional[Tuple[int, int, int, int]]:
    """Minimal observed-space (y0, x0, h, w) window covering every pixel
    whose warp coordinate can touch the canonical-space rectangle ``box``.

    coords: [H, W, 2] canonical->observed grids in [-1, 1]; box: (x0, x1,
    y0, y1) half-open canonical-pixel bounds of the expanded lip rectangle
    (``models.talking_face.expanded_lip_box``); margin: extra pixels of
    slack on every side.  None if no pixel ever lands in the box.
    """
    x0b, x1b, y0b, y1b = box
    y_min, x_min = height, width
    y_max = x_max = -1
    for grid in coords:
        gx = ((grid[..., 0] + 1.0) * width - 1.0) * 0.5
        gy = ((grid[..., 1] + 1.0) * height - 1.0) * 0.5
        # a sample touches the box if either bilinear neighbour is inside
        inside = ((gx >= x0b - 1) & (gx <= x1b) &
                  (gy >= y0b - 1) & (gy <= y1b))
        if not inside.any():
            continue
        ys, xs = np.nonzero(inside)
        y_min = min(y_min, ys.min())
        y_max = max(y_max, ys.max())
        x_min = min(x_min, xs.min())
        x_max = max(x_max, xs.max())
    if y_max < 0:
        return None
    return _round_window(y_min - margin, x_min - margin,
                         y_max + 1 + margin, x_max + 1 + margin,
                         height, width, align)
