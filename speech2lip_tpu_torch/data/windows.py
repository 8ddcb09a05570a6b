"""Host-side warp-window computation (counterpart of
``speech2lip_tpu/data/windows.py``).

numpy only.  Scans coord grids once to find the minimal observed-space
window whose backward warp can touch the expanded lip rectangle: the
validation behind the composite's static-window fast path.
"""

from __future__ import annotations

import json
import os

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


def cached_warp_window(root: str, box: Tuple[int, int, int, int],
                       height: int, width: int, coords_iter_factory,
                       margin: int = 8) -> Optional[Tuple[int, int, int, int]]:
    """Compute-or-load the dataset's warp window, memoised at
    ``<root>/warp_window.json`` and keyed by the box, the geometry and the
    margin (the same file and key as the JAX package's).  The key has no
    field for the scan's protocol, so a file left by another scan of the
    same geometry is taken as it is (ROADMAP C)."""
    path = os.path.join(root, "warp_window.json")
    key = {"box": list(box), "h": height, "w": width, "margin": margin}
    if os.path.exists(path):
        try:
            with open(path) as f:
                rec = json.load(f)
            if rec.get("key") == key:
                win = rec.get("window")
                return tuple(win) if win is not None else None
        except (ValueError, KeyError):
            pass
    win = compute_warp_window(coords_iter_factory(), box, height, width,
                              margin=margin)
    try:
        with open(path, "w") as f:
            json.dump({"key": key,
                       "window": list(win) if win else None}, f)
    except OSError:
        pass
    return win


def validate_window(coords: Iterable[np.ndarray],
                    box: Tuple[int, int, int, int],
                    window: Tuple[int, int, int, int],
                    height: int, width: int) -> bool:
    """True iff ``window`` covers every pixel that can touch ``box``."""
    need = compute_warp_window(coords, box, height, width, margin=0, align=1)
    if need is None:
        return True
    y0, x0, wh, ww = window
    ny0, nx0, nh, nw = need
    return (y0 <= ny0 and x0 <= nx0
            and y0 + wh >= ny0 + nh and x0 + ww >= nx0 + nw)
