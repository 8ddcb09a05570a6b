"""Optical-flow visualisation with the Middlebury colour wheel (a copy of
``speech2lip_tpu/ops/flowviz.py``, numpy): ``flow_to_image`` and
``extract_flow`` (coord grid -> displacement field), for the trainer's
visualisation panels.
"""

from __future__ import annotations

import numpy as np

UNKNOWN_FLOW_THRESH = 1e7


def _make_color_wheel() -> np.ndarray:
    """[55, 3] Middlebury colour wheel."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] uint8 visualisation."""
    u = flow[:, :, 0].astype(np.float64).copy()
    v = flow[:, :, 1].astype(np.float64).copy()
    bad = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[bad] = 0
    v[bad] = 0
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max(-1.0, rad.max())
    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)

    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = k0 + 1
    k1[k1 == ncols + 1] = 1
    f = fk - k0
    img = np.zeros(u.shape + (3,), np.uint8)
    for i in range(3):
        col0 = _WHEEL[(k0 - 1) % ncols, i] / 255.0
        col1 = _WHEEL[(k1 - 1) % ncols, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[:, :, i] = np.floor(255 * col * (~bad)).astype(np.uint8)
    return img


def extract_flow(grid: np.ndarray) -> np.ndarray:
    """[B, H, W, 2] grid in [-1, 1] -> pixel displacement field."""
    _, h, w, _ = grid.shape
    px = (grid / 2.0 + 0.5).copy()
    px[..., 0] *= (w - 1)
    px[..., 1] *= (h - 1)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    cur = np.stack([xx, yy], -1)[None].astype(px.dtype)
    return px - cur
