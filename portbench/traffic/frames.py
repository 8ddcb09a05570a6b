"""An identity's frames made on the device from a seed: the general
generator of the serving mixes.

A frame holds what a preprocessed identity gives the renderer
(``infer/renderer.render_face_batch``'s batch): the canonical face
``rgb_face_zero``, the observed face ``rgb_face_ori``, the canonical lip
mask and the canonical-to-observed ``coord`` grid, with a DeepSpeech window
[16, 29] of audio.  The head moves smoothly: each frame's grid is the
identity grid scaled, rotated and shifted by sinusoids of fixed amplitudes
and periods whose phases come from the seed.  The amplitudes and periods
are the mix's, so every seed sweeps the same extent (the same warp window
and the same work) in another order.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F


def identity_grid(face: int, device) -> torch.Tensor:
    """[face, face, 2] grid of (x, y) on ``linspace(-1, 1, face)``, as the
    preprocessing writes a still head's grid."""
    t = torch.linspace(-1.0, 1.0, face, device=device)
    ys, xs = torch.meshgrid(t, t, indexing="ij")
    return torch.stack([xs, ys], -1)


def canonical_face(face: int, gen: torch.Generator, device) -> torch.Tensor:
    """A smooth face-like image [face, face, 3] in [0, 1]: a vertical
    shade and low-frequency colour noise upsampled from 12 x 12."""
    low = torch.rand(1, 3, 12, 12, generator=gen, device=device)
    img = F.interpolate(low, size=(face, face), mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0)
    ys = torch.linspace(0.0, 1.0, face, device=device)[:, None, None]
    base = torch.tensor([0.85, 0.62, 0.55], device=device)
    return (0.6 * base * (1.0 - 0.2 * ys) + 0.4 * img).clamp(0.0, 1.0)


def motion_grids(n: int, face: int, motion: Dict[str, Any],
                 gen: torch.Generator, device) -> torch.Tensor:
    """[n, face, face, 2] grids of a smoothly moving head at ``fps``:
    scale 1 + s sin, rotation r sin, shift (tx sin, ty sin), each term
    with its period (seconds) and a phase drawn from ``gen``."""
    fps = float(motion["fps"])
    amp = motion["amplitude"]      # {scale, rotate, shift_x, shift_y}
    per = motion["period_s"]
    keys = ("scale", "rotate", "shift_x", "shift_y")
    phase = 2 * math.pi * torch.rand(len(keys), generator=gen,
                                     device=device)
    t = torch.arange(n, device=device, dtype=torch.float32) / fps
    v = {k: float(amp[k]) * torch.sin(2 * math.pi * t / float(per[k])
                                      + phase[i])
         for i, k in enumerate(keys)}
    s = (1.0 + v["scale"])[:, None, None]
    c, sn = torch.cos(v["rotate"])[:, None, None], \
        torch.sin(v["rotate"])[:, None, None]
    g = identity_grid(face, device)
    x, y = g[..., 0][None], g[..., 1][None]
    gx = s * (c * x - sn * y) + v["shift_x"][:, None, None]
    gy = s * (sn * x + c * y) + v["shift_y"][:, None, None]
    return torch.stack([gx, gy], -1).contiguous()


def warp(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img [H, W, 3] sampled at grid [n, H, W, 2] (bilinear, zeros)."""
    src = img.permute(2, 0, 1)[None].expand(grid.shape[0], -1, -1, -1)
    return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False).permute(0, 2, 3, 1)


def lip_mask(face: int, lip: Dict[str, int], device) -> torch.Tensor:
    m = torch.zeros(face, face, 3, device=device)
    m[lip["y"]:lip["y"] + lip["h"], lip["x"]:lip["x"] + lip["w"]] = 1.0
    return m


def warp_window(coords: torch.Tensor, box: Tuple[int, int, int, int],
                margin: int = 8, align: int = 8
                ) -> Tuple[int, int, int, int]:
    """The observed-space (y0, x0, h, w) window holding every pixel whose
    warp can touch the canonical rectangle ``box`` = (x0, x1, y0, y1),
    widened by ``margin`` and aligned to ``align`` (the preprocessing's
    ``warp_window.json`` rule: a sample touches the box if either bilinear
    neighbour is inside)."""
    n, h, w, _ = coords.shape
    x0b, x1b, y0b, y1b = box
    gx = ((coords[..., 0] + 1.0) * w - 1.0) * 0.5
    gy = ((coords[..., 1] + 1.0) * h - 1.0) * 0.5
    inside = ((gx >= x0b - 1) & (gx <= x1b) & (gy >= y0b - 1)
              & (gy <= y1b)).any(0)
    ys, xs = torch.nonzero(inside, as_tuple=True)
    if ys.numel() == 0:
        raise ValueError("no pixel of any frame reaches the lip box")
    y0 = int(ys.min()) - margin
    x0 = int(xs.min()) - margin
    y1 = int(ys.max()) + 1 + margin
    x1 = int(xs.max()) + 1 + margin
    y0 = max(0, (y0 // align) * align)
    x0 = max(0, (x0 // align) * align)
    wh = min(h - y0, -(-(y1 - y0) // align) * align)
    ww = min(w - x0, -(-(x1 - x0) // align) * align)
    return y0, x0, wh, ww


def expanded_lip_box(lip: Dict[str, int], divisor: int = 5):
    """(x0, x1, y0, y1) of the composite's expanded lip rectangle."""
    p = lip["w"] // divisor
    return (lip["x"] - p, lip["x"] + lip["w"] + p, lip["y"] - p,
            lip["y"] + lip["h"] + 2 * p)


def make_identity(seed_gen: torch.Generator, n_frames: int, pad: int,
                  geo: Dict[str, Any], motion: Dict[str, Any], device
                  ) -> Dict[str, torch.Tensor]:
    """The frames of one identity on ``device``, float32: ``n_frames``
    frames and ``pad`` more repeating the first ones, so that every run of
    consecutive frames is a view."""
    face = int(geo["face"])
    lip = geo["lip"]
    can = canonical_face(face, seed_gen, device)
    coord = motion_grids(n_frames, face, motion, seed_gen, device)
    audio = torch.randn(n_frames, 16, 29, generator=seed_gen, device=device)
    idx = torch.arange(n_frames + pad, device=device) % n_frames
    out = {"coord": coord[idx], "audio": audio[idx],
           "index": idx.to(torch.int32)}
    obs = torch.empty(n_frames + pad, face, face, 3, device=device)
    for i in range(0, n_frames + pad, 64):
        obs[i:i + 64] = warp(can, out["coord"][i:i + 64])
    out["rgb_face_ori"] = obs
    out["rgb_face_zero"] = can[None].expand(n_frames + pad, -1, -1,
                                            -1).contiguous()
    out["mask_lip_canonical"] = lip_mask(face, lip, device)[None].expand(
        n_frames + pad, -1, -1, -1).contiguous()
    return out
