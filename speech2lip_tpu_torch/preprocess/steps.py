"""Preprocessing steps STEP0 and STEP3-STEP6 (counterpart of
``speech2lip_tpu/preprocess/steps.py``):

  crop_face           STEP0 fixed-window face crop
  mesh_depth          z-buffer depth of the posed 3DMM mesh (rasterized)
  warp_images         STEP3 every observed frame warped into the canonical
                      pose, batched over frames
  compute_uv_mapping  STEP4 per-frame observed -> canonical coord grids
  canonical_masks     STEP5 canonical depth, face mask (+ head mask from a
                      parsing map)
  crop_lip            STEP6 mouth box and lip crops

Arrays come in and go out as numpy; the work runs on ``device`` (the
assets' device unless named), float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from speech2lip_tpu_torch.data.dataset import compute_mouth_bbox
from speech2lip_tpu_torch.ops.geometry import (backproject_depth,
                                               intrinsics, pose_matrix,
                                               project_3d)
from speech2lip_tpu_torch.ops.grid_sample import grid_sample
from speech2lip_tpu_torch.ops.rasterize import rasterize
from speech2lip_tpu_torch.preprocess import face_3dmm as bfm

# frames a step warps or rasterizes at once
FRAME_CHUNK = 16


def crop_face(frame: np.ndarray, center_xy: Tuple[int, int],
              size: int = 500) -> np.ndarray:
    """Fixed-window square crop around a hand-picked centre."""
    cx, cy = center_xy
    half = size // 2
    y0, x0 = cy - half, cx - half
    return frame[y0:y0 + size, x0:x0 + size]


def mesh_depth(assets: bfm.BFMAssets, id_para, exp_para, euler, trans,
               focal: float, height: int, width: int,
               **raster_kwargs) -> torch.Tensor:
    """[B, H, W] z-buffer depth (-Z of the posed mesh; 0 where no face)."""
    geo = bfm.forward_geo(assets, id_para, exp_para)
    rott = bfm.rot_trans_pts(geo, bfm.euler2rot(euler), trans)
    pix = bfm.camera_pixels(rott, focal, height, width)
    frag = rasterize(pix, assets.tris, height, width, **raster_kwargs)
    return torch.where(torch.isfinite(frag.zbuf), frag.zbuf,
                       torch.zeros_like(frag.zbuf))


def _track(track: Dict[str, np.ndarray], device):
    get = lambda k: torch.as_tensor(np.asarray(track[k], np.float32),
                                    device=device)
    focal = float(track["focal"])
    return focal, get("id"), get("exp"), get("euler"), get("trans")


def _camera(focal: float, height: int, width: int, device):
    k = intrinsics(focal, height, width)
    return (torch.as_tensor(k, device=device),
            torch.as_tensor(np.linalg.pinv(k), device=device))


def _device(assets, device):
    return torch.device(device) if device is not None else assets.tris.device


def warp_images(track: Dict[str, np.ndarray], assets: bfm.BFMAssets,
                frames: np.ndarray, canonical_idx: int, height: int,
                width: int, device=None, **raster_kwargs) -> np.ndarray:
    """STEP3: each observed frame warped into the canonical pose, masked
    by the canonical face region.

    frames: [N, H, W, 3] float RGB in [0, 255] or [0, 1]."""
    dev = _device(assets, device)
    assets = bfm.assets_to(assets, dev)
    focal, id_p, exp, euler, trans = _track(track, dev)
    k, inv_k = _camera(focal, height, width, dev)
    c = slice(canonical_idx, canonical_idx + 1)
    can_depth = mesh_depth(assets, id_p, exp[c], euler[c], trans[c], focal,
                           height, width, **raster_kwargs)[0]
    t_can_inv = torch.linalg.inv(pose_matrix(euler[c], trans[c])[0])
    face_mask = (can_depth > 0).float()[..., None]
    cam = backproject_depth(can_depth, inv_k)
    out = []
    for s in range(0, frames.shape[0], FRAME_CHUNK):
        sl = slice(s, s + FRAME_CHUNK)
        t_rel = pose_matrix(euler[sl], trans[sl]) @ t_can_inv
        grid, _ = project_3d(cam, k, t_rel, height, width)
        img = torch.as_tensor(np.asarray(frames[sl], np.float32), device=dev)
        out.append((grid_sample(img, grid) * face_mask).cpu().numpy())
    return np.concatenate(out)


def compute_uv_mapping(track: Dict[str, np.ndarray], assets: bfm.BFMAssets,
                       canonical_idx: int, height: int, width: int,
                       n_frames: Optional[int] = None, device=None,
                       **raster_kwargs) -> np.ndarray:
    """STEP4: per-frame observed -> canonical backward-warp grids in
    [-1, 1], [N, H, W, 2] (the coords/%05d.npy contract)."""
    dev = _device(assets, device)
    assets = bfm.assets_to(assets, dev)
    focal, id_p, exp, euler, trans = _track(track, dev)
    k, inv_k = _camera(focal, height, width, dev)
    n = n_frames or exp.shape[0]
    c = slice(canonical_idx, canonical_idx + 1)
    t_can = pose_matrix(euler[c], trans[c])[0]
    out = []
    for s in range(0, n, FRAME_CHUNK):
        sl = slice(s, min(s + FRAME_CHUNK, n))
        nb = sl.stop - sl.start
        depth = mesh_depth(assets, id_p.expand(nb, -1), exp[sl], euler[sl],
                           trans[sl], focal, height, width, **raster_kwargs)
        t_rel = t_can @ torch.linalg.inv(pose_matrix(euler[sl], trans[sl]))
        for i in range(nb):
            grid, _ = project_3d(backproject_depth(depth[i], inv_k), k,
                                 t_rel[i], height, width)
            out.append(torch.clamp(grid, -1.0, 1.0).cpu().numpy())
    return np.stack(out)


def canonical_masks(track: Dict[str, np.ndarray], assets: bfm.BFMAssets,
                    canonical_idx: int, height: int, width: int,
                    parsing_map: Optional[np.ndarray] = None, device=None,
                    **raster_kwargs):
    """STEP5: canonical depth, face mask (+ the head mask decoded from a
    red-coded parsing colour map).

    Returns (depth [H, W], face_mask [H, W] bool, head_mask or None)."""
    dev = _device(assets, device)
    assets = bfm.assets_to(assets, dev)
    focal, id_p, exp, euler, trans = _track(track, dev)
    c = slice(canonical_idx, canonical_idx + 1)
    depth = mesh_depth(assets, id_p, exp[c], euler[c], trans[c], focal,
                       height, width, **raster_kwargs)[0].cpu().numpy()
    head_mask = None
    if parsing_map is not None:
        head_mask = ((parsing_map[:, :, 0] >= 200)
                     & (parsing_map[:, :, 1] <= 50)
                     & (parsing_map[:, :, 2] <= 50))
    return depth, depth > 0, head_mask


def mouth_bbox_from_landmarks(lms: np.ndarray, dst_w: int, dst_h: int,
                              center_y_ratio: float = 1.02):
    """Fixed-size mouth box from canonical landmarks 48+."""
    return compute_mouth_bbox(lms, dst_w, dst_h, center_y_ratio)


def crop_lip(warped_frames: np.ndarray, lms_canonical: np.ndarray,
             dst_w: int, dst_h: int, center_y_ratio: float = 1.02):
    """STEP6: lip mask and per-frame lip crops of the canonical-pose faces.

    Returns (crops [N, dst_h, dst_w, 3], lip_mask [H, W], (x, y))."""
    x, y, w, h = mouth_bbox_from_landmarks(lms_canonical, dst_w, dst_h,
                                           center_y_ratio)
    hh, ww = warped_frames.shape[1:3]
    mask = np.zeros((hh, ww), np.uint8)
    mask[y:y + h, x:x + w] = 255
    return warped_frames[:, y:y + h, x:x + w, :], mask, (x, y)
