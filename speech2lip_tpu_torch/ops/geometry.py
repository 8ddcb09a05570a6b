"""Rigid-pose and pinhole-projection geometry (counterpart of
``speech2lip_tpu/ops/geometry.py``).

The canonical-depth photometric loss backprojects the learned canonical
depth, moves the points into the observed pose and projects them into a
sampling grid.  Poses are batched over leading axes; points are [4, N]
homogeneous columns.  ``project_3d`` normalises pixels by (size - 1) and
its grid then feeds samplers that use align_corners=False: the reference's
convention, kept as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from speech2lip_tpu_torch.ops.grid_sample import grid_sample


def euler2rot(euler: torch.Tensor) -> torch.Tensor:
    """[B, 3] euler angles (theta, phi, psi) -> [B, 3, 3] rotation
    Rx @ Ry @ Rz, each built from column vectors."""
    theta, phi, psi = euler[:, 0], euler[:, 1], euler[:, 2]
    one = torch.ones_like(theta)
    zero = torch.zeros_like(theta)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    cs, ss = torch.cos(psi), torch.sin(psi)

    def cols(*vecs):
        return torch.stack([torch.stack(v, -1) for v in vecs], -1)

    rot_x = cols((one, zero, zero), (zero, ct, st), (zero, -st, ct))
    rot_y = cols((cp, zero, -sp), (zero, one, zero), (sp, zero, cp))
    rot_z = cols((cs, -ss, zero), (ss, cs, zero), (zero, zero, one))
    return rot_x @ rot_y @ rot_z


def pose_matrix(euler: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """[B, 3] euler + [B, 3] trans -> [B, 4, 4] camera transform, with the
    sign flips on components 1 and 2 of both."""
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=euler.dtype,
                        device=euler.device)
    rot = euler2rot(euler * flip)
    top = torch.cat([rot, (trans * flip)[..., None]], dim=-1)   # [B, 3, 4]
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=euler.dtype,
                          device=euler.device).expand(euler.shape[0], 1, 4)
    return torch.cat([top, bottom], dim=1)


def rel_pose_can2obs(canonical_euler, canonical_trans, euler, trans):
    """T_obs @ inv(T_canonical)."""
    t_can = pose_matrix(canonical_euler, canonical_trans)
    return pose_matrix(euler, trans) @ torch.linalg.inv(t_can)


def rel_pose_obs2can(canonical_euler, canonical_trans, euler, trans):
    """inv(T_obs @ inv(T_canonical))."""
    return torch.linalg.inv(
        rel_pose_can2obs(canonical_euler, canonical_trans, euler, trans))


def intrinsics(focal: float, height: int, width: int) -> np.ndarray:
    """4x4 K matrix with the principal point at the image centre."""
    return np.array([
        [focal, 0.0, width / 2.0, 0.0],
        [0.0, focal, height / 2.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ], dtype=np.float32)


def _pixels(xs, ys, dtype):
    return torch.stack([xs.to(dtype), ys.to(dtype),
                        torch.ones_like(xs, dtype=dtype)], dim=0)  # [3, N]


def backproject_depth(depth: torch.Tensor, inv_k: torch.Tensor):
    """Depth [H, W] -> homogeneous camera-space points [4, H*W]."""
    h, w = depth.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=depth.dtype, device=depth.device),
        torch.arange(w, dtype=depth.dtype, device=depth.device),
        indexing="ij")
    cam = inv_k[:3, :3] @ _pixels(xs.reshape(-1), ys.reshape(-1),
                                  depth.dtype)
    cam = depth.reshape(1, -1) * cam
    return torch.cat([cam, torch.ones_like(cam[:1])], dim=0)


def _project(cam2, height: int, width: int, eps: float = 1e-7):
    """[..., 3, N] camera points -> grid [..., N, 2] in [-1, 1]."""
    z = cam2[..., 2, :]
    pix = cam2[..., :2, :] / (z[..., None, :] + eps)
    gx = pix[..., 0, :] / (width - 1)
    gy = pix[..., 1, :] / (height - 1)
    return torch.stack([(gx - 0.5) * 2.0, (gy - 0.5) * 2.0], dim=-1), z


def project_3d(points: torch.Tensor, k: torch.Tensor, t: torch.Tensor,
               height: int, width: int, eps: float = 1e-7):
    """Project homogeneous points [4, H*W] through k [4, 4] and poses t
    [..., 4, 4].  Returns (grid [..., H, W, 2], z [..., H, W])."""
    cam2 = (k @ t)[..., :3, :] @ points
    grid, z = _project(cam2, height, width, eps)
    lead = grid.shape[:-2]
    return (grid.reshape(*lead, height, width, 2),
            z.reshape(*lead, height, width))


def warp_grid_crop(depth: torch.Tensor, rel_pose: torch.Tensor,
                   k: torch.Tensor, inv_k: torch.Tensor, box,
                   height: int, width: int) -> torch.Tensor:
    """``backproject_depth`` + ``project_3d`` restricted to the static crop
    box = (x0, x1, y0, y1) of the target plane, for poses rel_pose
    [..., 4, 4].  Returns grid [..., y1-y0, x1-x0, 2]."""
    x0, x1, y0, y1 = box
    ys, xs = torch.meshgrid(
        torch.arange(y0, y1, dtype=depth.dtype, device=depth.device),
        torch.arange(x0, x1, dtype=depth.dtype, device=depth.device),
        indexing="ij")
    grid = warp_grid_points(depth[y0:y1, x0:x1].reshape(-1), xs.reshape(-1),
                            ys.reshape(-1), rel_pose, k, inv_k, height, width)
    return grid.reshape(*grid.shape[:-2], y1 - y0, x1 - x0, 2)


def warp_grid_points(depth_pts: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor, rel_pose: torch.Tensor,
                     k: torch.Tensor, inv_k: torch.Tensor, height: int,
                     width: int, eps: float = 1e-7) -> torch.Tensor:
    """``backproject_depth`` + ``project_3d`` at S target pixels (xs, ys)
    with depth depth_pts [S], for poses rel_pose [..., 4, 4].  Returns
    grid [..., S, 2]."""
    dt = depth_pts.dtype
    cam = inv_k[:3, :3].to(dt) @ _pixels(xs, ys, dt)
    cam = depth_pts[None, :] * cam
    points = torch.cat([cam, torch.ones_like(cam[:1])], dim=0)
    grid, _ = _project((k @ rel_pose)[..., :3, :].to(dt) @ points, height,
                       width, eps)
    return grid


def inverse_warp(src_img: torch.Tensor, tgt_depth: torch.Tensor,
                 rel_pose: torch.Tensor, k: torch.Tensor,
                 inv_k: torch.Tensor):
    """Backward-warp src_img [B, H, W, C] into the target views of poses
    rel_pose [B, 4, 4] given the target depth [H, W], border padding.
    Returns (warped [B, H, W, C], z [B, H, W])."""
    h, w = tgt_depth.shape
    grid, z = project_3d(backproject_depth(tgt_depth, inv_k), k, rel_pose,
                         h, w)
    return grid_sample(src_img, grid, padding_mode="border"), z
