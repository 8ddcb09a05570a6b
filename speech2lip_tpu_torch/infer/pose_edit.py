"""Controllable head-pose editing at inference (counterpart of
``speech2lip_tpu/infer/pose_edit.py``).

Render the canonical-space face, forward-splat it into a novel head pose
with the learned canonical depth (``ops/splat.py``), then refine it with
the post-fusion U-Net.  With ``use_kernels`` the lip runs through K1 and
the U-Net through ``unet_light.apply_infer`` as the ``Renderer`` serves it
(K3 where H and W are multiples of 4; the JAX function calls XLA's
``unet_light.apply(train=False)``, the same function); on CPU tensors the
kernel wrappers run their plain versions.  ``use_kernels=False`` is the
plain path.  The geometry and the splat run in float32.
``PoseEditRenderer`` binds it to cast parameters, as ``cli/infer
--change_pose`` serves it.
"""

from __future__ import annotations

import torch

from speech2lip_tpu_torch.infer.renderer import FrontEnd, render_lip_batch
from speech2lip_tpu_torch.models import talking_face as tf
from speech2lip_tpu_torch.models import unet_light
from speech2lip_tpu_torch.ops.geometry import (backproject_depth, intrinsics,
                                               pose_matrix, project_3d)
from speech2lip_tpu_torch.ops.splat import forward_splat_nearest


def edited_rel_pose(canonical_euler, canonical_trans, edit: str, index: int,
                    value: float) -> torch.Tensor:
    """T(edited) @ inv(T_canonical), where the edited pose is the canonical
    one with component ``index`` of its euler angles (``edit="euler"``) or
    of its translation (``"trans"``) set to ``value``.  euler, trans [3]
    or [B, 3] -> [4, 4] or [B, 4, 4]."""
    euler = torch.as_tensor(canonical_euler)
    trans = torch.as_tensor(canonical_trans)
    lead = euler.shape[:-1]
    euler, trans = euler.reshape(-1, 3), trans.reshape(-1, 3)
    new_euler, new_trans = euler.clone(), trans.clone()
    if edit == "euler":
        new_euler[:, index] = value
    elif edit == "trans":
        new_trans[:, index] = value
    else:
        raise ValueError(edit)
    rel = pose_matrix(new_euler, new_trans) @ torch.linalg.inv(
        pose_matrix(euler, trans))
    return rel.reshape(*lead, 4, 4)


def pose_flow(canonical_depth: torch.Tensor, rel_pose: torch.Tensor,
              focal: float):
    """The forward warp's splat inputs: each canonical pixel projected with
    its depth into the target views of rel_pose [B, 4, 4] (canonical ->
    target).  Returns (flow [B, H, W, 2] pixel displacements, z [B, H, W]
    target depth, inf where the canonical depth is 0)."""
    h, w = canonical_depth.shape
    dev = canonical_depth.device
    k = torch.from_numpy(intrinsics(focal, h, w)).to(dev)
    cam = backproject_depth(canonical_depth, torch.linalg.inv(k))
    grid, z = project_3d(cam, k, rel_pose.to(dev, torch.float32), h, w)
    # the grid is in [-1, 1]: pixel displacements for the splat
    tx = (grid[..., 0] / 2.0 + 0.5) * (w - 1)
    ty = (grid[..., 1] / 2.0 + 0.5) * (h - 1)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    flow = torch.stack([tx - xs, ty - ys], dim=-1)
    return flow, torch.where(canonical_depth > 0, z, torch.inf)


def forward_warp_to_pose(canonical_img: torch.Tensor,
                         canonical_depth: torch.Tensor,
                         rel_pose: torch.Tensor, focal: float) -> torch.Tensor:
    """Forward-splat canonical-space images into new poses: each canonical
    pixel with a depth > 0 is projected into the target view
    (``pose_flow``) and splatted to its nearest pixel with a min-z
    occlusion resolve.

    canonical_img [H, W, 3] or [B, H, W, 3]; canonical_depth [H, W] (the
    learned ``canonical_depth``); rel_pose [4, 4] or [B, 4, 4],
    canonical -> target.  Returns the images' shape."""
    single = canonical_img.dim() == 3
    if single:
        canonical_img, rel_pose = canonical_img[None], rel_pose[None]
    flow, z = pose_flow(canonical_depth, rel_pose, focal)
    valid = (canonical_depth > 0)[..., None]
    out = forward_splat_nearest(canonical_img * valid, flow, z)
    return out[0] if single else out


def render_pose_edited_batch(params, unet_params, unet_state, batch, *,
                             lip_x: int, lip_y: int, lip_h: int, lip_w: int,
                             focal: float, edit: str, axis: int, value: float,
                             compute_dtype=torch.float32,
                             use_kernels: bool = False) -> torch.Tensor:
    """Render the lip, paste it into the canonical face, forward-splat the
    canonical composite into the edited head pose (component ``axis`` of
    ``edit`` set to ``value``), then refine it with the U-Net.

    batch: audio, index, rgb_face_zero, mask_lip_canonical,
    canonical_euler, canonical_trans, tensors on one device.  params in
    ``compute_dtype`` except ``canonical_depth``, which the geometry reads
    in float32.  Returns [B, H, W, 3] float32 pose-edited faces."""
    rgb_lip = render_lip_batch(params, batch["audio"], batch["index"].float(),
                               lip_h, lip_w, use_kernels=use_kernels,
                               compute_dtype=compute_dtype)
    merged = tf.paste_lip(rgb_lip, batch["rgb_face_zero"].to(rgb_lip.dtype),
                          batch["mask_lip_canonical"].to(rgb_lip.dtype),
                          lip_x, lip_y)
    rel = edited_rel_pose(batch["canonical_euler"].float(),
                          batch["canonical_trans"].float(), edit, axis, value)
    warped = forward_warp_to_pose(merged.float(),
                                  params["canonical_depth"].float(), rel,
                                  focal).to(compute_dtype)
    return unet_light.apply_infer(unet_params, unet_state, warped,
                                  use_kernels).float()


class PoseEditRenderer(FrontEnd):
    """Renderer of pose-edited frames (``render_pose_edited_batch``),
    called like the ``Renderer``: built once with the parameters, the lip
    size (the dataset's, as the JAX CLI takes it) and the edit, then called
    with (batch, lip_x, lip_y).

    Runs on the card unless ``device`` names another.  Casts the float32
    parameters to ``model.compute_dtype`` once; the canonical depth stays
    float32 for the geometry.  Every batch runs through K1 and, where H
    and W are multiples of 4, K3; their wrappers run their plain versions
    on the CPU.
    """

    def __init__(self, cfg, params, unet_params, unet_state, *, lip_h: int,
                 lip_w: int, edit: str, axis: int, value: float,
                 device=None):
        self.params = self.bind(cfg, (params, unet_params, unet_state),
                                device)
        self.params[0]["canonical_depth"] = params["canonical_depth"].to(
            self.device, torch.float32)
        self.options = dict(lip_h=int(lip_h), lip_w=int(lip_w),
                            focal=float(cfg["data"]["face_img_focal"]),
                            edit=edit, axis=int(axis), value=float(value),
                            compute_dtype=self.compute_dtype)

    def _render(self, batch, lip_x: int, lip_y: int, use_kernels: bool):
        with torch.no_grad():
            return {"face": render_pose_edited_batch(
                *self.params, batch, lip_x=int(lip_x), lip_y=int(lip_y),
                use_kernels=use_kernels, **self.options)}

    def __call__(self, batch, lip_x: int, lip_y: int):
        return self._render(batch, lip_x, lip_y, True)

    def render_plain(self, batch, lip_x: int, lip_y: int):
        """The same batch with no kernel, on the same cast parameters: the
        reference the kernel path is held to.  It serves nothing."""
        return self._render(batch, lip_x, lip_y, False)
