"""TalkingFace lip renderer (counterpart of
``speech2lip_tpu/models/talking_face.py``): the forward pieces, the
single-frame pixel render and the post-fusion composite, with the training
half's black-hole augmentation and differentiable window gather.

Parameters are the JAX package's tree (nested dicts/lists of tensors, see
``weights.from_jax``); images are NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch

from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.ops.embedders import fourier_embed, time_embed
from speech2lip_tpu_torch.ops.grid_sample import (grid_sample,
                                                  grid_sample_onehot,
                                                  warp_box_mask)
from speech2lip_tpu_torch.ops.kernels.fused_mlp import fused_mlp
from speech2lip_tpu_torch.ops.kernels.hat_sample import hat_sample
from speech2lip_tpu_torch.ops.kernels.window_sample import window_sample

AUDIO_CODE_DIM = 64
TIME_DIM = 20


def encode_audio(params, audio: torch.Tensor) -> torch.Tensor:
    """DeepSpeech window [B, 16, 29] -> 64-d audio code [B, 64]."""
    x = audio
    for conv_p in params["audio_enc"]["conv"]:
        x = tnn.leaky_relu(tnn.conv1d(conv_p, x, stride=2, padding=1), 0.02)
    x = x[:, 0, :]  # L collapsed 16->8->4->2->1
    x = tnn.leaky_relu(tnn.linear(params["audio_enc"]["fc"][0], x), 0.02)
    return tnn.linear(params["audio_enc"]["fc"][1], x)


def frame_feature(params, audio_code: torch.Tensor, t_index) -> tuple:
    """Per-frame constant trunk inputs (base [B, W], skip [B, W]) of one
    frame index (a scalar)."""
    t_index = torch.as_tensor(t_index, dtype=torch.float32,
                              device=audio_code.device)
    t_emb = time_embed(t_index, TIME_DIM)[None, :].to(audio_code.dtype)
    base = (tnn.linear(params["fc_audio"], audio_code)
            + tnn.linear(params["fc_time"], t_emb))
    skip = (tnn.linear(params["fc_audio_skip"], audio_code)
            + tnn.linear(params["fc_time_skip"], t_emb))
    return base, skip


def mlp_trunk(params, uv_emb: torch.Tensor, base: torch.Tensor,
              skip: torch.Tensor, skips=(4,)) -> torch.Tensor:
    """The 8-layer MLP-v2 trunk as plain ops.  uv_emb [..., 42]; base/skip
    broadcastable [..., W].  Returns rgb [..., 3]."""
    h = tnn.linear(params["fc_uv"], uv_emb) + base
    h_skip = None
    for i, layer in enumerate(params["trunk"]):
        h = tnn.relu(tnn.linear(layer, h))
        if i in skips:
            if h_skip is None:
                h_skip = tnn.linear(params["fc_uv_skip"], uv_emb) + skip
            h_skip, h = torch.broadcast_tensors(h_skip, h)
            h = torch.cat([h_skip, h], dim=-1)
    return tnn.linear(params["output"], h)


def mlp_trunk_kernel(params, uv_emb: torch.Tensor, base: torch.Tensor,
                     skip: torch.Tensor, skip_layer: int = 4) -> torch.Tensor:
    """The trunk through K1 (``fused_mlp``) for B frames over shared uv
    embeddings uv_emb [N, 42] in the weights' dtype; base/skip [B, W].
    Returns [B, N, 3] float32."""
    f32 = lambda t: t.float().contiguous()
    trunk = params["trunk"]
    return fused_mlp(
        uv_emb.contiguous(), f32(params["fc_uv"]["b"] + base),
        f32(params["fc_uv_skip"]["b"] + skip),
        params["fc_uv"]["w"].contiguous(),
        params["fc_uv_skip"]["w"].contiguous(),
        [l["w"].contiguous() for l in trunk], [f32(l["b"]) for l in trunk],
        params["output"]["w"].contiguous(), f32(params["output"]["b"]),
        skip_layer=skip_layer)


def render_pixels(params, coords: torch.Tensor, audio_code: torch.Tensor,
                  t_index, skips=(4,), use_kernels: bool = False):
    """RGB of one frame at uv coords [..., N, 2] in [0, 1] (leading axes,
    e.g. the 4-offset ensemble, fold into the rows); audio_code [1, 64].
    ``use_kernels`` runs the trunk through K1 with one frame (float32
    out); otherwise as plain ops in the working dtype."""
    uv_emb = fourier_embed(coords, 10)
    base, skip = frame_feature(params, audio_code, t_index)
    if use_kernels:
        flat = uv_emb.reshape(-1, uv_emb.shape[-1])
        out = mlp_trunk_kernel(params, flat.to(params["fc_uv"]["w"].dtype),
                               base, skip, skip_layer=skips[0])[0]
        return out.reshape(*uv_emb.shape[:-1], out.shape[-1])
    return mlp_trunk(params, uv_emb, base, skip, skips)


def paste_lip(rgb_lip, face, mask_lip, lip_x: int, lip_y: int):
    """Paste the lip crop [B, lh, lw, 3] into face [B, H, W, 3] at
    (lip_y, lip_x) and blend by the canonical lip mask."""
    _, lh, lw, _ = rgb_lip.shape
    padded = torch.zeros_like(face)
    padded[:, lip_y:lip_y + lh, lip_x:lip_x + lw] = rgb_lip.to(face.dtype)
    return mask_lip * padded + (1.0 - mask_lip) * face


def expanded_lip_box(lip_h: int, lip_w: int, lip_x: int, lip_y: int,
                     divisor: int = 5):
    """(x0, x1, y0, y1) half-open bounds of the expanded lip rectangle:
    rows [y-p, y+lh+2p), cols [x-p, x+lw+p), p = lip_w // divisor."""
    p = lip_w // divisor
    return (lip_x - p, lip_x + lip_w + p, lip_y - p, lip_y + lip_h + 2 * p)


def _sample_box_region(merged_canonical, grid_w, box, h: int, w: int,
                       use_kernels: bool = False,
                       pallas_gather: bool = False):
    """Sample the warped image over the window.  When the box plus a 1 px
    halo is interior, only the crop around the box is sampled: through the
    differentiable K7 sampler ``hat_sample`` when ``pallas_gather`` (its
    kernels when ``use_kernels``, else its plain versions), through K2
    (forward only) when ``use_kernels``, else through the one-hot
    contraction; otherwise a full-frame zeros-padded ``grid_sample``."""
    x0b, x1b, y0b, y1b = box
    if x0b - 1 >= 0 and y0b - 1 >= 0 and x1b + 1 <= w and y1b + 1 <= h:
        src = merged_canonical[:, y0b - 1:y1b + 1, x0b - 1:x1b + 1]
        bb, wh, ww, _ = grid_w.shape
        if pallas_gather:
            # K2 and K7 read the crop and the window in place
            out = hat_sample(src, grid_w, y0b - 1, x0b - 1, h, w,
                             kernels=use_kernels)
        elif use_kernels:
            # K2 reads the crop and the window in place: no copy of either
            out = window_sample(src, grid_w, y0b - 1, x0b - 1, h, w)
        else:
            out = grid_sample_onehot(src, grid_w.reshape(bb, wh * ww, 2),
                                     y0b - 1, x0b - 1, h, w)
        return out.reshape(bb, wh, ww, -1)
    return grid_sample(merged_canonical, grid_w)


def post_fusion_composite(rgb_lip, face_canonical, rgb_gt, mask_lip, coord,
                          lip_x: int, lip_y: int, expand_divisor: int = 5,
                          blackaug_noise: Optional[tuple] = None,
                          window: Optional[tuple] = None,
                          use_kernels: bool = False,
                          static_warp: Optional[tuple] = None,
                          pallas_gather: bool = False):
    """Composite the rendered lip into the observed-pose face.

    paste+blend in canonical space -> expanded box -> backward warp via
    ``coord`` -> closed-form binarized warped box mask -> optional
    black-hole augmentation -> blend with the observed face.

    Args:
      rgb_lip: [B, lh, lw, 3]; face_canonical/rgb_gt/mask_lip: [B, H, W, 3];
      coord: [B, H, W, 2] canonical->observed grid in [-1, 1];
      blackaug_noise: optional (noise1 [B,H,W,1], noise2 [B,H,W,1], apply)
        from ``train.losses.black_hole_noise`` and a bool (tensor);
      window: optional static (y0, x0, h, w) observed-space crop validated
        (data.windows.compute_warp_window) to hold every warped-lip pixel;
        without blackaug only that crop is warped, with it the full-frame
        warp carries no gradient and only the window's gather does;
      use_kernels: run the window gather through the CUDA kernels (K2, or
        K7 with ``pallas_gather``) rather than plain ops;
      static_warp: optional (warped_base [B,H,W,3], face_mask_obs
        [B,H,W,3]): the canonical face and its >0 mask warped by ``coord``
        ahead of time (both are dataset constants), used with ``window``
        in place of the blackaug branch's two full-frame warps;
      pallas_gather: sample the window through the differentiable K7
        sampler ``hat_sample``.
    Returns:
      (unet_input [B, H, W, 3], rgb_gt possibly noise-swapped,
       merged_canonical [B, H, W, 3]).
    """
    b, lh, lw, _ = rgb_lip.shape
    h, w = face_canonical.shape[1:3]
    merged_canonical = paste_lip(rgb_lip, face_canonical, mask_lip,
                                 lip_x, lip_y)
    box = expanded_lip_box(lh, lw, lip_x, lip_y, expand_divisor)

    if window is not None and blackaug_noise is None:
        wy0, wx0, wh, ww = window
        grid_w = coord[:, wy0:wy0 + wh, wx0:wx0 + ww]
        rgb_merged_w = _sample_box_region(merged_canonical, grid_w, box, h,
                                          w, use_kernels=use_kernels,
                                          pallas_gather=pallas_gather)
        mask_w = warp_box_mask(grid_w, box, h, w).to(rgb_merged_w.dtype)
        gt_w = rgb_gt[:, wy0:wy0 + wh, wx0:wx0 + ww]
        blended = mask_w * rgb_merged_w + (1.0 - mask_w) * gt_w
        unet_input = rgb_gt.clone()
        unet_input[:, wy0:wy0 + wh, wx0:wx0 + ww] = blended.to(rgb_gt.dtype)
        return unet_input, rgb_gt, merged_canonical

    if window is not None:
        # outside the window the warp samples canonical pixels outside the
        # expanded box, where merged_canonical == face_canonical: the
        # full-frame warp needs no gradient, only the window's gather does
        wy0, wx0, wh, ww = window
        if static_warp is not None:
            full = static_warp[0].to(merged_canonical.dtype)
        else:
            full = grid_sample(merged_canonical.detach(), coord)
        grid_w = coord[:, wy0:wy0 + wh, wx0:wx0 + ww]
        if pallas_gather:
            # the window view as it is: K2 and K7 read it in place
            win = hat_sample(merged_canonical, grid_w,
                             kernels=use_kernels).reshape(b, wh, ww, 3)
        else:
            win = grid_sample(merged_canonical, grid_w)
        rgb_merged = full.clone()
        rgb_merged[:, wy0:wy0 + wh, wx0:wx0 + ww] = win.to(full.dtype)
    else:
        rgb_merged = grid_sample(merged_canonical, coord)
    mask_warped = warp_box_mask(coord, box, h, w).to(rgb_merged.dtype)

    if blackaug_noise is not None:
        noise1, noise2, apply = blackaug_noise
        if static_warp is not None and window is not None:
            mask_face_obs = static_warp[1].to(rgb_merged.dtype)
        else:
            mask_face_obs = grid_sample(
                (face_canonical > 0).to(rgb_merged.dtype), coord)
            mask_face_obs = (mask_face_obs == 1).to(rgb_merged.dtype)
        # noise is 0 inside the face mask's holes, 1 elsewhere
        n1 = torch.where(mask_face_obs > 0, noise1, 1.0)
        n2 = torch.where(mask_face_obs > 0, noise2, 1.0)
        merged_aug = n1 * rgb_merged + (1 - n1) * rgb_gt
        gt_aug = n2 * rgb_gt + (1 - n2) * rgb_merged
        apply = torch.as_tensor(apply, device=rgb_merged.device)
        rgb_merged = torch.where(apply, merged_aug, rgb_merged)
        rgb_gt = torch.where(apply, gt_aug, rgb_gt)

    unet_input = mask_warped * rgb_merged + (1.0 - mask_warped) * rgb_gt
    return unet_input, rgb_gt, merged_canonical
