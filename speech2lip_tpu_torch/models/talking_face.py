"""TalkingFace lip renderer, inference half (counterpart of
``speech2lip_tpu/models/talking_face.py``).

Parameters are the JAX package's tree (nested dicts/lists of tensors, see
``weights.from_jax``); images are NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch

from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.ops.embedders import time_embed
from speech2lip_tpu_torch.ops.grid_sample import (grid_sample,
                                                  grid_sample_onehot,
                                                  warp_box_mask)

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
                       use_kernels: bool = False):
    """Sample the warped image over the window.  When the box plus a 1 px
    halo is interior, only the crop around the box is sampled (K2 when
    ``use_kernels``, else the one-hot contraction); otherwise a full-frame
    zeros-padded ``grid_sample``."""
    x0b, x1b, y0b, y1b = box
    if x0b - 1 >= 0 and y0b - 1 >= 0 and x1b + 1 <= w and y1b + 1 <= h:
        src = merged_canonical[:, y0b - 1:y1b + 1, x0b - 1:x1b + 1]
        bb, wh, ww, _ = grid_w.shape
        flat = grid_w.reshape(bb, wh * ww, 2)
        if use_kernels:
            from speech2lip_tpu_torch.ops.kernels.window_sample import \
                window_sample
            out = window_sample(src.contiguous(), flat.contiguous(),
                                y0b - 1, x0b - 1, h, w)
        else:
            out = grid_sample_onehot(src, flat, y0b - 1, x0b - 1, h, w)
        return out.reshape(bb, wh, ww, -1)
    return grid_sample(merged_canonical, grid_w)


def post_fusion_composite(rgb_lip, face_canonical, rgb_gt, mask_lip, coord,
                          lip_x: int, lip_y: int, expand_divisor: int = 5,
                          window: Optional[tuple] = None,
                          use_kernels: bool = False):
    """Composite the rendered lip into the observed-pose face (inference:
    no black-hole augmentation).

    paste+blend in canonical space -> expanded box -> backward warp via
    ``coord`` -> closed-form binarized warped box mask -> blend with the
    observed face.  With a validated static ``window`` (y0, x0, h, w) only
    that observed-space crop is warped; ``window=None`` warps the full frame.

    Returns (unet_input [B, H, W, 3], rgb_gt, merged_canonical).
    """
    _, lh, lw, _ = rgb_lip.shape
    h, w = face_canonical.shape[1:3]
    merged_canonical = paste_lip(rgb_lip, face_canonical, mask_lip,
                                 lip_x, lip_y)
    box = expanded_lip_box(lh, lw, lip_x, lip_y, expand_divisor)

    if window is not None:
        wy0, wx0, wh, ww = window
        grid_w = coord[:, wy0:wy0 + wh, wx0:wx0 + ww]
        rgb_merged_w = _sample_box_region(merged_canonical, grid_w, box, h,
                                          w, use_kernels=use_kernels)
        mask_w = warp_box_mask(grid_w, box, h, w).to(rgb_merged_w.dtype)
        gt_w = rgb_gt[:, wy0:wy0 + wh, wx0:wx0 + ww]
        blended = mask_w * rgb_merged_w + (1.0 - mask_w) * gt_w
        unet_input = rgb_gt.clone()
        unet_input[:, wy0:wy0 + wh, wx0:wx0 + ww] = blended.to(rgb_gt.dtype)
        return unet_input, rgb_gt, merged_canonical

    rgb_merged = grid_sample(merged_canonical, coord)
    mask_warped = warp_box_mask(coord, box, h, w).to(rgb_merged.dtype)
    unet_input = mask_warped * rgb_merged + (1.0 - mask_warped) * rgb_gt
    return unet_input, rgb_gt, merged_canonical
