"""Frame renderer: audio window -> composited face frame (counterpart of
``speech2lip_tpu/infer/renderer.py``).

Five stages per batch of frames: the audio encoder (once per frame), the
per-frame audio/time features, the lip MLP over the lip crop's pixels (K1),
the paste/blend composite with the windowed backward warp (K2), and the
post-fusion U-Net (five K3 blocks).  ``use_kernels`` routes the three
kernel stages through the kernel wrappers, which launch their CUDA kernels
on CUDA tensors and run their plain versions on CPU tensors;
``use_kernels=False`` is the plain path of the JAX package's XLA graph.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from speech2lip_tpu_torch.models import talking_face as tf
from speech2lip_tpu_torch.models import unet_light
from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.ops.coords import get_coords
from speech2lip_tpu_torch.ops.embedders import fourier_embed, time_embed

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def batched_frame_feature(params, audio_codes, t_indices):
    """audio_codes [B, 64], t_indices [B] -> (base [B, W], skip [B, W])."""
    t_emb = time_embed(t_indices.float(), tf.TIME_DIM).to(audio_codes.dtype)
    base = (tnn.linear(params["fc_audio"], audio_codes)
            + tnn.linear(params["fc_time"], t_emb))
    skip = (tnn.linear(params["fc_audio_skip"], audio_codes)
            + tnn.linear(params["fc_time_skip"], t_emb))
    return base, skip


def render_lip_batch(params, audio, t_indices, height: int, width: int,
                     use_kernels: bool = False, compute_dtype=torch.float32):
    """Canonical lip crops of a batch of frames (eval path, no ensemble).

    audio [B, 16, 29]; t_indices [B].  Returns [B, height, width, 3]
    float32."""
    codes = tf.encode_audio(params, audio.to(compute_dtype))
    base, skip = batched_frame_feature(params, codes, t_indices)
    coords = get_coords(width, height, dtype=compute_dtype,
                        device=audio.device)
    uv_emb = fourier_embed(coords, 10)  # [N, 42]
    if use_kernels:
        out = tf.mlp_trunk_kernel(params, uv_emb, base, skip)
    else:
        out = tf.mlp_trunk(params, uv_emb[None], base[:, None, :],
                           skip[:, None, :])
    return out.reshape(out.shape[0], height, width, 3).float()


def render_face_batch(params, unet_params, unet_state, batch: Dict[str, Any],
                      *, lip_x: int, lip_y: int, lip_h: int, lip_w: int,
                      expand_divisor: int = 5, use_kernels: bool = False,
                      compute_dtype=torch.float32,
                      window: Optional[tuple] = None) -> Dict[str, Any]:
    """Full inference step for a batch of frames.

    batch: audio [B,16,29], index [B], rgb_face_zero / rgb_face_ori /
    mask_lip_canonical [B,H,W,3], coord [B,H,W,2], all tensors on one
    device.  ``window``: optional static (y0, x0, h, w) observed-space crop
    validated (data.windows.compute_warp_window) to hold every warped-lip
    pixel.  Returns {'lip': [B,lh,lw,3], 'face': [B,H,W,3]} float32.
    """
    rgb_lip = render_lip_batch(params, batch["audio"], batch["index"].float(),
                               lip_h, lip_w, use_kernels=use_kernels,
                               compute_dtype=compute_dtype)
    cast = lambda x: x.to(compute_dtype)
    unet_in, _, _ = tf.post_fusion_composite(
        cast(rgb_lip), cast(batch["rgb_face_zero"]),
        cast(batch["rgb_face_ori"]), cast(batch["mask_lip_canonical"]),
        batch["coord"].float(), lip_x, lip_y, expand_divisor=expand_divisor,
        window=window, use_kernels=use_kernels)
    unet_in = unet_in.to(compute_dtype)
    if use_kernels:
        face = unet_light.apply_infer_fused(unet_params, unet_state, unet_in)
    else:
        face, _ = unet_light.apply(unet_params, unet_state, unet_in)
    return {"lip": rgb_lip, "face": face.float()}


class Renderer:
    """Renderer bound to a config's geometry and a device.

    Casts the float32 parameters to ``model.compute_dtype`` once.  On a
    CUDA device every batch runs through the kernels K1-K3 and a kernel
    that fails raises: there is no fallback.  On the CPU the kernel
    wrappers run their plain versions.
    """

    def __init__(self, cfg: Dict[str, Any], params, unet_params, unet_state,
                 device=None, window: Optional[tuple] = None):
        d = cfg["data"]
        self.lip_h = int(d["height"])
        self.lip_w = int(d["width"])
        self.expand_divisor = int(d.get("expand_mask_divisor", 5))
        if window is None:
            window = d.get("warp_window")
        self.window = tuple(window) if window is not None else None
        self.compute_dtype = _DTYPES[cfg["model"].get("compute_dtype",
                                                      "float32")]
        self.device = torch.device(device if device is not None else "cpu")

        def cast(tree):
            if isinstance(tree, dict):
                return {k: cast(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [cast(v) for v in tree]
            t = tree.to(self.device)
            return t.to(self.compute_dtype) if t.dtype == torch.float32 else t

        self.params = (cast(params), cast(unet_params), cast(unet_state))

    def __call__(self, batch: Dict[str, Any], lip_x: int, lip_y: int):
        p, up, us = self.params
        with torch.no_grad():
            return render_face_batch(
                p, up, us, batch, lip_x=int(lip_x), lip_y=int(lip_y),
                lip_h=self.lip_h, lip_w=self.lip_w,
                expand_divisor=self.expand_divisor, use_kernels=True,
                compute_dtype=self.compute_dtype, window=self.window)
