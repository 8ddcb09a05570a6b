"""Frame renderer: audio window -> composited face frame (counterpart of
``speech2lip_tpu/infer/renderer.py``).

Five stages per batch of frames: the audio encoder (once per frame), the
per-frame audio/time features, the lip MLP over the lip crop's pixels (K1),
the paste/blend composite with the windowed backward warp (K2), and the
post-fusion U-Net (five K3 blocks, ``unet_light.apply_infer``).
``use_kernels`` routes the three kernel stages through the kernel
wrappers, which launch their CUDA kernels on CUDA tensors and run their
plain versions on CPU tensors; ``use_kernels=False`` is the plain path of
the JAX package's XLA graph.

``FrontEnd`` is what the four serving front ends (``Renderer``,
``static_scene.StaticSceneRenderer``, ``pipeline.MultiSpeakerServer`` and
``pose_edit.PoseEditRenderer``) bind alike: device, path, dtype, cast
parameters and lip geometry.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from speech2lip_tpu_torch.core import spans
from speech2lip_tpu_torch.core.device import DTYPES, cast_tree, resolve_device
from speech2lip_tpu_torch.infer import graphs
from speech2lip_tpu_torch.models import talking_face as tf
from speech2lip_tpu_torch.models import unet_light
from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.ops.coords import get_coords
from speech2lip_tpu_torch.ops.embedders import fourier_embed, time_embed


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
                      window: Optional[tuple] = None,
                      stage=spans.span) -> Dict[str, Any]:
    """Full inference step for a batch of frames.

    batch: audio [B,16,29], index [B], rgb_face_zero / rgb_face_ori /
    mask_lip_canonical [B,H,W,3], coord [B,H,W,2], all tensors on one
    device.  ``window``: optional static (y0, x0, h, w) observed-space crop
    validated (data.windows.compute_warp_window) to hold every warped-lip
    pixel.  ``stage(name)``: the context each of the three stages runs in,
    its span, or the capture of its CUDA graph (``infer.graphs``).
    Returns {'lip': [B,lh,lw,3], 'face': [B,H,W,3]} float32.
    """
    with stage("render.lip"):
        rgb_lip = render_lip_batch(params, batch["audio"],
                                   batch["index"].float(), lip_h, lip_w,
                                   use_kernels=use_kernels,
                                   compute_dtype=compute_dtype)
    with stage("render.composite"):
        cast = lambda x: x.to(compute_dtype)
        unet_in, _, _ = tf.post_fusion_composite(
            cast(rgb_lip), cast(batch["rgb_face_zero"]),
            cast(batch["rgb_face_ori"]), cast(batch["mask_lip_canonical"]),
            batch["coord"].float(), lip_x, lip_y,
            expand_divisor=expand_divisor, window=window,
            use_kernels=use_kernels)
        unet_in = unet_in.to(compute_dtype)
    with stage("render.unet"):
        face = unet_light.apply_infer(unet_params, unet_state, unet_in,
                                      use_kernels).float()
    return {"lip": rgb_lip, "face": face}


class FrontEnd:
    """Base of the serving front ends: ``bind`` sets what they bind
    alike."""

    def bind(self, cfg: Dict[str, Any], trees, device=None,
             use_kernels: Optional[bool] = True,
             compute_dtype: Optional[torch.dtype] = None,
             kernel_dtype: Optional[torch.dtype] = None,
             plain_dtype: Optional[torch.dtype] = None):
        """Sets ``device`` (the card unless ``device`` names another),
        ``use_kernels`` (None: the card's default, the kernels there; a
        CUDA device serves no plain path, so False raises there before any
        tensor moves), ``compute_dtype`` (the override, else
        ``kernel_dtype`` with the kernels and ``plain_dtype`` without,
        each the config's ``model.compute_dtype`` where None) and the lip
        geometry; returns ``trees`` on the device in that dtype."""
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if use_kernels is None:
            use_kernels = on_card
        if on_card and not use_kernels:
            raise ValueError(f"{type(self).__name__}: a CUDA device runs "
                             "the kernels; use_kernels=False is for the CPU")
        self.use_kernels = bool(use_kernels)
        self.compute_dtype = (
            compute_dtype or (kernel_dtype if use_kernels else plain_dtype)
            or DTYPES[cfg["model"].get("compute_dtype", "float32")])
        d = cfg["data"]
        self.lip_h, self.lip_w = int(d["height"]), int(d["width"])
        self.expand_divisor = int(d.get("expand_mask_divisor", 5))
        return cast_tree(trees, self.device, self.compute_dtype)


class Renderer(FrontEnd):
    """Renderer bound to a config's geometry and a device.

    Runs on the card unless ``device`` names another.  Casts the float32
    parameters to ``model.compute_dtype`` once.  On a CUDA device every
    batch runs through the kernels K1, K2 and, where H and W are multiples
    of 4, K3 (``unet_light.apply_infer``); a kernel that fails raises:
    there is no fallback.  From the second consecutive batch of one shape
    on, the three stages replay CUDA graphs (``infer.graphs``), and the
    returned tensors are the caller's.  On the CPU the kernel wrappers run
    their plain versions.
    """

    def __init__(self, cfg: Dict[str, Any], params, unet_params, unet_state,
                 device=None, window: Optional[tuple] = None):
        self.params = self.bind(cfg, (params, unet_params, unet_state),
                                device)
        if window is None:
            window = cfg["data"].get("warp_window")
        self.window = tuple(window) if window is not None else None
        # each input's static buffer holds it in the dtype the batch's
        # first op casts it to (None: as given)
        cdt = self.compute_dtype
        self.staged = {"audio": None, "index": None, "rgb_face_zero": cdt,
                       "rgb_face_ori": cdt, "mask_lip_canonical": cdt,
                       "coord": torch.float32}
        self.graphs = graphs.StageGraphs(self.device)

    def __call__(self, batch: Dict[str, Any], lip_x: int, lip_y: int):
        p, up, us = self.params
        lip_x, lip_y = int(lip_x), int(lip_y)
        x = {k: batch[k] for k in self.staged}

        def body(stage, b):
            return render_face_batch(
                p, up, us, b, lip_x=lip_x, lip_y=lip_y, lip_h=self.lip_h,
                lip_w=self.lip_w, expand_divisor=self.expand_divisor,
                use_kernels=True, compute_dtype=self.compute_dtype,
                window=self.window, stage=stage)

        with spans.span("render"), torch.no_grad():
            return self.graphs(graphs.input_key(x, lip_x, lip_y), x,
                               self.staged, body)
