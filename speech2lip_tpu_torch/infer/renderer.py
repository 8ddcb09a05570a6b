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

from speech2lip_tpu_torch.core import spans
from speech2lip_tpu_torch.infer import graphs
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
        if use_kernels:
            face = unet_light.apply_infer_fused(unet_params, unet_state,
                                                unet_in)
        else:
            face, _ = unet_light.apply(unet_params, unet_state, unet_in)
        face = face.float()
    return {"lip": rgb_lip, "face": face}


def resolve_device(device=None) -> torch.device:
    """The device a renderer runs on: the card unless the caller names
    another (``device="cpu"``); raises when the card is asked for and
    there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return device


def cast_tree(tree, device, dtype):
    """The tree's tensors on ``device``, float32 leaves cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_tree(v, device, dtype) for v in tree]
    t = torch.as_tensor(tree).to(device)
    return t.to(dtype) if t.dtype == torch.float32 else t


class Renderer:
    """Renderer bound to a config's geometry and a device.

    Runs on the card unless ``device`` names another.  Casts the float32
    parameters to ``model.compute_dtype`` once.  On a CUDA device every
    batch runs through the kernels K1-K3 and a kernel that fails raises:
    there is no fallback; from the second consecutive batch of one shape
    on, the three stages replay CUDA graphs (``infer.graphs``), and the
    returned tensors are the caller's.  On the CPU the kernel wrappers run
    their plain versions.
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
        self.device = resolve_device(device)
        self.params = tuple(cast_tree(t, self.device, self.compute_dtype)
                            for t in (params, unet_params, unet_state))
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
