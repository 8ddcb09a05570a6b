"""Static-scene serving renderer: the U-Net on a lip-window crop only
(counterpart of ``speech2lip_tpu/infer/static_scene.py``).

Serving new audio reuses the canonical frame's artifacts for every frame:
``rgb_face_zero``/``rgb_face_ori``, the lip mask and the ``coord`` grid are
per-identity constants; only the audio window and the time index stream.
So the post-fusion U-Net input differs from a fixed image only inside the
warp window, and the U-Net has a finite receptive field (~24 px at input
scale).  The full-frame output is computed once per identity
(``static_face``), and each batch runs the U-Net on a haloed crop around
the window and pastes its interior back.

The crop equals the full frame exactly only with translation-equivariant
ops: crops are aligned to 4 so both pools keep the full image's grid, and
the plain path upsamples with the exact-2x closed form
(``unet_light.apply(exact2x=True)``).  The kernel path runs K3
(``unet_light.apply_infer``), which upsamples align-corners on the crop, as
the JAX package's fused TPU kernel does: there the crop's interior differs
from the full frame by the sampling grid (a behaviour of the reference).
As in the JAX package, K3 takes a U-Net input of at most ``K3_MAX`` pixels
a side (the TPU kernel's VMEM budget); a larger one runs exact-2x.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from speech2lip_tpu_torch.core import spans
from speech2lip_tpu_torch.infer import graphs
from speech2lip_tpu_torch.infer.renderer import FrontEnd, render_lip_batch
from speech2lip_tpu_torch.models import talking_face as tf
from speech2lip_tpu_torch.models import unet_light

# receptive-field radius at input scale: DoubleConv(+-2 @1) + (+-4 @2) +
# (+-8 @4) + the up path's DoubleConvs (+-4, +-2) + upsample slop -> 24 px;
# HALO rounds it up to a multiple of 4
HALO = 32
PASTE_MARGIN = 32   # interior = window + PASTE_MARGIN >= receptive field
K3_MAX = 500        # the JAX static scene's cap on K3's input side


def _align4(v: int, up: bool) -> int:
    return -(-v // 4) * 4 if up else (v // 4) * 4


def crop_geometry(window: Tuple[int, int, int, int], face_h: int,
                  face_w: int) -> Optional[Dict[str, int]]:
    """(crop, interior) rectangles for a validated warp window.

    The rectangles clamp to the frame: where the crop reaches the image
    edge its conv zero padding coincides with the full frame's.  None when
    the frame is not a multiple of 4 (the pooling grid would shift) or the
    crop covers 90% of the frame or more."""
    wy0, wx0, wh, ww = window
    if face_h % 4 or face_w % 4:
        return None
    iy0 = max(0, _align4(wy0 - PASTE_MARGIN, up=False))
    ix0 = max(0, _align4(wx0 - PASTE_MARGIN, up=False))
    iy1 = min(face_h, _align4(wy0 + wh + PASTE_MARGIN, up=True))
    ix1 = min(face_w, _align4(wx0 + ww + PASTE_MARGIN, up=True))
    cy0, cx0 = max(0, iy0 - HALO), max(0, ix0 - HALO)
    cy1, cx1 = min(face_h, iy1 + HALO), min(face_w, ix1 + HALO)
    if (cy1 - cy0) * (cx1 - cx0) >= 0.9 * face_h * face_w:
        return None
    return {"cy0": cy0, "cx0": cx0, "ch": cy1 - cy0, "cw": cx1 - cx0,
            "iy0": iy0, "ix0": ix0, "ih": iy1 - iy0, "iw": ix1 - ix0}


def _under_cap(x) -> bool:
    return x.shape[1] <= K3_MAX and x.shape[2] <= K3_MAX


class StaticSceneRenderer(FrontEnd):
    """Per-identity renderer for streaming audio.

    cfg: config dict (lip geometry, ``model.compute_dtype``); params /
    unet_params / unet_state: the port's parameter trees; base: the
    canonical frame's sample dict (rgb_face_zero, rgb_face_ori,
    mask_lip_canonical [H, W, 3], coord [H, W, 2]; arrays or tensors);
    window: validated warp window (``data.windows.compute_warp_window``);
    lip_x/lip_y: lip paste offsets.

    Runs on the card unless ``device`` names another.  On a CUDA device it
    runs K1, K2 and K3 in bfloat16, as the JAX package forces bf16 with its
    kernels, and ``use_kernels=False`` raises: the card serves no plain
    path.  On the CPU ``use_kernels`` picks which of the JAX package's two
    paths to mirror: the plain exact-2x path in ``model.compute_dtype``
    (default), or the kernel path's semantics in bf16 through the kernel
    wrappers' plain versions.  ``compute_dtype`` overrides the dtype (the
    kernels have float32 bodies too).  Without a crop geometry every batch
    runs the full frame.
    """

    # the inputs' static buffers: float32, as ``_composite`` reads them
    STAGED = {"audio": torch.float32, "t_indices": torch.float32}

    def __init__(self, cfg: Dict[str, Any], params, unet_params, unet_state,
                 base: Dict[str, Any], window: Tuple[int, int, int, int],
                 lip_x: int, lip_y: int, device=None,
                 use_kernels: Optional[bool] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        self.params, self.unet_params, self.unet_state = self.bind(
            cfg, (params, unet_params, unet_state), device, use_kernels,
            compute_dtype, kernel_dtype=torch.bfloat16)
        self.lip_x, self.lip_y = int(lip_x), int(lip_y)
        self.scene = tuple(
            torch.as_tensor(base[k]).to(self.device, self.compute_dtype)[None]
            for k in ("rgb_face_zero", "rgb_face_ori", "mask_lip_canonical"))
        self.coord = torch.as_tensor(base["coord"]).to(
            self.device, torch.float32)[None]
        self.face_h, self.face_w = self.scene[0].shape[1:3]
        self.window = tuple(int(v) for v in window)
        self.geo = crop_geometry(self.window, self.face_h, self.face_w)
        # outside the warp window the composite is rgb_face_ori itself
        with torch.no_grad():
            self.static_face = self._unet(self.scene[1])
        self.graphs = graphs.StageGraphs(self.device)

    def _composite(self, audio, t_indices, use_kernels: bool,
                   stage=spans.span):
        audio = torch.as_tensor(audio).to(self.device, torch.float32)
        t = torch.as_tensor(t_indices).to(self.device, torch.float32)
        b = audio.shape[0]
        with stage("render.lip"):
            rgb_lip = render_lip_batch(self.params, audio, t, self.lip_h,
                                       self.lip_w, use_kernels=use_kernels,
                                       compute_dtype=self.compute_dtype)
        with stage("render.composite"):
            fz, gt, mask = (x.expand(b, *x.shape[1:]) for x in self.scene)
            unet_in, _, _ = tf.post_fusion_composite(
                rgb_lip.to(self.compute_dtype), fz, gt, mask,
                self.coord.expand(b, *self.coord.shape[1:]), self.lip_x,
                self.lip_y, expand_divisor=self.expand_divisor,
                window=self.window, use_kernels=use_kernels)
            return unet_in.to(self.compute_dtype)

    def _unet(self, x):
        """The U-Net on x as the JAX static scene runs it: K3 on the kernel
        path where x is at most ``K3_MAX`` a side, exact-2x elsewhere."""
        return unet_light.apply_infer(self.unet_params, self.unet_state, x,
                                      self.use_kernels and _under_cap(x),
                                      exact2x=True)

    def _render(self, unet_in, unet, static_face):
        """``unet`` on the crop of the composite, its interior pasted into
        ``static_face``; on the whole composite without a crop geometry."""
        if self.geo is None:
            return unet(unet_in).float()
        g = self.geo
        crop = unet_in[:, g["cy0"]:g["cy0"] + g["ch"],
                       g["cx0"]:g["cx0"] + g["cw"]].contiguous()
        out = unet(crop)
        y0, x0 = g["iy0"] - g["cy0"], g["ix0"] - g["cx0"]
        face = static_face.expand(unet_in.shape[0], -1, -1,
                                  -1).to(out.dtype).clone()
        face[:, g["iy0"]:g["iy0"] + g["ih"],
             g["ix0"]:g["ix0"] + g["iw"]] = out[:, y0:y0 + g["ih"],
                                                x0:x0 + g["iw"]]
        return face.float()

    def __call__(self, audio, t_indices):
        """audio [B, 16, 29], t_indices [B] -> faces [B, H, W, 3] float32:
        the U-Net on the crop, its interior pasted into ``static_face``.
        On a CUDA device the stages replay CUDA graphs from the second
        consecutive batch of one shape on (``infer.graphs``); the faces
        returned are the caller's."""
        x = {"audio": torch.as_tensor(audio),
             "t_indices": torch.as_tensor(t_indices)}
        with spans.span("render"), torch.no_grad():
            return self.graphs(graphs.input_key(x), x, self.STAGED,
                               self._batch)["face"]

    def _batch(self, stage, x):
        """The kernel path's batch, each stage in ``stage(name)``."""
        unet_in = self._composite(x["audio"], x["t_indices"],
                                  self.use_kernels, stage)
        with stage("render.unet"):
            return {"face": self._render(unet_in, self._unet,
                                         self.static_face)}

    def render_plain(self, audio, t_indices):
        """The kernel path's batch computed with no kernel, on this
        renderer's parameters, dtype and scene: the lip and the composite
        through their plain versions, the U-Net with no kernel on the crop
        and on the static face: K3's function (align-corners) where the
        kernel path runs K3, exact-2x elsewhere.  The reference the kernel
        path is held to; it serves nothing."""
        def unet(x):
            k3 = unet_light.k3_runs(x.shape, _under_cap(x))
            return unet_light.apply_infer(self.unet_params, self.unet_state,
                                          x, False, exact2x=not k3)
        with torch.no_grad():
            return self._render(self._composite(audio, t_indices, False),
                                unet, unet(self.scene[1]))

    def render_full(self, audio, t_indices):
        """The full-frame U-Net on the same composite (same upsample
        semantics), for parity checks and timing."""
        with torch.no_grad():
            return self._unet(self._composite(audio, t_indices,
                                              self.use_kernels)).float()
