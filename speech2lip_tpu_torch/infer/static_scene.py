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
(``apply_infer_fused``), which upsamples align-corners on the crop, as the
JAX package's fused TPU kernel does: there the crop's interior differs
from the full frame by the sampling grid (a behaviour of the reference).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from speech2lip_tpu_torch.core import spans
from speech2lip_tpu_torch.infer import graphs
from speech2lip_tpu_torch.infer.renderer import (_DTYPES, cast_tree,
                                                 render_lip_batch,
                                                 resolve_device)
from speech2lip_tpu_torch.models import talking_face as tf
from speech2lip_tpu_torch.models import unet_light

# receptive-field radius at input scale: DoubleConv(+-2 @1) + (+-4 @2) +
# (+-8 @4) + the up path's DoubleConvs (+-4, +-2) + upsample slop -> 24 px;
# HALO rounds it up to a multiple of 4
HALO = 32
PASTE_MARGIN = 32   # interior = window + PASTE_MARGIN >= receptive field


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


def fused_unet_fits(h: int, w: int) -> bool:
    """Whether the kernel path runs the U-Net at h x w through K3: H and W
    multiples of 4 and at most 500 (the TPU kernel's VMEM budget), the
    JAX package's shape rule."""
    return h % 4 == 0 and w % 4 == 0 and h <= 500 and w <= 500


def _apply_unet(unet_params, unet_state, x, use_kernels: bool):
    """The U-Net as the JAX package's ``_apply_unet`` chooses it by shape:
    with kernels, K3 (``apply_infer_fused``) where ``fused_unet_fits``;
    otherwise the plain exact-2x forward.  The choice follows the
    reference's shape rule; it is not a fallback for a kernel that fails
    (one that fails raises)."""
    if use_kernels and fused_unet_fits(*x.shape[1:3]):
        return unet_light.apply_infer_fused(unet_params, unet_state, x)
    out, _ = unet_light.apply(unet_params, unet_state, x, exact2x=True)
    return out


def _plain_unet(unet_params, unet_state, x):
    """What ``_apply_unet(use_kernels=True)`` computes, with no kernel:
    K3's function (``unet_light.apply``, align-corners) where K3 runs,
    the exact-2x forward elsewhere."""
    out, _ = unet_light.apply(unet_params, unet_state, x,
                              exact2x=not fused_unet_fits(*x.shape[1:3]))
    return out


class StaticSceneRenderer:
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
        d = cfg["data"]
        self.lip_h, self.lip_w = int(d["height"]), int(d["width"])
        self.lip_x, self.lip_y = int(lip_x), int(lip_y)
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if use_kernels is None:
            use_kernels = on_card
        if on_card and not use_kernels:
            raise ValueError("StaticSceneRenderer: a CUDA device runs the "
                             "kernels; use_kernels=False is for the CPU")
        self.use_kernels = bool(use_kernels)
        cdt = _DTYPES[cfg["model"].get("compute_dtype", "float32")]
        self.compute_dtype = compute_dtype or (
            torch.bfloat16 if self.use_kernels else cdt)
        self.params, self.unet_params, self.unet_state = (
            cast_tree(t, self.device, self.compute_dtype)
            for t in (params, unet_params, unet_state))
        self.scene = tuple(
            torch.as_tensor(base[k]).to(self.device, self.compute_dtype)[None]
            for k in ("rgb_face_zero", "rgb_face_ori", "mask_lip_canonical"))
        self.coord = torch.as_tensor(base["coord"]).to(
            self.device, torch.float32)[None]
        self.face_h, self.face_w = self.scene[0].shape[1:3]
        self.window = tuple(int(v) for v in window)
        self.geo = crop_geometry(self.window, self.face_h, self.face_w)
        self.expand_divisor = int(d.get("expand_mask_divisor", 5))
        # outside the warp window the composite is rgb_face_ori itself
        with torch.no_grad():
            self.static_face = _apply_unet(self.unet_params, self.unet_state,
                                           self.scene[1], self.use_kernels)
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
            return {"face": self._render(
                unet_in, lambda u: _apply_unet(
                    self.unet_params, self.unet_state, u, self.use_kernels),
                self.static_face)}

    def render_plain(self, audio, t_indices):
        """The kernel path's batch computed with no kernel, on this
        renderer's parameters, dtype and scene: the lip and the composite
        through their plain versions, the U-Net through ``_plain_unet`` on
        the crop and on the static face.  The reference the kernel path is
        held to; it serves nothing."""
        def unet(x):
            return _plain_unet(self.unet_params, self.unet_state, x)
        with torch.no_grad():
            return self._render(self._composite(audio, t_indices, False),
                                unet, unet(self.scene[1]))

    def render_full(self, audio, t_indices):
        """The full-frame U-Net on the same composite (same upsample
        semantics), for parity checks and timing."""
        with torch.no_grad():
            return _apply_unet(
                self.unet_params, self.unet_state,
                self._composite(audio, t_indices, self.use_kernels),
                self.use_kernels).float()
