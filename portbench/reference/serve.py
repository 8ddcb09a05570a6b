"""The plain reference of the two serving paths, in blocks of frames.

``dub``: a batch of frames of an identity's video with new audio (the
``Renderer``'s function): the lip crop from the audio, pasted into the
canonical face, warped to the observed pose over the whole frame, blended
into the observed face, through the U-Net (eval BatchNorm).

``avatar``: a fixed pose (the ``StaticSceneRenderer``'s stated semantics):
the same composite at the canonical frame, the U-Net over the crop that
the warp window fixes, its interior pasted into the U-Net's output over the
observed face, computed once.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from portbench.reference import common as C
from portbench.traffic import weights as W

BLOCK = 8  # frames a block: the float32 U-Net at 500^2 stays near 4 GB


def stated_precision(cfg) -> str:
    """The type the configuration states: ``bf16`` for a bfloat16 model,
    else ``f32``."""
    return ("bf16" if cfg["model"].get("compute_dtype") == "bfloat16"
            else "f32")


def _setup(weights, precision: str):
    """(rounding, params, unet params, unet state, dtype): ``bf16`` is the
    model computed in bfloat16 (weights and activations), the others float32
    with their rounding."""
    if precision == "bf16":
        bf = lambda t: W.tree_map(lambda x: x.to(torch.bfloat16), t)
        return (C.Precision("f32"), *(bf(t) for t in weights),
                torch.bfloat16)
    return (C.Precision(precision), *(C.f32_tree(t) for t in weights),
            torch.float32)


def _grid_dtype(cfg) -> torch.dtype:
    return (torch.bfloat16 if cfg["model"].get("compute_dtype")
            == "bfloat16" else torch.float32)


def dub(cfg: Dict[str, Any], weights, batch: Dict[str, torch.Tensor],
        lip_x: int, lip_y: int, precision: str = "f32"):
    """{'lip', 'face'} float32 of a batch (audio [B, 16, 29], index [B],
    rgb_face_zero / rgb_face_ori / mask_lip_canonical [B, H, W, 3], coord
    [B, H, W, 2])."""
    q, p, up, us, dt = _setup(weights, precision)
    d = cfg["data"]
    lh, lw = int(d["height"]), int(d["width"])
    div = int(d.get("expand_mask_divisor", 5))
    lips, faces = [], []
    with torch.no_grad(), C.no_tf32():
        for i in range(0, batch["audio"].shape[0], BLOCK):
            sl = slice(i, i + BLOCK)
            lip = C.render_lip(q, p, batch["audio"][sl].to(dt),
                               batch["index"][sl].float(), lh, lw,
                               _grid_dtype(cfg))
            x = C.composite(lip, batch["rgb_face_zero"][sl].to(dt),
                            batch["rgb_face_ori"][sl].to(dt),
                            batch["mask_lip_canonical"][sl].to(dt),
                            batch["coord"][sl].float(), lip_x, lip_y, div)
            lips.append(lip.float())
            faces.append(C.unet(q, up, us, x).float())
    return {"lip": torch.cat(lips), "face": torch.cat(faces)}


def static_face(weights, face_ori: torch.Tensor, precision: str = "f32"):
    """The U-Net over the observed face [H, W, 3] of the fixed pose."""
    q, _, up, us, dt = _setup(weights, precision)
    with torch.no_grad(), C.no_tf32():
        return C.unet(q, up, us, face_ori.to(dt)[None])[0].float()


def avatar(cfg: Dict[str, Any], weights, scene: Dict[str, torch.Tensor],
           audio: torch.Tensor, t: torch.Tensor, window, lip_x: int,
           lip_y: int, static: torch.Tensor, precision: str = "f32"):
    """Faces [B, H, W, 3] float32 of audio windows [B, 16, 29] at frame
    indices t [B]; ``scene`` holds the fixed pose's rgb_face_zero /
    rgb_face_ori / mask_lip_canonical [H, W, 3] and coord [H, W, 2];
    ``static`` is ``static_face`` of it."""
    q, p, up, us, dt = _setup(weights, precision)
    d = cfg["data"]
    lh, lw = int(d["height"]), int(d["width"])
    div = int(d.get("expand_mask_divisor", 5))
    h, w = scene["rgb_face_ori"].shape[:2]
    g = C.crop_rule(window, h, w)
    out = []
    with torch.no_grad(), C.no_tf32():
        for i in range(0, audio.shape[0], BLOCK):
            sl = slice(i, i + BLOCK)
            n = audio[sl].shape[0]
            lip = C.render_lip(q, p, audio[sl].to(dt), t[sl].float(), lh,
                               lw, _grid_dtype(cfg))
            ex = lambda k: scene[k].to(
                torch.float32 if k == "coord" else dt)[None].expand(
                    n, *scene[k].shape)
            x = C.composite(lip, ex("rgb_face_zero"), ex("rgb_face_ori"),
                            ex("mask_lip_canonical"), ex("coord"), lip_x,
                            lip_y, div)
            if g is None:
                out.append(C.unet(q, up, us, x).float())
                continue
            crop = x[:, g["cy0"]:g["cy0"] + g["ch"],
                     g["cx0"]:g["cx0"] + g["cw"]]
            y = C.unet(q, up, us, crop).float()
            face = static[None].expand(n, -1, -1, -1).clone()
            oy, ox = g["iy0"] - g["cy0"], g["ix0"] - g["cx0"]
            face[:, g["iy0"]:g["iy0"] + g["ih"],
                 g["ix0"]:g["ix0"] + g["iw"]] = y[:, oy:oy + g["ih"],
                                                 ox:ox + g["iw"]]
            out.append(face)
    return torch.cat(out)
