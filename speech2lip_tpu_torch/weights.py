"""Weight bridge from the JAX package's parameter trees.

The port keeps the JAX package's tree structure and layouts: linear ``w``
is [in, out], conv1d kernels are LIO, conv2d kernels HWIO, and each U-Net
BatchNorm is split into params ``bn*`` {scale, bias} and state ``bn*``
{mean, var}.  Converting is therefore a checked, typed copy of every leaf;
the checks pin the layouts the renderer's kernels rely on.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

# TalkingFace entries the renderer does not read
_UNUSED = ("canonical_depth", "pose_enc", "fc_pose", "fc_pose_skip")


def _tree(x, device, dtype):
    if isinstance(x, dict):
        return {k: _tree(v, device, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device, dtype) for v in x]
    t = torch.from_numpy(np.array(x, copy=True)).to(device)
    return t.to(dtype) if t.is_floating_point() else t


def _expect(cond: bool, what: str):
    if not cond:
        raise ValueError(f"from_jax: unexpected parameter layout: {what}")


def _check_talking_face(p: Dict[str, Any]):
    width = p["fc_uv"]["w"].shape[1]
    _expect(p["fc_uv"]["w"].shape[0] == 42, "fc_uv.w must be [42, W]")
    _expect(p["fc_uv_skip"]["w"].shape == p["fc_uv"]["w"].shape,
            "fc_uv_skip.w must match fc_uv.w")
    for i, conv in enumerate(p["audio_enc"]["conv"]):
        _expect(conv["w"].ndim == 3 and conv["w"].shape[0] == 3,
                f"audio_enc.conv[{i}].w must be LIO [3, in, out]")
    trunk = p["trunk"]
    wide = [i for i, l in enumerate(trunk) if l["w"].shape[0] == 2 * width]
    _expect(len(wide) == 1 and all(l["w"].shape[1] == width for l in trunk),
            "trunk must hold one [2W, W] layer after the skip, else [W, W]")
    _expect(p["output"]["w"].shape == (width, 3), "output.w must be [W, 3]")


def _check_unet(params: Dict[str, Any], state: Dict[str, Any]):
    for name in ("inc", "down1", "down2", "up1", "up2"):
        blk, st = params[name], state[name]
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            w = blk[conv]["w"]
            _expect(w.ndim == 4 and w.shape[:2] == (3, 3),
                    f"{name}.{conv}.w must be HWIO [3, 3, in, out]")
            _expect(set(blk[bn]) == {"scale", "bias"}
                    and set(st[bn]) == {"mean", "var"},
                    f"{name}.{bn} must split into params and state")
            _expect(blk[bn]["scale"].shape == (w.shape[3],),
                    f"{name}.{bn} width must match {conv}")
    _expect(params["outc"]["w"].shape[:2] == (1, 1), "outc.w must be 1x1")


def from_jax(params_np, unet_params_np, unet_state_np, device="cpu",
             dtype=torch.float32) -> Tuple[dict, dict, dict]:
    """JAX parameter trees (nested dicts/lists of numpy arrays, as
    ``jax.tree.map(np.asarray, ...)`` gives them) -> the port's trees of
    tensors on ``device``, floating leaves cast to ``dtype``.

    Returns (talking_face params, unet params, unet state).
    """
    params = _tree({k: v for k, v in params_np.items() if k not in _UNUSED},
                   device, dtype)
    unet_params = _tree(unet_params_np, device, dtype)
    unet_state = _tree(unet_state_np, device, dtype)
    _check_talking_face(params)
    _check_unet(unet_params, unet_state)
    return params, unet_params, unet_state


def random_params(seed: int = 0, device="cpu", dtype=torch.float32):
    """Parameters of the default model made from a seed, laid out as
    ``from_jax`` returns them: uniform(+-1/sqrt(fan_in)) weights and biases
    as in the JAX package's ``init``, BatchNorm at a random eval state (no
    JAX needed)."""
    from speech2lip_tpu_torch.config import default_config

    m = default_config()["model"]
    width, depth, skip = m["net_width"], m["net_depth"], m["skips"][0]
    base = 64  # the U-Net's first width
    rng = np.random.default_rng(seed)

    def u(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def lin(i, o):
        return {"w": u((i, o), i), "b": u((o,), i)}

    def conv1(i, o):
        return {"w": u((3, i, o), 3 * i), "b": u((o,), 3 * i)}

    tf = {
        "audio_enc": {"conv": [conv1(29, 32), conv1(32, 32), conv1(32, 64),
                               conv1(64, 64)],
                      "fc": [lin(64, 64), lin(64, 64)]},
        "fc_uv": lin(42, width), "fc_uv_skip": lin(42, width),
        "fc_audio": lin(64, width), "fc_audio_skip": lin(64, width),
        "fc_time": lin(20, width), "fc_time_skip": lin(20, width),
        "trunk": [lin(2 * width if i == skip + 1 else width, width)
                  for i in range(depth)],
        "output": lin(width, m["output_ch"]),
    }
    up, us = {}, {}
    for name, cin, cmid, cout in (("inc", 3, base, base),
                                  ("down1", base, 2 * base, 2 * base),
                                  ("down2", 2 * base, 2 * base, 2 * base),
                                  ("up1", 4 * base, 2 * base, base),
                                  ("up2", 2 * base, base, base)):
        up[name] = {"conv1": {"w": u((3, 3, cin, cmid), 9 * cin)},
                    "conv2": {"w": u((3, 3, cmid, cout), 9 * cmid)}}
        us[name] = {}
        for bn, c in (("bn1", cmid), ("bn2", cout)):
            up[name][bn] = {
                "scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32)}
            us[name][bn] = {
                "mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    up["outc"] = {"w": u((1, 1, base, 3), base), "b": u((3,), base)}
    return from_jax(tf, up, us, device=device, dtype=dtype)
