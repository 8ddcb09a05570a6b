"""Weight bridge from the JAX package's parameter trees.

The port keeps the JAX package's tree structure and layouts: linear ``w``
is [in, out], conv1d kernels are LIO, conv2d kernels HWIO, and each
BatchNorm is split into params {scale, bias} and state {mean, var}.
Converting is therefore a checked, typed copy of every leaf; the checks pin
the layouts the kernels rely on.  The frozen nets of the training losses
(LPIPS, SyncNet) convert the same way.  ``random_*`` make each tree from a
seed, with numpy only, for a machine that has no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

# TalkingFace entries of the head-pose variant, which the port does not run
_UNUSED = ("pose_enc", "fc_pose", "fc_pose_skip")


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
    _expect("canonical_depth" not in p or p["canonical_depth"].ndim == 2,
            "canonical_depth must be [H, W]")


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


def _uniform(rng):
    """uniform(+-1/sqrt(fan_in)) leaves, as the JAX package's ``init``."""
    def u(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    return u


def _random_bn(rng, c):
    """A random eval BatchNorm (params, state), so that folding matters."""
    return ({"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
             "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32)},
            {"mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)})


def random_params(seed: int = 0, device="cpu", dtype=torch.float32):
    """Parameters of the default model made from a seed, laid out as
    ``from_jax`` returns them: uniform(+-1/sqrt(fan_in)) weights and biases
    as in the JAX package's ``init``, BatchNorm at a random eval state, and
    a canonical depth of the configured size drawn from U(0.8, 1.2) (no
    JAX needed)."""
    from speech2lip_tpu_torch.config import default_config

    m = default_config()["model"]
    width, depth, skip = m["net_width"], m["net_depth"], m["skips"][0]
    base = 64  # the U-Net's first width
    rng = np.random.default_rng(seed)
    u = _uniform(rng)

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
        "canonical_depth": rng.uniform(
            0.8, 1.2, (m["canonical_depth_height"],
                       m["canonical_depth_width"])).astype(np.float32),
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
            up[name][bn], us[name][bn] = _random_bn(rng, c)
    up["outc"] = {"w": u((1, 1, base, 3), base), "b": u((3,), base)}
    return from_jax(tf, up, us, device=device, dtype=dtype)


def lpips_from_jax(lpips_np, device="cpu"):
    """The JAX LPIPS tree {"convs": [{w HWIO, b}] x5, "lins": [{w [1, 1,
    C, 1]}] x5} -> the port's, float32 (the frozen nets run in float32)."""
    from speech2lip_tpu_torch.models.lpips import ALEX_SPEC
    p = _tree(lpips_np, device, torch.float32)
    _expect(len(p["convs"]) == len(ALEX_SPEC) == len(p["lins"]),
            "lpips must hold five convs and five lins")
    for conv, lin, (out_ch, kernel, _, _) in zip(p["convs"], p["lins"],
                                                 ALEX_SPEC):
        _expect(tuple(conv["w"].shape[:2]) == kernel
                and conv["w"].shape[3] == out_ch,
                f"lpips conv must be HWIO {kernel} x {out_ch}")
        _expect(tuple(lin["w"].shape) == (1, 1, out_ch, 1),
                f"lpips lin must be [1, 1, {out_ch}, 1]")
    return p


def random_lpips(seed: int = 0, device="cpu"):
    """LPIPS weights made from a seed, as the JAX package's ``init``."""
    from speech2lip_tpu_torch.models.lpips import ALEX_SPEC
    u = _uniform(np.random.default_rng(seed))
    convs, lins, c = [], [], 3
    for out_ch, (kh, kw), _, _ in ALEX_SPEC:
        convs.append({"w": u((kh, kw, c, out_ch), kh * kw * c),
                      "b": u((out_ch,), kh * kw * c)})
        lins.append({"w": u((1, 1, out_ch, 1), out_ch)})
        c = out_ch
    return lpips_from_jax({"convs": convs, "lins": lins}, device)


def syncnet_from_jax(params_np, state_np, device="cpu"):
    """The JAX SyncNet (params, state) trees -> the port's, float32."""
    from speech2lip_tpu_torch.models.syncnet import AUDIO_SPEC, FACE_SPEC
    params = _tree(params_np, device, torch.float32)
    state = _tree(state_np, device, torch.float32)
    for name, spec in (("face", FACE_SPEC), ("audio", AUDIO_SPEC)):
        _expect(len(params[name]) == len(spec) == len(state[name]),
                f"syncnet {name} must hold {len(spec)} blocks")
        for i, (blk, st, (out_ch, kernel, _, _, _)) in enumerate(
                zip(params[name], state[name], spec)):
            _expect(tuple(blk["conv"]["w"].shape[:2]) == kernel
                    and blk["conv"]["w"].shape[3] == out_ch
                    and set(blk["bn"]) == {"scale", "bias"}
                    and set(st["bn"]) == {"mean", "var"},
                    f"syncnet {name}[{i}] must be an HWIO conv + split BN")
    return params, state


def random_syncnet(seed: int = 0, device="cpu"):
    """SyncNet weights made from a seed: convs as the JAX package's
    ``init``, BatchNorm at a random eval state."""
    from speech2lip_tpu_torch.models.syncnet import AUDIO_SPEC, FACE_SPEC
    rng = np.random.default_rng(seed)
    u = _uniform(rng)
    params, state = {}, {}
    for name, spec, c in (("face", FACE_SPEC, 15), ("audio", AUDIO_SPEC, 1)):
        params[name], state[name] = [], []
        for out_ch, (kh, kw), _, _, _ in spec:
            bn_p, bn_s = _random_bn(rng, out_ch)
            params[name].append({
                "conv": {"w": u((kh, kw, c, out_ch), kh * kw * c),
                         "b": u((out_ch,), kh * kw * c)},
                "bn": bn_p})
            state[name].append({"bn": bn_s})
            c = out_ch
    return syncnet_from_jax(params, state, device)
