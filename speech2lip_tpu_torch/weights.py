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


def random_params(seed: int = 0, device="cpu", dtype=torch.float32,
                  cfg=None, canonical_depth_init=None):
    """Parameters of the model made from a seed, laid out as ``from_jax``
    returns them: uniform(+-1/sqrt(fan_in)) weights and biases as in the
    JAX package's ``init``, BatchNorm at a random eval state, and a
    canonical depth drawn from U(0.8, 1.2) (no JAX needed).

    ``cfg``: a config whose ``model`` section gives the widths, depth,
    skips, output channels, audio input (``use_audio_mel``) and canonical
    depth (``use_canonical_depth``, its size); the defaults otherwise.
    ``canonical_depth_init`` [H, W] replaces the drawn depth."""
    from speech2lip_tpu_torch.config import default_config

    m = (cfg or default_config())["model"]
    width, depth = m["net_width"], m["net_depth"]
    skips = list(m.get("skips", [4]))
    audio_in = 80 if m.get("use_audio_mel") else 29
    base = 64  # the U-Net's first width
    rng = np.random.default_rng(seed)
    u = _uniform(rng)

    def lin(i, o):
        return {"w": u((i, o), i), "b": u((o,), i)}

    def conv1(i, o):
        return {"w": u((3, i, o), 3 * i), "b": u((o,), 3 * i)}

    tf = {
        "audio_enc": {"conv": [conv1(audio_in, 32), conv1(32, 32),
                               conv1(32, 64), conv1(64, 64)],
                      "fc": [lin(64, 64), lin(64, 64)]},
        "fc_uv": lin(42, width), "fc_uv_skip": lin(42, width),
        "fc_audio": lin(64, width), "fc_audio_skip": lin(64, width),
        "fc_time": lin(20, width), "fc_time_skip": lin(20, width),
        "trunk": [lin(2 * width if i - 1 in skips else width, width)
                  for i in range(depth)],
        "output": lin(width, m["output_ch"]),
        "canonical_depth": rng.uniform(
            0.8, 1.2, (m["canonical_depth_height"],
                       m["canonical_depth_width"])).astype(np.float32),
    }
    if canonical_depth_init is not None:
        tf["canonical_depth"] = np.asarray(canonical_depth_init, np.float32)
    if not m.get("use_canonical_depth", True):
        del tf["canonical_depth"]
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


def _syncnet(seed: int, bn, device):
    """A SyncNet tree made from a seed: convs as the JAX package's
    ``init``, each block's BatchNorm from ``bn(rng, channels)``."""
    from speech2lip_tpu_torch.models.syncnet import AUDIO_SPEC, FACE_SPEC
    rng = np.random.default_rng(seed)
    u = _uniform(rng)
    params, state = {}, {}
    for name, spec, c in (("face", FACE_SPEC, 15), ("audio", AUDIO_SPEC, 1)):
        params[name], state[name] = [], []
        for out_ch, (kh, kw), _, _, _ in spec:
            bn_p, bn_s = bn(rng, out_ch)
            params[name].append({
                "conv": {"w": u((kh, kw, c, out_ch), kh * kw * c),
                         "b": u((out_ch,), kh * kw * c)},
                "bn": bn_p})
            state[name].append({"bn": bn_s})
            c = out_ch
    return syncnet_from_jax(params, state, device)


def random_syncnet(seed: int = 0, device="cpu"):
    """SyncNet weights made from a seed: convs as the JAX package's
    ``init``, BatchNorm at a random eval state (a frozen net's)."""
    return _syncnet(seed, _random_bn, device)


def init_syncnet(seed: int = 0, device="cpu"):
    """A SyncNet to train, made from a seed with the JAX package's
    ``init`` distribution: convs and biases uniform(+-1/sqrt(fan_in)),
    BatchNorm at scale 1, bias 0, mean 0, var 1."""
    def fresh_bn(_, c):
        return ({"scale": np.ones(c, np.float32),
                 "bias": np.zeros(c, np.float32)},
                {"mean": np.zeros(c, np.float32),
                 "var": np.ones(c, np.float32)})
    return _syncnet(seed, fresh_bn, device)


_DS_LINEARS = ("fc1", "fc2", "fc3", "fc5", "fc6")


def deepspeech_from_jax(tree_np, device="cpu"):
    """The JAX DeepSpeech tree (``core/checkpoint.load_nested`` of its npz,
    or ``jax.tree.map(np.asarray, deepspeech.init(...))``) -> the port's,
    float32 tensors on ``device`` (the model computes in float32)."""
    p = _tree(tree_np, device, torch.float32)
    for name in _DS_LINEARS:
        w, b = p[name]["w"], p[name]["b"]
        _expect(w.ndim == 2 and b.shape == (w.shape[1],),
                f"deepspeech {name} must be w [in, out], b [out]")
    hidden = p["fc1"]["w"].shape[1]
    for name in ("lstm_fw", "lstm_bw"):
        k, b = p[name]["kernel"], p[name]["bias"]
        _expect(tuple(k.shape) == (3 * hidden, 4 * hidden)
                and tuple(b.shape) == (4 * hidden,),
                f"deepspeech {name} must be a fused [in + h, 4h] kernel "
                f"with in = 2h = {2 * hidden}")
    _expect(p["fc3"]["w"].shape[1] == 2 * hidden
            and p["fc5"]["w"].shape[0] == 2 * hidden,
            "deepspeech fc3 must widen to 2h and fc5 take both directions")
    return p


def random_deepspeech(seed: int = 0, input_dim: int = 494, hidden: int = 2048,
                      n_logits: int = 29, device="cpu"):
    """DeepSpeech weights made from a seed, with numpy: the shapes and the
    uniform bounds of the JAX package's ``deepspeech.init`` (linears
    U(+-1/sqrt(in)) weights and biases; LSTM kernels U(+-1/sqrt(in + h)),
    zero biases)."""
    rng = np.random.default_rng(seed)
    u = _uniform(rng)

    def lin(i, o):
        return {"w": u((i, o), i), "b": u((o,), i)}

    def lstm(i):
        return {"kernel": u((i + hidden, 4 * hidden), i + hidden),
                "bias": np.zeros((4 * hidden,), np.float32)}

    tree = {"fc1": lin(input_dim, hidden), "fc2": lin(hidden, hidden),
            "fc3": lin(hidden, 2 * hidden), "lstm_fw": lstm(2 * hidden),
            "lstm_bw": lstm(2 * hidden), "fc5": lin(2 * hidden, hidden),
            "fc6": lin(hidden, n_logits)}
    return deepspeech_from_jax(tree, device)


# -- the preprocessing nets: FAN, S3FD, DSFD, BiSeNet -------------------------

def _check_convs(tree, what: str, path: str = ""):
    """Every conv of a tree is HWIO (4-D ``w``, optional ``b`` of its out
    width) and every BatchNorm's params hold {scale, bias}."""
    if isinstance(tree, list):
        for i, t in enumerate(tree):
            _check_convs(t, what, f"{path}[{i}]")
        return
    if not isinstance(tree, dict):
        return
    if "w" in tree:
        w = tree["w"]
        _expect(w.ndim == 4, f"{what} {path}.w must be HWIO")
        _expect("b" not in tree or tuple(tree["b"].shape) == (w.shape[3],),
                f"{what} {path}.b must match {path}.w's out width")
        return
    if "scale" in tree:
        # a BatchNorm's {scale, bias}, or an L2 norm's {scale}
        _expect(set(tree) in ({"scale", "bias"}, {"scale"}),
                f"{what} {path} must be a BatchNorm's {{scale, bias}}")
        return
    for k, v in tree.items():
        _check_convs(v, what, f"{path}.{k}" if path else k)


def _check_bn_state(state, what: str, path: str = ""):
    if isinstance(state, list):
        for i, s in enumerate(state):
            _check_bn_state(s, what, f"{path}[{i}]")
    elif isinstance(state, dict):
        if "mean" in state or "var" in state:
            _expect(set(state) == {"mean", "var"},
                    f"{what} {path} BatchNorm state must be {{mean, var}}")
            return
        for k, v in state.items():
            _check_bn_state(v, what, f"{path}.{k}" if path else k)


def _kernel(tree, shape, what: str):
    _expect(tuple(tree["w"].shape) == tuple(shape),
            f"{what} must be HWIO {tuple(shape)}")


def fan_from_jax(params_np, state_np, device="cpu"):
    """The JAX FAN (params, state) trees (``fan.ckpt``'s {"params",
    "state"}, or ``fan.init``'s pair as numpy) -> the port's, float32."""
    from speech2lip_tpu_torch.models import fan
    params = _tree(params_np, device, torch.float32)
    state = _tree(state_np, device, torch.float32)
    _expect(isinstance(params, dict) and {"conv1", "bn1", "hg", "top",
                                          "pred"} <= set(params),
            "fan params must hold conv1, bn1, hg, top, pred")
    for k in ("bl", "al"):   # empty for one module: absent from a file
        params.setdefault(k, [])
    _check_convs(params, "fan")
    _check_bn_state(state, "fan")
    _kernel(params["conv1"], (7, 7, 3, 64), "fan conv1")
    n = len(params["hg"])
    _expect(n >= 1 and all(len(params[k]) == n for k in
                           ("top", "conv_last", "bn_end", "pred"))
            and len(params["bl"]) == len(params["al"]) == n - 1
            and len(state["hg"]) == n,
            "fan must hold one hg / top / conv_last / bn_end / pred per "
            "module and one bl / al between modules")
    for m in range(n):
        _kernel(params["pred"][m], (1, 1, fan.HG_FEATS, fan.N_LANDMARKS),
                f"fan pred[{m}]")
        _expect(f"up1_{fan.HG_DEPTH}" in params["hg"][m]
                and "low2_1" in params["hg"][m],
                f"fan hg[{m}] must be a depth-{fan.HG_DEPTH} hourglass")
    return params, state


def s3fd_from_jax(params_np, device="cpu"):
    """The JAX S3FD params tree (``s3fd.ckpt``) -> the port's, float32."""
    from speech2lip_tpu_torch.models import s3fd
    params = _tree(params_np, device, torch.float32)
    _check_convs(params, "s3fd")
    for item in s3fd.VGG:
        if item != "M":
            name, cin, cout = item
            _kernel(params[name], (3, 3, cin, cout), f"s3fd {name}")
    for name, cin, cout, k in s3fd.EXTRA:
        _kernel(params[name], (k, k, cin, cout), f"s3fd {name}")
    for i, s in enumerate(s3fd.SOURCES):
        ch = s3fd.SOURCE_CH[s]
        _kernel(params[f"cls_{s}"], (3, 3, ch, 4 if i == 0 else 2),
                f"s3fd cls_{s}")
        _kernel(params[f"reg_{s}"], (3, 3, ch, 4), f"s3fd reg_{s}")
    for s in s3fd.L2_SCALES:
        _expect(tuple(params[s + "_l2"]["scale"].shape)
                == (params[s]["w"].shape[3],), f"s3fd {s}_l2 scale width")
    return params


def dsfd_from_jax(params_np, state_np, device="cpu"):
    """The JAX DSFD (params, state) trees -> the port's, float32; any
    stage depths (ResNet-152's are (3, 8, 36, 3))."""
    from speech2lip_tpu_torch.models import dsfd
    params = _tree(params_np, device, torch.float32)
    state = _tree(state_np, device, torch.float32)
    _check_convs(params, "dsfd")
    _check_bn_state(state, "dsfd")
    _kernel(params["stem"]["conv"], (7, 7, 3, 64), "dsfd stem")
    cin = 64
    for li, cout in enumerate(dsfd.STAGE_CH):
        blocks = params[f"layer{li + 1}"]
        _expect(len(blocks) >= 1 and len(state[f"layer{li + 1}"])
                == len(blocks), f"dsfd layer{li + 1} must hold its blocks")
        for bi, blk in enumerate(blocks):
            c = cin if bi == 0 else cout
            _kernel(blk["c1"]["conv"], (1, 1, c, cout // 4),
                    f"dsfd layer{li + 1}[{bi}].c1")
            _kernel(blk["c3"]["conv"], (1, 1, cout // 4, cout),
                    f"dsfd layer{li + 1}[{bi}].c3")
            _expect(("down" in blk) == (bi == 0),
                    f"dsfd layer{li + 1}: a projection on block 0 only")
        cin = cout
    for i, ch in enumerate(dsfd.SOURCE_CH):
        _kernel(params[f"fem{i}"]["cpm1"], (3, 3, ch, 256), f"dsfd fem{i}")
        _kernel(params[f"cls{i}"], (3, 3, dsfd.FEM_CH, 4 if i == 0 else 2),
                f"dsfd cls{i}")
        _kernel(params[f"reg{i}"], (3, 3, dsfd.FEM_CH, 4), f"dsfd reg{i}")
    return params, state


def bisenet_from_jax(params_np, state_np, device="cpu"):
    """The JAX BiSeNet (params, state) trees -> the port's, float32."""
    from speech2lip_tpu_torch.models import bisenet
    params = _tree(params_np, device, torch.float32)
    state = _tree(state_np, device, torch.float32)
    _check_convs(params, "bisenet")
    _check_bn_state(state, "bisenet")
    _kernel(params["stem"]["conv"], (7, 7, 3, 64), "bisenet stem")
    for name, _, cout in bisenet.LAYERS:
        _expect(len(params[name]) == 2 and len(state[name]) == 2,
                f"bisenet {name} must hold two blocks")
        _kernel(params[name][1]["c2"]["conv"], (3, 3, cout, cout),
                f"bisenet {name}[1].c2")
    _kernel(params["ffm"]["conv"], (1, 1, 256, 256), "bisenet ffm")
    _expect(params["out_final"]["w"].shape[:3] == (1, 1, 256),
            "bisenet out_final must be a 1x1 conv of 256 channels")
    return params, state


class _Nets:
    """Seeded numpy leaves in the JAX ``init``s' shapes: convs and biases
    uniform(+-1/sqrt(fan_in)), BatchNorm at a random eval state."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.u = _uniform(self.rng)

    def conv(self, cin, cout, k, bias=True):
        fan_in = k * k * cin
        p = {"w": self.u((k, k, cin, cout), fan_in)}
        if bias:
            p["b"] = self.u((cout,), fan_in)
        return p

    def bn(self, c):
        return _random_bn(self.rng, c)

    def conv_bn(self, cin, cout, k):
        bp, bs = self.bn(cout)
        return {"conv": self.conv(cin, cout, k, bias=False), "bn": bp}, \
            {"bn": bs}


def _fan_tree(r: _Nets, n_modules: int):
    from speech2lip_tpu_torch.models import fan

    def brc(cin, cout, k):
        bp, bs = r.bn(cin)
        return {"bn": bp, "conv": r.conv(cin, cout, k, bias=False)}, \
            {"bn": bs}

    def block(cin, cout):
        p, s = {}, {}
        for name, (i, o) in (("b1", (cin, cout // 2)),
                             ("b2", (cout // 2, cout // 4)),
                             ("b3", (cout // 4, cout // 4))):
            p[name], s[name] = brc(i, o, 3)
        if cin != cout:
            p["down"], s["down"] = brc(cin, cout, 1)
        return p, s

    f = fan.HG_FEATS
    params, state = {"conv1": r.conv(3, 64, 7)}, {}
    params["bn1"], state["bn1"] = r.bn(64)
    for name, cin, cout in (("conv2", 64, 128), ("conv3", 128, 128),
                            ("conv4", 128, f)):
        params[name], state[name] = block(cin, cout)
    for k in ("hg", "top", "conv_last", "bn_end", "pred", "bl", "al"):
        params[k] = []
    for k in ("hg", "top", "bn_end"):
        state[k] = []
    for m in range(n_modules):
        hp, hs = {}, {}
        for d in range(1, fan.HG_DEPTH + 1):
            for tag in ("up1", "low1", "low3"):
                hp[f"{tag}_{d}"], hs[f"{tag}_{d}"] = block(f, f)
        hp["low2_1"], hs["low2_1"] = block(f, f)
        params["hg"].append(hp)
        state["hg"].append(hs)
        tp, tsd = block(f, f)
        params["top"].append(tp)
        state["top"].append(tsd)
        params["conv_last"].append(r.conv(f, f, 1))
        bp, bs = r.bn(f)
        params["bn_end"].append(bp)
        state["bn_end"].append(bs)
        params["pred"].append(r.conv(f, fan.N_LANDMARKS, 1))
        if m < n_modules - 1:
            params["bl"].append(r.conv(f, f, 1))
            params["al"].append(r.conv(fan.N_LANDMARKS, f, 1))
    return params, state


def random_fan(seed: int = 0, n_modules: int = 4, device="cpu"):
    """A FAN (params, state) made from a seed, in ``fan.init``'s shapes."""
    return fan_from_jax(*_fan_tree(_Nets(seed), n_modules), device)


def random_s3fd(seed: int = 0, device="cpu"):
    """S3FD params made from a seed, in ``s3fd.init``'s shapes."""
    from speech2lip_tpu_torch.models import s3fd
    r = _Nets(seed)
    params = {}
    for item in s3fd.VGG:
        if item != "M":
            name, cin, cout = item
            params[name] = r.conv(cin, cout, 3)
    for name, cin, cout, k in s3fd.EXTRA:
        params[name] = r.conv(cin, cout, k)
    for s, scale in s3fd.L2_SCALES.items():
        params[s + "_l2"] = {"scale": np.full(
            (params[s]["w"].shape[-1],), scale, np.float32)}
    for i, s in enumerate(s3fd.SOURCES):
        ch = s3fd.SOURCE_CH[s]
        params[f"cls_{s}"] = r.conv(ch, 4 if i == 0 else 2, 3)
        params[f"reg_{s}"] = r.conv(ch, 4, 3)
    return s3fd_from_jax(params, device)


def random_dsfd(seed: int = 0, depths=(3, 8, 36, 3), device="cpu"):
    """A DSFD (params, state) made from a seed, in ``dsfd.init``'s shapes
    (ResNet-152 depths unless given)."""
    from speech2lip_tpu_torch.models import dsfd
    r = _Nets(seed)
    params, state = {}, {}
    params["stem"], state["stem"] = r.conv_bn(3, 64, 7)
    cin = 64
    for li, (n, cout) in enumerate(zip(depths, dsfd.STAGE_CH)):
        bps, bss = [], []
        for bi in range(n):
            c, cmid = (cin if bi == 0 else cout), cout // 4
            bp, bs = {}, {}
            for name, (i, o, k) in (("c1", (c, cmid, 1)),
                                    ("c2", (cmid, cmid, 3)),
                                    ("c3", (cmid, cout, 1))):
                bp[name], bs[name] = r.conv_bn(i, o, k)
            if bi == 0:
                bp["down"], bs["down"] = r.conv_bn(c, cout, 1)
            bps.append(bp)
            bss.append(bs)
        params[f"layer{li + 1}"], state[f"layer{li + 1}"] = bps, bss
        cin = cout
    for name, c1, c2, c3 in dsfd.EXTRA:
        (pa, sa), (pb, sb) = r.conv_bn(c1, c2, 1), r.conv_bn(c2, c3, 3)
        params[name], state[name] = {"a": pa, "b": pb}, {"a": sa, "b": sb}
    for name, ci, co in dsfd.FPN:
        params[name] = r.conv(ci, co, 1)
    for i, cs in enumerate(dsfd.SOURCE_CH):
        params[f"fem{i}"] = {
            "cpm1": r.conv(cs, 256, 3), "cpm2": r.conv(cs, 256, 3),
            "cpm3": r.conv(256, 128, 3), "cpm4": r.conv(256, 128, 3),
            "cpm5": r.conv(128, 128, 3)}
        params[f"cls{i}"] = r.conv(dsfd.FEM_CH, 4 if i == 0 else 2, 3)
        params[f"reg{i}"] = r.conv(dsfd.FEM_CH, 4, 3)
    return dsfd_from_jax(params, state, device)


def random_bisenet(seed: int = 0, device="cpu"):
    """A BiSeNet (params, state) made from a seed, in ``bisenet.init``'s
    shapes."""
    from speech2lip_tpu_torch.models import bisenet
    r = _Nets(seed)
    params, state = {}, {}
    params["stem"], state["stem"] = r.conv_bn(3, 64, 7)
    for name, cin, cout in bisenet.LAYERS:
        bps, bss = [], []
        for i in range(2):
            c = cin if i == 0 else cout
            bp, bs = {}, {}
            bp["c1"], bs["c1"] = r.conv_bn(c, cout, 3)
            bp["c2"], bs["c2"] = r.conv_bn(cout, cout, 3)
            if c != cout:
                bp["down"], bs["down"] = r.conv_bn(c, cout, 1)
            bps.append(bp)
            bss.append(bs)
        params[name], state[name] = bps, bss
    for name, cin in (("arm16", 256), ("arm32", 512)):
        cp, cs = r.conv_bn(cin, 128, 3)
        ap, as_ = r.bn(128)
        params[name] = {"conv": cp, "atten": r.conv(128, 128, 1, bias=False),
                        "atten_bn": ap}
        state[name] = {"conv": cs, "atten_bn": as_}
    for name, cin, cout, k in (("head32", 128, 128, 3),
                               ("head16", 128, 128, 3), ("avg", 512, 128, 1),
                               ("ffm", 256, 256, 1), ("out", 256, 256, 3)):
        params[name], state[name] = r.conv_bn(cin, cout, k)
    params["ffm_a1"] = r.conv(256, 64, 1, bias=False)
    params["ffm_a2"] = r.conv(64, 256, 1, bias=False)
    params["out_final"] = r.conv(256, bisenet.N_CLASSES, 1, bias=False)
    return bisenet_from_jax(params, state, device)
