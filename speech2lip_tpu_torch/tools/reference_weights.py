"""Reference-format weight files made from a seed: the files a user of the
reference downloads, in their names, state_dict keys and blob layouts, for
rehearsing ``tools/convert_weights`` where the pretrained files are absent.

Each state_dict is the inverse of its converter applied to a tree of
``weights.random_*`` (torch Linear [out, in], Conv2d OIHW, Conv1d OIL,
BatchNorm weight / bias / running_mean / running_var /
num_batches_tracked), so converting a file gives that tree back exactly.
The files and their blob layouts:

    model_may.pt               {"model": sd, "it", "epoch_it", "loss_val_best"}
    lipsync_expert.pth         {"state_dict": sd, "global_step", "global_epoch"}
    alex.pth                   torchvision AlexNet ``features`` (bare sd)
    weights/v0.1/alex.pth      the LPIPS linear heads (bare sd)
    79999_iter.pth             BiSeNet (bare sd)
    2DFAN4.pth                 FAN, {"state_dict": sd} with "module." keys
    WIDERFace_DSFD_RES152.pth  DSFD on ResNet-152 (bare sd)
    s3fd-619a316812.pth        S3FD (bare sd)
    deepspeech-0_1_0.npz       DeepSpeech's graph constants by name

At the published widths by default; ``small=True`` narrows what the
converters allow (the talking face's width and canonical depth, DSFD's
depths 1, 1, 1, 1, DeepSpeech's hidden width 32) for tests on a CPU.  FAN
keeps its four modules: the converter reads four.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

# (file name under the output dir) of each artifact kind
FILES = {
    "talking_face": "model_may.pt",
    "syncnet": "lipsync_expert.pth",
    "lpips_alex": "alex.pth",
    "lpips_lin": os.path.join("weights", "v0.1", "alex.pth"),
    "bisenet": "79999_iter.pth",
    "fan": "2DFAN4.pth",
    "dsfd": "WIDERFace_DSFD_RES152.pth",
    "s3fd": "s3fd-619a316812.pth",
    "deepspeech": "deepspeech-0_1_0.npz",
}
# the May geometry's talking face (configs/may: 500^2 canonical depth)
MAY_FACE = 500


def numpy_tree(tree):
    """A tree of tensors as the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy()


class _SD(dict):
    """A state_dict under construction, in torch layouts."""

    def put(self, key, arr):
        import torch
        self[key] = torch.from_numpy(np.ascontiguousarray(arr))

    def linear(self, prefix, p):
        self.put(prefix + ".weight", p["w"].T)
        self.put(prefix + ".bias", p["b"])

    def conv2d(self, prefix, p):
        self.put(prefix + ".weight", p["w"].transpose(3, 2, 0, 1))
        if "b" in p:
            self.put(prefix + ".bias", p["b"])

    def conv1d(self, prefix, p):
        self.put(prefix + ".weight", p["w"].transpose(2, 1, 0))
        self.put(prefix + ".bias", p["b"])

    def bn(self, prefix, p, s):
        self.put(prefix + ".weight", p["scale"])
        self.put(prefix + ".bias", p["bias"])
        self.put(prefix + ".running_mean", s["mean"])
        self.put(prefix + ".running_var", s["var"])
        self.put(prefix + ".num_batches_tracked", np.asarray(0, np.int64))

    def conv_bn(self, conv_prefix, bn_prefix, p, s):
        self.conv2d(conv_prefix, p["conv"])
        self.bn(bn_prefix, p["bn"], s["bn"])


# -- the inverses of the converters -------------------------------------------

def talking_face_sd(params, unet_params, unet_state) -> Dict[str, Any]:
    """The reference TalkingFace state_dict of (talking_face params, unet
    params, unet state) numpy trees."""
    sd = _SD()
    for i, conv in zip((0, 2, 4, 6), params["audio_enc"]["conv"]):
        sd.conv1d(f"encoder_conv.{i}", conv)
    for i, fc in zip((0, 2), params["audio_enc"]["fc"]):
        sd.linear(f"encoder_fc1.{i}", fc)
    for name in ("fc_uv", "fc_uv_skip", "fc_audio", "fc_audio_skip",
                 "fc_time", "fc_time_skip"):
        sd.linear(name, params[name])
    for i, layer in enumerate(params["trunk"]):
        sd.linear(f"pts_linears.{i}", layer)
    sd.linear("output_linear", params["output"])
    if "canonical_depth" in params:
        sd.put("canonical_depth_head", params["canonical_depth"])
    unet = {"inc": "post_fusion_unet.inc",
            "down1": "post_fusion_unet.down1.maxpool_conv.1",
            "down2": "post_fusion_unet.down2.maxpool_conv.1",
            "up1": "post_fusion_unet.up1.conv",
            "up2": "post_fusion_unet.up2.conv"}
    for name, prefix in unet.items():
        p, s = unet_params[name], unet_state[name]
        sd.conv2d(f"{prefix}.double_conv.0", p["conv1"])
        sd.bn(f"{prefix}.double_conv.1", p["bn1"], s["bn1"])
        sd.conv2d(f"{prefix}.double_conv.3", p["conv2"])
        sd.bn(f"{prefix}.double_conv.4", p["bn2"], s["bn2"])
    sd.conv2d("post_fusion_unet.outc.conv", unet_params["outc"])
    return dict(sd)


def syncnet_sd(params, state) -> Dict[str, Any]:
    sd = _SD()
    for name, enc in (("face", "face_encoder"), ("audio", "audio_encoder")):
        for i, (p, s) in enumerate(zip(params[name], state[name])):
            pre = f"{enc}.{i}.conv_block"
            sd.conv2d(pre + ".0", p["conv"])
            sd.bn(pre + ".1", p["bn"], s["bn"])
    return dict(sd)


def lpips_sds(tree):
    """(torchvision AlexNet ``features`` state_dict, LPIPS lin state_dict)."""
    alex, lin = _SD(), _SD()
    for i, conv in zip((0, 3, 6, 8, 10), tree["convs"]):
        alex.conv2d(f"features.{i}", conv)
    for i, head in enumerate(tree["lins"]):
        lin.put(f"lin{i}.model.1.weight", head["w"].transpose(3, 2, 0, 1))
    return dict(alex), dict(lin)


def bisenet_sd(params, state) -> Dict[str, Any]:
    sd = _SD()
    sd.conv_bn("cp.resnet.conv1", "cp.resnet.bn1", params["stem"],
               state["stem"])
    for li in range(1, 5):
        for b, (p, s) in enumerate(zip(params[f"layer{li}"],
                                       state[f"layer{li}"])):
            pre = f"cp.resnet.layer{li}.{b}"
            sd.conv_bn(pre + ".conv1", pre + ".bn1", p["c1"], s["c1"])
            sd.conv_bn(pre + ".conv2", pre + ".bn2", p["c2"], s["c2"])
            if "down" in p:
                sd.conv_bn(pre + ".downsample.0", pre + ".downsample.1",
                           p["down"], s["down"])
    cbr = lambda pre, p, s: sd.conv_bn(pre + ".conv", pre + ".bn", p, s)
    for arm in ("arm16", "arm32"):
        p, s = params[arm], state[arm]
        cbr(f"cp.{arm}.conv", p["conv"], s["conv"])
        sd.conv2d(f"cp.{arm}.conv_atten", p["atten"])
        sd.bn(f"cp.{arm}.bn_atten", p["atten_bn"], s["atten_bn"])
    for mine, theirs in (("head32", "cp.conv_head32"),
                         ("head16", "cp.conv_head16"), ("avg", "cp.conv_avg"),
                         ("ffm", "ffm.convblk"), ("out", "conv_out.conv")):
        cbr(theirs, params[mine], state[mine])
    sd.conv2d("ffm.conv1", params["ffm_a1"])
    sd.conv2d("ffm.conv2", params["ffm_a2"])
    sd.conv2d("conv_out.conv_out", params["out_final"])
    return dict(sd)


_S3FD_HEADS = {"conv3_3": "conv3_3_norm", "conv4_3": "conv4_3_norm",
               "conv5_3": "conv5_3_norm", "fc7": "fc7",
               "conv6_2": "conv6_2", "conv7_2": "conv7_2"}


def s3fd_sd(params) -> Dict[str, Any]:
    sd = _SD()
    for name, p in params.items():
        if name.endswith("_l2"):
            sd.put(name[:-3] + "_norm.weight", p["scale"])
        elif name.startswith(("cls_", "reg_")):
            src = name[4:]
            tag = "conf" if name.startswith("cls_") else "loc"
            sd.conv2d(f"{_S3FD_HEADS[src]}_mbox_{tag}", p)
        else:
            sd.conv2d(name, p)
    return dict(sd)


_DSFD_STAGES = {1: "layer1.4", 2: "layer2.0", 3: "layer3.0", 4: "layer4.0"}
_DSFD_FPN = (("lat3", "latlayer3"), ("lat2", "latlayer2"),
             ("lat1", "latlayer1"), ("smooth3", "smooth3"),
             ("smooth2", "smooth2"), ("smooth1", "smooth1"))
_DSFD_FEMS = ("cpm3_3", "cpm4_3", "cpm5_3", "cpm7", "cpm6_2", "cpm7_2")


def dsfd_sd(params, state) -> Dict[str, Any]:
    sd = _SD()
    sd.conv_bn("layer1.0", "layer1.1", params["stem"], state["stem"])
    for li, pre in _DSFD_STAGES.items():
        for bi, (p, s) in enumerate(zip(params[f"layer{li}"],
                                        state[f"layer{li}"])):
            blk = f"{pre}.{bi}"
            for i in (1, 2, 3):
                sd.conv_bn(f"{blk}.conv{i}", f"{blk}.bn{i}", p[f"c{i}"],
                           s[f"c{i}"])
            if "down" in p:
                sd.conv_bn(f"{blk}.downsample.0", f"{blk}.downsample.1",
                           p["down"], s["down"])
    for name in ("layer5", "layer6"):
        p, s = params[name], state[name]
        sd.conv_bn(f"{name}.0", f"{name}.1", p["a"], s["a"])
        sd.conv_bn(f"{name}.3", f"{name}.4", p["b"], s["b"])
    for mine, theirs in _DSFD_FPN:
        sd.conv2d(theirs, params[mine])
    for i, fem in enumerate(_DSFD_FEMS):
        for j in range(1, 6):
            sd.conv2d(f"{fem}.cpm{j}", params[f"fem{i}"][f"cpm{j}"])
        sd.conv2d(f"conf_pal2.{i}", params[f"cls{i}"])
        sd.conv2d(f"loc_pal2.{i}", params[f"reg{i}"])
    return dict(sd)


def fan_sd(params, state) -> Dict[str, Any]:
    sd = _SD()

    def brc(bn_prefix, conv_prefix, p, s):
        sd.bn(bn_prefix, p["bn"], s["bn"])
        sd.conv2d(conv_prefix, p["conv"])

    def block(prefix, p, s):
        for i in (1, 2, 3):
            brc(f"{prefix}.bn{i}", f"{prefix}.conv{i}", p[f"b{i}"],
                s[f"b{i}"])
        if "down" in p:
            brc(prefix + ".downsample.0", prefix + ".downsample.2",
                p["down"], s["down"])

    sd.conv2d("conv1", params["conv1"])
    sd.bn("bn1", params["bn1"], state["bn1"])
    for name in ("conv2", "conv3", "conv4"):
        block(name, params[name], state[name])
    for m, (hp, hs) in enumerate(zip(params["hg"], state["hg"])):
        for key in hp:
            mine, d = key.rsplit("_", 1)
            theirs = {"up1": "b1", "low1": "b2", "low3": "b3",
                      "low2": "b2_plus"}[mine]
            block(f"m{m}.{theirs}_{d}", hp[key], hs[key])
        block(f"top_m_{m}", params["top"][m], state["top"][m])
        sd.conv2d(f"conv_last{m}", params["conv_last"][m])
        sd.bn(f"bn_end{m}", params["bn_end"][m], state["bn_end"][m])
        sd.conv2d(f"l{m}", params["pred"][m])
        if m < len(params["bl"]):
            sd.conv2d(f"bl{m}", params["bl"][m])
            sd.conv2d(f"al{m}", params["al"][m])
    return {"module." + k: v for k, v in sd.items()}


def deepspeech_consts(tree) -> Dict[str, np.ndarray]:
    """DeepSpeech 0.1.0's graph constants by name."""
    out = {}
    for i, name in ((1, "fc1"), (2, "fc2"), (3, "fc3"), (5, "fc5"),
                    (6, "fc6")):
        out[f"h{i}"], out[f"b{i}"] = tree[name]["w"], tree[name]["b"]
    for d in ("fw", "bw"):
        cell = f"bidirectional_rnn/{d}/basic_lstm_cell"
        out[cell + "/kernel"] = tree[f"lstm_{d}"]["kernel"]
        out[cell + "/bias"] = tree[f"lstm_{d}"]["bias"]
    return out


# -- the trees and the files --------------------------------------------------

def reference_trees(seed: int = 0, small: bool = False) -> Dict[str, Any]:
    """The numpy trees the files hold, by kind, made from ``seed``: each
    is what its converter must give back."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.config import default_config
    cfg = default_config()
    face = 16 if small else MAY_FACE
    cfg["model"].update(canonical_depth_height=face,
                        canonical_depth_width=face)
    if small:
        cfg["model"]["net_width"] = 32
    return {
        "talking_face": numpy_tree(weights.random_params(seed, cfg=cfg)),
        "syncnet": numpy_tree(weights.random_syncnet(seed + 1)),
        "lpips": numpy_tree(weights.random_lpips(seed + 2)),
        "bisenet": numpy_tree(weights.random_bisenet(seed + 3)),
        "fan": numpy_tree(weights.random_fan(seed + 4, n_modules=4)),
        "dsfd": numpy_tree(weights.random_dsfd(
            seed + 5, **({"depths": (1, 1, 1, 1)} if small else {}))),
        "s3fd": numpy_tree(weights.random_s3fd(seed + 6)),
        "deepspeech": numpy_tree(weights.random_deepspeech(
            seed + 7, **({"hidden": 32} if small else {}))),
    }


def write_reference_files(out_dir: str, trees: Dict[str, Any]
                          ) -> Dict[str, str]:
    """Write ``trees`` (``reference_trees``) as the reference's files under
    ``out_dir``; returns {file kind: path}."""
    import torch
    paths = {k: os.path.join(out_dir, v) for k, v in FILES.items()}
    os.makedirs(os.path.dirname(paths["lpips_lin"]), exist_ok=True)
    alex, lin = lpips_sds(trees["lpips"])
    blobs = {
        "talking_face": {"model": talking_face_sd(*trees["talking_face"]),
                         "it": 0, "epoch_it": 0,
                         "loss_val_best": float("inf")},
        "syncnet": {"state_dict": syncnet_sd(*trees["syncnet"]),
                    "global_step": 0, "global_epoch": 0},
        "lpips_alex": alex, "lpips_lin": lin,
        "bisenet": bisenet_sd(*trees["bisenet"]),
        "fan": {"state_dict": fan_sd(*trees["fan"])},
        "dsfd": dsfd_sd(*trees["dsfd"]),
        "s3fd": s3fd_sd(trees["s3fd"]),
    }
    for kind, blob in blobs.items():
        torch.save(blob, paths[kind])
    np.savez(paths["deepspeech"], **deepspeech_consts(trees["deepspeech"]))
    return paths

