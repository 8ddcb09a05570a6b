"""Convert reference PyTorch / TensorFlow checkpoints to the weights files
both packages read (counterpart of the JAX package's
``tools/convert_weights.py``, with its converters, file names and keys).

Supported sources (each optional: convert what you have):
- model_may.pt (reference CheckpointIO format): TalkingFace + post-fusion
  U-Net + canonical depth -> talking_face.ckpt + unet.ckpt
- lipsync_expert.pth (Wav2Lip SyncNet) -> syncnet tree
- lpips alex.pth + lpips_weights_v0.1/alex.pth -> lpips tree
- 79999_iter.pth (BiSeNet), 2DFAN4.pth (FAN), WIDERFace_DSFD_RES152.pth
  (DSFD), s3fd*.pth (S3FD)
- DeepSpeech 0.1.0 as an .npz of the frozen graph's named constants (a
  .pb needs TensorFlow)

Layout mapping: torch Linear [out,in] -> [in,out]; Conv2d OIHW -> HWIO;
Conv1d OIL -> LIO.  The outputs are the JAX package's npz checkpoints,
written by ``core/checkpoint.save``, so either package loads them.  Only
host files are read and written; no device is touched.

Every ``.pt`` / ``.pth`` is read with ``torch.load(weights_only=True)``:
a blob of tensors, dicts, lists and numbers loads; one that the
weights-only unpickler refuses raises with the file's name, and is never
unpickled in full.

Usage:
  python -m speech2lip_tpu_torch.tools.convert_weights talking_face model_may.pt out_dir/
  python -m speech2lip_tpu_torch.tools.convert_weights syncnet lipsync_expert.pth out.ckpt
  python -m speech2lip_tpu_torch.tools.convert_weights lpips alex.pth lin_alex.pth out.ckpt
  python -m speech2lip_tpu_torch.tools.convert_weights {bisenet,fan,dsfd,s3fd} in.pth out.ckpt
  python -m speech2lip_tpu_torch.tools.convert_weights deepspeech model.npz out.ckpt
  python -m speech2lip_tpu_torch.tools.convert_weights --all SRC_DIR OUT_DIR
"""

from __future__ import annotations

import glob
import os
import pickle
import sys

import numpy as np


def _t(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _linear(sd, prefix):
    return {"w": _t(sd[prefix + ".weight"]).T.copy(),
            "b": _t(sd[prefix + ".bias"])}


def _conv2d(sd, prefix, bias=True):
    p = {"w": _t(sd[prefix + ".weight"]).transpose(2, 3, 1, 0).copy()}
    if bias and prefix + ".bias" in sd:
        p["b"] = _t(sd[prefix + ".bias"])
    return p


def _conv1d(sd, prefix):
    return {"w": _t(sd[prefix + ".weight"]).transpose(2, 1, 0).copy(),
            "b": _t(sd[prefix + ".bias"])}


def _bn(sd, prefix):
    params = {"scale": _t(sd[prefix + ".weight"]),
              "bias": _t(sd[prefix + ".bias"])}
    state = {"mean": _t(sd[prefix + ".running_mean"]),
             "var": _t(sd[prefix + ".running_var"])}
    return params, state


# ---------------------------------------------------------------------------
# TalkingFace + U-Net (reference tf_nerf.py state_dict names)
# ---------------------------------------------------------------------------

def convert_talking_face(sd):
    """state_dict of reference TalkingFace → (tf_params, unet_params,
    unet_state) pytrees matching models/talking_face.py + unet_light.py."""
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    params = {
        "audio_enc": {
            "conv": [_conv1d(sd, f"encoder_conv.{i}") for i in (0, 2, 4, 6)],
            "fc": [_linear(sd, "encoder_fc1.0"), _linear(sd, "encoder_fc1.2")],
        },
        "fc_uv": _linear(sd, "fc_uv"),
        "fc_uv_skip": _linear(sd, "fc_uv_skip"),
        "fc_audio": _linear(sd, "fc_audio"),
        "fc_audio_skip": _linear(sd, "fc_audio_skip"),
        "fc_time": _linear(sd, "fc_time"),
        "fc_time_skip": _linear(sd, "fc_time_skip"),
        "trunk": [_linear(sd, f"pts_linears.{i}") for i in range(8)],
        "output": _linear(sd, "output_linear"),
    }
    if "canonical_depth_head" in sd:
        params["canonical_depth"] = _t(sd["canonical_depth_head"])

    def dconv(prefix):
        p1, s1 = _bn(sd, f"{prefix}.double_conv.1")
        p2, s2 = _bn(sd, f"{prefix}.double_conv.4")
        return ({"conv1": _conv2d(sd, f"{prefix}.double_conv.0", bias=False),
                 "bn1": p1,
                 "conv2": _conv2d(sd, f"{prefix}.double_conv.3", bias=False),
                 "bn2": p2},
                {"bn1": s1, "bn2": s2})

    unet_params, unet_state = {}, {}
    unet_params["inc"], unet_state["inc"] = dconv("post_fusion_unet.inc")
    unet_params["down1"], unet_state["down1"] = dconv(
        "post_fusion_unet.down1.maxpool_conv.1")
    unet_params["down2"], unet_state["down2"] = dconv(
        "post_fusion_unet.down2.maxpool_conv.1")
    unet_params["up1"], unet_state["up1"] = dconv("post_fusion_unet.up1.conv")
    unet_params["up2"], unet_state["up2"] = dconv("post_fusion_unet.up2.conv")
    unet_params["outc"] = _conv2d(sd, "post_fusion_unet.outc.conv")
    return params, unet_params, unet_state


# ---------------------------------------------------------------------------
# SyncNet (reference syncnet.py state_dict names)
# ---------------------------------------------------------------------------

def convert_syncnet(sd):
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    from speech2lip_tpu_torch.models.syncnet import (AUDIO_SPEC,
                                                       FACE_SPEC)

    def encoder(name, spec):
        out = []
        for i in range(len(spec)):
            prefix = f"{name}.{i}.conv_block"
            bn_p, bn_s = _bn(sd, prefix + ".1")
            out.append(({"conv": _conv2d(sd, prefix + ".0"), "bn": bn_p},
                        {"bn": bn_s}))
        return [p for p, _ in out], [s for _, s in out]

    fp, fs = encoder("face_encoder", FACE_SPEC)
    ap, as_ = encoder("audio_encoder", AUDIO_SPEC)
    return ({"face": fp, "audio": ap}, {"face": fs, "audio": as_})


# ---------------------------------------------------------------------------
# LPIPS (torchvision alexnet features + lpips lin heads)
# ---------------------------------------------------------------------------

def convert_lpips(alexnet_sd, lin_sd):
    conv_ids = [0, 3, 6, 8, 10]  # torchvision alexnet.features indices
    convs = [_conv2d(alexnet_sd, f"features.{i}") for i in conv_ids]
    lins = [{"w": _t(lin_sd[f"lin{i}.model.1.weight"])
             .transpose(2, 3, 1, 0).copy()} for i in range(5)]
    return {"convs": convs, "lins": lins}


# ---------------------------------------------------------------------------
# BiSeNet face parser (79999_iter.pth state_dict names)
# ---------------------------------------------------------------------------

def convert_bisenet(sd):
    sd = {k.replace("module.", ""): v for k, v in sd.items()}

    def conv_bn(conv_prefix, bn_prefix):
        p, s = _bn(sd, bn_prefix)
        return ({"conv": _conv2d(sd, conv_prefix, bias=False), "bn": p},
                {"bn": s})

    def cbr(prefix):  # ConvBNReLU module
        return conv_bn(prefix + ".conv", prefix + ".bn")

    params, state = {}, {}
    params["stem"], state["stem"] = conv_bn("cp.resnet.conv1",
                                            "cp.resnet.bn1")
    for li, name in enumerate(("layer1", "layer2", "layer3", "layer4"), 1):
        bp, bs = [], []
        for b in range(2):
            pre = f"cp.resnet.layer{li}.{b}"
            p1, s1 = conv_bn(pre + ".conv1", pre + ".bn1")
            p2, s2 = conv_bn(pre + ".conv2", pre + ".bn2")
            blk_p, blk_s = {"c1": p1, "c2": p2}, {"c1": s1, "c2": s2}
            if pre + ".downsample.0.weight" in sd:
                pd, sdn = conv_bn(pre + ".downsample.0", pre + ".downsample.1")
                blk_p["down"], blk_s["down"] = pd, sdn
            bp.append(blk_p)
            bs.append(blk_s)
        params[name], state[name] = bp, bs

    for arm in ("arm16", "arm32"):
        conv, conv_s = cbr(f"cp.{arm}.conv")
        att_bn_p, att_bn_s = _bn(sd, f"cp.{arm}.bn_atten")
        params[arm] = {"conv": conv,
                       "atten": _conv2d(sd, f"cp.{arm}.conv_atten",
                                        bias=False),
                       "atten_bn": att_bn_p}
        state[arm] = {"conv": conv_s, "atten_bn": att_bn_s}
    params["head32"], state["head32"] = cbr("cp.conv_head32")
    params["head16"], state["head16"] = cbr("cp.conv_head16")
    params["avg"], state["avg"] = cbr("cp.conv_avg")
    params["ffm"], state["ffm"] = cbr("ffm.convblk")
    params["ffm_a1"] = _conv2d(sd, "ffm.conv1", bias=False)
    params["ffm_a2"] = _conv2d(sd, "ffm.conv2", bias=False)
    params["out"], state["out"] = cbr("conv_out.conv")
    params["out_final"] = _conv2d(sd, "conv_out.conv_out", bias=False)
    return params, state


# ---------------------------------------------------------------------------
# S3FD face detector (face_alignment s3fd state_dict names)
# ---------------------------------------------------------------------------

def convert_s3fd(sd):
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    params = {}
    convs = ["conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1",
             "conv3_2", "conv3_3", "conv4_1", "conv4_2", "conv4_3",
             "conv5_1", "conv5_2", "conv5_3", "fc6", "fc7",
             "conv6_1", "conv6_2", "conv7_1", "conv7_2"]
    for name in convs:
        params[name] = _conv2d(sd, name)
    for src in ("conv3_3", "conv4_3", "conv5_3"):
        params[src + "_l2"] = {"scale": _t(sd[f"{src}_norm.weight"])}
    head_names = {  # face_alignment naming for the per-source heads
        "conv3_3": ("conv3_3_norm_mbox_conf", "conv3_3_norm_mbox_loc"),
        "conv4_3": ("conv4_3_norm_mbox_conf", "conv4_3_norm_mbox_loc"),
        "conv5_3": ("conv5_3_norm_mbox_conf", "conv5_3_norm_mbox_loc"),
        "fc7": ("fc7_mbox_conf", "fc7_mbox_loc"),
        "conv6_2": ("conv6_2_mbox_conf", "conv6_2_mbox_loc"),
        "conv7_2": ("conv7_2_mbox_conf", "conv7_2_mbox_loc"),
    }
    for src, (cname, rname) in head_names.items():
        params[f"cls_{src}"] = _conv2d(sd, cname)
        params[f"reg_{src}"] = _conv2d(sd, rname)
    return params


# ---------------------------------------------------------------------------
# DSFD (pip face_detection package's WIDERFace_DSFD_RES152.pth naming:
# dsfd/face_ssd.py wraps torchvision resnet152 stages in nn.Sequential, so
# layer1 = [conv1, bn1, relu, maxpool, resnet.layer1] and layer2..4 are
# single-element Sequentials; layer5/layer6 are [conv,bn,relu]×2; FEM
# modules are cpm3_3/cpm4_3/cpm5_3/cpm7/cpm6_2/cpm7_2 with cpm1..cpm5
# branches; PAL2 heads are loc_pal2.<i>/conf_pal2.<i>.)
# ---------------------------------------------------------------------------

def convert_dsfd(sd):
    sd = {k.replace("module.", ""): v for k, v in sd.items()}

    def conv_bn(conv_prefix, bn_prefix):
        p, s = _bn(sd, bn_prefix)
        return ({"conv": _conv2d(sd, conv_prefix, bias=False), "bn": p},
                {"bn": s})

    def bottleneck(prefix):
        p, s = {}, {}
        for i in (1, 2, 3):
            p[f"c{i}"], s[f"c{i}"] = conv_bn(f"{prefix}.conv{i}",
                                             f"{prefix}.bn{i}")
        if f"{prefix}.downsample.0.weight" in sd:
            p["down"], s["down"] = conv_bn(f"{prefix}.downsample.0",
                                           f"{prefix}.downsample.1")
        return p, s

    params, state = {}, {}
    params["stem"], state["stem"] = conv_bn("layer1.0", "layer1.1")
    stage_prefixes = {1: "layer1.4", 2: "layer2.0", 3: "layer3.0",
                      4: "layer4.0"}
    for li, pre in stage_prefixes.items():
        blocks_p, blocks_s = [], []
        bi = 0
        while f"{pre}.{bi}.conv1.weight" in sd:
            bp, bs = bottleneck(f"{pre}.{bi}")
            blocks_p.append(bp)
            blocks_s.append(bs)
            bi += 1
        params[f"layer{li}"] = blocks_p
        state[f"layer{li}"] = blocks_s
    for name in ("layer5", "layer6"):
        pa, sa = conv_bn(f"{name}.0", f"{name}.1")
        pb, sb = conv_bn(f"{name}.3", f"{name}.4")
        params[name] = {"a": pa, "b": pb}
        state[name] = {"a": sa, "b": sb}
    for mine, theirs in (("lat3", "latlayer3"), ("lat2", "latlayer2"),
                         ("lat1", "latlayer1"), ("smooth3", "smooth3"),
                         ("smooth2", "smooth2"), ("smooth1", "smooth1")):
        params[mine] = _conv2d(sd, theirs)
    fem_names = ["cpm3_3", "cpm4_3", "cpm5_3", "cpm7", "cpm6_2", "cpm7_2"]
    for i, fem in enumerate(fem_names):
        params[f"fem{i}"] = {f"cpm{j}": _conv2d(sd, f"{fem}.cpm{j}")
                             for j in range(1, 6)}
        params[f"cls{i}"] = _conv2d(sd, f"conf_pal2.{i}")
        params[f"reg{i}"] = _conv2d(sd, f"loc_pal2.{i}")
    return params, state


# ---------------------------------------------------------------------------
# FAN 2D face-alignment network (face_alignment 2DFAN4 state_dict names)
# ---------------------------------------------------------------------------

def convert_fan(sd, n_modules=4):
    sd = {k.replace("module.", ""): v for k, v in sd.items()}

    def bn(prefix):
        p = {"scale": _t(sd[prefix + ".weight"]),
             "bias": _t(sd[prefix + ".bias"])}
        s = {"mean": _t(sd[prefix + ".running_mean"]),
             "var": _t(sd[prefix + ".running_var"])}
        return p, s

    def brc(bn_prefix, conv_prefix):  # BN→ReLU→conv unit
        bp, bs = bn(bn_prefix)
        return ({"bn": bp, "conv": _conv2d(sd, conv_prefix, bias=False)},
                {"bn": bs})

    def conv_block(prefix):
        p1, s1 = brc(prefix + ".bn1", prefix + ".conv1")
        p2, s2 = brc(prefix + ".bn2", prefix + ".conv2")
        p3, s3 = brc(prefix + ".bn3", prefix + ".conv3")
        params = {"b1": p1, "b2": p2, "b3": p3}
        state = {"b1": s1, "b2": s2, "b3": s3}
        if prefix + ".downsample.0.weight" in sd:
            dp, ds = brc(prefix + ".downsample.0", prefix + ".downsample.2")
            params["down"], state["down"] = dp, ds
        return params, state

    def hourglass(prefix, depth=4):
        params, state = {}, {}
        for d in range(1, depth + 1):
            for src, dst in (("b1", "up1"), ("b2", "low1"), ("b3", "low3")):
                p, s = conv_block(f"{prefix}.{src}_{d}")
                params[f"{dst}_{d}"], state[f"{dst}_{d}"] = p, s
        p, s = conv_block(f"{prefix}.b2_plus_1")
        params["low2_1"], state["low2_1"] = p, s
        return params, state

    params = {"conv1": _conv2d(sd, "conv1", bias=True)}
    state = {}
    params["bn1"], state["bn1"] = bn("bn1")
    for name in ("conv2", "conv3", "conv4"):
        params[name], state[name] = conv_block(name)
    hg, top, cl, be, pred, bl, al = [], [], [], [], [], [], []
    hg_s, top_s, be_s = [], [], []
    for m in range(n_modules):
        p, s = hourglass(f"m{m}")
        hg.append(p); hg_s.append(s)
        p, s = conv_block(f"top_m_{m}")
        top.append(p); top_s.append(s)
        cl.append(_conv2d(sd, f"conv_last{m}", bias=True))
        bp, bs = bn(f"bn_end{m}")
        be.append(bp); be_s.append(bs)
        pred.append(_conv2d(sd, f"l{m}", bias=True))
        if m < n_modules - 1:
            bl.append(_conv2d(sd, f"bl{m}", bias=True))
            al.append(_conv2d(sd, f"al{m}", bias=True))
    params.update({"hg": hg, "top": top, "conv_last": cl, "bn_end": be,
                   "pred": pred, "bl": bl, "al": al})
    state.update({"hg": hg_s, "top": top_s, "bn_end": be_s})
    return params, state


# ---------------------------------------------------------------------------
# DeepSpeech 0.1.0 frozen graph
# ---------------------------------------------------------------------------

def convert_deepspeech(pb_path):
    """DeepSpeech 0.1.0 weights from an ``.npz`` of the frozen graph's
    named constants.  A ``.pb`` needs TensorFlow to parse: where it is
    installed its constants are read, else an ImportError names it (run
    the conversion where TensorFlow exists and ship the ``.ckpt``)."""
    if pb_path.endswith(".npz"):
        z = np.load(pb_path)
        arrs = {k: z[k] for k in z.files}
    else:
        try:
            import tensorflow as tf
        except ImportError as e:
            raise ImportError(
                f"{pb_path}: reading a DeepSpeech .pb graph needs TensorFlow, "
                "which is not installed; convert it where TensorFlow exists, "
                "or pass an .npz of the graph's named constants") from e
        gd = tf.compat.v1.GraphDef()
        with open(pb_path, "rb") as f:
            gd.ParseFromString(f.read())
        arrs = {}
        for node in gd.node:
            if node.op == "Const":
                t = node.attr["value"].tensor
                arrs[node.name] = np.array(tf.make_ndarray(t))

    def find(*names):
        for n in names:
            if n in arrs:
                return arrs[n]
        raise KeyError(f"none of {names} in graph constants: "
                       f"{sorted(arrs)[:20]}...")

    return {
        "fc1": {"w": find("h1"), "b": find("b1")},
        "fc2": {"w": find("h2"), "b": find("b2")},
        "fc3": {"w": find("h3"), "b": find("b3")},
        "lstm_fw": {
            "kernel": find("bidirectional_rnn/fw/basic_lstm_cell/kernel",
                           "bidirectional_rnn/fw/basic_lstm_cell/weights"),
            "bias": find("bidirectional_rnn/fw/basic_lstm_cell/bias",
                         "bidirectional_rnn/fw/basic_lstm_cell/biases")},
        "lstm_bw": {
            "kernel": find("bidirectional_rnn/bw/basic_lstm_cell/kernel",
                           "bidirectional_rnn/bw/basic_lstm_cell/weights"),
            "bias": find("bidirectional_rnn/bw/basic_lstm_cell/bias",
                         "bidirectional_rnn/bw/basic_lstm_cell/biases")},
        "fc5": {"w": find("h5"), "b": find("b5")},
        "fc6": {"w": find("h6"), "b": find("b6")},
    }


# the reference artifact kinds (reference README.md:57 weight inventory +
# the detectors its preprocess scripts download), matched by the filenames
# the reference documents.  Each entry:
# kind -> (output ckpt name, [candidate source filename globs])
ALL_ARTIFACTS = {
    "talking_face": ("talking_face", ["model_may.pt", "model_*.pt"]),
    "syncnet": ("syncnet_weights.ckpt", ["lipsync_expert.pth"]),
    "lpips": ("lpips_weights.ckpt", ["alex.pth"]),  # + lin weights, below
    "bisenet": ("bisenet_weights.ckpt", ["79999_iter.pth"]),
    "fan": ("fan_weights.ckpt", ["2DFAN4.pth", "2DFAN-4.pth",
                                 "2DFAN4*.pth"]),
    "dsfd": ("dsfd_weights.ckpt", ["WIDERFace_DSFD_RES152.pth",
                                   "dsfd*.pth"]),
    "s3fd": ("s3fd_weights.ckpt", ["s3fd*.pth"]),
    "deepspeech": ("deepspeech.ckpt", ["deepspeech*.pb", "*.pb"]),
}


def convert_all(src_dir: str, out_dir: str):
    """Convert every reference artifact present under ``src_dir``
    (searched recursively) into ``out_dir``: the one-command path for a
    user bringing the reference's downloaded weights.  Returns
    {kind: output_path} for the artifacts found."""
    os.makedirs(out_dir, exist_ok=True)

    def find(patterns):
        for pat in patterns:
            hits = (glob.glob(os.path.join(src_dir, pat))
                    + glob.glob(os.path.join(src_dir, "**", pat),
                                recursive=True))
            if hits:
                return sorted(hits)[0]
        return None

    done = {}
    for kind, (out_name, patterns) in ALL_ARTIFACTS.items():
        src = find(patterns)
        if src is None:
            print(f"[convert --all] {kind}: no source found "
                  f"({patterns[0]}) - skipped")
            continue
        out = os.path.join(out_dir, out_name)
        if kind == "talking_face":
            argv = [kind, src, out_dir]
            out = os.path.join(out_dir, "talking_face.ckpt")
        elif kind == "lpips":
            # the official LPIPS release names BOTH files alex.pth (the
            # ~230 MB torchvision backbone vs the ~6 KB linear head under
            # weights/v0.1/): disambiguate by size, largest = backbone
            hits = sorted(set(
                glob.glob(os.path.join(src_dir, "**", "alex.pth"),
                          recursive=True)
                + glob.glob(os.path.join(src_dir, "alex.pth"))
                + glob.glob(os.path.join(src_dir, "**", "lin_alex.pth"),
                            recursive=True)), key=os.path.getsize)
            if len(hits) < 2:
                print("[convert --all] lpips: need both the alexnet "
                      "backbone and the LPIPS linear head (alex.pth x2 or "
                      "lin_alex.pth) - skipped")
                continue
            argv = [kind, hits[-1], hits[0], out]
        else:
            argv = [kind, src, out]
        main(argv)
        done[kind] = out
        print(f"[convert --all] {kind}: {src} -> {out}")
    return done


def load_blob(path: str):
    """A reference ``.pt`` / ``.pth`` blob on the host, by the weights-only
    unpickler; a blob it refuses raises with the file's name."""
    import torch
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise pickle.UnpicklingError(
            f"{path}: the weights-only unpickler refused this file (it "
            "holds objects other than tensors, dicts, lists and numbers); "
            "re-save its state_dict alone. " + str(e).splitlines()[0]) from e


def main(argv=None):
    from speech2lip_tpu_torch.core import checkpoint as ckpt

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    kind = argv[0]
    if kind == "--all":
        found = convert_all(argv[1], argv[2])
        print(f"converted {len(found)}/{len(ALL_ARTIFACTS)} artifact kinds")
        return found
    if kind == "talking_face":
        src, out_dir = argv[1], argv[2]
        blob = load_blob(src)
        sd = blob.get("model", blob)
        tf_p, unet_p, unet_s = convert_talking_face(sd)
        ckpt.save(f"{out_dir}/talking_face.ckpt", tf_p)
        ckpt.save(f"{out_dir}/unet.ckpt", {"params": unet_p, "state": unet_s})
    elif kind == "syncnet":
        blob = load_blob(argv[1])
        ckpt.save(argv[2], convert_syncnet(blob["state_dict"]))
    elif kind == "lpips":
        alex, lin = load_blob(argv[1]), load_blob(argv[2])
        ckpt.save(argv[3], convert_lpips(alex, lin))
    elif kind == "s3fd":
        blob = load_blob(argv[1])
        ckpt.save(argv[2], convert_s3fd(blob.get("state_dict", blob)))
    elif kind == "dsfd":
        blob = load_blob(argv[1])
        p, s = convert_dsfd(blob.get("state_dict", blob))
        ckpt.save(argv[2], {"params": p, "state": s})
    elif kind == "fan":
        blob = load_blob(argv[1])
        p, s = convert_fan(blob.get("state_dict", blob))
        ckpt.save(argv[2], {"params": p, "state": s})
    elif kind == "bisenet":
        p, s = convert_bisenet(load_blob(argv[1]))
        ckpt.save(argv[2], {"params": p, "state": s})
    elif kind == "deepspeech":
        ckpt.save(argv[2], convert_deepspeech(argv[1]))
    else:
        raise SystemExit(f"unknown kind {kind}")
    print("converted", kind)
    return {kind: argv[-1]}


if __name__ == "__main__":
    main()
