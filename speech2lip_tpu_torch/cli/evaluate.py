"""Evaluation CLI: the PSNR / SSIM / CPBD / LMD / Sync-score protocol
(counterpart of ``speech2lip_tpu/cli/evaluate.py``).

    python -m speech2lip_tpu_torch.cli.evaluate --pred rendering_result/may/postfusion \
        --gt dataset/may_face_crop_lip/ori_images_face [--offset N] \
        [--lms-pred DIR --lms-gt DIR | --lms-from-fan [WEIGHTS]] \
        [--config configs/may/may.yaml --sync] [--device cuda|cpu]

Scores a rendered directory against ground truth and prints one JSON line
of metric values (``main`` also returns it).  Frames go to the device in
batches; it is the card unless ``--device`` names another.

``--lms-from-fan`` scores LMD with a landmark detector on both frame sets,
as the JAX CLI chooses it: the FAN with the weights at the given path (the
JAX CLI's ``(params, state)`` tuple file, or a ``{"params", "state"}``
one), else the repository's distilled detector
(``models/tiny_landmarks.ckpt``, ``lmd_detector: "tiny"``), else a random
FAN (``"fan-random"``: ``weights.random_fan(0)``, another random net than
the JAX CLI's ``fan.init(PRNGKey(0))``).
"""

from __future__ import annotations

import argparse
import json
import os

# frames a batch on the device
CHUNK = 16


def _read(path: str, rgb: bool = False):
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if rgb else img


def main(argv=None):
    p = argparse.ArgumentParser(description="Score rendered frames.")
    p.add_argument("--pred", required=True, help="rendered frames dir")
    p.add_argument("--gt", required=True, help="ground-truth frames dir")
    p.add_argument("--offset", type=int, default=0,
                   help="index of the first GT frame matching pred 00001.jpg")
    p.add_argument("--lms-pred", help="landmarks dir for rendered frames")
    p.add_argument("--lms-gt", help="landmarks dir for GT frames")
    p.add_argument("--lms-from-fan", nargs="?", const="models/fan_weights.ckpt",
                   default=None, metavar="WEIGHTS",
                   help="compute LMD by running a landmark detector on both "
                        "frame sets; with no FAN weights at WEIGHTS, the "
                        "repository's models/tiny_landmarks.ckpt")
    p.add_argument("--config", help="config (for the sync score)")
    p.add_argument("--sync", action="store_true",
                   help="compute the SyncNet confidence score")
    p.add_argument("--max-frames", type=int, default=10000)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to score on (default: the card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from speech2lip_tpu_torch.core.device import resolve_device
    from speech2lip_tpu_torch.train import metrics_eval as me

    device = resolve_device(args.device)
    pred_files = sorted(f for f in os.listdir(args.pred)
                        if f.endswith(".jpg"))[:args.max_frames]
    gt_files = sorted(f for f in os.listdir(args.gt) if f.endswith(".jpg"))
    gt_of = [gt_files[args.offset + i] for i in range(len(pred_files))]
    psnrs, ssims, cpbds = [], [], []
    for s in range(0, len(pred_files), CHUNK):
        load = lambda d, names: torch.from_numpy(np.stack(
            [_read(os.path.join(d, f)) for f in names])).to(device,
                                                            torch.float64)
        pred = load(args.pred, pred_files[s:s + CHUNK])
        gt = load(args.gt, gt_of[s:s + CHUNK])
        psnrs.append(me.psnr(gt, pred))
        ssims.append(me.ssim(gt, pred))
        cpbds.append(me.cpbd(pred))   # BGR, as the JAX CLI passes it
    mean = lambda vals: float(torch.cat(vals).mean()) if vals else float(
        "nan")
    out = {"n_frames": len(pred_files), "psnr": mean(psnrs),
           "ssim": mean(ssims), "cpbd": mean(cpbds)}

    if args.lms_pred and args.lms_gt:
        lp = [np.loadtxt(os.path.join(args.lms_pred,
                                      f.replace(".jpg", ".lms")))
              for f in pred_files]
        lg = [np.loadtxt(os.path.join(args.lms_gt, f.replace(".jpg", ".lms")))
              for f in gt_of]
        out["lmd"] = float(me.lmd(torch.from_numpy(np.stack(lp)),
                                  torch.from_numpy(np.stack(lg))))
        out["lmd_detector"] = "precomputed"
    elif args.lms_from_fan is not None:
        out["lmd"], out["lmd_detector"] = _lmd_from_detector(
            args, pred_files, gt_of, device)

    if args.sync and args.config:
        out.update(_sync_score(args, device))

    print(json.dumps(out))
    return out


def _fan_weights(path: str, device):
    """A FAN weights file: the JAX CLI's ``(params, state)`` tuple layout
    (keys ``0/...``, ``1/...``) or the preprocessing CLI's {"params",
    "state"}."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.core import checkpoint as ckpt
    tree, _ = ckpt.load_nested(path)
    if isinstance(tree, dict) and "params" in tree:
        tree = (tree["params"], tree["state"])
    if not isinstance(tree, (list, tuple)) or len(tree) != 2:
        raise ValueError(f"{path}: not a FAN (params, state) file")
    return weights.fan_from_jax(tree[0], tree[1], device)


def _lmd_from_detector(args, pred_files, gt_of, device):
    """LMD through a landmark detector on both frame sets: the FAN of the
    weights file, else the distilled tiny detector, else a random FAN (the
    JAX CLI's order).  The FAN sees each whole frame as the face box."""
    import numpy as np
    import torch

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.models import tiny_landmarks as tl
    from speech2lip_tpu_torch.ops.nn import full_float32
    from speech2lip_tpu_torch.preprocess.landmarks import detect_landmarks
    from speech2lip_tpu_torch.train import metrics_eval as me

    if os.path.exists(args.lms_from_fan):
        fan_p, fan_s = _fan_weights(args.lms_from_fan, device)
        detector = "fan"
    elif os.path.exists(tl.CKPT):
        print("# LMD detector: models/tiny_landmarks.ckpt (distilled "
              "in-repo; self-consistent, not the published-FAN protocol)")
        params = tl.load(tl.CKPT, device)
        detector = "tiny"
    else:
        print(f"# WARNING: FAN weights '{args.lms_from_fan}' not found: a "
              "random FAN, weights.random_fan(0) (LMD measures pred/GT "
              "consistency through one detector; not comparable to the "
              "published protocol, nor to the JAX CLI's random FAN)")
        fan_p, fan_s = weights.random_fan(0, device=device)
        detector = "fan-random"

    def lms_of(d, names):
        out = []
        for s in range(0, len(names), CHUNK):
            imgs = np.stack([_read(os.path.join(d, f), rgb=True)
                             for f in names[s:s + CHUNK]])
            imgs = imgs.astype(np.float32) / 255.0
            with torch.no_grad(), full_float32():
                if detector == "tiny":
                    out.append(tl.detect(params, torch.from_numpy(imgs).to(
                        device)))
                    continue
                h, w = imgs.shape[1:3]
                out.append(torch.from_numpy(np.stack([
                    detect_landmarks(fan_p, fan_s, img, (0, 0, w, h),
                                     device) for img in imgs])).to(device))
        return torch.cat(out)

    lmd = me.lmd(lms_of(args.pred, pred_files), lms_of(args.gt, gt_of))
    return float(lmd), detector


def _sync_score(args, device):
    """SyncNet confidence over the rendered clip: every rendered frame
    resized whole to 96², ``len - 5`` windows of 5, the mel window of
    rendered frame i at clip frame ``offset + i + 2``."""
    import cv2
    import numpy as np
    import torch

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.config import load_config
    from speech2lip_tpu_torch.core import checkpoint as ckpt
    from speech2lip_tpu_torch.ops import audio_dsp
    from speech2lip_tpu_torch.ops.nn import full_float32
    from speech2lip_tpu_torch.train import metrics_eval as me
    from speech2lip_tpu_torch.train.losses import sync_window_to_syncnet_input

    cfg = load_config(args.config)
    root = cfg["data"]["path"]
    wav = audio_dsp.load_wav(os.path.join(root, "audio", "audio.wav"))
    mel = audio_dsp.melspectrogram(wav, cfg["data"].get("mel_fmin", 55.0)).T

    sync_path = cfg["training"].get("syncnet_weights",
                                    "models/syncnet_weights.ckpt")
    teacher = weights.init_syncnet(0, device)
    if os.path.exists(sync_path):
        # a (params, state) tuple, as the converter and the pretrainer save
        teacher, _ = ckpt.load(sync_path, like=teacher)
    else:
        print(f"# sync teacher '{sync_path}' not found: scoring against "
              "weights.init_syncnet(0), a random teacher that differs from "
              "the JAX package's syncnet.init(PRNGKey(0))")

    files = sorted(f for f in os.listdir(args.pred) if f.endswith(".jpg"))
    frames = np.stack([cv2.resize(_read(os.path.join(args.pred, f)),
                                  (96, 96)) for f in files])
    frames = torch.from_numpy(frames.astype(np.float32) / 255.0)  # BGR
    t = len(frames) - 5
    # each window fed as RGB; the flip back to BGR happens inside
    windows = sync_window_to_syncnet_input(torch.stack(
        [frames[i:i + 5].flip(-1) for i in range(t)]))
    # rendered frame i is clip frame offset + i
    mels = torch.from_numpy(np.stack(
        [audio_dsp.crop_audio_window(mel, args.offset + i + 2).T
         for i in range(t)]))
    with full_float32():
        conf, offset = me.sync_confidence(*teacher, mels, windows)
    return {"sync_conf": conf, "sync_offset": offset}


if __name__ == "__main__":
    main()
