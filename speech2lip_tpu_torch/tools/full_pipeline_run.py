"""Raw video to talking head: the reference's whole workflow as one command
(counterpart of the JAX package's ``tools/full_pipeline_run.py``).

It starts where a user of the reference starts, from a raw AVI with an
audio track (reference README.md "Data Preparation" -> preprocess_may.sh
STEP0-6 -> train.py -> inference.py), and calls every CLI of the port in
order, in this process, on the card unless ``--device`` names another:

  1. synthesize a talking-head world: a 3DMM identity whose expression
     follows a smooth function of time, an audio track whose amplitude
     envelopes follow the expression components, rendered with the port's
     rasterizer (``preprocess/face_3dmm.render_mesh``) and written as an
     MJPG + PCM AVI (``preprocess/video_io.write_avi``);
  2. ``cli/preprocess extract``, ``crop_face``, ``landmarks`` (FAN + DSFD
     with shallow weights made from a seed; the landmark files are then
     replaced by the projected true points, as the reference's accuracy
     rests on pretrained FAN), ``track`` (find_focal + the 4-phase fit),
     ``warp``, ``uv_mapping``, ``masks``, ``crop_lip``, ``audio_features``;
  3. ``trainer.fit`` from random init on the produced tree, validating so
     that ``model_best.ckpt`` is selected;
  4. ``cli/infer`` renders the held-out val split from model_best.ckpt;
  5. ``cli/evaluate`` scores the rendered frames against the truth.

    python -m speech2lip_tpu_torch.tools.full_pipeline_run --out /tmp/pipe \
        [--frames 80 --crop 96 --lip-w 24 --lip-h 16 --iters 1200] \
        [--track-scale 0.25] [--dtype bfloat16] [--device cuda|cpu] \
        [--json PIPELINE.json] [--psnr-bar 26]

The JSON report has the JAX tool's keys: per-step wall seconds, the focal
found by the grid search against the true one, the val-PSNR trajectory
and the rendered frames' metrics; ``backend`` is the torch device.
``--psnr-bar`` exits 1 when the rendered PSNR falls below it or no best
checkpoint was selected.  ``main(argv, part=...)`` returns the report;
``part(name)``, if given, is a context manager entered around each step
(``synthesize_world``, the preprocessing steps, ``train``, ``infer``,
``evaluate``); where it yields a dict, the step's return value is put
there under ``"result"`` (``cli/infer``'s holds the ``renderer`` that
rendered the frames).

The STEP1 weights are drawn by the port's ``weights.random_fan`` /
``random_dsfd``, with numpy: another draw than the JAX tool's
``jax.random``, so the DSFD boxes of the two tools differ (the landmark
points are replaced by the truth in both).  ``--devices N`` above 1 runs
the ``track`` and ``train`` steps as N ranks
(``parallel.distributed.launch``: NCCL on N cards, gloo on the CPU), in
place of the JAX tool's N virtual devices; their ``part`` result is then
the launcher's completed process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

STEPS = ["synthesize(avi)", "extract", "crop_face", "landmarks",
         "track(find_focal+fit)", "warp", "uv_mapping", "masks", "crop_lip",
         "audio_features", "train", "infer", "evaluate"]


def save_assets_reference_schema(assets, assets_dir: str) -> None:
    """Write a BFMAssets as the reference's 3DMM_info / keys_info /
    topology_info .npy schema (facemodel.py:15-49), so load_assets
    round-trips it."""
    from speech2lip_tpu_torch.preprocess import face_3dmm as bfm
    bfm.save_reference_schema(assets, assets_dir)


def make_world(out: str, args, device="cpu"):
    """Synthesize the raw inputs on ``device``: clip.avi (MJPG + PCM), the
    3DMM assets, and the true landmarks in cropped-frame coordinates."""
    import numpy as np
    import torch

    from speech2lip_tpu_torch.preprocess import face_3dmm as bfm
    from speech2lip_tpu_torch.preprocess.video_io import write_avi

    dev = torch.device(device)
    rng = np.random.default_rng(args.seed)
    assets = bfm.synthetic_assets(n_verts=args.verts, id_dim=8, exp_dim=6,
                                  tex_dim=8, seed=args.seed, device=dev)
    # stretch the blob along z: a unit sphere at z0 = -focal/(0.42·crop)
    # subtends depth/distance ~ 1/33, where focal and depth are nearly
    # interchangeable and find_focal's landmark grid is flat.  A real face
    # at arm's length sits near 1/10; stretching restores that
    if args.depth_stretch != 1.0:
        mu = assets.mu.reshape(-1, 3).clone()
        mu[:, 2] *= args.depth_stretch
        assets = assets._replace(mu=mu.reshape(-1))
    assets_dir = os.path.join(out, "assets")
    save_assets_reference_schema(assets, assets_dir)

    n, fps = args.frames, 25.0
    t = np.arange(n) / fps
    # expression: a smooth multi-frequency trajectory (the "speech")
    exp = np.zeros((n, 6), np.float32)
    freqs = (1.3, 0.7, 2.1)
    amps = (0.9, 0.6, 0.4)
    phases = (0.0, 1.1, 0.3)
    for k, (f, a, ph) in enumerate(zip(freqs, amps, phases)):
        exp[:, k] = a * np.sin(2 * np.pi * f * t + ph)
    # mild head motion, so the tracker and the warps have work to do
    euler = np.stack([0.05 * np.sin(2 * np.pi * 0.31 * t + p)
                      for p in (0.0, 2.0, 4.0)], axis=1).astype(np.float32)
    z0 = -args.focal_true / (0.42 * args.crop)  # face radius ~ 0.42·crop px
    trans = np.stack([0.15 * np.sin(2 * np.pi * 0.23 * t),
                      0.12 * np.sin(2 * np.pi * 0.17 * t + 1.0),
                      z0 + args.z_motion * np.sin(2 * np.pi * 0.11 * t)],
                     axis=1).astype(np.float32)

    # audio: tones whose amplitude envelopes follow the expression
    sr = 16000
    ns = int(round(n / fps * sr))
    ta = np.arange(ns) / sr
    wav = np.zeros(ns, np.float64)
    for k, (f, a, ph) in enumerate(zip(freqs, amps, phases)):
        env = 0.5 + 0.45 * np.sin(2 * np.pi * f * ta + ph)
        wav += (0.28, 0.2, 0.14)[k] * env * np.sin(
            2 * np.pi * (220 * 2**k) * ta)
    wav_i16 = (np.clip(wav, -1, 1) * 32767).astype(np.int16)

    # the posed, lit identity at raw size, the face at the frame's center
    raw = args.crop + 2 * args.margin
    put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    idp = torch.zeros((1, 8), device=dev)
    ej, tj, xj = put(euler), put(trans), put(exp)
    tex = bfm.forward_tex(assets, put(0.5 * rng.standard_normal((1, 8))))
    gamma = np.zeros((n, 27), np.float32)
    gamma[:, 0] = 0.2 * np.sin(2 * np.pi * 0.13 * t)  # slow light drift
    frames = []
    chunk = 8
    with torch.no_grad():
        for i in range(0, n, chunk):
            sl = slice(i, min(n, i + chunk))
            b = sl.stop - sl.start
            geo = bfm.forward_geo(assets, idp.expand(b, -1), xj[sl])
            rott = bfm.rot_trans_pts(geo, bfm.euler2rot(ej[sl]), tj[sl])
            imgs, _ = bfm.render_mesh(assets, rott, tex.expand(b, -1, -1),
                                      put(gamma[sl]), args.focal_true,
                                      raw, raw, tile=16,
                                      max_faces_per_tile=256)
            frames.extend(imgs.cpu().numpy().astype(np.uint8))

        # guard against a silent black render (a missing -z camera
        # negation once produced an all-black world that trains to a
        # meaningless PSNR): the video must carry signal
        fstack = np.stack(frames)
        if fstack.max() < 20 or fstack.std() < 2.0:
            raise RuntimeError(
                f"synthesized world is (near-)black: max={fstack.max()} "
                f"std={fstack.std():.2f}: rendering convention broken")

        write_avi(os.path.join(out, "clip.avi"), frames, fps=fps,
                  audio=wav_i16, sample_rate=sr)

        # the true 68 landmarks, mapped raw -> cropped coordinates
        cxy = (raw / 2, raw / 2)
        geo_l = bfm.get_3dlandmarks(assets, idp.expand(n, -1), xj, ej, tj,
                                    args.focal_true, cxy)
        lms_raw = bfm.forward_transform(geo_l, ej, tj, args.focal_true,
                                        cxy)[:, :, :2].cpu().numpy()
    off = raw // 2 - args.crop // 2
    return {"assets_dir": assets_dir, "lms_crop": lms_raw - off,
            "raw": raw, "n": n}


def synth_step1_weights(out: str):
    """FAN (1 module) and DSFD (depths 1, 1, 1, 1) weights files made from
    seeds 0 and 1: the pretrained files are absent, and STEP1's file
    contract still runs through the real detector and landmark code."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.core import checkpoint as ckpt
    wdir = os.path.join(out, "weights")
    os.makedirs(wdir, exist_ok=True)
    fan_p, fan_s = weights.random_fan(0, n_modules=1)
    ckpt.save(os.path.join(wdir, "fan.ckpt"),
              {"params": fan_p, "state": fan_s})
    dsfd_p, dsfd_s = weights.random_dsfd(1, depths=(1, 1, 1, 1))
    ckpt.save(os.path.join(wdir, "dsfd.ckpt"),
              {"params": dsfd_p, "state": dsfd_s})
    return wdir


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--crop", type=int, default=96, help="STEP0 crop size")
    ap.add_argument("--margin", type=int, default=24)
    ap.add_argument("--lip-w", type=int, default=24)
    ap.add_argument("--lip-h", type=int, default=16)
    ap.add_argument("--verts", type=int, default=400)
    ap.add_argument("--depth-stretch", type=float, default=2.5,
                    help="stretch the synthetic head along z so focal is "
                         "identifiable from the landmark grid (see "
                         "make_world)")
    ap.add_argument("--z-motion", type=float, default=1.0,
                    help="amplitude of the head's z oscillation (scale "
                         "cue across frames)")
    ap.add_argument("--focal-true", type=float, default=900.0,
                    help="rendering focal; find_focal's 600-1500 grid "
                         "must straddle it")
    ap.add_argument("--track-scale", type=float, default=0.25)
    ap.add_argument("--iters", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--val-frames", type=int, default=12)
    ap.add_argument("--validate-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default=None,
                    help="training.compute_dtype override (e.g. bfloat16)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default: the card)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the track and train steps (cards, "
                         "or gloo ranks with --device cpu)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--psnr-bar", type=float, default=None)
    return ap.parse_args(argv)


def build_cfg(root: str, ckpt_dir: str, focal: float, args):
    """The training config of the preprocessed identity."""
    from speech2lip_tpu_torch.config import default_config
    cfg = default_config()
    cfg["data"].update({
        "path": root, "width": args.lip_w, "height": args.lip_h,
        "face_img_focal": focal,
        "val_split_frames": args.val_frames,
    })
    cfg["model"].update({
        "canonical_depth_height": args.crop,
        "canonical_depth_width": args.crop,
        "canonical_depth_init_path": os.path.join(
            root, "depth_face_canonical.npy"),
    })
    cfg["training"].update({
        "out_dir": ckpt_dir, "batch_size": args.batch,
        "batch_rays": 0,
        "print_every": max(1, args.iters // 20),
        "checkpoint_every": args.validate_every,
        "backup_every": 0, "visualize_every": 0,
        "validate_every": args.validate_every,
        "learning_rate": args.lr,
    })
    if args.dtype:
        cfg["training"]["compute_dtype"] = args.dtype
    return cfg


def main(argv=None, part=None):
    args = parse_args(argv)
    part = part or (lambda name: contextlib.nullcontext())

    import numpy as np

    from speech2lip_tpu_torch.cli import evaluate as cli_evaluate
    from speech2lip_tpu_torch.cli import infer as cli_infer
    from speech2lip_tpu_torch.cli import preprocess as cli_pre
    from speech2lip_tpu_torch.config import save_config
    from speech2lip_tpu_torch.core.device import resolve_device
    from speech2lip_tpu_torch.parallel.distributed import launch
    from speech2lip_tpu_torch.train.trainer import fit

    device = resolve_device(args.device)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    root = os.path.join(out, "identity")
    timings, t_all = {}, time.perf_counter()

    @contextlib.contextmanager
    def timed(name, key=None):
        """Times the step; the body sets ``step["result"]``."""
        step = {}
        with part(name) as slot:
            t0 = time.perf_counter()
            yield step
            if key is not False:
                timings[key or name] = round(time.perf_counter() - t0, 3)
            if isinstance(slot, dict):
                slot["result"] = step.get("result")

    with timed("synthesize_world") as step:
        world = make_world(out, args, device)
        wdir = synth_step1_weights(out)
        step["result"] = world

    def pre(name, *extra):
        argv = [name, "--root", root, "--assets", world["assets_dir"],
                "--crop_size", str(args.crop), "--lip_w", str(args.lip_w),
                "--lip_h", str(args.lip_h),
                "--track_scale", str(args.track_scale),
                "--weights_dir", wdir, "--device", str(device), *extra]
        with timed(name) as step:
            step["result"] = (
                launch(args.devices, "speech2lip_tpu_torch.cli.preprocess",
                       argv)
                if name == "track" and args.devices > 1
                else cli_pre.main(argv))

    pre("extract", "--video", os.path.join(out, "clip.avi"))
    c = world["raw"] // 2
    pre("crop_face", "--raw_frames", os.path.join(root, "ori_images"),
        "--crop_center", str(c), str(c))
    pre("landmarks")
    # STEP1 made contract-valid files through the real FAN / DSFD code;
    # the points become the projected truth (their accuracy belongs to the
    # absent pretrained weights)
    for i in range(world["n"]):
        np.savetxt(os.path.join(root, "landmarks", f"{i + 1:05d}.lms"),
                   world["lms_crop"][i])
    pre("track")        # find_focal grid + the 4-phase fit
    for step in ("warp", "uv_mapping", "masks", "crop_lip",
                 "audio_features"):
        pre(step)

    track = np.load(os.path.join(root, "track_params.pt.npz"))
    focal_found = float(track["focal"])

    # -- train on the preprocessed tree (the whole stage-1 loss) --------------
    ckpt_dir = os.path.join(out, "ckpts")
    cfg = build_cfg(root, ckpt_dir, focal_found, args)
    cfg_path = os.path.join(out, "config.yaml")
    save_config(cfg_path, cfg)
    with timed("train") as step:
        step["result"] = (
            launch(args.devices, "speech2lip_tpu_torch.cli.train",
                   [cfg_path, "--max-iters", args.iters, "--device",
                    device.type])
            if args.devices > 1
            else fit(cfg, max_iters=args.iters, device=device))

    traj = []
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "val/psnr" in rec:
                traj.append({"it": rec["it"], "psnr": rec["val/psnr"]})
    best_selected = os.path.exists(os.path.join(ckpt_dir, "model_best.ckpt"))

    # -- render the val split from the best checkpoint; score it -------------
    cwd = os.getcwd()
    os.chdir(out)       # cli/infer writes under ./rendering_result
    try:
        with timed("infer") as step:
            step["result"] = cli_infer.main([
                cfg_path, "--output_dir", "pipeline",
                "--model_path", "model_best.ckpt", "--batch",
                str(args.batch), "--device", str(device)])
    finally:
        os.chdir(cwd)
    pred_dir = os.path.join(out, "rendering_result", "pipeline",
                            "postfusion")
    n_train = world["n"] - args.val_frames
    with timed("evaluate", key=False) as step:
        metrics = step["result"] = cli_evaluate.main([
            "--pred", pred_dir, "--gt", os.path.join(root, "ori_images_face"),
            "--offset", str(n_train), "--device", str(device)])

    report = {
        "pipeline": STEPS,
        "geometry": {"frames": world["n"], "raw": world["raw"],
                     "crop": args.crop, "lip": [args.lip_h, args.lip_w]},
        "iters": args.iters,
        "compute_dtype": args.dtype or "float32",
        "phase_seconds": timings,
        "total_seconds": round(time.perf_counter() - t_all, 3),
        "focal_true": args.focal_true,
        "focal_found": focal_found,
        "val_psnr_trajectory": traj,
        "best_checkpoint_selected": best_selected,
        "rendered_val_metrics": metrics,
        "backend": str(device),
    }
    print(json.dumps(report, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)

    if args.psnr_bar is not None:
        ok = metrics["psnr"] >= args.psnr_bar and best_selected
        print(f"PSNR bar {args.psnr_bar}: "
              f"{'PASS' if ok else 'FAIL'} (rendered {metrics['psnr']:.2f})")
        if not ok:
            sys.exit(1)
    return report


if __name__ == "__main__":
    main()
