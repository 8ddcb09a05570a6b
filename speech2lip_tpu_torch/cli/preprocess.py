"""Preprocessing CLI: raw video -> the training artifact tree (counterpart
of ``speech2lip_tpu/cli/preprocess.py``), one entry point with a
subcommand per step:

    python -m speech2lip_tpu_torch.cli.preprocess <step> --root DIR \
        [options] [--device cuda|cpu]

steps: extract, crop_face, landmarks, track (find_focal + the 4-phase
fit), warp, uv_mapping, masks, crop_lip, audio_features, all.  The same
flags, files and formats as the JAX CLI.  The nets and the tracker run on
the card unless ``--device`` names another, in float32 with TF32 off.

Started as N ranks (``python -m torch.distributed.run --nproc_per_node N
-m speech2lip_tpu_torch.cli.preprocess track ...``), the ``track`` step
splits its photometric frames over the ranks, as the JAX CLI shards them
over its devices; rank 0 runs every other step and writes every file.

3DMM assets (3DMM_info.npy / keys_info.npy / topology_info.npy) and the
weights (fan.ckpt, s3fd.ckpt, dsfd.ckpt, bisenet.ckpt, deepspeech.ckpt in
the JAX package's npz layout) are user-supplied.  ``main`` returns a
summary: the steps run, the frames and the wall seconds of each.
"""

from __future__ import annotations

import argparse
import os
import time

ALL_STEPS = ["landmarks", "track", "warp", "uv_mapping", "masks",
             "crop_lip", "audio_features"]


def _imwrite(path, img_float_rgb):
    import cv2
    import numpy as np
    img = (np.clip(img_float_rgb, 0, 255).astype("uint8")
           if img_float_rgb.max() > 1.5
           else (np.clip(img_float_rgb, 0, 1) * 255).astype("uint8"))
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def _read_frames(frames_dir):
    import cv2
    import numpy as np
    files = sorted(f for f in os.listdir(frames_dir) if f.endswith(".jpg"))
    imgs = [cv2.cvtColor(cv2.imread(os.path.join(frames_dir, f)),
                         cv2.COLOR_BGR2RGB).astype(np.float32)
            for f in files]
    return np.stack(imgs), files


def _nested(path, name):
    """A {"params", "state"} weights file as a nested tree."""
    from speech2lip_tpu_torch.core import checkpoint as ckpt
    tree, _ = ckpt.load_nested(path)
    if not isinstance(tree, dict) or "params" not in tree:
        raise SystemExit(f"{name}.ckpt must hold {{'params', 'state'}}")
    return tree


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Speech2Lip preprocessing")
    p.add_argument("step", choices=["extract", "crop_face"] + ALL_STEPS
                   + ["all"])
    p.add_argument("--root", required=True, help="identity artifact tree")
    p.add_argument("--video", help="source video file (extract)")
    p.add_argument("--raw_frames", help="raw video frames dir (crop_face)")
    p.add_argument("--crop_center", type=int, nargs=2, default=[930, 275])
    p.add_argument("--crop_size", type=int, default=500)
    p.add_argument("--assets", help="3DMM asset dir")
    p.add_argument("--weights_dir", default="models",
                   help="dir with fan / s3fd / dsfd / bisenet / deepspeech "
                        ".ckpt")
    p.add_argument("--focal", type=float, default=None,
                   help="skip find_focal with a known focal")
    p.add_argument("--lip_w", type=int, default=120)
    p.add_argument("--lip_h", type=int, default=80)
    p.add_argument("--center_y_ratio", type=float, default=1.02)
    p.add_argument("--canonical_idx", type=int, default=0)
    p.add_argument("--fps", type=float, default=25.0)
    p.add_argument("--track_scale", type=float, default=1.0,
                   help="scale factor on tracker iteration budgets")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    from speech2lip_tpu_torch.core.device import resolve_device
    from speech2lip_tpu_torch.ops.nn import full_float32

    import torch

    from speech2lip_tpu_torch.parallel import distributed
    from speech2lip_tpu_torch.parallel.mesh import make_mesh

    args = parse_args(argv)
    dev = resolve_device(args.device)
    made = distributed.initialize_if_needed(dev)
    dev = distributed.rank_device(dev)
    # all ranks on the 'data' axis: the tracker's photometric phases
    # split their frames over it (one process: no mesh)
    mesh = (make_mesh(device=dev) if distributed.process_count() > 1
            else None)
    summary = {"steps": [], "frames": {}, "seconds": {}}
    try:
        with full_float32():
            _run(args, dev, summary, mesh)
    finally:
        if made:
            torch.distributed.destroy_process_group()
    return summary


def _run(args, dev, summary, mesh=None):
    import numpy as np
    import torch

    from speech2lip_tpu_torch.parallel.mesh import barrier

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.core import checkpoint as ckpt

    def done(step, t0, frames):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        summary["steps"].append(step)
        summary["frames"][step] = frames
        summary["seconds"][step] = time.perf_counter() - t0

    root = args.root
    main = mesh is None or mesh.rank == 0
    if args.step in ("extract", "crop_face") and not main:
        return
    t0 = time.perf_counter()
    if args.step == "extract":
        # video -> ori_images/%05d.jpg + audio/audio.wav
        from speech2lip_tpu_torch.preprocess.video_io import (extract_frames,
                                                              extract_wav)
        if not args.video:
            raise SystemExit("extract requires --video")
        os.makedirs(os.path.join(root, "audio"), exist_ok=True)
        n, fps = extract_frames(args.video, os.path.join(root, "ori_images"))
        try:
            extract_wav(args.video, os.path.join(root, "audio", "audio.wav"))
            audio_msg = "+ audio/audio.wav"
        except ValueError as e:
            audio_msg = f"(no audio extracted: {e})"
        print(f"extracted {n} frames @ {fps:g} fps {audio_msg}")
        done("extract", t0, n)
        return

    if args.step == "crop_face":
        from speech2lip_tpu_torch.preprocess.steps import crop_face
        frames, files = _read_frames(args.raw_frames)
        out = os.path.join(root, "ori_images_face")
        os.makedirs(out, exist_ok=True)
        for img, f in zip(frames, files):
            _imwrite(os.path.join(out, f),
                     crop_face(img, tuple(args.crop_center), args.crop_size))
        print(f"cropped {len(files)} frames -> {out}")
        done("crop_face", t0, len(files))
        return

    steps = [args.step] if args.step != "all" else ALL_STEPS
    if not main:     # a rank other than 0 takes part in the track step only
        steps = [s for s in steps if s == "track"]
    wpath = lambda name: os.path.join(args.weights_dir, name + ".ckpt")

    if "landmarks" in steps:
        from speech2lip_tpu_torch.preprocess.landmarks import run_step1
        tree = _nested(wpath("fan"), "fan")
        fan_p, fan_s = weights.fan_from_jax(tree["params"], tree["state"],
                                            dev)
        bis = dsfd = s3fd_params = None
        if os.path.exists(wpath("bisenet")):
            tree = _nested(wpath("bisenet"), "bisenet")
            bis = weights.bisenet_from_jax(tree["params"], tree["state"],
                                           dev)
        # face detector preference: DSFD (the reference's own detector) >
        # S3FD > the BiSeNet parsing box > the full frame
        if os.path.exists(wpath("dsfd")):
            tree = _nested(wpath("dsfd"), "dsfd")
            dsfd = weights.dsfd_from_jax(tree["params"], tree["state"], dev)
        elif os.path.exists(wpath("s3fd")):
            s3fd_params = weights.s3fd_from_jax(
                ckpt.load_nested(wpath("s3fd"))[0], dev)
        bbox = run_step1(os.path.join(root, "ori_images_face"),
                         os.path.join(root, "landmarks"),
                         os.path.join(root, "face_bbox_dict.npy"),
                         fan_p, fan_s, *(bis or (None, None)),
                         s3fd_params=s3fd_params, dsfd=dsfd)
        print("landmarks written"
              + (" (DSFD bboxes)" if dsfd is not None else
                 " (S3FD bboxes)" if s3fd_params is not None else ""))
        done("landmarks", t0, len(bbox))

    from speech2lip_tpu_torch.data.dataset import _load_track_params
    from speech2lip_tpu_torch.preprocess import face_3dmm as bfm
    from speech2lip_tpu_torch.preprocess import steps as S
    from speech2lip_tpu_torch.preprocess.tracker import (FaceTracker,
                                                         TrackerConfig)

    barrier()      # rank 0's earlier steps are on disk
    frames = files = None
    if any(s in steps for s in ("track", "warp")):
        frames, files = _read_frames(os.path.join(root, "ori_images_face"))
    h = w = args.crop_size
    load_track = lambda: _load_track_params(
        os.path.join(root, "track_params.pt"))
    assets = (bfm.load_assets(args.assets, device=dev)
              if any(s in steps for s in ("track", "warp", "uv_mapping",
                                          "masks")) else None)

    if "track" in steps:
        t0 = time.perf_counter()
        lms = np.stack([np.loadtxt(os.path.join(root, "landmarks",
                                                f.replace(".jpg", ".lms")))
                        for f in files]).astype(np.float32)[:, :, :2]
        ts = args.track_scale
        cfg = TrackerConfig(
            img_h=h, img_w=w,
            iters_focal_pose=max(1, int(2000 * ts)),
            iters_focal_idexp=max(1, int(2500 * ts)),
            iters_pose=max(1, int(1500 * ts)),
            iters_idexp=max(1, int(2000 * ts)),
            iters_photo=max(1, int(71 * ts)),
            iters_window=max(1, int(50 * ts)))
        tr = FaceTracker(assets, lms, cfg, mesh=mesh, device=dev)
        focal = args.focal or tr.find_focal()
        timings = {}
        track = tr.fit(float(focal), images=frames, timings=timings)
        if main:
            np.savez(os.path.join(root, "track_params.pt.npz"), **track)
            print("tracked; focal =", focal)
        summary["focal"] = float(focal)
        summary["track_timings"] = timings
        done("track", t0, len(files))
        barrier()      # the track file is on disk for every rank

    if "warp" in steps:
        t0 = time.perf_counter()
        warped = S.warp_images(load_track(), assets, frames,
                               args.canonical_idx, h, w, device=dev)
        out = os.path.join(root, "warp_images")
        os.makedirs(out, exist_ok=True)
        for img, f in zip(warped, files):
            _imwrite(os.path.join(out, f), img)
        print(f"warped {len(files)} frames")
        done("warp", t0, len(files))

    if "uv_mapping" in steps:
        t0 = time.perf_counter()
        coords = S.compute_uv_mapping(load_track(), assets,
                                      args.canonical_idx, h, w, device=dev)
        out = os.path.join(root, "coords")
        os.makedirs(out, exist_ok=True)
        names = sorted(f for f in os.listdir(
            os.path.join(root, "ori_images_face")) if f.endswith(".jpg"))
        for grid, f in zip(coords, names):
            np.save(os.path.join(out, f.replace(".jpg", ".npy")), grid)
        print(f"saved {len(coords)} coord grids")
        done("uv_mapping", t0, len(coords))

    if "masks" in steps:
        import cv2
        t0 = time.perf_counter()
        parsing = None
        if os.path.exists(wpath("bisenet")):
            from speech2lip_tpu_torch.models import bisenet
            tree = _nested(wpath("bisenet"), "bisenet")
            bp, bs = weights.bisenet_from_jax(tree["params"], tree["state"],
                                              dev)
            can = _read_frames(os.path.join(root, "ori_images_face"))[0][
                args.canonical_idx] / 255.0
            classes = bisenet.parse_face(
                bp, bs, torch.as_tensor(can, device=dev)).cpu().numpy()
            classes = cv2.resize(classes.astype(np.uint8), (w, h),
                                 interpolation=cv2.INTER_NEAREST)
            # colour-coded as the reference's parsing map: head classes red
            parsing = np.zeros((h, w, 3), np.uint8)
            parsing[np.isin(classes, list(range(1, 16)))] = (255, 0, 0)
            cv2.imwrite(os.path.join(root, "canonical_face_parsing.jpg"),
                        parsing[..., ::-1])
        depth, face_mask, head_mask = S.canonical_masks(
            load_track(), assets, args.canonical_idx, h, w,
            parsing_map=parsing, device=dev)
        np.save(os.path.join(root, "depth_face_canonical.npy"), depth)
        cv2.imwrite(os.path.join(root, "canonical_face_mask.jpg"),
                    face_mask.astype(np.uint8) * 255)
        if head_mask is None:
            # no parsing weights: the mesh's face mask keeps the dataset
            # contract complete (BiSeNet refines it)
            print("WARNING: no bisenet.ckpt; head mask = face mask")
            head_mask = face_mask
        cv2.imwrite(os.path.join(root, "canonical_head_mask.jpg"),
                    head_mask.astype(np.uint8) * 255)
        print("canonical masks + depth written")
        done("masks", t0, 1)

    if "crop_lip" in steps:
        import cv2
        t0 = time.perf_counter()
        warped, names = _read_frames(os.path.join(root, "warp_images"))
        lms = np.loadtxt(os.path.join(
            root, "landmarks",
            "{:05d}.lms".format(args.canonical_idx + 1))).astype(np.float32)
        crops, lip_mask, (x, y) = S.crop_lip(
            warped, lms, args.lip_w, args.lip_h, args.center_y_ratio)
        out = os.path.join(root, "images")
        os.makedirs(out, exist_ok=True)
        for img, f in zip(crops, names):
            _imwrite(os.path.join(out, f), img)
        cv2.imwrite(os.path.join(root, "canonical_lip_mask.jpg"), lip_mask)
        print(f"lip crops at ({x}, {y})")
        summary["lip_box"] = (x, y)
        done("crop_lip", t0, len(names))

    if "audio_features" in steps:
        from speech2lip_tpu_torch.ops.audio_dsp import load_wav
        from speech2lip_tpu_torch.preprocess.audio_features import (
            wav_to_deepspeech_windows)
        t0 = time.perf_counter()
        if os.path.exists(wpath("deepspeech")):
            ds = weights.deepspeech_from_jax(
                ckpt.load_nested(wpath("deepspeech"))[0], dev)
        else:
            print("WARNING: no deepspeech.ckpt; using random weights "
                  "(weights.random_deepspeech(0), another random net than "
                  "the JAX CLI's deepspeech.init(PRNGKey(0)))")
            ds = weights.random_deepspeech(0, device=dev)
        wav = load_wav(os.path.join(root, "audio", "audio.wav"))
        windows = wav_to_deepspeech_windows(wav, 16000, ds, device=dev)
        np.save(os.path.join(root, "audio", "audio.npy"),
                windows.astype(np.float32))
        print(f"audio features: {windows.shape}")
        done("audio_features", t0, len(windows))


if __name__ == "__main__":
    main()
