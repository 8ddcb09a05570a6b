"""Inference CLI (counterpart of ``speech2lip_tpu/cli/infer.py``).

Usage:
    python -m speech2lip_tpu_torch.cli.infer configs/may/may.yaml \
        [--output_dir NAME] [--model_path P | --model_iter N] \
        [--use_new_audio] [--batch N] [--bf16 | --fp32] [--device cuda|cpu] \
        [--change_pose V [--pose_edit euler|trans] [--pose_axis I]] \
        [--export_video]

Renders every frame of the val split (or of the audio_test clip with
``--use_new_audio``) from the checkpoint in ``training.out_dir`` and
writes ``rendering_result/<out>/postfusion/%05d.jpg``, batched over
frames.  Runs on the card unless ``--device`` names another, in bfloat16
there unless ``--fp32``.  ``--change_pose`` renders each frame in a head
pose whose euler or trans component ``--pose_axis`` is set to the value
(``infer/pose_edit.py``); ``--export_video`` also muxes the frames, with
the identity's ``audio/audio.wav`` where there is one, into
``rendering_result/<out>/result.avi``.
"""

from __future__ import annotations

import argparse
import os
import time

# the batch entries the pose editor reads
_POSE_KEYS = ("audio", "index", "rgb_face_zero", "mask_lip_canonical",
              "canonical_euler", "canonical_trans")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Render lip-synced frames.")
    parser.add_argument("config", type=str)
    parser.add_argument("--output_dir", type=str, default="test")
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--model_iter", type=str, default=None)
    parser.add_argument("--use_new_audio", action="store_true")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--bf16", action="store_true",
                        help="serve in bfloat16 (the default on the card)")
    parser.add_argument("--fp32", action="store_true",
                        help="serve in float32")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (default: the card)")
    parser.add_argument("--export_video", action="store_true",
                        help="also mux the frames (+ audio.wav if present) "
                             "into rendering_result/<out>/result.avi")
    parser.add_argument("--change_pose", type=float, default=None,
                        help="controllable pose: value assigned to one "
                             "canonical euler/trans component "
                             "(infer/pose_edit.py)")
    parser.add_argument("--pose_edit", choices=["euler", "trans"],
                        default="euler")
    parser.add_argument("--pose_axis", type=int, default=0,
                        help="which euler/trans component to edit (0..2)")
    args = parser.parse_args(argv)

    from speech2lip_tpu_torch.config import load_config
    from speech2lip_tpu_torch.core.checkpoint import CheckpointManager
    from speech2lip_tpu_torch.data import image_io
    from speech2lip_tpu_torch.data.dataset import LipDataset, stack_batch
    from speech2lip_tpu_torch.infer.pipeline import RENDER_KEYS
    from speech2lip_tpu_torch.core.device import resolve_device
    from speech2lip_tpu_torch.infer.renderer import Renderer
    from speech2lip_tpu_torch.train.trainer import (init_params, to_device,
                                                    warp_window)

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.fp32:
        cfg["model"]["compute_dtype"] = "float32"
    elif args.bf16:
        cfg["model"]["compute_dtype"] = "bfloat16"
    elif (device.type == "cuda"
          and cfg["model"].get("compute_dtype", "float32") == "float32"):
        cfg["model"]["compute_dtype"] = "bfloat16"
        print("CUDA device: serving in bfloat16 (pass --fp32 to override)")
    mode = "test" if args.use_new_audio else "val"
    ds = LipDataset(cfg["data"]["path"], mode, cfg)

    params, unet_p, unet_s = init_params(cfg, ds, device=device)
    mgr = CheckpointManager(cfg["training"]["out_dir"])
    name = args.model_path or (
        f"model_{args.model_iter}.ckpt" if args.model_iter else None)
    like = {"params": params, "unet_params": unet_p, "unet_state": unet_s,
            "it": 0}
    state, scalars = mgr.restore(like, name=name)
    if not scalars:
        print("WARNING: no checkpoint found in "
              f"{cfg['training']['out_dir']}: rendering with RANDOM weights")
    else:
        print(f"loaded checkpoint at it={scalars.get('it')}")

    window = warp_window(cfg, ds)
    print(f"warp window: {window}")
    if args.change_pose is not None:
        from speech2lip_tpu_torch.infer.pose_edit import PoseEditRenderer
        renderer = PoseEditRenderer(
            cfg, state["params"], state["unet_params"], state["unet_state"],
            lip_h=ds.lip_h, lip_w=ds.lip_w, edit=args.pose_edit,
            axis=args.pose_axis, value=args.change_pose, device=device)
        keys = _POSE_KEYS
        print(f"pose edit: {args.pose_edit}[{args.pose_axis}] = "
              f"{args.change_pose}")
    else:
        renderer = Renderer(cfg, state["params"], state["unet_params"],
                            state["unet_state"], device=device, window=window)
        keys = RENDER_KEYS

    out_dir = os.path.join("rendering_result", args.output_dir, "postfusion")
    os.makedirs(out_dir, exist_ok=True)

    n = len(ds)
    exported = [] if args.export_video else None
    t0 = time.perf_counter()
    render_s = 0.0
    for start in range(0, n, args.batch):
        idxs = list(range(start, min(start + args.batch, n)))
        host = stack_batch([ds.load_frame(i) for i in idxs])
        batch = to_device({k: host[k] for k in keys}, device)
        t_r = time.perf_counter()
        out = renderer(batch, ds.lefttop_x, ds.lefttop_y)
        faces = out["face"].cpu().numpy()
        render_s += time.perf_counter() - t_r
        for j, i in enumerate(idxs):
            rgb8 = image_io.to_uint8(faces[j])
            image_io.imwrite(os.path.join(out_dir, f"{i + 1:05d}.jpg"), rgb8)
            if exported is not None:
                exported.append(rgb8)
    total_s = time.perf_counter() - t0
    print(f"wrote {n} frames to {out_dir} ({n / total_s:.1f} frames/s, "
          f"render {n / max(render_s, 1e-9):.1f} frames/s)")
    res = {"frames": n, "out_dir": out_dir, "seconds": total_s,
           "render_seconds": render_s, "it": scalars.get("it"),
           "compute_dtype": cfg["model"]["compute_dtype"],
           "renderer": renderer}
    if exported:
        from speech2lip_tpu_torch.preprocess.video_io import write_avi
        audio = None
        wav_path = os.path.join(cfg["data"]["path"], "audio", "audio.wav")
        if os.path.exists(wav_path):
            from scipy.io import wavfile
            _, audio = wavfile.read(wav_path)
        res["video"] = os.path.join(os.path.dirname(out_dir), "result.avi")
        write_avi(res["video"], exported, fps=cfg["data"].get("fps", 25.0),
                  audio=audio)
        print(f"wrote {res['video']}")
    return res


if __name__ == "__main__":
    main()
