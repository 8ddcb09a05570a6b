"""Inference CLI (counterpart of ``speech2lip_tpu/cli/infer.py``).

Usage:
    python -m speech2lip_tpu_torch.cli.infer configs/may/may.yaml \
        [--output_dir NAME] [--model_path P | --model_iter N] \
        [--use_new_audio] [--batch N] [--bf16 | --fp32] [--device cuda|cpu]

Renders every frame of the val split (or of the audio_test clip with
``--use_new_audio``) from the checkpoint in ``training.out_dir`` and
writes ``rendering_result/<out>/postfusion/%05d.jpg``, batched over
frames.  Runs on the card unless ``--device`` names another, in bfloat16
there unless ``--fp32``.  ``--change_pose`` and ``--export_video`` of the
JAX CLI are not ported yet (ROADMAP A5, A7).
"""

from __future__ import annotations

import argparse
import os
import time

# the batch entries the renderer reads
_RENDER_KEYS = ("audio", "index", "rgb_face_zero", "rgb_face_ori",
                "mask_lip_canonical", "coord")


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
    args = parser.parse_args(argv)

    from speech2lip_tpu_torch.config import load_config
    from speech2lip_tpu_torch.core.checkpoint import CheckpointManager
    from speech2lip_tpu_torch.data import image_io
    from speech2lip_tpu_torch.data.dataset import LipDataset, stack_batch
    from speech2lip_tpu_torch.infer.renderer import Renderer, resolve_device
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
    renderer = Renderer(cfg, state["params"], state["unet_params"],
                        state["unet_state"], device=device, window=window)

    out_dir = os.path.join("rendering_result", args.output_dir, "postfusion")
    os.makedirs(out_dir, exist_ok=True)

    n = len(ds)
    t0 = time.perf_counter()
    render_s = 0.0
    for start in range(0, n, args.batch):
        idxs = list(range(start, min(start + args.batch, n)))
        host = stack_batch([ds.load_frame(i) for i in idxs])
        batch = to_device({k: host[k] for k in _RENDER_KEYS}, device)
        t_r = time.perf_counter()
        out = renderer(batch, ds.lefttop_x, ds.lefttop_y)
        faces = out["face"].cpu().numpy()
        render_s += time.perf_counter() - t_r
        for j, i in enumerate(idxs):
            image_io.imwrite(os.path.join(out_dir, f"{i + 1:05d}.jpg"),
                             image_io.to_uint8(faces[j]))
    total_s = time.perf_counter() - t0
    print(f"wrote {n} frames to {out_dir} ({n / total_s:.1f} frames/s, "
          f"render {n / max(render_s, 1e-9):.1f} frames/s)")
    return {"frames": n, "out_dir": out_dir, "seconds": total_s,
            "render_seconds": render_s, "it": scalars.get("it"),
            "compute_dtype": cfg["model"]["compute_dtype"]}


if __name__ == "__main__":
    main()
