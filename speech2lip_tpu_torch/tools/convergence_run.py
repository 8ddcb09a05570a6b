"""Train-from-scratch convergence run on a learnable synthetic identity
(counterpart of the JAX package's ``tools/convergence_run.py``).

    python -m speech2lip_tpu_torch.tools.convergence_run --out /tmp/conv \
        --iters 1500 [--face 64 --lip-h 16 --lip-w 24 --frames 120] \
        [--sync-start-iter N [--pretrain-teacher STEPS]] [--dtype bfloat16] \
        [--device cuda|cpu] [--json CONVERGENCE.json]

Steps, on the card unless ``--device`` names another:
  1. ``data.synthetic.make_learnable_tree``: an identity whose lip images
     are a smooth function of the audio latent;
  2. with ``--sync-start-iter``, the SyncNet teacher: trained for
     ``--pretrain-teacher`` steps on the identity
     (``train/syncnet_pretrain.py``), else ``weights.init_syncnet(0)``;
     the same file is the sync stage's teacher and ``cli/evaluate``'s;
  3. ``trainer.fit`` from random init, validating periodically, so that
     ``model_best.ckpt`` is selected;
  4. ``cli/infer`` renders the val split from the best checkpoint and
     ``cli/evaluate`` scores it (PSNR/SSIM/CPBD; with the sync stage also
     LMD and the sync confidence), both called in-process;
  5. with the sync stage, the boundary's ``model_<N>.ckpt`` and the final
     ``model.ckpt`` are rendered and scored the same way;
  6. a JSON report (the JAX tool's keys) is printed and, with ``--json``,
     written.

``main(argv, part=...)`` returns the report; ``part(name)``, if given, is a
context manager entered around each step ("teacher", "fit", then
"infer:<render>" and "evaluate:<render>" for each render).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def build_cfg(root: str, geo, out_dir: str, args):
    from speech2lip_tpu_torch.data.synthetic import synthetic_config
    cfg = synthetic_config(root, geo)
    cfg["data"]["val_split_frames"] = args.val_frames
    cfg["training"].update({
        "out_dir": out_dir,
        "batch_size": args.batch,
        "print_every": max(1, args.iters // 20),
        "checkpoint_every": args.validate_every,
        "backup_every": 0,
        "validate_every": args.validate_every,
        "visualize_every": 0,
        "learning_rate": args.lr,
    })
    cfg["training"]["batch_rays"] = 0  # whole-frame steps
    if args.dtype:
        cfg["training"]["compute_dtype"] = args.dtype
    return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="work dir (tree + ckpts)")
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--face", type=int, default=64)
    ap.add_argument("--lip-h", type=int, default=16)
    ap.add_argument("--lip-w", type=int, default=24)
    ap.add_argument("--val-frames", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--validate-every", type=int, default=100)
    ap.add_argument("--psnr-bar", type=float, default=None,
                    help="fail (exit 1) if final val PSNR below this")
    ap.add_argument("--sync-start-iter", type=int, default=None,
                    help="cross the staged-training boundary: after this "
                         "iteration the post-net freezes and the SyncNet "
                         "loss turns on.  The teacher is saved and shared "
                         "with cli/evaluate --sync, and the report adds "
                         "val PSNR / sync confidence / LMD before and "
                         "after the boundary and the loss_sync trajectory")
    ap.add_argument("--pretrain-teacher", type=int, default=0,
                    help="train the SyncNet teacher for N steps on the "
                         "identity's ground-truth frames first, instead "
                         "of a random-init teacher")
    ap.add_argument("--dtype", default=None,
                    help="training.compute_dtype override (e.g. bfloat16)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default: the card)")
    ap.add_argument("--json", default=None, help="write report here")
    return ap.parse_args(argv)


def main(argv=None, part=None):
    args = parse_args(argv)
    part = part or (lambda name: contextlib.nullcontext())

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.cli import evaluate as cli_evaluate
    from speech2lip_tpu_torch.cli import infer as cli_infer
    from speech2lip_tpu_torch.config import save_config
    from speech2lip_tpu_torch.core import checkpoint as ckpt_io
    from speech2lip_tpu_torch.data.synthetic import make_learnable_tree
    from speech2lip_tpu_torch.core.device import resolve_device
    from speech2lip_tpu_torch.train.trainer import fit

    device = resolve_device(args.device)
    out = os.path.abspath(args.out)
    root = os.path.join(out, "identity")
    ckpt_dir = os.path.join(out, "ckpts")
    os.makedirs(out, exist_ok=True)
    geo = make_learnable_tree(root, n_frames=args.frames, face=args.face,
                              lip_h=args.lip_h, lip_w=args.lip_w)
    cfg = build_cfg(root, geo, ckpt_dir, args)
    teacher_hist = None
    if args.sync_start_iter is not None:
        # one teacher for training and scoring: cli/evaluate --sync loads
        # training.syncnet_weights
        teacher_path = os.path.join(out, "syncnet_teacher.ckpt")
        with part("teacher"):
            if args.pretrain_teacher > 0:
                from speech2lip_tpu_torch.train.syncnet_pretrain import (
                    pretrain_teacher)
                teacher, teacher_hist = pretrain_teacher(
                    cfg, steps=args.pretrain_teacher, device=device)
            else:
                teacher = weights.init_syncnet(0)
            ckpt_io.save(teacher_path, teacher)
        cfg["training"].update({
            "use_syncloss": True,
            "sync_start_iter": args.sync_start_iter,
            "postnet_freeze_iter": args.sync_start_iter,
            "syncnet_weights": teacher_path,
            # an immutable model_<N>.ckpt at the staging boundary: the
            # "before" model of the report
            "backup_every": args.sync_start_iter,
        })
    cfg_path = os.path.join(out, "config.yaml")
    save_config(cfg_path, cfg)

    t0 = time.time()
    with part("fit"):
        fit(cfg, max_iters=args.iters, device=device)
    train_s = time.time() - t0

    def records(key):
        with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
            return [r for r in map(json.loads, f) if key in r]

    traj = [{"it": r["it"], "psnr": r["val/psnr"]}
            for r in records("val/psnr")]
    best_selected = os.path.exists(os.path.join(ckpt_dir, "model_best.ckpt"))
    n_train = args.frames - args.val_frames

    def render_and_score(render_name: str, model_file: str,
                         with_sync: bool) -> dict:
        cwd = os.getcwd()
        os.chdir(out)       # cli/infer writes under ./rendering_result
        try:
            with part(f"infer:{render_name}"):
                cli_infer.main([cfg_path, "--output_dir", render_name,
                                "--model_path", model_file,
                                "--batch", str(args.batch),
                                "--device", str(device)])
        finally:
            os.chdir(cwd)
        cmd = ["--pred", os.path.join(out, "rendering_result", render_name,
                                      "postfusion"),
               "--gt", os.path.join(root, "ori_images_face"),
               "--offset", str(n_train), "--device", str(device)]
        if with_sync:
            # the sync confidence against the shared teacher, and LMD
            # through the same detector before and after the boundary
            cmd += ["--sync", "--config", cfg_path, "--lms-from-fan"]
        with part(f"evaluate:{render_name}"):
            return cli_evaluate.main(cmd)

    metrics = render_and_score("convergence", "model_best.ckpt",
                               with_sync=args.sync_start_iter is not None)
    report = {
        "geometry": geo,
        "iters": args.iters,
        "batch": args.batch,
        "compute_dtype": args.dtype or "float32",
        "train_seconds": round(train_s, 1),
        "val_psnr_trajectory": traj,
        "best_checkpoint_selected": best_selected,
        "rendered_val_metrics": metrics,
        "backend": str(device),
    }

    if args.sync_start_iter is not None:
        before = render_and_score(
            "conv_presync", f"model_{args.sync_start_iter}.ckpt",
            with_sync=True)
        after = render_and_score("conv_postsync", "model.ckpt",
                                 with_sync=True)
        report.update({
            "sync_start_iter": args.sync_start_iter,
            "teacher_pretrain_steps": args.pretrain_teacher,
            "teacher_bce_history": teacher_hist,
            "presync_val_metrics": before,
            "postsync_val_metrics": after,
            "loss_sync_trajectory": [
                {"it": r["it"], "loss_sync": r["train/loss_sync"]}
                for r in records("train/loss_sync")],
            # stability across the boundary: PSNR must not collapse
            "postsync_psnr_drop_db": round(
                before["psnr"] - after["psnr"], 3),
            "sync_conf_delta": round(
                after["sync_conf"] - before["sync_conf"], 4),
        })
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
