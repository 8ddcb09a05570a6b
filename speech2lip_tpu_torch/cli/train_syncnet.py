"""Train a SyncNet lip-sync expert for one identity (counterpart of
``speech2lip_tpu/cli/train_syncnet.py``).

    python -m speech2lip_tpu_torch.cli.train_syncnet configs/may/may.yaml \
        --out models/syncnet_may.ckpt [--steps 400] [--batch 16] \
        [--lr 1e-4] [--seed 0] [--device cuda|cpu]

Trains on the identity's ground-truth frames and audio
(``train/syncnet_pretrain.py``) and saves the (params, state) checkpoint
that ``training.syncnet_weights`` and ``cli/evaluate --sync`` of either
package load.  Runs on the card unless ``--device`` names another;
``main`` returns the loss history.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a per-identity SyncNet lip-sync expert.")
    ap.add_argument("config", type=str)
    ap.add_argument("--out", required=True, help="checkpoint output path")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    from speech2lip_tpu_torch.config import load_config
    from speech2lip_tpu_torch.core import checkpoint as ckpt_io
    from speech2lip_tpu_torch.train.syncnet_pretrain import pretrain_teacher

    cfg = load_config(args.config)
    teacher, history = pretrain_teacher(
        cfg, steps=args.steps, batch=args.batch, lr=args.lr, seed=args.seed,
        device=args.device)
    ckpt_io.save(args.out, teacher)
    print(f"saved {args.out} (bce {history[0]:.4f} -> {history[-1]:.4f})")
    return history


if __name__ == "__main__":
    main()
