"""Training CLI (counterpart of ``speech2lip_tpu/cli/train.py``).

Usage:
    python -m speech2lip_tpu_torch.cli.train configs/may/may.yaml \
        [--exit-after SECONDS] [--max-iters N] [--device cuda|cpu]

Trains on the card unless ``--device`` names another; ``--device cpu``
runs the kernels' plain versions.  Resumes from the output directory's
checkpoints by default; ``--exit-after`` checkpoints and exits with code 3
after that many seconds.

On N ranks, one a card (gloo ranks with ``--device cpu``):
    python -m torch.distributed.run --nproc_per_node N \
        -m speech2lip_tpu_torch.cli.train cfg.yaml
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a Speech2Lip model.")
    parser.add_argument("config", type=str, help="Path to config file.")
    parser.add_argument("--exit-after", type=int, default=-1,
                        help="Checkpoint and exit(3) after N seconds "
                             "(preemptible scheduling contract).")
    parser.add_argument("--max-iters", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: the card)")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from speech2lip_tpu_torch.config import load_config
    from speech2lip_tpu_torch.parallel.distributed import initialize_if_needed
    from speech2lip_tpu_torch.train.trainer import fit

    made = initialize_if_needed(args.device)
    try:
        cfg = load_config(args.config)
        return fit(cfg, max_iters=args.max_iters,
                   exit_after=args.exit_after if args.exit_after > 0
                   else None, device=args.device)
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
