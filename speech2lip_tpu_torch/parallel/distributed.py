"""Process-group start-up (counterpart of
``speech2lip_tpu/parallel/distributed.py``).

The JAX package reaches its other hosts through ``jax.distributed``; the
port runs one process a card over ``torch.distributed``.  Launch N ranks
with ``python -m torch.distributed.run --nproc_per_node N -m
speech2lip_tpu_torch.cli.train cfg.yaml``: the launcher sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, and
``initialize_if_needed`` joins the group they name, NCCL when the ranks
train on the card and gloo on the CPU.  A process started without them
is a world of one and no group is made.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """True when a launcher named this process's group in the
    environment."""
    return all(v in os.environ for v in _LAUNCH_VARS)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_if_needed(device="cuda") -> bool:
    """Join the process group the launcher's variables name, once: NCCL
    when ``device`` is a CUDA device (after ``torch.cuda.set_device
    (LOCAL_RANK)``, before anything is allocated on the card), gloo
    otherwise.  A no-op in a process no launcher started, and when the
    group exists already.  Returns whether it made the group."""
    if dist.is_initialized() or not launched():
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend="nccl" if cuda else "gloo",
                            init_method="env://")
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def rank_device(device) -> torch.device:
    """``device`` with the card's index pinned to this rank's
    ``LOCAL_RANK`` when it names the card without one and a launcher
    started the process; otherwise ``device`` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and launched():
        return torch.device("cuda", local_rank())
    return device


def launch(n: int, module: str, args, **kw):
    """Run ``python -m module args`` as ``n`` ranks on this host through
    ``torch.distributed.run --standalone`` (a free local port), waiting
    for them; raises ``CalledProcessError`` when a rank fails.  ``kw``
    goes to ``subprocess.run``."""
    import subprocess
    import sys
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={int(n)}", "-m", module, *map(str, args)]
    return subprocess.run(cmd, check=True, **kw)
