"""Metrics and logging (counterpart of ``speech2lip_tpu/core/metrics.py``):
a JSONL scalar stream mirrored to TensorBoard event files, a file and
console logger, and image panels written as JPEGs.

Under a process group only rank 0 writes them (``is_main_process``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict

import numpy as np

from speech2lip_tpu_torch.core.tb_events import EventFileWriter
from speech2lip_tpu_torch.data import image_io


def is_main_process() -> bool:
    from speech2lip_tpu_torch.parallel.distributed import is_main_process
    return is_main_process()


def setup_logger(out_dir: str, logfile: str = "train.log") -> logging.Logger:
    """File + console logger of ``<out_dir>/<logfile>``; a later call for
    another file moves the logger there."""
    logger = logging.getLogger("speech2lip_tpu_torch")
    logger.setLevel(logging.INFO)
    path = os.path.abspath(os.path.join(out_dir, logfile))
    if not any(getattr(h, "baseFilename", None) == path
               for h in logger.handlers):
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        os.makedirs(out_dir, exist_ok=True)
        fh = logging.FileHandler(path, mode="a")
        fh.setFormatter(logging.Formatter(
            "[%(levelname)s] %(asctime)s: %(message)s", datefmt="%m-%d %H:%M"))
        logger.addHandler(fh)
        ch = logging.StreamHandler()
        ch.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
        logger.addHandler(ch)
    return logger


class MetricsWriter:
    """Append-only JSONL scalar stream ({"it": N, "t": wall time, tag:
    value, ...} a line), mirrored to a TensorBoard event file."""

    def __init__(self, out_dir: str, name: str = "metrics.jsonl",
                 tensorboard: bool = True):
        self.path = os.path.join(out_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        self._f = open(self.path, "a")
        self._tb = (EventFileWriter(os.path.join(out_dir, "tensorboard"))
                    if tensorboard else None)

    def scalars(self, it: int, values: Dict[str, Any], prefix: str = ""):
        rec = {"it": int(it), "t": time.time()}
        for k, v in values.items():
            try:
                rec[prefix + k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("it", "t"):
                    self._tb.scalar(int(it), k, v, wall_time=rec["t"])
            self._tb.flush()

    def image(self, it: int, tag: str, img, out_subdir: str = "images"):
        """Write a [H, W, 3] float RGB image in [0, 1] as
        ``<out_subdir>/<tag>_<it>.jpg``."""
        d = os.path.join(os.path.dirname(self.path), out_subdir)
        os.makedirs(d, exist_ok=True)
        arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype("uint8")
        image_io.imwrite(os.path.join(d, f"{tag}_{it:08d}.jpg"), arr)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
