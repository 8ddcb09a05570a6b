"""Host time of the training loop's batch build, by part, at May geometry.

    python -m speech2lip_tpu_torch.tools.bench_loader [--device cuda|cpu]

Writes a learnable identity (``data.synthetic.make_learnable_tree``, 500²
face, 120x80 lip, 48 frames) to a temporary directory and times, over
``--batches`` batches of ``--batch`` training frames in the order
``trainer.batch_iterator`` reads them, each part of
``LipDataset.load_frame``: the lip and face JPEG decodes, the coord grid,
the black-hole augmentation's two host warps (``blackaug_statics``) and
the sync-loss extras (5 coord grids, 5 decodes resized to 96x96, the mel
window); then ``stack_batch`` and the copy to ``--device``.  Prints one
JSON line of milliseconds per batch.  The parts are timed apart from
``load_frame`` itself, which is timed whole.  It also times the stage-1
iterator (the sync loss off) with the Python reader and with the
prefetcher ``fit`` takes (``prefetch_backend``: the native runtime or
the cv2 thread pool), and names that backend.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from speech2lip_tpu_torch.data.dataset import LipDataset, stack_batch
from speech2lip_tpu_torch.data.image_io import imread_float
from speech2lip_tpu_torch.data.synthetic import (make_learnable_tree,
                                                 synthetic_config)
from speech2lip_tpu_torch.train.trainer import (batch_iterator,
                                                prefetch_backend, to_device)


def _ms(fn):
    t = time.perf_counter()
    out = fn()
    return 1e3 * (time.perf_counter() - t), out


def measure(root: str, cfg, batch: int, batches: int, device) -> dict:
    ds = LipDataset(root, "train", cfg)
    order = np.arange(len(ds))
    np.random.default_rng(0).shuffle(order)
    parts = {k: 0.0 for k in ("lip_jpeg", "face_jpeg", "coord", "blackaug",
                              "sync_extras", "load_frame", "stack_batch",
                              "to_device")}
    for b in range(batches):
        samples = []
        for pos in order[b * batch:(b + 1) * batch]:
            pos = int(pos)
            name = ds.files[ds._index_map[pos]]
            parts["lip_jpeg"] += _ms(lambda: imread_float(
                os.path.join(ds.images_dir, name)))[0]
            parts["face_jpeg"] += _ms(lambda: imread_float(
                os.path.join(ds.faces_dir, name)))[0]
            t, coord = _ms(lambda: ds._coord(pos))
            parts["coord"] += t
            parts["blackaug"] += _ms(lambda: ds.blackaug_statics(coord))[0]
            parts["sync_extras"] += _ms(lambda: ds._sync_extras(pos))[0]
            t, s = _ms(lambda: ds.load_frame(pos))
            parts["load_frame"] += t
            samples.append(s)
        t, host = _ms(lambda: stack_batch(samples))
        parts["stack_batch"] += t

        def copy():
            out = to_device(host, device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            return out
        parts["to_device"] += _ms(copy)[0]
    per_batch = {k: v / batches for k, v in parts.items()}
    per_batch["batch_build"] = (per_batch["load_frame"]
                                + per_batch["stack_batch"]
                                + per_batch["to_device"])
    nbytes = sum(v.nbytes for v in host.values())
    return {"ms_per_batch": per_batch, "batch": batch, "batches": batches,
            "batch_mbytes": nbytes / 1e6, "frames_in_split": len(ds),
            "sync_keys_mbytes": sum(
                host[k].nbytes for k in ("mel", "audio_window",
                                         "coord_window", "rgb_window_neg")
            ) / 1e6}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--batches", type=int, default=3)
    parser.add_argument("--frames", type=int, default=48)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_loader: no CUDA device (pass --device cpu)")
    with tempfile.TemporaryDirectory() as tmp:
        geo = make_learnable_tree(tmp, n_frames=args.frames, face=500,
                                  lip_h=80, lip_w=120)
        cfg = synthetic_config(tmp, geo)
        # the iterator's own order and batch, for a check of the totals
        ds = LipDataset(tmp, "train", cfg)
        t = time.perf_counter()
        for i, _ in enumerate(batch_iterator(ds, args.batch, True, 0)):
            if i + 1 == args.batches:
                break
        iterator_ms = 1e3 * (time.perf_counter() - t) / args.batches
        out = measure(tmp, cfg, args.batch, args.batches, device)
        stage1 = LipDataset(tmp, "train", dict(cfg, training=dict(
            cfg["training"], use_syncloss=False)))
        backend = prefetch_backend(stage1)
        stage1_ms = {}
        for name, native in (("python", False), (backend, True)):
            t = time.perf_counter()
            for i, _ in enumerate(batch_iterator(stage1, args.batch, True, 0,
                                                 use_native=native)):
                if i + 1 == args.batches:
                    break
            stage1_ms[name] = 1e3 * (time.perf_counter() - t) / args.batches
    out["batch_iterator_ms_per_batch"] = iterator_ms
    out["prefetch_backend"] = backend
    out["stage1_iterator_ms_per_batch"] = stage1_ms
    out["device"] = (torch.cuda.get_device_name(0) if device.type == "cuda"
                     else "cpu")
    out["host_cpus"] = os.cpu_count()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
