"""Multi-identity serving daemon over a filesystem request queue
(counterpart of ``speech2lip_tpu/cli/serve.py``, the same protocol).

Usage:
    python -m speech2lip_tpu_torch.cli.serve cfg_id0.yaml [cfg_id1.yaml ...] \
        --queue QUEUE_DIR --out OUT_DIR [--batch 32] [--poll 0.5] \
        [--once] [--grace S] [--static] [--deepspeech deepspeech.ckpt] \
        [--bf16 | --fp32] [--device cuda|cpu]

Loads N trained identities (each config's checkpoint in its
``training.out_dir``) into one ``MultiSpeakerServer`` and streams new-audio
requests through it.  Runs on the card unless ``--device`` names another:
the kernels in bfloat16 there unless ``--fp32``, the plain path in float32
on the CPU unless ``--bf16``.

Request protocol (one file per request dropped into QUEUE_DIR):
    <identity_index>__<request_id>.npy   DeepSpeech windows [N, 16, 29]
    <identity_index>__<request_id>.wav   raw speech (needs --deepspeech, a
                                         DeepSpeech npz checkpoint, or an
                                         identity in mel mode, use_audio_mel)
Clients should write under another name and ``os.rename`` into the queue
(atomic within a directory).  The daemon also skips files modified within
the last ``--grace`` seconds, and retries a failed request once on the
next pass before giving up.

Responses: frames at OUT_DIR/<request_id>/%05d.jpg and
OUT_DIR/<request_id>.done (the frame count) written last; a request that
fails twice is removed and leaves <request_id>.err with the message.
Frames are written as ``np.clip(x * 255, 0, 255).astype(np.uint8)``,
which truncates, as the JAX daemon writes them (``cli/infer`` rounds).
``--once`` drains the queue and exits; otherwise the daemon polls.
``--static`` serves through a ``StaticSceneRenderer`` per identity (the
U-Net on the warp window's crop), falling back to the full path for an
identity with no warp window or no coord grid.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _load_identity(cfg_path: str, device):
    """(config, dataset, state) of one identity: the 'test' split where the
    tree has audio_test/, else 'val'; the checkpoint restored over seeded
    parameters (with a warning where there is none)."""
    from speech2lip_tpu_torch.config import load_config
    from speech2lip_tpu_torch.core.checkpoint import CheckpointManager
    from speech2lip_tpu_torch.data.dataset import LipDataset
    from speech2lip_tpu_torch.train.trainer import init_params

    cfg = load_config(cfg_path)
    root = cfg["data"]["path"]
    mode = "test" if os.path.isdir(os.path.join(root, "audio_test")) \
        else "val"
    ds = LipDataset(root, mode, cfg)
    params, unet_p, unet_s = init_params(cfg, ds, device=device)
    like = {"params": params, "unet_params": unet_p, "unet_state": unet_s,
            "it": 0}
    state, scalars = CheckpointManager(cfg["training"]["out_dir"]).restore(
        like)
    if not scalars:
        print(f"WARNING: no checkpoint for {cfg_path}: serving RANDOM "
              "weights")
    return cfg, ds, state


def _audio_windows(path: str, cfg, ds_params, device) -> np.ndarray:
    """A request's audio windows: the .npy as it is, or a .wav as mel
    windows (a mel-mode identity) or as DeepSpeech windows."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    from speech2lip_tpu_torch.ops import audio_dsp
    wav = audio_dsp.load_wav(path)
    if cfg["model"].get("use_audio_mel"):
        mel = audio_dsp.melspectrogram(
            wav, fmin=cfg["data"].get("mel_fmin", 55.0)).T
        n = max(0, int((mel.shape[0] - 16) / 80.0 * 25.0) + 1)
        return np.stack([audio_dsp.crop_audio_window(mel, i + 2)
                         for i in range(n)]).astype(np.float32)
    if ds_params is None:
        raise ValueError(".wav request needs --deepspeech (or a "
                         "use_audio_mel identity)")
    from speech2lip_tpu_torch.preprocess.audio_features import \
        wav_to_deepspeech_windows
    return wav_to_deepspeech_windows(wav, 16000, ds_params, device=device)


def _warp_windows(identities):
    """Each identity's warp window (the config's, else its coord grids',
    cached on disk) and their union, which holds for every identity, or
    None (the full-frame warp) where any identity has none."""
    from speech2lip_tpu_torch.data.windows import cached_warp_window
    from speech2lip_tpu_torch.models import talking_face as tf

    windows = []
    for cfg_i, ds_i, _ in identities:
        win = cfg_i["data"].get("warp_window")
        if win is None:
            box = tf.expanded_lip_box(
                ds_i.lip_h, ds_i.lip_w, ds_i.lefttop_x, ds_i.lefttop_y,
                cfg_i["data"].get("expand_mask_divisor", 5))
            win = cached_warp_window(cfg_i["data"]["path"], box, ds_i.face_h,
                                     ds_i.face_w, ds_i.iter_coords)
        windows.append(tuple(win) if win is not None else None)
    if any(w is None for w in windows):
        return windows, None
    y0 = min(w[0] for w in windows)
    x0 = min(w[1] for w in windows)
    y1 = max(w[0] + w[2] for w in windows)
    x1 = max(w[1] + w[3] for w in windows)
    return windows, (y0, x0, y1 - y0, x1 - x0)


def main(argv=None):
    """Serve the queue.  Returns a summary: the requests done and failed,
    the frames and seconds, and the server, the static renderers and the
    canonical frames that served them."""
    ap = argparse.ArgumentParser(description="Serve trained identities.")
    ap.add_argument("configs", nargs="+")
    ap.add_argument("--queue", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--poll", type=float, default=0.5)
    ap.add_argument("--once", action="store_true")
    ap.add_argument("--deepspeech", type=str, default=None)
    ap.add_argument("--grace", type=float, default=0.0, help=(
        "skip queue files modified within this many seconds (guards "
        "against non-atomic client writes; 0 disables)"))
    ap.add_argument("--static", action="store_true", help=(
        "serve through the static-scene renderers (U-Net on the "
        "lip-window crop only). Falls back per identity when no warp "
        "window exists."))
    ap.add_argument("--bf16", action="store_true",
                    help="serve in bfloat16 (the default on the card)")
    ap.add_argument("--fp32", action="store_true",
                    help="serve in float32 (the default on the CPU)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.core import checkpoint as ckpt
    from speech2lip_tpu_torch.data import image_io
    from speech2lip_tpu_torch.infer.pipeline import (MultiSpeakerServer,
                                                     frame_batch)
    from speech2lip_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    dtype = (torch.float32 if args.fp32 else
             torch.bfloat16 if args.bf16 else None)
    identities = [_load_identity(c, device) for c in args.configs]
    windows, window = _warp_windows(identities)
    server = MultiSpeakerServer(
        identities[0][0],
        [(st["params"], st["unet_params"], st["unet_state"])
         for _, _, st in identities],
        [(ds.lefttop_x, ds.lefttop_y) for _, ds, _ in identities],
        window=window, device=device, compute_dtype=dtype)
    bases = [ds.load_frame(0) for _, ds, _ in identities]
    static_renderers = None
    if args.static:
        from speech2lip_tpu_torch.infer.static_scene import \
            StaticSceneRenderer
        static_renderers = []
        for (cfg_i, ds_i, st_i), base_i, win_i in zip(identities, bases,
                                                      windows):
            if win_i is None or "coord" not in base_i:
                static_renderers.append(None)  # the full path
                continue
            static_renderers.append(StaticSceneRenderer(
                cfg_i, st_i["params"], st_i["unet_params"],
                st_i["unet_state"], base_i, win_i, ds_i.lefttop_x,
                ds_i.lefttop_y, device=device, compute_dtype=dtype))
        n_crop = sum(r is not None and r.geo is not None
                     for r in static_renderers)
        print(f"static-scene serving: {n_crop}/{len(identities)} "
              "identities on the windowed U-Net path")
    ds_params = None
    if args.deepspeech:
        tree, _ = ckpt.load_nested(args.deepspeech)
        ds_params = weights.deepspeech_from_jax(tree, device)

    os.makedirs(args.out, exist_ok=True)
    print(f"serving {len(identities)} identities from {args.queue}")

    fail_counts = {}
    summary = {"done": [], "err": [], "frames": 0, "render_seconds": 0.0,
               "static_renderers": sum(r is not None for r in
                                       static_renderers or []),
               "server": server, "renderers": static_renderers,
               "bases": bases}

    def handle(fname):
        """Process one queue file.  Returns True when the file reached a
        terminal state (rendered, or failed twice and err'd); False when
        it was kept in the queue for one retry."""
        stem = os.path.splitext(fname)[0]
        ident_s, _, req = stem.partition("__")
        path = os.path.join(args.queue, fname)
        try:
            ident = int(ident_s)
            cfg, ds, _ = identities[ident]
            wins = _audio_windows(path, cfg, ds_params, device)
            req_dir = os.path.join(args.out, req)
            os.makedirs(req_dir, exist_ok=True)
            n = wins.shape[0]
            sr = (static_renderers[ident]
                  if static_renderers is not None else None)
            for start in range(0, n, args.batch):
                stop = min(start + args.batch, n)
                if sr is not None:
                    t0 = time.perf_counter()
                    faces = sr(wins[start:stop],
                               np.arange(start, stop, dtype=np.float32))
                else:
                    b = frame_batch(bases[ident], wins, start, stop, device)
                    t0 = time.perf_counter()
                    faces = server.render(ident, b)["face"]
                faces = faces.cpu().numpy()
                summary["render_seconds"] += time.perf_counter() - t0
                for k, i in enumerate(range(start, stop)):
                    img = np.clip(faces[k] * 255.0, 0, 255).astype(np.uint8)
                    image_io.imwrite(os.path.join(req_dir, f"{i:05d}.jpg"),
                                     img)
            with open(os.path.join(args.out, req + ".done"), "w") as f:
                f.write(str(n))
            print(f"request {req}: {n} frames for identity {ident}")
            os.remove(path)
            fail_counts.pop(fname, None)
            summary["done"].append(req)
            summary["frames"] += n
            return True
        except Exception as e:  # keep serving; retry once before dropping
            fail_counts[fname] = fail_counts.get(fname, 0) + 1
            if fail_counts[fname] < 2:
                print(f"request {req} failed ({e}); will retry")
                return False
            with open(os.path.join(args.out, req + ".err"), "w") as f:
                f.write(f"{type(e).__name__}: {e}")
            print(f"request {req} FAILED: {e}")
            if os.path.exists(path):
                os.remove(path)
            fail_counts.pop(fname, None)
            summary["err"].append(req)
            return True

    def _queue_files():
        return sorted(f for f in os.listdir(args.queue)
                      if f.endswith((".npy", ".wav")) and "__" in f)

    t_start = time.perf_counter()
    while True:
        now = time.time()
        pending = [f for f in _queue_files()
                   if args.grace <= 0 or now - os.path.getmtime(
                       os.path.join(args.queue, f)) >= args.grace]
        resolved = sum(handle(fname) for fname in pending)
        if args.once:
            # drain fully: failed-once files get their retry this pass;
            # stop when the queue is empty or nothing can make progress
            if not _queue_files() or (not resolved and not pending):
                break
            continue
        if not pending:
            time.sleep(args.poll)
    summary["seconds"] = time.perf_counter() - t_start
    summary["compute_dtype"] = str(server.compute_dtype).replace("torch.",
                                                                 "")
    return summary


if __name__ == "__main__":
    main()
