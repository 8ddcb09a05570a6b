"""Multi-identity serving benchmark: identities streaming request waves at
a 512x512 face (counterpart of ``tools/bench_serving.py``).

    python -m speech2lip_tpu_torch.tools.bench_serving [--identities 8] \
        [--face 512] [--lip-h 80] [--lip-w 120] [--batch 16] [--rounds 8] \
        [--static] [--device cuda|cpu]

Builds ``--identities`` identities with weights from seeds
(``weights.random_params``) that share the lip size at the face size,
and streams ``--rounds`` waves of ``--batch`` frames per identity through
``MultiSpeakerServer.render_all`` (``--static``: through one
``StaticSceneRenderer`` per identity, the U-Net on the warp window's
crop).  A wave ends when its frames are on the card's host side of a
``torch.cuda.synchronize``.  Prints one JSON line: aggregate frames/s,
per-wave latency (median and max), the device and the path.  Runs on the
card unless ``--device`` names another; the card's name is in the line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--identities", type=int, default=8)
    ap.add_argument("--face", type=int, default=512)
    ap.add_argument("--lip-h", type=int, default=80)
    ap.add_argument("--lip-w", type=int, default=120)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--static", action="store_true", help=(
        "static-scene renderers (canonical artifacts fixed per identity, "
        "U-Net on the lip-window crop only)"))
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def build(args) -> SimpleNamespace:
    """The identities and their inputs: ``wave()`` renders one wave and
    returns each identity's faces; ``server`` (or ``renderers`` with
    ``--static``), ``batches`` or ``audio`` and ``t_idx`` are what it
    renders with."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.config import default_config
    from speech2lip_tpu_torch.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch.data.windows import compute_warp_window
    from speech2lip_tpu_torch.infer.pipeline import (RENDER_KEYS,
                                                     MultiSpeakerServer)
    from speech2lip_tpu_torch.core.device import resolve_device
    from speech2lip_tpu_torch.models import talking_face as tfm

    device = resolve_device(args.device)
    face, lip_h, lip_w = args.face, args.lip_h, args.lip_w
    cfg = default_config()
    cfg["data"]["height"], cfg["data"]["width"] = lip_h, lip_w
    cfg["model"]["canonical_depth_height"] = face
    cfg["model"]["canonical_depth_width"] = face

    raw, geo = synthetic_batch(args.batch, face=face, lip_h=lip_h,
                               lip_w=lip_w)
    box = tfm.expanded_lip_box(lip_h, lip_w, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window(
        [raw["coord"][i] for i in range(args.batch)], box, face, face,
        margin=16)
    param_sets = [weights.random_params(s, cfg=cfg)
                  for s in range(args.identities)]
    rng = np.random.default_rng(0)
    audio = [torch.from_numpy(rng.standard_normal(
        raw["audio"].shape).astype(np.float32)).to(device)
        for _ in range(args.identities)]
    if args.static:
        from speech2lip_tpu_torch.infer.static_scene import \
            StaticSceneRenderer
        base = {k: raw[k][0] for k in ("rgb_face_zero", "rgb_face_ori",
                                       "mask_lip_canonical", "coord")}
        renderers = [StaticSceneRenderer(cfg, *ps, base=base,
                                         window=tuple(window),
                                         lip_x=geo["lip_x"],
                                         lip_y=geo["lip_y"], device=device)
                     for ps in param_sets]
        t_idx = torch.arange(args.batch, dtype=torch.float32, device=device)

        def wave():
            return [r(a, t_idx) for r, a in zip(renderers, audio)]
        return SimpleNamespace(wave=wave, renderers=renderers, audio=audio,
                               t_idx=t_idx, crop=renderers[0].geo,
                               path="static-window", device=device)
    server = MultiSpeakerServer(
        cfg, param_sets, [(geo["lip_x"], geo["lip_y"])] * args.identities,
        window=tuple(window), device=device)
    batches = []
    for a in audio:
        b = {k: torch.from_numpy(raw[k]).to(device) for k in RENDER_KEYS}
        b["audio"] = a
        batches.append(b)

    def wave():
        return [o["face"] for o in server.render_all(batches)]
    return SimpleNamespace(wave=wave, server=server, batches=batches,
                           crop=None, path=("kernels" if server.use_kernels
                                            else "plain"), device=device)


def run(args, bench: Optional[SimpleNamespace] = None) -> dict:
    """Stream the waves of ``bench`` (built from ``args`` where it is
    None); returns the JSON record.  The last wave's faces stay in
    ``bench.outs``."""
    bench = bench or build(args)
    device, wave, crop = bench.device, bench.wave, bench.crop

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    wave()   # warm-up (the first launch of each kernel loads its module)
    sync()
    lat = []
    t_all0 = time.perf_counter()
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        outs = wave()
        sync()
        lat.append(time.perf_counter() - t0)
    total_s = time.perf_counter() - t_all0
    frames = args.identities * args.batch * args.rounds
    fps = frames / total_s
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    bench.outs = outs
    return {
        "metric": f"serving_fps_{args.identities}id_{args.face}sq",
        "value": fps,
        "unit": "frames/s aggregate",
        "identities": args.identities,
        "face": args.face,
        "batch_per_identity": args.batch,
        "rounds": args.rounds,
        "wave_latency_ms_p50": 1e3 * sorted(lat)[len(lat) // 2],
        "wave_latency_ms_max": 1e3 * max(lat),
        "realtime_factor_per_identity_25fps": fps / args.identities / 25.0,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "static_scene": args.static,
        "static_crop": (f"{crop['ch']}x{crop['cw']}" if crop else None),
        "path": bench.path,
        "finite": finite,
        "out_shape": list(outs[-1].shape),
    }


def main(argv=None) -> dict:
    rec = run(parse(argv))
    print(json.dumps(rec), flush=True)
    if not rec["finite"]:
        sys.exit("bench_serving: non-finite frames")
    return rec


if __name__ == "__main__":
    main()
