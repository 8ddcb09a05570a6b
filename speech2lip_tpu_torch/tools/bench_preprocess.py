"""The 3DMM tracker at the reference's budgets, timed by phase (counterpart
of ``tools/bench_preprocess.py``).

Runs the port's ``find_focal`` and 4-phase ``fit`` at 500^2 on a
Basel-sized synthetic 3DMM (34,650 vertices, id 100 / exp 79 / tex 100)
over ~50 frames of random pixels and plausible landmark tracks, and prints
one JSON line with each phase's wall seconds (the device synchronised at
each phase's end).

    python -m speech2lip_tpu_torch.tools.bench_preprocess [--frames 50]
        [--verts 34650] [--no-focal] [--budget-scale 0.1]
        [--image-size 500] [--json out.json] [--device cuda|cpu]

``--scaling --devices N`` also runs the tool again as N ranks
(``parallel.distributed.launch``: NCCL on the card, gloo on the CPU),
whose tracker splits the photometric phases' frames over them, and adds
their phase c/d seconds (rank 0's clock), the speed-up of phases c+d and
the JAX tool's full-clip extrapolation table, from those N-rank times
where the JAX tool simulates a device's share.  Started under a launcher,
the tool is one of those ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

BUDGETS = ("iters_focal_pose", "iters_focal_idexp", "iters_pose",
           "iters_idexp", "iters_photo", "iters_window")


def _timed(fn, dev, iters: int = 3) -> float:
    """Median wall ms of ``fn()`` after one warm-up, the device synced."""
    import torch
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    fn()
    sync()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    return sorted(ms)[len(ms) // 2]


def profile_photo(tracker, track, images, focal: float) -> dict:
    """Phase c's loss and gradients once on the fitted key frames: its
    wall ms, the rasterization's, and the top device ops of one
    iteration."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speech2lip_tpu_torch.ops.rasterize import rasterize
    from speech2lip_tpu_torch.preprocess import face_3dmm as bfm

    dev, c = tracker.device, tracker.cfg
    n = tracker.lms.shape[0]
    bs = min(c.batch_size, n)
    sel = np.arange(0, n, max(1, n // bs))[:bs]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    q0 = {"id": t(track["id"]), "exp_sel": t(track["exp"][sel]),
          "euler_sel": t(track["euler"][sel]),
          "trans_sel": t(track["trans"][sel]), "tex": t(track["tex"]),
          "light": t(track["light"][sel])}
    imgs, lms = t(images[sel]), tracker.lms[torch.as_tensor(sel)]

    def iteration():
        q = {k: v.clone().requires_grad_(True) for k, v in q0.items()}
        loss = tracker.photo_loss(q, imgs, lms, (3.0, 2.0, 1.0), focal)
        torch.autograd.grad(loss, list(q.values()))

    with torch.no_grad():
        geo = bfm.forward_geo(tracker.assets, q0["id"].expand(bs, -1),
                              q0["exp_sel"])
        rott = bfm.rot_trans_pts(geo, bfm.euler2rot(q0["euler_sel"]),
                                 q0["trans_sel"])
        pix = bfm.camera_pixels(rott, focal, c.img_h, c.img_w)
    out = {"photo_frames": bs,
           "photo_iter_ms": _timed(iteration, dev),
           "raster_ms": _timed(lambda: rasterize(
               pix, tracker.assets.tris, c.img_h, c.img_w,
               **c.raster_kwargs), dev)}
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        iteration()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    key = "self_device_time_total" if dev.type == "cuda" else \
        "self_cpu_time_total"
    rows = sorted(prof.key_averages(), key=lambda e: getattr(e, key, 0),
                  reverse=True)[:8]
    out["photo_top_ops_ms"] = {e.key: getattr(e, key, 0) / 1e3
                               for e in rows}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--verts", type=int, default=34650)
    ap.add_argument("--no-focal", action="store_true",
                    help="skip the find_focal grid search")
    ap.add_argument("--scaling", action="store_true",
                    help="also time phases c/d on --devices ranks and "
                         "extrapolate full clips")
    ap.add_argument("--devices", type=int, default=2,
                    help="ranks of the --scaling run")
    ap.add_argument("--clips", default="500,1000,5000",
                    help="clip lengths (frames) for the extrapolation")
    ap.add_argument("--budget-scale", type=float, default=1.0,
                    help="multiply every tracker iteration budget")
    ap.add_argument("--image-size", type=int, default=500)
    ap.add_argument("--json", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="also time one photometric iteration on the key "
                         "frames, its rasterization, and its top device "
                         "ops (torch.profiler)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from speech2lip_tpu_torch.core.device import resolve_device
    from speech2lip_tpu_torch.ops.nn import full_float32
    from speech2lip_tpu_torch.parallel import distributed
    from speech2lip_tpu_torch.parallel.mesh import make_mesh
    from speech2lip_tpu_torch.preprocess import face_3dmm as bfm
    from speech2lip_tpu_torch.preprocess.tracker import (FaceTracker,
                                                         TrackerConfig)

    dev = resolve_device(args.device)
    made = distributed.initialize_if_needed(dev)
    dev = distributed.rank_device(dev)
    mesh = (make_mesh(device=dev) if distributed.process_count() > 1
            else None)
    print(f"# building a {args.verts}-vertex synthetic BFM (id 100 / exp 79 "
          "/ tex 100)...", file=sys.stderr)
    assets = bfm.synthetic_assets(n_verts=args.verts, id_dim=100,
                                  exp_dim=79, tex_dim=100, device=dev)
    n, h, w = args.frames, args.image_size, args.image_size
    rng = np.random.default_rng(0)
    # plausible landmark tracks: a smooth drift around the centre
    base_lms = rng.uniform(0.3 * h, 0.7 * h, (68, 2)).astype(np.float32)
    drift = 3.0 * np.sin(np.arange(n)[:, None, None] / 7.0
                         + rng.uniform(0, 6, (1, 68, 2)))
    lms = (base_lms[None] + drift).astype(np.float32)
    images = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)

    cfg = TrackerConfig(img_h=h, img_w=w)
    if args.budget_scale != 1.0:
        cfg = dataclasses.replace(cfg, **{
            f: max(2, int(getattr(cfg, f) * args.budget_scale))
            for f in BUDGETS})
    report = {"frames": n, "verts": args.verts, "backend": dev.type,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "budgets": {f: getattr(cfg, f) for f in BUDGETS}}
    with full_float32():
        tracker = FaceTracker(assets, lms, cfg, mesh=mesh, device=dev)
        if not args.no_focal:
            t0 = time.perf_counter()
            focal = tracker.find_focal()
            report["find_focal_s"] = time.perf_counter() - t0
            report["focal"] = focal
        else:
            focal = 1200.0
        timings = {}
        t0 = time.perf_counter()
        track = tracker.fit(focal, images=images, timings=timings)
        report["fit_total_s"] = time.perf_counter() - t0
        if args.profile:
            report.update(profile_photo(tracker, track, images, focal))
    report.update({k + "_s": v for k, v in timings.items()})
    rank = 0
    if mesh is not None:
        report["ranks"], rank = mesh.data, mesh.rank
    if made:
        torch.distributed.destroy_process_group()
    if rank:
        return report
    if args.scaling:
        report.update(scaling(args, argv, cfg, n, timings))
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return report


def scaling(args, argv, cfg, n: int, timings) -> dict:
    """Phases c/d on ``--devices`` ranks (this tool again, launched),
    beside this run's, and the JAX tool's full-clip extrapolation: phases
    a/b scale with the frames, c is one key-frame fit, d one window per
    ``batch_size`` frames."""
    from speech2lip_tpu_torch.parallel.distributed import launch

    d = args.devices
    argv = [a for a in (sys.argv[1:] if argv is None else argv)
            if a not in ("--scaling", "--profile")]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ranks.json")
        print(f"# phases c/d on {d} ranks...", file=sys.stderr)
        launch(d, "speech2lip_tpu_torch.tools.bench_preprocess",
               [*argv, "--no-focal", "--json", out],
               stdout=subprocess.DEVNULL)
        with open(out) as f:
            ranks = json.load(f)
    c1, d1 = timings["phase_c_photometric"], timings["phase_d_window"]
    cd, dd = ranks["phase_c_photometric_s"], ranks["phase_d_window_s"]
    ab_per_frame = (timings["phase_a_pose"] + timings["phase_b_idexp"]) / n
    table = []
    for clip in [int(x) for x in args.clips.split(",") if x]:
        windows = math.ceil(clip / cfg.batch_size)
        one = ab_per_frame * clip + c1 + windows * d1
        many = ab_per_frame * clip + cd + windows * dd
        table.append({"clip_frames": clip, "windows": windows,
                      "chip1_min": one / 60, f"chips{d}_min": many / 60,
                      "speedup": one / many})
    return {"devices": d, "phase_c_photometric_ranks_s": cd,
            "phase_d_window_ranks_s": dd,
            "phase_cd_speedup_at_devices": (c1 + d1) / (cd + dd),
            "extrapolation": table}


if __name__ == "__main__":
    main()
