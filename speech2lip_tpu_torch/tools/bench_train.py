"""Training-step benchmark at May geometry (counterpart of the JAX
package's ``tools/bench_train.py``; informational, no benchmark cell).

    python -m speech2lip_tpu_torch.tools.bench_train [--batch-scaling |
        --ablate] [--device cuda|cpu]

Modes, on the card unless ``--device`` names another, at May geometry
(500^2 face, 120x80 lip, every stage-1 loss), random weights and a
synthetic batch made from seeds:

- default: the stage-1 step at batch 1 and the sync-stage step (SyncNet
  loss, U-Net frozen) at batches 1 and 4, in float32 and bfloat16;
- ``--batch-scaling``: in bfloat16 at batches 1/2/4/8, the whole step, the
  U-Net's forward + backward alone, the lip MLP with its ensemble forward
  + backward alone, and the lip-losses-only step (that gradient and its
  Adam update: the post-fusion path and the U-Net ablated);
- ``--ablate``: the loss-term variants at batches 1 and 8 in bfloat16
  (``full`` warps the black-hole base in the step, ``full+hostwarp`` takes
  it from the batch, made on the host by ``grid_sample_np``, ``+dcrop`` the
  depth loss on its support's box, ``+pallas`` the K7 gathers, ``+pts``
  the depth loss on a ring of May-like support; then one term off each).

The batch is the one ``fit`` hands the step (``train_inputs``): the
canonical frame and masks are per-identity constants, the black-hole
warps come with the batch, the depth loss runs on its support's points.
The default and batch-scaling steps take the K7 gathers (K2 forward, K7
backward), as ``fit`` does for bfloat16 at a batch of 4 or more; each row
counts the K2 / dsrc / dgrid launches of a step.  The port runs eagerly:
a case's "compile" is one warm-up step, then ``ITERS`` steps are timed by
CUDA events (a wall clock on the CPU).  A case that runs out of device
memory is reported as OOM.  float32 runs under torch's TF32 settings as
``fit`` does (by default cuDNN's convolutions in TF32, matmuls not); a
caller that turns TF32 off, as ``chip_smoke.py`` does, times strict
float32.  ``main(argv, size=(face, lip_h, lip_w))``
returns the rows; ``size`` shrinks the geometry for a CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

MAY = (500, 80, 120)      # face, lip_h, lip_w
ITERS = 5
SEED = 0
MARGIN = 16               # the warp window's margin


def train_inputs(dev, b, face, lip_h, lip_w, with_sync=False, seed=SEED):
    """A synthetic training batch on ``dev`` as the trainer hands it to the
    step: the canonical face and masks are per-identity constants (one
    frame's, broadcast), the black-hole branch's static warps are made from
    them, the warp window is validated; plus seeded parameters and frozen
    nets.  Returns (batch, geo, window, params, frozen)."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch.data.windows import compute_warp_window
    from speech2lip_tpu_torch.models import talking_face as tf
    from speech2lip_tpu_torch.ops.grid_sample import grid_sample
    from speech2lip_tpu_torch.train import trainer

    raw, geo = synthetic_batch(b, face=face, lip_h=lip_h, lip_w=lip_w,
                               seed=seed, with_sync=with_sync)
    for k in ("rgb_face_zero", "mask_head_canonical", "mask_face_canonical"):
        raw[k] = np.broadcast_to(raw[k][:1], raw[k].shape).copy()
    box = tf.expanded_lip_box(lip_h, lip_w, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window([raw["coord"][i] for i in range(b)], box,
                                 face, face, margin=MARGIN)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    batch["warped_base"] = grid_sample(batch["rgb_face_zero"], batch["coord"])
    m = grid_sample((batch["rgb_face_zero"] > 0).float(), batch["coord"])
    batch["blackaug_face_mask"] = (m == 1.0).float()
    params = weights.random_params(seed, device=dev)
    if face != params[0]["canonical_depth"].shape[0]:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params[0]["canonical_depth"] = 0.8 + 0.4 * torch.rand(
            face, face, device=dev, generator=gen)
    frozen = {"lpips": weights.random_lpips(seed + 1, device=dev),
              "depth_pts": trainer.depth_loss_points(
                  raw["mask_head_canonical"][0],
                  raw["mask_face_canonical"][0], raw["rgb_face_zero"][0],
                  device=dev)}
    if with_sync:
        frozen["syncnet"] = weights.random_syncnet(seed + 2, device=dev)
    return batch, geo, window, params, frozen


def statics(geo, window, face, dtype: str, **over):
    """The step's statics: the JAX tool's focal and face box scaled to
    ``face``, the K7 gathers on unless ``over`` says otherwise."""
    from speech2lip_tpu_torch.train import train_step as ts
    edge = face // 10
    kw = dict(lip_h=geo["lip_h"], lip_w=geo["lip_w"], lip_x=geo["lip_x"],
              lip_y=geo["lip_y"], face_h=face, face_w=face,
              focal=1200.0 * face / MAY[0], window=window,
              face_bbox=(edge, edge, face - edge, face - edge),
              compute_dtype=dtype, pallas_gather=True)
    kw.update(over)
    return ts.StepStatics(**kw)


def launch_counts():
    """(K2, K7 dsrc, K7 dgrid) launch counters."""
    from speech2lip_tpu_torch.ops.kernels import hat_sample as khs
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws
    return kws.launches, khs.dsrc_launches, khs.dgrid_launches


def timed(fn, dev, iters=None):
    """(ms per call of ``fn``, K2 / dsrc / dgrid launches per call) over
    ``iters`` (default ``ITERS``) calls after one warm-up call."""
    iters = iters or ITERS
    fn()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    before = launch_counts()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = 1e3 * (time.perf_counter() - t0) / iters
    after = launch_counts()
    launches = dict(zip(("window_sample", "hat_sample_dsrc",
                         "hat_sample_dgrid"),
                        ((a - b) / iters for a, b in zip(after, before))))
    return ms, launches


def step_runner(st, params, frozen, batch, dev, seed=SEED):
    """A closure running one train step a call, each from the state the
    last one left (as the JAX tool's timed loop steps)."""
    from speech2lip_tpu_torch.config import default_config
    from speech2lip_tpu_torch.train import train_step as ts
    opt = ts.make_optimizer(default_config())
    step = ts.make_train_step(opt, st, frozen)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = batch["audio"].shape[0]
    holder = {"state": ts.init_train_state(*params, opt)}

    def run():
        holder["state"], holder["metrics"] = step(
            holder["state"], batch, ts.draw_noise(st, b, device=dev,
                                                  generator=gen))
        return holder["metrics"]["loss"]
    run.holder = holder
    return run


def _oom(e: BaseException) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError) or (
        "out of memory" in str(e).lower())


def _row(rows, **r):
    rows.append(r)
    return r


def default_mode(dev, size, rows):
    face, lip_h, lip_w = size
    cases = [(False, 1, "stage1 b1"), (True, 1, "sync   b1"),
             (True, 4, "sync   b4")]
    for cd in ("float32", "bfloat16"):
        for sync_on, b, tag in cases:
            try:
                batch, geo, window, params, frozen = train_inputs(
                    dev, b, face, lip_h, lip_w, with_sync=sync_on)
                st = statics(geo, window, face, cd, sync_on=sync_on,
                             postnet_frozen=sync_on)
                run = step_runner(st, params, frozen, batch, dev)
                ms, n = timed(run, dev)
            except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
                if not _oom(e):
                    raise
                why = str(e).splitlines()[0][:90]
                print(f"{tag:9s} {cd:9s}: OOM ({why})", flush=True)
                _row(rows, mode="default", case=tag.replace("   ", " "),
                     dtype=cd, batch=b, error="OOM")
                torch.cuda.empty_cache()
                continue
            loss = float(run.holder["metrics"]["loss"])
            print(f"{tag:9s} {cd:9s}: {ms:7.1f} ms/step ({ms / b:7.1f} "
                  f"ms/frame); launches a step K2/dsrc/dgrid "
                  f"{n['window_sample']:g}/{n['hat_sample_dsrc']:g}/"
                  f"{n['hat_sample_dgrid']:g}; loss {loss:.5g}", flush=True)
            _row(rows, mode="default", case=tag.replace("   ", " "),
                 dtype=cd, batch=b, ms_per_step=ms, ms_per_frame=ms / b,
                 launches=n, loss=loss)
            del batch, params, frozen, run


def batch_scaling(dev, size, rows, batches=(1, 2, 4, 8)):
    """Batch amortization in bfloat16: whole step, U-Net f+b, lip MLP f+b
    (ensemble), lip-losses-only step, ms a frame each."""
    from speech2lip_tpu_torch.config import default_config
    from speech2lip_tpu_torch.models import unet_light
    from speech2lip_tpu_torch.train import train_step as ts

    face, lip_h, lip_w = size
    bf = torch.bfloat16
    cast = lambda t: ts.tree_map(
        lambda x: x.to(bf) if x.dtype == torch.float32 else x, t)
    for b in batches:
        batch, geo, window, params, frozen = train_inputs(
            dev, b, face, lip_h, lip_w)
        st = statics(geo, window, face, "bfloat16")
        full_ms, n = timed(step_runner(st, params, frozen, batch, dev), dev)

        # the lip MLP with its ensemble, forward + backward, on the lip
        # photometric loss alone
        st_lip = dataclasses.replace(st, use_canonical_depth_loss=False,
                                     use_perceptual=False)
        p_c = cast(params[0])
        leaves = [t.requires_grad_(True) for t in ts.tree_leaves(p_c)]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        aud, rgb = batch["audio"].to(bf), batch["rgb"].to(bf)

        def lip_grad():
            out = ts.render_lip_ensemble(
                p_c, aud, batch["index"].float(),
                ts.draw_noise(st_lip, b, device=dev, generator=gen)["lip"],
                st_lip)
            return torch.autograd.grad(((out - rgb) ** 2).mean(), leaves,
                                       allow_unused=True)
        lip_ms, _ = timed(lip_grad, dev)

        # the U-Net alone at the face size, train mode, forward + backward
        up, us = cast(params[1]), cast(params[2])
        ul = [t.requires_grad_(True) for t in ts.tree_leaves(up)]
        x = batch["rgb_face_ori"].to(bf)

        def unet_grad():
            y, _ = unet_light.apply(up, us, x, train=True)
            return torch.autograd.grad(((y - x) ** 2).mean(), ul)
        unet_ms, _ = timed(unet_grad, dev)

        # the lip-losses-only step: the post-fusion path, the U-Net and the
        # depth loss ablated; the lip MLP's gradients and its Adam update
        opt = ts.make_optimizer(default_config())
        opt_state = opt.init(leaves)

        def lip_step():
            grads = [torch.zeros_like(t) if g is None else g
                     for g, t in zip(lip_grad(), leaves)]
            updates, _ = opt.update(grads, opt_state)
            return torch._foreach_add(leaves, updates)
        lo_ms, _ = timed(lip_step, dev)
        print(f"batch {b}: full {full_ms / b:6.1f} ms/frame (step "
              f"{full_ms:6.1f}) | unet f+b {unet_ms / b:6.1f} ms/frame | "
              f"lip-mlp f+b {lip_ms / b:6.1f} ms/frame | lip-only step "
              f"{lo_ms / b:6.1f} ms/frame", flush=True)
        _row(rows, mode="batch_scaling", batch=b, dtype="bfloat16",
             full_ms_per_step=full_ms, full_ms_per_frame=full_ms / b,
             unet_ms_per_frame=unet_ms / b, lip_mlp_ms_per_frame=lip_ms / b,
             lip_only_ms_per_frame=lo_ms / b, launches=n)
        del batch, params, frozen


ABLATIONS = [
    ("full", {"pallas_gather": False}, "in-step"),
    ("full+hostwarp", {"pallas_gather": False}, "host"),
    ("full+hw+dcrop", {"pallas_gather": False, "depth_loss_box": "auto"},
     "host"),
    ("full+hw+pallas", {}, "host"),
    ("full+hw+pts", {"_depth_pts": True}, "host"),
    ("no-blackaug", {"pallas_gather": False, "use_blackaug": False},
     "in-step"),
    ("no-depthloss", {"pallas_gather": False,
                      "use_canonical_depth_loss": False}, "in-step"),
    ("no-perceptual", {"pallas_gather": False, "use_perceptual": False},
     "in-step"),
    ("no-ensemble", {"pallas_gather": False, "ensemble": False}, "in-step"),
    ("photo-only", {"pallas_gather": False, "use_blackaug": False,
                    "use_canonical_depth_loss": False,
                    "use_perceptual": False}, "in-step"),
]


def ring_points(face, rgb_face_zero, dev):
    """``frozen['depth_pts']`` on a disk ring of May-like support (~30% of
    the frame): the cost depends on the point count only."""
    yy, xx = np.mgrid[0:face, 0:face]
    r2 = (yy - face // 2) ** 2 + (xx - face // 2) ** 2
    ring = (r2 < int(face * 0.46) ** 2) & (r2 > int(face * 0.34) ** 2)
    ys, xs = np.nonzero(ring)
    put = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    return {"xs": put(xs, torch.int64), "ys": put(ys, torch.int64),
            "w": torch.ones((ys.size, 3), device=dev),
            "rgb_zero_pts": put(np.asarray(rgb_face_zero)[ys, xs],
                                torch.float32)}


def ablate(dev, size, rows, batches=(1, 8)):
    """The step's time a loss-term variant at batches 1 and 8, bfloat16."""
    from speech2lip_tpu_torch.ops.grid_sample import grid_sample_np
    from speech2lip_tpu_torch.train import trainer

    face, lip_h, lip_w = size
    for b in batches:
        batch, geo, window, params, frozen = train_inputs(
            dev, b, face, lip_h, lip_w)
        host = {k: v.cpu().numpy() for k, v in batch.items()}
        fz, coord = host["rgb_face_zero"], host["coord"]
        hw = dict(batch,
                  warped_base=torch.from_numpy(grid_sample_np(
                      fz, coord)).to(dev),
                  blackaug_face_mask=torch.from_numpy((grid_sample_np(
                      (fz > 0).astype(fz.dtype), coord) == 1.0).astype(
                          fz.dtype)).to(dev))
        in_step = {k: v for k, v in batch.items()
                   if k not in ("warped_base", "blackaug_face_mask")}
        dbox = trainer.depth_loss_box(host["mask_head_canonical"][0],
                                      host["mask_face_canonical"][0])
        print(f"# depth-loss crop: {dbox}" + (
            " (its box holds more than 16384 pixels: +dcrop skipped)"
            if dbox is None else ""), flush=True)
        pts = ring_points(face, fz[0], dev)
        print(f"# depth-pts bundle: S={pts['xs'].numel()} "
              f"({100.0 * pts['xs'].numel() / face ** 2:.1f}% of {face}^2)",
              flush=True)
        no_pts = {k: v for k, v in frozen.items() if k != "depth_pts"}
        for name, over, warp in ABLATIONS:
            over = dict(over)
            use_pts = over.pop("_depth_pts", False)
            if over.get("depth_loss_box") == "auto":
                if dbox is None:
                    continue
                over["depth_loss_box"] = dbox
            st = statics(geo, window, face, "bfloat16", **over)
            fz_nets = dict(no_pts, depth_pts=pts) if use_pts else no_pts
            ms, n = timed(step_runner(st, params, fz_nets,
                                      hw if warp == "host" else in_step,
                                      dev), dev)
            print(f"batch {b} {name:14s}: {ms:7.1f} ms/step "
                  f"({ms / b:6.1f} ms/frame)", flush=True)
            _row(rows, mode="ablate", case=name, batch=b, dtype="bfloat16",
                 ms_per_step=ms, ms_per_frame=ms / b, launches=n)
        del batch, params, frozen, hw, in_step


def main(argv=None, size=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--batch-scaling", action="store_true")
    mode.add_argument("--ablate", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)

    from speech2lip_tpu_torch.infer.renderer import resolve_device
    dev = resolve_device(args.device)
    size = tuple(size or MAY)
    rows = []
    print(f"# {size[0]}^2 face, {size[2]}x{size[1]} lip, {dev}", flush=True)
    if args.batch_scaling:
        batch_scaling(dev, size, rows)
    elif args.ablate:
        ablate(dev, size, rows)
    else:
        default_mode(dev, size, rows)
    return rows


if __name__ == "__main__":
    main()
