"""Time K7's backward kernels (``hat_sample_dsrc``, ``hat_sample_dgrid``)
beside aten's ``grid_sampler_2d_backward`` at May geometry on the card.

    python -m speech2lip_tpu_torch.tools.bench_hat_sample

May geometry: a seeded bfloat16 500x500x3 source, batch 8, and the train
step's two gathers on the synthetic batch (``cases``, which
``chip_smoke.py`` checks and times too):

- ``dsrc`` on ``train``: the blackaug window gather as the train step
  hands it to dsrc: the warp window of ``compute_warp_window(margin=16)``
  as the view of the coord grid the composite passes (the synthetic
  batch's coord holds the batch innermost: points 2B floats apart), and a
  seeded normal cotangent zeroed off the warped lip box, where the
  composite's mask drops the sample;
- ``dsrc`` on ``window``: the same points as a contiguous [B, P, 2] copy
  with the cotangent nonzero on every point;
- ``dgrid`` on ``points``: the depth-loss points, the support of the
  head-minus-face ring of the canonical masks warped through a seeded
  depth and the batch's poses, border-clamped.

Library: ``torch.ops.aten.grid_sampler_2d_backward`` on float32 NCHW
copies of the source and the cotangent, the grid renormalised to the
source (one dtype for all; made outside the timed call), computing only
the cotangent the kernel computes.

Each gets the two times of ``bench_window_sample``, by CUDA events: the
call time (eager calls, the host's dispatch included) and the device time
(a CUDA graph of calls, replayed), in turns kernel, library, library,
kernel, each the mean of its two turns, plus the kernels' time in a
profile.  Prints one line per case and a JSON line with every number.
Runs on the card only.  The package it times is the first
``speech2lip_tpu_torch`` on the path, named in the JSON, so one call can
time two trees in turns (``PYTHONPATH=<tree> python <this file>``); a
tree whose K7 takes no grid view is given a contiguous copy of it, made
outside the timed call, and the JSON says so.
"""

from __future__ import annotations

import json

import torch

FACE, LIP_H, LIP_W, MARGIN, BATCH, SEED = 500, 80, 120, 16, 8, 0


def cases(dev, dtype=torch.bfloat16) -> dict:
    """{name: (src, grid, cotangent, (y_off, x_off, height, width))}: the
    ``train``, ``window`` and ``points`` cases above, on one full-frame
    source, and ``integer``, a grid exactly on pixel centres (the source
    a 500x500 crop of a 512x512 image, where the normalised coordinates
    of integers are exact)."""
    from speech2lip_tpu_torch.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch.data.windows import compute_warp_window
    from speech2lip_tpu_torch.models import talking_face as tf
    from speech2lip_tpu_torch.ops import geometry
    from speech2lip_tpu_torch.ops.grid_sample import warp_box_mask
    from speech2lip_tpu_torch.ops.kernels.hat_sample import border_clamp
    from speech2lip_tpu_torch.train import trainer

    raw, geo = synthetic_batch(BATCH, face=FACE, lip_h=LIP_H, lip_w=LIP_W,
                               seed=SEED)
    box = tf.expanded_lip_box(LIP_H, LIP_W, geo["lip_x"], geo["lip_y"])
    wy0, wx0, wh, ww = compute_warp_window(
        [raw["coord"][i] for i in range(BATCH)], box, FACE, FACE,
        margin=MARGIN)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    view = batch["coord"][:, wy0:wy0 + wh, wx0:wx0 + ww]
    pts = trainer.depth_loss_points(
        raw["mask_head_canonical"][0], raw["mask_face_canonical"][0],
        raw["rgb_face_zero"][0], device=dev)
    depth = 0.8 + 0.4 * torch.rand(FACE, FACE, device=dev, generator=gen)
    k = torch.from_numpy(geometry.intrinsics(geo["focal"], FACE,
                                             FACE)).to(dev)
    rel = geometry.rel_pose_obs2can(
        batch["canonical_euler"], batch["canonical_trans"], batch["euler"],
        batch["trans"])
    ring = geometry.warp_grid_points(
        depth.reshape(-1)[pts["ys"] * FACE + pts["xs"]], pts["xs"],
        pts["ys"], rel, k, torch.linalg.inv(k), FACE, FACE)
    ring = border_clamp(ring, FACE, FACE, 0, 0, FACE, FACE).contiguous()
    src = torch.rand(BATCH, FACE, FACE, 3, device=dev,
                     generator=gen).to(dtype)
    cols = torch.randint(1, FACE - 1, (BATCH, 2, 40000), device=dev,
                         generator=gen)
    on_px = ((2.0 * cols.float() + 1.0) / 512 - 1.0).transpose(1, 2)
    cot = lambda p: torch.randn(BATCH, p, 3, device=dev,
                                generator=gen).to(dtype)
    full = (0, 0, FACE, FACE)
    window = cot(wh * ww)
    in_box = warp_box_mask(view, box, FACE, FACE).reshape(BATCH, -1, 1)
    return {"train": (src, view, window * in_box.to(dtype), full),
            "window": (src, view.reshape(BATCH, -1, 2).contiguous(), window,
                       full),
            "points": (src, ring, cot(ring.shape[1]), full),
            "integer": (src, on_px.contiguous(), cot(40000),
                        (0, 0, 512, 512))}


def run(dtype=torch.bfloat16) -> dict:
    import speech2lip_tpu_torch
    from speech2lip_tpu_torch.ops.kernels import hat_sample as khs
    from speech2lip_tpu_torch.tools.bench_window_sample import (crop_grid,
                                                                in_turns)

    if not torch.cuda.is_available():
        raise RuntimeError("bench_hat_sample: no CUDA device")
    x = cases(torch.device("cuda"), dtype)
    src = x["train"][0]
    src32 = src.float().permute(0, 3, 1, 2).contiguous()
    backward = torch.ops.aten.grid_sampler_2d_backward
    result = {"package": speech2lip_tpu_torch.__file__,
              "device": torch.cuda.get_device_name(0),
              "dtype": str(dtype).split(".")[1], "source": list(src.shape)}
    for kern, case, mask in (("dsrc", "train", [True, False]),
                             ("dsrc", "window", [True, False]),
                             ("dgrid", "points", [False, True])):
        _, grid, cot, geom = x[case]
        if kern == "dsrc":
            fn = lambda: khs.hat_sample_dsrc(grid, cot, FACE, FACE, *geom)
        else:
            fn = lambda: khs.hat_sample_dgrid(src, grid, cot, *geom)
        copied = False
        try:
            got = fn()
        except ValueError:
            grid, copied = grid.reshape(BATCH, -1, 2).contiguous(), True
            got = fn()
        if kern == "dsrc":
            ref = khs.hat_sample_dsrc_plain(grid, cot, FACE, FACE, *geom)
        else:
            ref = khs.hat_sample_dgrid_plain(src, grid, cot, *geom)
        g4 = crop_grid(grid.reshape(BATCH, -1, 2), *geom, FACE, FACE)
        cot32 = cot.float().transpose(1, 2)[:, :, None].contiguous()
        lib = lambda: backward(cot32, src32, g4, 0, 0, False, mask)
        times = in_turns({"kernel": fn, "library": lib})
        result[f"{kern} {case}"] = {
            "grid": list(grid.shape), "grid_strides": list(grid.stride()),
            "grid_copied": copied,
            "live_points": int((cot != 0).any(-1).sum()),
            "max_abs_err_vs_plain": float((got.float() - ref.float()).abs()
                                          .max()),
            "times": times}
        for name, t in times.items():
            prof = ("not in the trace" if t["profiled_ms"] is None
                    else f"{t['profiled_ms']:.4f} ms")
            print(f"# {kern} {case} {name}: call {t['call_ms']:.4f} ms, "
                  f"device (graph) {t['device_ms']:.4f} ms, kernels in the "
                  f"profile {prof}", flush=True)
    return result


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
