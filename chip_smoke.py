"""Smoke run of the PyTorch/CUDA port (speech2lip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, at first use), checks each
against its plain PyTorch version at May shapes (500x500 face, 120x80 lip)
in float32 and bfloat16, then drives the port's two paths on random
parameters made from a seed:

- serving: three batches of 8 frames through the Renderer in bfloat16
  (K1 fused_mlp, K2 window_sample, K3 fused_block), one batch against the
  plain path;
- training: three bfloat16 stage-1 steps at batch 8 with the K7 gathers on
  (K2 forward, K7 hat_sample_dsrc / hat_sample_dgrid backward), one step
  against the plain path, a float32 step on a small input, and one
  sync-stage step (SyncNet loss, frozen U-Net) at batch 2;

checks that the kernels carried each path (launch counts), and times the
kernels and both paths with CUDA events.  Needs one CUDA device; without
one it exits non-zero before printing any result.

The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel's launches on the main path, error and times.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

FACE, LIP_H, LIP_W, MARGIN = 500, 80, 120, 16
SEED = 0
# kernel vs plain bounds on max|diff|, times max(1, max|plain|): float32 sums
# in another order (3xTF32 products in K1/K3), bfloat16 rounds at other
# places (a few bf16 ulps of the outputs at most)
BOUND = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
K2_BOUND = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # one rounding apart
SLICE_BF16_BOUND = 1e-2  # kernel path vs plain path, face and lip
# K7 vs plain: dsrc's float32 atomics add in another order (bf16 then
# rounds once, one ulp apart at most); dgrid sums the same inputs in float32
K7_BOUND = {"dsrc": {torch.float32: 1e-5, torch.bfloat16: 1e-2},
            "dgrid": {torch.float32: 1e-5, torch.bfloat16: 1e-5}}
# train step, kernel path vs plain path, relative to the largest plain
# magnitude: float32 sums in another order; in bfloat16 a K2/dsrc output
# one ulp (2^-8) apart flips roundings that the bf16 U-Net carries on
TRAIN_BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TRAIN_B, SYNC_B = 8, 2


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def check(name: str, pairs, bound: float) -> float:
    """Max |kernel - plain| over (kernel, plain) output pairs; fails when it
    exceeds bound * max(1, max|plain|).  Returns the absolute error."""
    worst = 0.0
    for got, ref in pairs:
        got, ref = got.float(), ref.float()
        require(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                f"{name}: output {tuple(got.shape)} vs {tuple(ref.shape)} "
                "or non-finite")
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        log(f"# check {name}: max|diff| {err:.3g}, bound {bound} x {scale:.3g}")
        require(err <= bound * scale, f"{name} disagrees with its plain "
                "version")
        worst = max(worst, err)
    return worst


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def named_leaves(tree, prefix=""):
    """[(dotted name, tensor)] in ``train_step.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


# kernel-name fragments of the train step's device time, by layer: the
# port's kernels, cuDNN convolutions, matmuls (lip MLP, 1x1 convs, LPIPS
# heads) and everything else (BatchNorm, activations, losses, Adam, glue)
PROFILE_GROUPS = (
    ("K2/K7 (port kernels)", ("hat_dsrc", "hat_dgrid", "window_sample")),
    ("convolutions", ("conv", "implicit", "fprop", "dgrad", "wgrad",
                      "cudnn", "winograd")),
    ("matmuls", ("gemm", "nvjet", "cutlass", "cublas")),
)


def profile_train_step(run, what: str, step_ms: float,
                       steps: int = 2) -> float:
    """Device time of ``steps`` calls of ``run`` by kernel group and the
    busiest kernels (torch.profiler), against ``step_ms`` of CUDA-event
    wall time per step measured without the profiler.  Returns the device
    ms per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    per_kernel, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        per_kernel[e.key] = t / 1000.0 / steps        # ms per step
        launches += e.count
    total = sum(per_kernel.values())
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other (elementwise, reductions, glue)"] = 0.0
    for key, ms in per_kernel.items():
        low = key.lower()
        for name, frags in PROFILE_GROUPS:
            if any(f in low for f in frags):
                groups[name] += ms
                break
        else:
            groups["other (elementwise, reductions, glue)"] += ms
    log(f"# profile {what}: device time {total:.2f} ms per step over "
        f"{launches // steps} kernel launches, against {step_ms:.2f} ms "
        f"wall: busy {100 * total / step_ms:.1f}%")
    for name, ms in groups.items():
        log(f"# profile   {name}: {ms:.2f} ms ({100 * ms / total:.1f}%)")
    for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        log(f"# profile   top {ms:.3f} ms {key[:110]}")
    return total


def train_inputs(dev, b, face, lip_h, lip_w, with_sync=False):
    """A synthetic training batch on ``dev`` as the trainer hands it to the
    step: the canonical face and masks are per-identity constants (one
    frame's, broadcast), the blackaug branch's static warps are made from
    them, the warp window is validated; plus seeded parameters and frozen
    nets.  Returns (batch, geo, window, params, frozen)."""
    import numpy as np

    from speech2lip_tpu.data.synthetic import synthetic_batch
    from speech2lip_tpu.data.windows import compute_warp_window
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.models import talking_face as tf
    from speech2lip_tpu_torch.ops.grid_sample import grid_sample
    from speech2lip_tpu_torch.train import trainer

    raw, geo = synthetic_batch(b, face=face, lip_h=lip_h, lip_w=lip_w,
                               seed=SEED, with_sync=with_sync)
    for k in ("rgb_face_zero", "mask_head_canonical", "mask_face_canonical"):
        raw[k] = np.broadcast_to(raw[k][:1], raw[k].shape).copy()
    box = tf.expanded_lip_box(lip_h, lip_w, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window([raw["coord"][i] for i in range(b)], box,
                                 face, face, margin=MARGIN)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    batch["warped_base"] = grid_sample(batch["rgb_face_zero"], batch["coord"])
    m = grid_sample((batch["rgb_face_zero"] > 0).float(), batch["coord"])
    batch["blackaug_face_mask"] = (m == 1.0).float()
    params = weights.random_params(SEED, device=dev)
    if face != params[0]["canonical_depth"].shape[0]:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params[0]["canonical_depth"] = 0.8 + 0.4 * torch.rand(
            face, face, device=dev, generator=gen)
    frozen = {"lpips": weights.random_lpips(SEED + 1, device=dev),
              "depth_pts": trainer.depth_loss_points(
                  raw["mask_head_canonical"][0],
                  raw["mask_face_canonical"][0], raw["rgb_face_zero"][0],
                  device=dev)}
    if with_sync:
        frozen["syncnet"] = weights.random_syncnet(SEED + 2, device=dev)
    return batch, geo, window, params, frozen


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke runs "
                         "only on a GPU")
    from speech2lip_tpu.data.synthetic import synthetic_batch
    from speech2lip_tpu.data.windows import compute_warp_window
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.config import default_config
    from speech2lip_tpu_torch.infer.renderer import Renderer, render_face_batch
    from speech2lip_tpu_torch.models import talking_face as tf
    from speech2lip_tpu_torch.models import unet_light
    from speech2lip_tpu_torch.ops import nn as tnn
    from speech2lip_tpu_torch.ops.coords import get_coords
    from speech2lip_tpu_torch.ops.embedders import fourier_embed
    from speech2lip_tpu_torch.ops.kernels import _build
    from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
    from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
    from speech2lip_tpu_torch.ops.kernels import hat_sample as khs
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws
    from speech2lip_tpu_torch.ops.kernels.conv_block import fold_bn
    from speech2lip_tpu_torch.ops import geometry
    from speech2lip_tpu_torch.train import train_step as ts
    from speech2lip_tpu_torch.train import trainer

    dev = torch.device("cuda")
    # plain versions in full float32 (no TF32 in cuBLAS or cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"# card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"# build: {time.perf_counter() - t0:.1f} s (kernels in "
        f"{_build.BUILD_DIR})")

    # -- May-geometry inputs ----------------------------------------------
    raw, geo = synthetic_batch(8, face=FACE, lip_h=LIP_H, lip_w=LIP_W,
                               seed=SEED)
    box = tf.expanded_lip_box(LIP_H, LIP_W, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window([raw["coord"][i] for i in range(8)], box,
                                 FACE, FACE, margin=MARGIN)
    log(f"# geometry: face {FACE}, lip {LIP_H}x{LIP_W} at "
        f"({geo['lip_y']}, {geo['lip_x']}), box {box}, window {window}")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def k1_args(dtype, frames=8):
        tp, _, _ = weights.random_params(SEED, device=dev, dtype=dtype)
        uv = fourier_embed(get_coords(LIP_W, LIP_H, dtype=dtype, device=dev),
                           10).contiguous()
        base = torch.randn(frames, 256, device=dev, generator=gen)
        skip = torch.randn(frames, 256, device=dev, generator=gen)
        trunk = tp["trunk"]
        return (uv, (tp["fc_uv"]["b"].float() + base).contiguous(),
                (tp["fc_uv_skip"]["b"].float() + skip).contiguous(),
                tp["fc_uv"]["w"], tp["fc_uv_skip"]["w"],
                [l["w"] for l in trunk], [l["b"].float() for l in trunk],
                tp["output"]["w"], tp["output"]["b"].float())

    x0b, x1b, y0b, y1b = box
    wy0, wx0, wh, ww = window

    def k2_args(dtype):
        src = torch.rand(8, y1b - y0b + 2, x1b - x0b + 2, 3, device=dev,
                         generator=gen).to(dtype)
        grid = batch["coord"][:, wy0:wy0 + wh, wx0:wx0 + ww].reshape(
            8, wh * ww, 2).contiguous()
        return (src, grid, y0b - 1, x0b - 1, FACE, FACE)

    def k3_cases(dtype, b=8):
        _, up, us = weights.random_params(SEED, device=dev, dtype=dtype)
        cases = []
        for name, hw, cx, cl, pool in (("inc", 500, 3, 0, True),
                                       ("down1", 250, 64, 0, True),
                                       ("down2", 125, 128, 0, False),
                                       ("up1", 250, 128, 128, False),
                                       ("up2", 500, 64, 64, False)):
            p, s = up[name], us[name]
            s1, b1 = fold_bn(p["bn1"], s["bn1"])
            s2, b2 = fold_bn(p["bn2"], s["bn2"])
            x = torch.rand(b, hw, hw, cx, device=dev, generator=gen).to(dtype)
            lo = (torch.rand(b, hw // 2, hw // 2, cl, device=dev,
                             generator=gen).to(dtype) if cl else None)
            cases.append((name, (x, p["conv1"]["w"], s1.float(), b1.float(),
                                 p["conv2"]["w"], s2.float(), b2.float()),
                          dict(up=lo, pool=pool)))
        return cases

    def k7_cases(dtype):
        """(name, src, grid, cotangent, (y_off, x_off, H, W)) of K7 at the
        main path's shapes: the blackaug window gather (full-frame source,
        the warp window's points), the depth-loss points (the head-minus-
        face ring's S support points, border-clamped) and a grid exactly
        on pixel centres (a 500x500 crop of a 512x512 image, where the
        normalised coordinates of integers are exact)."""
        b = 8
        src = torch.rand(b, FACE, FACE, 3, device=dev, generator=gen).to(dtype)
        win = batch["coord"][:, wy0:wy0 + wh, wx0:wx0 + ww].reshape(
            b, wh * ww, 2).contiguous()
        pts = trainer.depth_loss_points(
            raw["mask_head_canonical"][0], raw["mask_face_canonical"][0],
            raw["rgb_face_zero"][0], device=dev)
        depth = 0.8 + 0.4 * torch.rand(FACE, FACE, device=dev, generator=gen)
        k = torch.from_numpy(geometry.intrinsics(geo["focal"], FACE,
                                                 FACE)).to(dev)
        rel = geometry.rel_pose_obs2can(
            batch["canonical_euler"], batch["canonical_trans"],
            batch["euler"], batch["trans"])
        ring = geometry.warp_grid_points(
            depth.reshape(-1)[pts["ys"] * FACE + pts["xs"]], pts["xs"],
            pts["ys"], rel, k, torch.linalg.inv(k), FACE, FACE)
        ring = khs.border_clamp(ring, FACE, FACE, 0, 0, FACE,
                                FACE).contiguous()
        cols = torch.randint(1, FACE - 1, (b, 2, 40000), device=dev,
                             generator=gen)
        on_px = ((2.0 * cols.float() + 1.0) / 512 - 1.0).transpose(1, 2)
        out = []
        for name, grid, g_geo in (
                (f"window P={wh * ww}", win, (0, 0, FACE, FACE)),
                (f"points S={ring.shape[1]}", ring, (0, 0, FACE, FACE)),
                ("integer grid P=40000", on_px.contiguous(),
                 (0, 0, 512, 512))):
            cot = torch.randn(b, grid.shape[1], 3, device=dev,
                              generator=gen).to(dtype)
            out.append((name, src, grid, cot, g_geo))
        return out

    # -- phase 2: each kernel against its plain version --------------------
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        a = k1_args(dtype)
        errs[("fused_mlp", dtype)] = check(
            f"K1 fused_mlp {dn} B=8 N={LIP_H * LIP_W}",
            [(kmlp.fused_mlp(*a), kmlp.fused_mlp_plain(*a))], BOUND[dtype])

        a = k2_args(dtype)
        errs[("window_sample", dtype)] = check(
            f"K2 window_sample {dn} crop {tuple(a[0].shape[1:3])} "
            f"P={a[1].shape[1]}",
            [(kws.window_sample(*a), kws.window_sample_plain(*a))],
            K2_BOUND[dtype])

        worst = 0.0
        for name, args, kw in k3_cases(dtype):
            got = kfb.fused_block(*args, **kw)
            ref = kfb.fused_block_plain(*args, **kw)
            pairs = zip(got, ref) if kw["pool"] else [(got, ref)]
            worst = max(worst, check(
                f"K3 fused_block {dn} {name} {tuple(args[0].shape)}", pairs,
                BOUND[dtype]))
        errs[("fused_block", dtype)] = worst

        # K1b: one frame (render_pixels), the 4-offset ensemble in the rows
        a = k1_args(dtype, frames=1)
        a = (fourier_embed(torch.rand(4 * LIP_H * LIP_W, 2, device=dev,
                                      generator=gen), 10).to(dtype),) + a[1:]
        errs[("fused_mlp_one_frame", dtype)] = check(
            f"K1b fused_mlp {dn} one frame N={4 * LIP_H * LIP_W}",
            [(kmlp.fused_mlp(*a), kmlp.fused_mlp_plain(*a))], BOUND[dtype])

        for kern in ("dsrc", "dgrid"):
            errs[(f"hat_sample_{kern}", dtype)] = 0.0
        for name, src, grid, cot, g_geo in k7_cases(dtype):
            hs, ws = src.shape[1:3]
            e = check(f"K7 hat_sample_dsrc {dn} {name}",
                      [(khs.hat_sample_dsrc(grid, cot, hs, ws, *g_geo),
                        khs.hat_sample_dsrc_plain(grid, cot, hs, ws, *g_geo))],
                      K7_BOUND["dsrc"][dtype])
            errs[("hat_sample_dsrc", dtype)] = max(
                errs[("hat_sample_dsrc", dtype)], e)
            dg = khs.hat_sample_dgrid(src, grid, cot, *g_geo)
            e = check(f"K7 hat_sample_dgrid {dn} {name}",
                      [(dg, khs.hat_sample_dgrid_plain(src, grid, cot,
                                                       *g_geo))],
                      K7_BOUND["dgrid"][dtype])
            errs[("hat_sample_dgrid", dtype)] = max(
                errs[("hat_sample_dgrid", dtype)], e)
            if name.startswith("integer"):
                require(bool((dg == 0).all()), "K7 dgrid on pixel centres "
                        "must be 0 (hat'(u) = -sign(u) on |u| < 1)")

    # -- phase 3: the main path, three batches through the Renderer --------
    cfg = default_config()
    cfg["model"]["compute_dtype"] = "bfloat16"
    params = weights.random_params(SEED)
    renderer = Renderer(cfg, *params, device=dev, window=window)
    for mod in (kmlp, kws, kfb):
        mod.launches = 0
    outs = []
    for i in range(3):
        out = renderer(batch, geo["lip_x"], geo["lip_y"])
        torch.cuda.synchronize()
        outs.append(out)
        counts = (kmlp.launches, kws.launches, kfb.launches)
        log(f"# render batch {i}: face {tuple(out['face'].shape)} lip "
            f"{tuple(out['lip'].shape)}; launches K1/K2/K3 so far {counts}")
        require(counts == (i + 1, i + 1, 5 * (i + 1)),
                f"kernel launches K1/K2/K3 {counts} after {i + 1} batches")
    launches = {"fused_mlp": kmlp.launches, "window_sample": kws.launches,
                "fused_block": kfb.launches}
    for out in outs:
        for key, shape in (("face", (8, FACE, FACE, 3)),
                           ("lip", (8, LIP_H, LIP_W, 3))):
            require(out[key].shape == shape
                    and bool(torch.isfinite(out[key]).all()),
                    f"{key} {tuple(out[key].shape)} not finite {shape}")
    plain = render_face_batch(
        *renderer.params, batch, lip_x=geo["lip_x"], lip_y=geo["lip_y"],
        lip_h=LIP_H, lip_w=LIP_W, use_kernels=False,
        compute_dtype=torch.bfloat16, window=window)
    for key in ("face", "lip"):
        e = float((outs[0][key] - plain[key]).abs().max())
        log(f"# slice bf16 kernels vs plain path: {key} max|diff| {e:.3g} "
            f"(bound {SLICE_BF16_BOUND})")
        require(e <= SLICE_BF16_BOUND,
                f"slice {key} disagrees with the plain path")

    # the slice in float32 on a small input, kernels vs plain path
    small, sgeo = synthetic_batch(2, face=64, lip_h=16, lip_w=24, seed=SEED)
    small = {k: torch.from_numpy(v).to(dev) for k, v in small.items()}
    p32 = weights.random_params(SEED, device=dev)
    kw = dict(lip_x=sgeo["lip_x"], lip_y=sgeo["lip_y"], lip_h=16, lip_w=24)
    got = render_face_batch(*p32, small, use_kernels=True, **kw)
    ref = render_face_batch(*p32, small, use_kernels=False, **kw)
    e = max(float((got[k] - ref[k]).abs().max()) for k in ("face", "lip"))
    log(f"# slice f32 face 64 kernels vs plain path: max|diff| {e:.3g} "
        f"(bound 1e-4)")
    require(e <= 1e-4, "float32 slice disagrees with the plain path")

    # -- phase 3b: K1b's own path, one frame's pixels ----------------------
    tp_bf = weights.random_params(SEED, device=dev, dtype=torch.bfloat16)[0]
    ens = torch.rand(4, LIP_H * LIP_W, 2, device=dev, generator=gen)
    code = torch.randn(1, 64, device=dev, generator=gen).to(torch.bfloat16)
    kmlp.launches = 0
    px = tf.render_pixels(tp_bf, ens, code, 7.0, use_kernels=True)
    torch.cuda.synchronize()
    launches["fused_mlp_one_frame"] = kmlp.launches
    require(kmlp.launches == 1 and px.shape == (4, LIP_H * LIP_W, 3)
            and bool(torch.isfinite(px).all()),
            f"render_pixels: K1 launches {kmlp.launches}, {tuple(px.shape)}")
    log(f"# render_pixels bf16 4x{LIP_H * LIP_W} pixels: K1 launches 1")

    # -- phase 5: the training path ----------------------------------------
    tbatch, tgeo, twin, tparams, tfrozen = train_inputs(
        dev, TRAIN_B, FACE, LIP_H, LIP_W)
    tcfg = dict(default_config()["training"], compute_dtype="bfloat16",
                batch_size=TRAIN_B)
    st = ts.StepStatics(
        lip_h=LIP_H, lip_w=LIP_W, lip_x=tgeo["lip_x"], lip_y=tgeo["lip_y"],
        face_h=FACE, face_w=FACE, focal=tgeo["focal"], window=twin,
        face_bbox=(0, 0, FACE, FACE), compute_dtype="bfloat16",
        depth_loss_box=trainer.depth_loss_box(
            tbatch["mask_head_canonical"][0].cpu().numpy(),
            tbatch["mask_face_canonical"][0].cpu().numpy()),
        pallas_gather=trainer.resolve_pallas_gather(tcfg, dev))
    require(st.pallas_gather and st.depth_loss_box is None
            and twin is not None,
            "the bf16 batch-8 step must take the K7 gathers, the points "
            "path and the warp window")
    opt = ts.make_optimizer(default_config())
    step = ts.make_train_step(opt, st, tfrozen)
    state = ts.init_train_state(*tparams, opt)
    tgen = torch.Generator(device=dev).manual_seed(SEED)
    count = lambda: (kws.launches, khs.dsrc_launches, khs.dgrid_launches,
                     kmlp.launches, kfb.launches)
    # per stage-1 step: K2 twice (the window gather and the depth-loss
    # points, forward), dsrc once (the window gather's source is rendered,
    # its grid is data), dgrid once (the points' grid follows the learned
    # depth, their source is data); K1 and K3 serve inference only
    for mod in (kmlp, kws, kfb):
        mod.launches = 0
    khs.dsrc_launches = khs.dgrid_launches = 0
    for i in range(3):
        draws = ts.draw_noise(st, TRAIN_B, device=dev, generator=tgen)
        state, metrics = step(state, tbatch, draws)
        torch.cuda.synchronize()
        got = count()
        log(f"# train step {i} bf16 B={TRAIN_B}: " + ", ".join(
            f"{k} {float(v):.5g}" for k, v in sorted(metrics.items()))
            + f"; launches K2/dsrc/dgrid/K1/K3 so far {got}")
        require(got == (2 * (i + 1), i + 1, i + 1, 0, 0),
                f"train launches K2/dsrc/dgrid/K1/K3 {got} after {i + 1} "
                "steps")
        require(all(bool(torch.isfinite(v)) for v in metrics.values()),
                "non-finite train metrics")
    launches["hat_sample_dsrc"] = khs.dsrc_launches
    launches["hat_sample_dgrid"] = khs.dgrid_launches
    for _, t in named_leaves({"p": state.params, "u": state.unet_params,
                              "s": state.unet_state}):
        require(bool(torch.isfinite(t).all()), "non-finite train state")

    def compare_paths(st_k, params, frozen, batch, bound, what):
        """One step's losses, grad_norm and the canonical-depth and trunk
        gradients, kernel path against plain path."""
        draws = ts.draw_noise(st_k, batch["audio"].shape[0], device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(SEED + 3))
        out = {}
        for use in (True, False):
            g, m, _, tr = ts.loss_and_grads(
                *params, frozen, batch, draws,
                dataclasses.replace(st_k, use_kernels=use))
            names = [n for n, _ in named_leaves(tr)]
            out[use] = (m, dict(zip(names, g)))
        (mk, gk), (mp, gp) = out[True], out[False]
        require(set(mk) == set(mp), "kernel and plain metrics differ")
        worst = 0.0
        for k in sorted(mp):
            e = abs(float(mk[k]) - float(mp[k])) / max(abs(float(mp[k])),
                                                       1e-6)
            log(f"# {what} {k}: kernel {float(mk[k]):.6g} plain "
                f"{float(mp[k]):.6g} rel {e:.3g} (bound {bound})")
            require(e <= bound, f"{what} {k} disagrees with the plain path")
            worst = max(worst, e)
        for n in gp:
            if n == "model.canonical_depth" or n.startswith("model.trunk."):
                a, r = gk[n].float(), gp[n].float()
                e = float((a - r).abs().max()) / max(
                    float(r.abs().max()), 1e-12)
                require(e <= bound and bool(torch.isfinite(a).all()),
                        f"{what} grad {n} rel {e:.3g} > {bound}")
                worst = max(worst, e)
        log(f"# {what}: kernel vs plain path worst rel {worst:.3g} over "
            f"{len(mp)} metrics, canonical_depth and trunk grads")
        return worst

    train_err = compare_paths(st, tparams, tfrozen, tbatch,
                              TRAIN_BOUND[torch.bfloat16],
                              f"train bf16 B={TRAIN_B}")
    # float32 on a small input (the points path forced on)
    sb, sgeo2, swin, sparams, sfrozen = train_inputs(dev, 2, 64, 16, 24)
    st32 = ts.StepStatics(
        lip_h=16, lip_w=24, lip_x=sgeo2["lip_x"], lip_y=sgeo2["lip_y"],
        face_h=64, face_w=64, focal=sgeo2["focal"], window=swin,
        face_bbox=(8, 8, 56, 56), pallas_gather=True)
    compare_paths(st32, sparams, sfrozen, sb, TRAIN_BOUND[torch.float32],
                  "train f32 face 64")

    # the sync stage: SyncNet loss on, U-Net frozen, B*T = 10 frames (the
    # K7 gathers stay on; the trainer's auto gate would leave batch 2 on
    # the plain gathers)
    yb, ygeo, ywin, yparams, yfrozen = train_inputs(
        dev, SYNC_B, FACE, LIP_H, LIP_W, with_sync=True)
    sst = dataclasses.replace(
        st, lip_x=ygeo["lip_x"], lip_y=ygeo["lip_y"], window=ywin,
        sync_on=True, postnet_frozen=True)
    ystep = ts.make_train_step(opt, sst, yfrozen)
    ystate = ts.init_train_state(*yparams, opt)
    before = count()
    ynew, ym = ystep(ystate, yb, ts.draw_noise(sst, SYNC_B, device=dev,
                                               generator=tgen))
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(count(), before))
    log("# sync step bf16 B=2 (10 frames): " + ", ".join(
        f"{k} {float(v):.5g}" for k, v in sorted(ym.items()))
        + f"; launches K2/dsrc/dgrid/K1/K3 {got}")
    # the stage-1 gathers plus the sync window gather (K2 + dsrc)
    require(got == (3, 2, 1, 0, 0), f"sync launches {got}")
    require("loss_sync" in ym and all(bool(torch.isfinite(v))
                                      for v in ym.values()),
            "sync step metrics")
    require(all(torch.equal(a, r) for a, r in zip(
        ts.tree_leaves(ynew.unet_params), ts.tree_leaves(ystate.unet_params))),
        "the frozen U-Net moved")

    # -- phase 4: timing (bf16, the serving dtype) -------------------------
    bf = torch.bfloat16
    a = k1_args(bf)
    t_k1 = (cuda_ms(lambda: kmlp.fused_mlp(*a)),
            cuda_ms(lambda: kmlp.fused_mlp_plain(*a)))
    a = k2_args(bf)
    t_k2 = (cuda_ms(lambda: kws.window_sample(*a)),
            cuda_ms(lambda: kws.window_sample_plain(*a)))
    # K3's plain version (float32 convs) is its correctness oracle; the
    # plain path serves each block as bf16 cuDNN convs (unet_light.apply's
    # upsample, concat, DoubleConv and pool), timed beside it
    _, up_bf, us_bf = weights.random_params(SEED, device=dev, dtype=bf)

    def plain_path_block(name, x, lo, pool):
        if lo is not None:
            x = torch.cat([x, tnn.upsample_bilinear(lo, *x.shape[1:3])], -1)
        y, _ = unet_light._double_conv(up_bf[name], us_bf[name], x)
        return (y, tnn.maxpool2d(y)) if pool else y

    t_k3 = [0.0, 0.0, 0.0]
    for name, args, kw in k3_cases(bf):
        tk = cuda_ms(lambda: kfb.fused_block(*args, **kw), iters=5)
        tp = cuda_ms(lambda: kfb.fused_block_plain(*args, **kw), iters=5)
        tc = cuda_ms(lambda: plain_path_block(name, args[0], kw["up"],
                                              kw["pool"]), iters=5)
        log(f"# time K3 {name} bf16 B=8: kernel {tk:.3f} ms, plain "
            f"(float32 convs) {tp:.3f} ms, plain path (bf16 cuDNN) "
            f"{tc:.3f} ms")
        t_k3[0] += tk
        t_k3[1] += tp
        t_k3[2] += tc
    log(f"# time K1 bf16 B=8 N=9600: kernel {t_k1[0]:.3f} ms, plain "
        f"{t_k1[1]:.3f} ms")
    log(f"# time K2 bf16 B=8 P={wh * ww}: kernel {t_k2[0]:.4f} ms, plain "
        f"{t_k2[1]:.4f} ms")
    log(f"# time K3 bf16 B=8 five blocks: kernel {t_k3[0]:.3f} ms, plain "
        f"(float32 convs) {t_k3[1]:.3f} ms, plain path (bf16 cuDNN) "
        f"{t_k3[2]:.3f} ms")

    # K7 at the main path's shapes: dsrc on the window gather, dgrid on
    # the depth-loss points
    cases = {c[0].split()[0]: c for c in k7_cases(bf)}
    _, src, grid, cot, g_geo = cases["window"]
    t_dsrc = (cuda_ms(lambda: khs.hat_sample_dsrc(grid, cot, FACE, FACE,
                                                  *g_geo)),
              cuda_ms(lambda: khs.hat_sample_dsrc_plain(grid, cot, FACE, FACE,
                                                        *g_geo)))
    _, src, grid, cot, g_geo = cases["points"]
    t_dgrid = (cuda_ms(lambda: khs.hat_sample_dgrid(src, grid, cot, *g_geo)),
               cuda_ms(lambda: khs.hat_sample_dgrid_plain(src, grid, cot,
                                                          *g_geo)))
    log(f"# time K7 hat_sample_dsrc bf16 B=8 window P={wh * ww}: kernel "
        f"{t_dsrc[0]:.4f} ms, plain {t_dsrc[1]:.4f} ms")
    log(f"# time K7 hat_sample_dgrid bf16 B=8 points "
        f"S={grid.shape[1]}: kernel {t_dgrid[0]:.4f} ms, plain "
        f"{t_dgrid[1]:.4f} ms")
    a = k1_args(bf, frames=1)
    a = (fourier_embed(ens.reshape(-1, 2), 10).to(bf),) + a[1:]
    t_k1b = (cuda_ms(lambda: kmlp.fused_mlp(*a)),
             cuda_ms(lambda: kmlp.fused_mlp_plain(*a)))
    log(f"# time K1b bf16 one frame N={4 * LIP_H * LIP_W}: kernel "
        f"{t_k1b[0]:.3f} ms, plain {t_k1b[1]:.3f} ms")

    # the train step at batch 8, bf16, kernel path and plain path in turns
    draws = ts.draw_noise(st, TRAIN_B, device=dev, generator=tgen)
    plain_step = ts.make_train_step(
        opt, dataclasses.replace(st, use_kernels=False), tfrozen)
    t_train = {True: [], False: []}
    for use in (False, True, True, False):
        fn = step if use else plain_step
        t_train[use].append(cuda_ms(lambda: fn(state, tbatch, draws),
                                    iters=3, warmup=1))
    t_train = {k: sum(v) / len(v) for k, v in t_train.items()}
    log(f"# train step bf16 batch {TRAIN_B}: {t_train[True]:.2f} ms/step = "
        f"{TRAIN_B * 1000 / t_train[True]:.1f} frames/s (plain path "
        f"{t_train[False]:.2f} ms = {TRAIN_B * 1000 / t_train[False]:.1f} "
        f"frames/s) on {card}")

    # the plain path's profile measures what the plain K2/K7 versions
    # cost inside the step, where dsrc's cotangent is zero off the lip box
    dev_k = profile_train_step(lambda: step(state, tbatch, draws),
                               f"train step bf16 B={TRAIN_B}", t_train[True])
    dev_p = profile_train_step(lambda: plain_step(state, tbatch, draws),
                               f"plain-path train step bf16 B={TRAIN_B}",
                               t_train[False])
    log(f"# profile device time per step, plain path minus kernel path: "
        f"{dev_p - dev_k:.3f} ms")

    for bsz in (8, 64):
        bb = batch if bsz == 8 else {
            k: v.repeat(bsz // 8, *([1] * (v.dim() - 1)))
            for k, v in batch.items()}
        iters = 5 if bsz == 8 else 3
        ms = cuda_ms(lambda: renderer(bb, geo["lip_x"], geo["lip_y"]),
                     iters=iters, warmup=1)
        pms = cuda_ms(lambda: render_face_batch(
            *renderer.params, bb, lip_x=geo["lip_x"], lip_y=geo["lip_y"],
            lip_h=LIP_H, lip_w=LIP_W, use_kernels=False,
            compute_dtype=torch.bfloat16, window=window),
            iters=iters, warmup=1)
        log(f"# slice bf16 batch {bsz}: {ms:.2f} ms/batch = "
            f"{bsz * 1000 / ms:.1f} frames/s (plain path {pms:.2f} ms = "
            f"{bsz * 1000 / pms:.1f} frames/s) on {card}")
        del bb

    kernels = [
        {"name": "fused_mlp", "route": "cuda",
         "source": "speech2lip_tpu_torch/csrc/fused_mlp.cu",
         "path": "render",
         "replaces": "speech2lip_tpu/ops/pallas/fused_mlp.py:80",
         "launches": launches["fused_mlp"],
         "max_abs_err": errs[("fused_mlp", bf)],
         "ms": t_k1[0], "plain_ms": t_k1[1]},
        {"name": "window_sample", "route": "cuda",
         "source": "speech2lip_tpu_torch/csrc/window_sample.cu",
         "path": "render",
         "replaces": "speech2lip_tpu/ops/pallas/window_sample.py:114",
         "launches": launches["window_sample"],
         "max_abs_err": errs[("window_sample", bf)],
         "ms": t_k2[0], "plain_ms": t_k2[1]},
        {"name": "fused_block", "route": "cuda",
         "source": "speech2lip_tpu_torch/csrc/fused_block.cu",
         "path": "render",
         "replaces": "speech2lip_tpu/ops/pallas/conv_hcw.py:867",
         "launches": launches["fused_block"],
         "max_abs_err": errs[("fused_block", bf)],
         "ms": t_k3[0], "plain_ms": t_k3[1]},
        {"name": "fused_mlp_one_frame", "route": "cuda",
         "source": "speech2lip_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "speech2lip_tpu/ops/pallas/fused_mlp.py:153",
         "path": "render_pixels",
         "launches": launches["fused_mlp_one_frame"],
         "max_abs_err": errs[("fused_mlp_one_frame", bf)],
         "ms": t_k1b[0], "plain_ms": t_k1b[1]},
        {"name": "hat_sample_dsrc", "route": "cuda",
         "source": "speech2lip_tpu_torch/csrc/hat_sample.cu",
         "replaces": "speech2lip_tpu/ops/pallas/hat_sample.py:143",
         "path": "train",
         "launches": launches["hat_sample_dsrc"],
         "max_abs_err": errs[("hat_sample_dsrc", bf)],
         "ms": t_dsrc[0], "plain_ms": t_dsrc[1]},
        {"name": "hat_sample_dgrid", "route": "cuda",
         "source": "speech2lip_tpu_torch/csrc/hat_sample.cu",
         "replaces": "speech2lip_tpu/ops/pallas/hat_sample.py:174",
         "path": "train",
         "launches": launches["hat_sample_dgrid"],
         "max_abs_err": errs[("hat_sample_dgrid", bf)],
         "ms": t_dgrid[0], "plain_ms": t_dgrid[1]},
    ]
    log(f"# train bf16 kernel vs plain path worst rel {train_err:.3g}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
