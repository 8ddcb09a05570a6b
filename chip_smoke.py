"""Smoke run of the PyTorch/CUDA port (speech2lip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, at first use), checks each
against its plain PyTorch version at May shapes (500x500 face, 120x80 lip)
in float32 and bfloat16, then drives the port's paths on random parameters
made from a seed:

- serving: three batches of 8 frames through the Renderer in bfloat16
  (K1 fused_mlp, K2 window_sample, K3 fused_block), one batch against the
  plain path;
- the U-Net's inference entry points at 500x500, batch 8, bfloat16:
  apply_infer_hcw (10 K4 conv3x3_hcw launches), apply_infer_pallas (10 K6
  conv3x3_infer launches) and apply_infer_dconv (5 K5 double_conv_hcw
  launches), each against the plain forward;
- static-scene serving: three batches of 8 through the
  StaticSceneRenderer in bfloat16 (K1, K2 and K3 on the lip-window crop);
- training: three bfloat16 stage-1 steps at batch 8 with the K7 gathers on
  (K2 forward, K7 hat_sample_dsrc / hat_sample_dgrid backward), one step
  against the plain path, a float32 step on a small input, and one
  sync-stage step (SyncNet loss, frozen U-Net) at batch 2;
- the dot probe's tool (speech2lip_tpu_torch.tools.bench_int8_dot) at its
  full shape and its own count of calls: one warm-up and ITERS timed K8
  dot_probe calls in bf16 and in int8, its outputs against the plain
  version;

checks that the kernels carried each path (launch counts, set to 0 just
before a path and read just after) and that the composite hands K2, and
hat_sample K2 and K7, the frame's crop and the coord grid's window as
views, with no copy op; and times the kernels, a PyTorch library call
computing the same function where there is one, and the paths with CUDA
events.  K2 and K7 get two times each, in turns with their library call:
the call time (the row's ms, the host's dispatch included) and the device
time (a CUDA graph of 100 calls replayed, device_ms); both K7 rows, on
the train step's own inputs, also count their device launches a call by
profile and carry the kernel's local bytes.  Needs one CUDA device; without one it exits non-zero before
printing any result.

The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel's launches on its path, error, times and bound.
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
# a U-Net entry point in bf16 against the plain forward in bf16: the plain
# forward rounds after every op, the kernels once per conv (the serving
# slice's bound)
UNET_BF16_BOUND = 1e-2
# K8 bf16 vs plain: float32 sums of exact bf16 products in another order
# than the plain version's float64 (int8 must be exact)
K8_BF16_BOUND = 1e-4
# static scene, kernel path: the crop's interior against the full frame.
# Align-corners upsampling samples the crop's coarse levels at other
# points than the full frame's (up to half a coarse pixel apart), and bf16
# rounds on top; a wrong column mask or swapped upsample ratios in K3 on
# the non-square crop moves it by the activations' own size
STATIC_GAP_BOUND = 1e-2
TRAIN_B, SYNC_B = 8, 2
# NVIDIA H100 SXM data sheet: dense bf16 and int8 tensor-core and float32
# (no tensor core) peaks, HBM3 rate; a bound is the larger of ops / peak
# and bytes / rate, each input read once and each output written once
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# (block.conv, H=W, cin) of the U-Net's ten convs at 500x500, and (block,
# H=W, cin) of its five DoubleConvs; the weights give cmid and cout
UNET_CONVS = [("inc.1", 500, 3), ("inc.2", 500, 64), ("down1.1", 250, 64),
              ("down1.2", 250, 128), ("down2.1", 125, 128),
              ("down2.2", 125, 128), ("up1.1", 250, 256), ("up1.2", 250, 128),
              ("up2.1", 500, 128), ("up2.2", 500, 64)]
UNET_DCONVS = [("inc", 500, 3), ("down1", 250, 64), ("down2", 125, 128),
               ("up1", 250, 256), ("up2", 500, 128)]


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(ops: float, moved: float, peak: str):
    """(least ms, what bounds it) of work of ``ops`` operations at the
    ``peak`` rate moving ``moved`` bytes through device memory."""
    t_ops, t_bytes = ops / PEAK[peak], moved / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def conv_ops(x, cin: int, cout: int) -> float:
    """Operations of a 3x3 conv over x's pixels (a multiply-add is 2)."""
    return 2.0 * x.numel() / x.shape[-1] * 9 * cin * cout


def library_conv(x, w, scale, bias):
    """One cuDNN call for conv3x3(x) * scale + bias (ReLU not included):
    channels-last F.conv2d on x's NHWC memory, the scale folded into the
    weights outside the call.  A yardstick; the port never calls it."""
    import torch.nn.functional as F
    wf = (w.float() * scale).to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bf = bias.to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    return lambda: F.conv2d(xc, wf, bf, padding=1)


def k5_weight_bytes(shape, cmid: int, cout: int, tiling: str) -> int:
    """Weight bytes one K5 launch on x of ``shape`` [B, H, W, Cin] streams
    from L2: every block reads conv1's weights once per conv1 M pass and
    conv2's once per conv2 M pass.  ``tiling`` "bf16" is the bf16 body of
    csrc/double_conv.cu (14x30 output tiles from a 16x32 mid tile at Cmid
    128, 30x30 from 32x32 in two M passes at Cmid 64, 512 output pixels a
    conv2 pass); "14x14" the bf16 body before it (as the float32 body
    still tiles): one pass per conv, 14x14 tiles.  bf16 weights."""
    b, h, w, cin = shape
    if tiling == "bf16":
        th, tw = (14, 30) if cmid == 128 else (30, 30)
        m1, m2 = (th + 2) // 16, -(-th * tw // 512)
    else:
        th = tw = 14
        m1 = m2 = 1
    blocks = -(-h // th) * -(-w // tw) * b
    return blocks * 9 * 2 * (m1 * cin * cmid + m2 * cmid * cout)


def named_leaves(tree, prefix=""):
    """[(dotted name, tensor)] in ``train_step.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


# kernel-name fragments of a profiled step's device time, by layer: the
# port's kernels, cuDNN convolutions, matmuls (lip MLP, 1x1 convs, LPIPS
# heads) and everything else (BatchNorm, activations, losses, Adam, glue)
PROFILE_GROUPS = (
    ("port kernels (K1-K7)", ("hat_dsrc", "hat_dgrid", "window_sample",
                              "fused_mlp_kernel", "conv3x3_kernel",
                              "double_conv_kernel")),
    ("convolutions", ("conv", "implicit", "fprop", "dgrad", "wgrad",
                      "cudnn", "winograd")),
    ("matmuls", ("gemm", "nvjet", "cutlass", "cublas")),
)


def profile_steps(run, what: str, step_ms: float, steps: int = 2):
    """Device time of ``steps`` calls of ``run`` by kernel group and the
    busiest kernels (torch.profiler), against ``step_ms`` of CUDA-event
    wall time per step measured without the profiler.  Returns (device ms,
    kernel launches) per step."""
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
    return total, launches // steps


def train_inputs(dev, b, face, lip_h, lip_w, with_sync=False):
    """A synthetic training batch on ``dev`` as the trainer hands it to the
    step: the canonical face and masks are per-identity constants (one
    frame's, broadcast), the blackaug branch's static warps are made from
    them, the warp window is validated; plus seeded parameters and frozen
    nets.  Returns (batch, geo, window, params, frozen)."""
    import numpy as np

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch.data.windows import compute_warp_window
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
    import torch.nn.functional as F

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.config import default_config
    from speech2lip_tpu_torch.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch.data.windows import compute_warp_window
    from speech2lip_tpu_torch.infer.renderer import Renderer, render_face_batch
    from speech2lip_tpu_torch.infer.static_scene import (StaticSceneRenderer,
                                                         crop_geometry)
    from speech2lip_tpu_torch.models import talking_face as tf
    from speech2lip_tpu_torch.models import unet_light
    from speech2lip_tpu_torch.ops import nn as tnn
    from speech2lip_tpu_torch.ops.coords import get_coords
    from speech2lip_tpu_torch.ops.embedders import fourier_embed
    from speech2lip_tpu_torch.ops.kernels import _build
    from speech2lip_tpu_torch.ops.kernels import conv_block as kcb
    from speech2lip_tpu_torch.ops.kernels import conv_hcw as kch
    from speech2lip_tpu_torch.ops.kernels import dot_probe as kdp
    from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
    from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
    from speech2lip_tpu_torch.ops.kernels import hat_sample as khs
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws
    from speech2lip_tpu_torch.ops.kernels.conv_block import fold_bn
    from speech2lip_tpu_torch.tools import bench_int8_dot as k8tool
    from speech2lip_tpu_torch.tools import bench_hat_sample as k7tool
    from speech2lip_tpu_torch.tools import bench_window_sample as k2tool
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
    crop = crop_geometry(window, FACE, FACE)
    require(crop is not None, f"window {window} gives no static-scene crop")
    log(f"# geometry: face {FACE}, lip {LIP_H}x{LIP_W} at "
        f"({geo['lip_y']}, {geo['lip_x']}), box {box}, window {window}, "
        f"static-scene crop {crop['ch']}x{crop['cw']}")
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
        """K2 as the composite calls it: the lip box's crop of a frame and
        the warp window of the coord grid, both views read in place."""
        frame = torch.rand(8, FACE, FACE, 3, device=dev,
                           generator=gen).to(dtype)
        src = frame[:, y0b - 1:y1b + 1, x0b - 1:x1b + 1]
        grid = batch["coord"][:, wy0:wy0 + wh, wx0:wx0 + ww]
        require(not (src.is_contiguous() or grid.is_contiguous()),
                "K2's inputs must be strided views")
        return (src, grid, y0b - 1, x0b - 1, FACE, FACE)

    def k3_cases(dtype, h=FACE, w=FACE, b=8):
        """(name, args, kwargs) of the U-Net's five K3 blocks on an h x w
        input: each block at 1/d of it, an up block's low-resolution
        source at half its own."""
        _, up, us = weights.random_params(SEED, device=dev, dtype=dtype)
        cases = []
        for name, d, cx, cl, pool in (("inc", 1, 3, 0, True),
                                      ("down1", 2, 64, 0, True),
                                      ("down2", 4, 128, 0, False),
                                      ("up1", 2, 128, 128, False),
                                      ("up2", 1, 64, 64, False)):
            p, s = up[name], us[name]
            s1, b1 = fold_bn(p["bn1"], s["bn1"])
            s2, b2 = fold_bn(p["bn2"], s["bn2"])
            hd, wd = h // d, w // d
            x = torch.rand(b, hd, wd, cx, device=dev, generator=gen).to(dtype)
            lo = (torch.rand(b, hd // 2, wd // 2, cl, device=dev,
                             generator=gen).to(dtype) if cl else None)
            cases.append((name, (x, p["conv1"]["w"], s1.float(), b1.float(),
                                 p["conv2"]["w"], s2.float(), b2.float()),
                          dict(up=lo, pool=pool)))
        return cases

    def k7_cases(dtype):
        """(name, src, grid, cotangent, (y_off, x_off, H, W)) of K7 at the
        main path's shapes, from ``bench_hat_sample.cases``: the blackaug
        window gather as the train step hands it over (the coord grid's
        window view, the cotangent zero off the warped lip box) and as a
        dense contiguous copy, the depth-loss points (border-clamped) and
        a grid exactly on pixel centres."""
        return [(f"{name} {tuple(c[1].shape)}", *c)
                for name, c in k7tool.cases(dev, dtype).items()]

    def conv_cases(dtype, b=8):
        """(name, (x, w, scale, bias)) of the U-Net's ten convs at May
        shapes, the eval BatchNorm folded (K4 and K6)."""
        _, up, us = weights.random_params(SEED, device=dev, dtype=dtype)
        out = []
        for name, hw, cin in UNET_CONVS:
            blk, k = name.split(".")
            p, s = up[blk], us[blk]
            sc, bi = fold_bn(p[f"bn{k}"], s[f"bn{k}"])
            x = torch.rand(b, hw, hw, cin, device=dev, generator=gen).to(dtype)
            out.append((name, (x, p[f"conv{k}"]["w"].contiguous(), sc.float(),
                               bi.float())))
        return out

    def dconv_cases(dtype, b=8):
        """(name, (x, w1, scale1, bias1, w2, scale2, bias2)) of the U-Net's
        five DoubleConvs at May shapes (K5)."""
        _, up, us = weights.random_params(SEED, device=dev, dtype=dtype)
        out = []
        for name, hw, cin in UNET_DCONVS:
            p, s = up[name], us[name]
            s1, b1 = fold_bn(p["bn1"], s["bn1"])
            s2, b2 = fold_bn(p["bn2"], s["bn2"])
            x = torch.rand(b, hw, hw, cin, device=dev, generator=gen).to(dtype)
            out.append((name, (x, p["conv1"]["w"], s1.float(), b1.float(),
                               p["conv2"]["w"], s2.float(), b2.float())))
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
        got = kws.window_sample(*a)
        errs[("window_sample", dtype)] = check(
            f"K2 window_sample {dn} crop view {tuple(a[0].shape[1:3])} of "
            f"{FACE}x{FACE}, window view {tuple(a[1].shape[1:3])}",
            [(got, kws.window_sample_plain(*a))], K2_BOUND[dtype])
        require(torch.equal(got, kws.window_sample(
            a[0].contiguous(), a[1].reshape(8, -1, 2).contiguous(), *a[2:])),
            "K2 on the views differs from K2 on contiguous copies")

        # K3 on the full frame (the Renderer) and on the static scene's
        # crop, which is not square and no tile multiple at any level
        worst = 0.0
        for name, args, kw in (k3_cases(dtype)
                               + k3_cases(dtype, crop["ch"], crop["cw"])):
            got = kfb.fused_block(*args, **kw)
            ref = kfb.fused_block_plain(*args, **kw)
            pairs = zip(got, ref) if kw["pool"] else [(got, ref)]
            lo = "" if kw["up"] is None else f" up {tuple(kw['up'].shape)}"
            worst = max(worst, check(
                f"K3 fused_block {dn} {name} {tuple(args[0].shape)}{lo}",
                pairs, BOUND[dtype]))
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

        # K4 and K6 launch one kernel; each wrapper is held against the
        # plain version on the ten convs, K5 on the five DoubleConvs
        worst = {"conv3x3_hcw": 0.0, "conv3x3_infer": 0.0,
                 "double_conv_hcw": 0.0}
        for name, args in conv_cases(dtype):
            ref = kfb.conv3x3_affine_plain(*args)
            shape = f"{tuple(args[0].shape)}->{args[1].shape[3]}"
            for kname, fn in (("conv3x3_hcw", kch.conv3x3_hcw),
                              ("conv3x3_infer", kcb.conv3x3_infer)):
                worst[kname] = max(worst[kname], check(
                    f"{kname} {dn} {name} {shape}", [(fn(*args), ref)],
                    BOUND[dtype]))
        for name, args in dconv_cases(dtype):
            worst["double_conv_hcw"] = max(worst["double_conv_hcw"], check(
                f"double_conv_hcw {dn} {name} {tuple(args[0].shape)}",
                [(kch.double_conv_hcw(*args),
                  kch.double_conv_hcw_plain(*args))], BOUND[dtype]))
        for kname, e in worst.items():
            errs[(kname, dtype)] = e
        torch.cuda.empty_cache()

    # registers, local memory (spills land there) and shared memory of K5's
    # eight instances and of the six of the conv kernel behind K3/K4/K6;
    # the bf16 bodies must keep everything on chip
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        insts = [(f"K5 attrs {dn} cmid {cmid} cout {cout}",
                  kch.double_conv_attrs(dtype, cmid, cout))
                 for cmid in (64, 128) for cout in (64, 128)]
        insts += [(f"K3/K4/K6 conv3x3_attrs {dn} cout {cout}",
                   kfb.conv3x3_attrs(dtype, cout)) for cout in (64, 128, 256)]
        for what, at in insts:
            log(f"# {what}: {at['regs']} registers, {at['local_bytes']} "
                f"local bytes, {at['smem_bytes']} shared bytes")
            require(dtype != torch.bfloat16 or at["local_bytes"] == 0,
                    f"{what} uses local memory")

    # -- phase 2b: K8, the dot probe, at its full shape, both types ------
    k8_in = k8tool.make_inputs(device=dev)
    k8_shape = (f"lhs {tuple(k8_in['bf16'][0].shape)} rhs "
                f"{tuple(k8_in['bf16'][1].shape)} T={k8tool.T}")
    k8_err = {}
    for dn, (lhs, rhs) in k8_in.items():
        got = kdp.dot_probe(lhs, rhs, k8tool.T)
        ref = kdp.dot_probe_plain(lhs, rhs, k8tool.T)
        if dn == "int8":
            require(got.shape == ref.shape and got.dtype == ref.dtype,
                    f"K8 int8 output {got.dtype} {tuple(got.shape)}")
            k8_err[dn] = float((got.long() - ref.long()).abs().max())
            log(f"# check K8 dot_probe int8 {k8_shape}: max|diff| "
                f"{k8_err[dn]:.3g}, bound 0 (int32 sums of integers)")
            require(k8_err[dn] == 0, "K8 int8 differs from its plain version")
        else:
            k8_err[dn] = check(f"K8 dot_probe bf16 {k8_shape}", [(got, ref)],
                               K8_BF16_BOUND)
        at = kdp.dot_probe_attrs(lhs.dtype)
        log(f"# K8 attrs {dn}: {at['regs']} registers, {at['local_bytes']} "
            f"local bytes, {at['smem_bytes']} shared bytes")
        require(at["local_bytes"] == 0, f"K8 {dn} uses local memory")
    del got, ref

    # -- phase 3: the main path, three batches through the Renderer --------
    bf = torch.bfloat16
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

    # the composite's window sample reads the frame's crop and the coord
    # grid's window in place: no copy op between the slices and K2
    from torch.utils._python_dispatch import TorchDispatchMode

    from torch.utils._pytree import tree_leaves

    class OpLog(TorchDispatchMode):
        """The names of the ops dispatched; with ``watch``, only of those
        that read a tensor sharing storage with a watched one."""

        def __init__(self, watch=()):
            super().__init__()
            self.ops = []
            self.storages = {t.untyped_storage().data_ptr() for t in watch}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not self.storages or any(
                    isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() in self.storages
                    for t in tree_leaves((args, kwargs))):
                self.ops.append(func.__name__)
            return func(*args, **(kwargs or {}))

    frame = torch.rand(8, FACE, FACE, 3, device=dev, generator=gen).to(bf)
    with OpLog() as oplog:
        tf._sample_box_region(frame, batch["coord"][:, wy0:wy0 + wh,
                                                    wx0:wx0 + ww],
                              box, FACE, FACE, use_kernels=True)
    copies = [op for op in oplog.ops
              if op.split(".")[0] in ("clone", "copy_", "_to_copy",
                                      "contiguous")]
    log(f"# composite window sample (kernels): ops {oplog.ops}; copies "
        f"{copies or 'none'}")
    require(not copies, f"the composite copies K2's inputs: {copies}")

    # the training composite's window gather (hat_sample: K2 forward, K7
    # dsrc backward) takes the same views: no copy op reads the crop, the
    # window or the cotangent in either pass; and dsrc on the window view
    # (the coord grid holds the batch innermost) against its plain version
    crop_leaf = frame[:, y0b - 1:y1b + 1, x0b - 1:x1b + 1].detach()
    crop_leaf.requires_grad_(True)
    grid_w = batch["coord"][:, wy0:wy0 + wh, wx0:wx0 + ww]
    k7_geo = (y0b - 1, x0b - 1, FACE, FACE)
    with OpLog(watch=(crop_leaf, grid_w)) as fwd_log:
        out = khs.hat_sample(crop_leaf, grid_w, *k7_geo)
    cot = torch.randn(out.shape, device=dev, generator=gen).to(bf)
    with OpLog(watch=(crop_leaf, grid_w, cot)) as bwd_log:
        (dsrc,) = torch.autograd.grad(out, [crop_leaf], cot)
    copies = [op for op in fwd_log.ops + bwd_log.ops
              if op.split(".")[0] in ("clone", "copy_", "_to_copy",
                                      "contiguous")]
    log(f"# hat_sample on the crop and window views: forward ops "
        f"{fwd_log.ops}, backward ops {bwd_log.ops}; copies "
        f"{copies or 'none'}")
    require(not copies and bwd_log.ops,
            f"hat_sample copies K2's or K7's inputs: {copies}")
    ref = khs.hat_sample_dsrc_plain(grid_w, cot, *crop_leaf.shape[1:3],
                                    *k7_geo)
    check("K7 hat_sample_dsrc bfloat16 window view "
          f"{tuple(grid_w.shape)} strides {grid_w.stride()}", [(dsrc, ref)],
          K7_BOUND["dsrc"][bf])
    del frame, crop_leaf, out, cot, dsrc, ref

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

    # -- phase 3c: the U-Net's inference entry points, 500x500, batch 8 ----
    _, up_bf, us_bf = weights.random_params(SEED, device=dev, dtype=bf)
    ux = torch.rand(8, FACE, FACE, 3, device=dev, generator=gen).to(bf)
    uref, _ = unet_light.apply(up_bf, us_bf, ux)
    unet_counts = lambda: (kch.conv3x3_launches, kcb.launches,
                           kch.double_conv_launches)
    for fn, kname, want in (
            (unet_light.apply_infer_hcw, "conv3x3_hcw", (10, 0, 0)),
            (unet_light.apply_infer_pallas, "conv3x3_infer", (0, 10, 0)),
            (unet_light.apply_infer_dconv, "double_conv_hcw", (0, 0, 5))):
        kch.conv3x3_launches = kch.double_conv_launches = kcb.launches = 0
        out = fn(up_bf, us_bf, ux)
        torch.cuda.synchronize()
        got = unet_counts()
        log(f"# {fn.__name__} bf16 B=8 {FACE}x{FACE}: launches K4/K6/K5 "
            f"{got}")
        require(got == want, f"{fn.__name__} launches K4/K6/K5 {got}, "
                f"expected {want}")
        launches[kname] = sum(got)
        check(f"{fn.__name__} bf16 vs apply (bf16 cuDNN)", [(out, uref)],
              UNET_BF16_BOUND)
    del out, uref

    # -- phase 3d: static-scene serving, three batches of 8 ----------------
    base = {k: raw[k][0] for k in ("rgb_face_zero", "rgb_face_ori",
                                   "mask_lip_canonical", "coord")}
    static = StaticSceneRenderer(cfg, *params, base, window, geo["lip_x"],
                                 geo["lip_y"], device=dev)
    g = static.geo
    require(static.use_kernels and static.compute_dtype == bf
            and g is not None, "static scene: kernels, bf16 and a crop")
    log(f"# static scene: window {window}, crop {g['ch']}x{g['cw']} at "
        f"({g['cy0']}, {g['cx0']}) = {g['ch'] * g['cw'] / FACE ** 2:.3f} "
        f"of the frame, interior {g['ih']}x{g['iw']} at ({g['iy0']}, "
        f"{g['ix0']})")
    for mod in (kmlp, kws, kfb):
        mod.launches = 0
    for i in range(3):
        sout = static(batch["audio"], batch["index"])
        torch.cuda.synchronize()
        counts = (kmlp.launches, kws.launches, kfb.launches)
        log(f"# static batch {i}: face {tuple(sout.shape)}; launches "
            f"K1/K2/K3 so far {counts}")
        require(counts == (i + 1, i + 1, 5 * (i + 1)),
                f"static scene launches K1/K2/K3 {counts} after {i + 1} "
                "batches")
        require(sout.shape == (8, FACE, FACE, 3)
                and bool(torch.isfinite(sout).all()),
                f"static face {tuple(sout.shape)} not finite")
    sfull = static.render_full(batch["audio"], batch["index"])
    inner = (slice(None), slice(g["iy0"], g["iy0"] + g["ih"]),
             slice(g["ix0"], g["ix0"] + g["iw"]))
    gap = float((sout[inner] - sfull[inner]).abs().max())
    gap_scale = max(1.0, float(sfull[inner].abs().max()))
    outside = sout.clone()
    outside[inner] = 0
    require(torch.equal(outside[0], outside[-1]),
            "static scene: the exterior differs between frames")
    log(f"# static scene bf16: crop interior vs render_full max|diff| "
        f"{gap:.3g}, bound {STATIC_GAP_BOUND} x {gap_scale:.3g} "
        "(align-corners upsampling on the crop is not "
        "translation-equivariant)")
    require(gap <= STATIC_GAP_BOUND * gap_scale,
            "static scene: the crop's interior strays from render_full")
    del sout, sfull, outside

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
    # its grid is data; a call is khs.DSRC_DEVICE_LAUNCHES[bf] device
    # launches), dgrid once (the points' grid follows the learned depth,
    # their source is data); K1 and K3 serve inference only
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

    # -- phase 3e: the dot probe's tool at its full shape -----------------
    # kdp.launches counts dot_probe calls that reached the card; an int8
    # call launches two kernels, the re-layout of rhs and then the dot
    kdp.launches = 0
    k8_run = k8tool.run(device=dev)
    torch.cuda.synchronize()
    k8_launches = {dn: r["launches"] for dn, r in k8_run.items()}
    log(f"# bench_int8_dot path: K8 launches {k8_launches}, total "
        f"{kdp.launches}")
    require(kdp.launches == 2 * (1 + k8tool.ITERS)
            and all(v == 1 + k8tool.ITERS for v in k8_launches.values()),
            f"bench_int8_dot: K8 calls {k8_launches}, expected "
            f"{1 + k8tool.ITERS} per type")
    for dn, r in k8_run.items():
        ref = kdp.dot_probe_plain(r["lhs"], r["rhs"], k8tool.T)
        if dn == "int8":
            require(torch.equal(r["out"], ref),
                    "bench_int8_dot: int8 output differs from plain")
        else:
            check("bench_int8_dot bf16 output", [(r["out"], ref)],
                  K8_BF16_BOUND)
    del k8_run, ref

    # -- phase 4: timing (bf16, the serving dtype) -------------------------
    # each kernel's ms, its plain version's, one PyTorch library call's
    # computing the same function (None, with a note, where there is none)
    # and the bound from this run's shapes
    rows = {}

    def row(name, ms, plain_ms, library_ms, ops, moved, peak, note=None,
            extra=None):
        b_ms, by = bound(ops, moved, peak)
        rows[name] = {"ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": b_ms,
                      "bound_by": by, **(extra or {})}
        if note:
            rows[name]["library_note"] = note
        lib = f"{library_ms:.4f} ms" if library_ms is not None else note
        log(f"# time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, library {lib}; bound {b_ms:.4f} ms by {by} "
            f"({ops / 1e9:.2f} Gop at the {peak} peak, {moved / 1e6:.2f} MB)")

    def timed_turns(name, kernel, library):
        """Call time (eager calls between two events, the host's dispatch
        included) and device time (one CUDA graph of 100 calls, replayed)
        of a kernel and its library call, in turns kernel, library,
        library, kernel; and each one's kernel time in a profile.  Returns
        (kernel call ms, library call ms, the row's extra keys)."""
        t = k2tool.in_turns({"kernel": kernel, "library": library})
        k, lib = t["kernel"], t["library"]
        log(f"# time {name} in turns: call {k['call_ms_turns']} ms, device "
            f"{k['device_ms_turns']} ms, profiled {k['profiled_ms']}; "
            f"library call {lib['call_ms_turns']} ms, device "
            f"{lib['device_ms_turns']} ms, profiled {lib['profiled_ms']}")
        return k["call_ms"], lib["call_ms"], {
            "device_ms": k["device_ms"], "profiled_ms": k["profiled_ms"],
            "library_device_ms": lib["device_ms"],
            "library_profiled_ms": lib["profiled_ms"]}

    def mlp_row(name, a):
        """K1 / K1b: uv [N, 42] through the input and skip projections
        once, the trunk and head per frame."""
        out = kmlp.fused_mlp(*a)
        trunk = list(a[5]) + [a[7]]
        ops = 2.0 * a[0].shape[0] * (a[3].numel() + a[4].numel()
                                     + a[1].shape[0] * sum(w.numel()
                                                           for w in trunk))
        row(name, cuda_ms(lambda: kmlp.fused_mlp(*a)),
            cuda_ms(lambda: kmlp.fused_mlp_plain(*a)), None, ops,
            nbytes(a[0], a[1], a[2], a[3], a[4], *a[5], *a[6], a[7], a[8],
                   out), "bf16",
            note="none: no single PyTorch call runs the 9-layer MLP with "
                 "per-frame biases")

    mlp_row("fused_mlp", k1_args(bf))
    a = k1_args(bf, frames=1)
    mlp_row("fused_mlp_one_frame",
            (fourier_embed(ens.reshape(-1, 2), 10).to(bf),) + a[1:])

    # K2 on the composite's views; grid_sample takes one dtype for source
    # and grid: float32 copies of the crop and the window, made outside
    # the timed call
    a = k2_args(bf)
    src, grid = a[0], a[1]
    out = kws.window_sample(*a)
    src32 = src.float().permute(0, 3, 1, 2).contiguous()
    g4 = k2tool.crop_grid(grid.reshape(8, -1, 2), *a[2:], *src.shape[1:3])
    lib = lambda: F.grid_sample(src32, g4, mode="bilinear",
                                padding_mode="zeros", align_corners=False)
    log(f"# K2 vs F.grid_sample on the crop: max|diff| "
        f"{float((lib()[:, :, 0].transpose(1, 2) - out.float()).abs().max()):.3g}")
    k_ms, l_ms, extra = timed_turns(
        "K2 window_sample", lambda: kws.window_sample(*a), lib)
    row("window_sample", k_ms, cuda_ms(lambda: kws.window_sample_plain(*a)),
        l_ms, 8.0 * src.shape[3] * out.shape[0] * out.shape[1],
        nbytes(src, grid, out), "f32", extra=extra)

    # K3's plain version (float32 convs) is its correctness oracle; the
    # plain path serves each block as bf16 cuDNN convs (unet_light.apply's
    # upsample, concat, DoubleConv and pool), timed beside it
    def plain_path_block(name, x, lo, pool):
        if lo is not None:
            x = torch.cat([x, tnn.upsample_bilinear(lo, *x.shape[1:3])], -1)
        y, _ = unet_light._double_conv(up_bf[name], us_bf[name], x)
        return (y, tnn.maxpool2d(y)) if pool else y

    # the mid activation's round trip through device memory (written by
    # the first launch, read by the second), timed at the HBM rate: what
    # one launch per block (ROADMAP B1) could save at most
    t_k3, ops, moved, mid_bytes = [0.0, 0.0, 0.0], 0.0, 0, 0
    for name, args, kw in k3_cases(bf):
        x, w1, w2 = args[0], args[1], args[4]
        outs = kfb.fused_block(*args, **kw)
        ops += conv_ops(x, w1.shape[2], w1.shape[3]) + conv_ops(
            x, w2.shape[2], w2.shape[3])
        moved += nbytes(*args, kw["up"], *(outs if kw["pool"] else (outs,)))
        mb = 2 * x.numel() // x.shape[3] * w1.shape[3] * x.element_size()
        mid_bytes += mb
        tk = cuda_ms(lambda: kfb.fused_block(*args, **kw), iters=5)
        tp = cuda_ms(lambda: kfb.fused_block_plain(*args, **kw), iters=5)
        tc = cuda_ms(lambda: plain_path_block(name, args[0], kw["up"],
                                              kw["pool"]), iters=5)
        log(f"# time K3 {name} bf16 B=8: kernel {tk:.3f} ms, plain "
            f"(float32 convs) {tp:.3f} ms, plain path (bf16 cuDNN) "
            f"{tc:.3f} ms; mid round trip {mb / 1e6:.1f} MB = "
            f"{1e3 * mb / HBM_BYTES_PER_S:.3f} ms at the HBM rate")
        t_k3 = [t_k3[0] + tk, t_k3[1] + tp, t_k3[2] + tc]
    log(f"# time K3 bf16 B=8 five blocks: kernel {t_k3[0]:.3f} ms, plain "
        f"path (bf16 cuDNN) {t_k3[2]:.3f} ms; mid round trips "
        f"{mid_bytes / 1e6:.1f} MB = "
        f"{1e3 * mid_bytes / HBM_BYTES_PER_S:.3f} ms at the HBM rate")
    row("fused_block", t_k3[0], t_k3[1], None, ops, moved, "bf16",
        note="none: no single PyTorch call fuses the upsample, concat, two "
             "convs, BatchNorm, ReLU and pool")

    # K4 and K6 (one kernel behind two wrappers) over the ten convs, K5
    # over the five DoubleConvs; library: cuDNN channels-last convs with
    # the scale folded into the weights (ReLU not included)
    t4 = t6 = tp = tl = ops = 0.0
    moved = 0
    t_pair = []
    for name, (x, w, sc, bi) in conv_cases(bf):
        k4 = cuda_ms(lambda: kch.conv3x3_hcw(x, w, sc, bi), iters=5)
        t4 += k4
        t6 += cuda_ms(lambda: kcb.conv3x3_infer(x, w, sc, bi), iters=5)
        tp += cuda_ms(lambda: kfb.conv3x3_affine_plain(x, w, sc, bi),
                      iters=5)
        lib_ms = cuda_ms(library_conv(x, w, sc, bi), iters=5)
        tl += lib_ms
        ops += conv_ops(x, w.shape[2], w.shape[3])
        moved += nbytes(x, w, sc, bi) + x.numel() // x.shape[3] * \
            w.shape[3] * x.element_size()
        t_pair.append(k4)
        log(f"# time conv {name} {tuple(x.shape)}->{w.shape[3]} bf16: K4 "
            f"{k4:.3f} ms, cuDNN {lib_ms:.3f} ms ({k4 / lib_ms:.2f}x), "
            f"{conv_ops(x, w.shape[2], w.shape[3]) / k4 / 1e9:.1f} TFLOP/s")
    log(f"# time K4 bf16 ten convs: {t4:.3f} ms against ten cuDNN convs "
        f"{tl:.3f} ms ({t4 / tl:.3f}x), {ops / t4 / 1e9:.1f} TFLOP/s")
    row("conv3x3_hcw", t4, tp, tl, ops, moved, "bf16")
    row("conv3x3_infer", t6, tp, tl, ops, moved, "bf16")
    t5 = tp = tl = ops = 0.0
    moved = 0
    traffic = [0.0, 0.0]
    for i, (name, args) in enumerate(dconv_cases(bf)):
        x, w1, s1, b1, w2, s2, b2 = args
        k5 = cuda_ms(lambda: kch.double_conv_hcw(*args), iters=5)
        t5 += k5
        tp += cuda_ms(lambda: kch.double_conv_hcw_plain(*args), iters=5)
        c1 = library_conv(x, w1, s1, b1)
        mid = c1().permute(0, 2, 3, 1)
        c2 = library_conv(mid, w2, s2, b2)
        lib_ms = cuda_ms(lambda: (c1(), c2()), iters=5)
        tl += lib_ms
        d_ops = conv_ops(x, w1.shape[2], w1.shape[3]) + conv_ops(
            mid, w2.shape[2], w2.shape[3])
        d_moved = nbytes(*args) + mid.numel() // mid.shape[3] * \
            w2.shape[3] * x.element_size()
        ops += d_ops
        moved += d_moved
        d_bound, d_by = bound(d_ops, d_moved, "bf16")
        wt = [k5_weight_bytes(x.shape, w1.shape[3], w2.shape[3], t)
              for t in ("bf16", "14x14")]
        traffic = [traffic[0] + wt[0], traffic[1] + wt[1]]
        log(f"# time DoubleConv {name} {tuple(x.shape)} bf16: K5 {k5:.3f} "
            f"ms, two K4 launches {t_pair[2 * i] + t_pair[2 * i + 1]:.3f} "
            f"ms, two cuDNN convs {lib_ms:.3f} ms, bound {d_bound:.3f} ms "
            f"by {d_by}; weights from L2 {wt[0] / 1e9:.3f} GB (14x14 "
            f"tiles: {wt[1] / 1e9:.3f} GB)")
    log(f"# time K5 bf16 five DoubleConvs: {t5:.3f} ms against ten K4 "
        f"launches {sum(t_pair):.3f} ms and two cuDNN convs each {tl:.3f} "
        f"ms; weights from L2 {traffic[0] / 1e9:.3f} GB (14x14 tiles: "
        f"{traffic[1] / 1e9:.3f} GB)")
    row("double_conv_hcw", t5, tp, tl, ops, moved, "bf16")
    del mid
    # float32 K5 (the 3xTF32 WMMA body): a log line only
    t5_f32 = 0.0
    for name, args in dconv_cases(torch.float32):
        k5 = cuda_ms(lambda: kch.double_conv_hcw(*args), iters=3)
        t5_f32 += k5
        log(f"# time DoubleConv {name} {tuple(args[0].shape)} float32: K5 "
            f"{k5:.3f} ms")
    log(f"# time K5 float32 five DoubleConvs: {t5_f32:.3f} ms")
    del args
    torch.cuda.empty_cache()

    # K7 at the main path's shapes: dsrc on the window gather as the train
    # step hands it over (the window view, the cotangent zero off the lip
    # box), dgrid on the depth-loss points; library:
    # aten.grid_sampler_2d_backward on float32 copies (one dtype for
    # source and grid)
    cases = k7tool.cases(dev, bf)
    backward = torch.ops.aten.grid_sampler_2d_backward
    k7_local = {}
    for which in ("dsrc", "dgrid"):
        for dtype in (bf, torch.float32):
            at = khs.attrs(which, dtype == bf)
            log(f"# K7 attrs {which} {str(dtype).split('.')[1]}: "
                f"{at['regs']} registers, {at['local_bytes']} local bytes, "
                f"{at['smem_bytes']} static shared bytes")
            require(dtype != bf or at["local_bytes"] == 0,
                    f"K7 {which} bf16 uses local memory")
            if dtype == bf:
                k7_local[which] = at["local_bytes"]
    for kern, case, mask, per_call_expected in (
            ("dsrc", "train", [True, False], khs.DSRC_DEVICE_LAUNCHES[bf]),
            ("dgrid", "points", [False, True], 1)):
        src, grid, cot, g_geo = cases[case]
        if kern == "dsrc":
            kernel = lambda: khs.hat_sample_dsrc(grid, cot, FACE, FACE,
                                                 *g_geo)
            plain = lambda: khs.hat_sample_dsrc_plain(grid, cot, FACE, FACE,
                                                      *g_geo)
        else:
            kernel = lambda: khs.hat_sample_dgrid(src, grid, cot, *g_geo)
            plain = lambda: khs.hat_sample_dgrid_plain(src, grid, cot,
                                                       *g_geo)
        out = kernel()
        src32 = src.float().permute(0, 3, 1, 2).contiguous()
        g4 = k2tool.crop_grid(grid.reshape(8, -1, 2), *g_geo, FACE, FACE)
        cot32 = cot.float().transpose(1, 2)[:, :, None].contiguous()
        k_ms, l_ms, extra = timed_turns(
            f"K7 hat_sample_{kern} {case}", kernel,
            lambda: backward(cot32, src32, g4, 0, 0, False, mask))
        # a call's device launches (dsrc: zero-fill, scatter, cast), from
        # a profile of a few calls
        _, per_call = profile_steps(kernel, f"K7 hat_sample_{kern} calls",
                                    k_ms, steps=5)
        require(per_call == per_call_expected, f"a {kern} call issues "
                f"{per_call} device launches, expected {per_call_expected}")
        extra.update(device_launches_per_call=per_call,
                     local_bytes=k7_local[kern])
        # the work of the points whose cotangent is nonzero; dgrid reads 4
        # taps of each point, not the whole source
        live = int((cot != 0).any(-1).sum())
        if kern == "dsrc":
            ops, moved = 8.0 * live * cot.shape[-1], nbytes(grid, cot, out)
        else:
            ops = 16.0 * live * cot.shape[-1]
            moved = min(nbytes(src), 4 * nbytes(cot)) + nbytes(grid, cot,
                                                                 out)
        log(f"# K7 {kern} {case}: grid {tuple(grid.shape)} strides "
            f"{grid.stride()}, {live} of {cot.shape[0] * cot.shape[1]} "
            f"points with a nonzero cotangent")
        row(f"hat_sample_{kern}", k_ms, cuda_ms(plain), l_ms, ops, moved,
            "f32", extra=extra)
    del cases, src, src32, out

    # K8 at the probe's shape.  Library: one cuBLAS call doing the same
    # 2*M*K*N*G*T operations, lhs tiled to [T*M, G*K] (materialised) times
    # rhs as [G*K, N]: torch.matmul in bf16 (bf16 output, half K8's output
    # bytes), torch._int_mm in int8 (rhs given column-major, the layout
    # cuBLASLt's int8 kernels take, made outside the timed call).  The
    # plain version computes one [M, N] tile and repeats it (1/T of the
    # operations).  An int8 call also moves the re-laid rhs [G, N, K]: its
    # re-layout launch writes it once and the dot reads it once
    m8, k8, n8, g8, t8 = (k8tool.M, k8tool.K, k8tool.N, k8tool.G, k8tool.T)
    ops8 = 2.0 * m8 * k8 * n8 * g8 * t8
    k8_rate = {}
    for dn, (lhs, rhs) in k8_in.items():
        out = kdp.dot_probe(lhs, rhs, t8)
        a_t = lhs.repeat(t8, g8)
        b_f = rhs.reshape(g8 * k8, n8)
        if dn == "int8":
            b_f = b_f.t().contiguous().t()
            lib = lambda: torch._int_mm(a_t, b_f)
            note = ("torch._int_mm (cuBLASLt s8 x s8 -> s32), lhs tiled to "
                    "[T*M, G*K], rhs column-major [G*K, N]")
        else:
            lib = lambda: torch.matmul(a_t, b_f)
            note = ("torch.matmul (cuBLAS), lhs tiled to [T*M, G*K], rhs "
                    "[G*K, N]; bf16 output, half K8's output bytes")
        lref = lib()
        log(f"# K8 {dn} vs the library call, program 0: max|diff| "
            f"{float((lref[:m8].double() - out[0].double()).abs().max()):.3g}")
        del lref
        km = cuda_ms(lambda: kdp.dot_probe(lhs, rhs, t8))
        pm = cuda_ms(lambda: kdp.dot_probe_plain(lhs, rhs, t8))
        lm = cuda_ms(lib)
        moved = nbytes(lhs, rhs, out) + (2 * rhs.numel() if dn == "int8"
                                         else 0)
        row(f"dot_probe_{dn}", km, pm, lm, ops8, moved, dn, note=note)
        unit = "TOP/s" if dn == "int8" else "TFLOP/s"
        k8_rate[dn] = ops8 / km / 1e9
        log(f"# time K8 {dn}: {k8_rate[dn]:.1f} {unit} ({ops8 / lm / 1e9:.1f} "
            f"library); kernel / library time {km / lm:.3f}x; "
            f"{100 * k8_rate[dn] * 1e12 / PEAK[dn]:.1f}% of the peak")
    log(f"# time K8 int8 / bf16 rate: {k8_rate['int8'] / k8_rate['bf16']:.3f}x "
        f"on {card}")
    del a_t, b_f, out

    # the U-Net entry points at 500x500, batch 8
    for name, fn in (("apply_infer_hcw (10 K4)", unet_light.apply_infer_hcw),
                     ("apply_infer_pallas (10 K6)",
                      unet_light.apply_infer_pallas),
                     ("apply_infer_dconv (5 K5)", unet_light.apply_infer_dconv),
                     ("apply_infer_fused (5 K3)", unet_light.apply_infer_fused),
                     ("apply (bf16 cuDNN)",
                      lambda p, s, x: unet_light.apply(p, s, x)[0])):
        ms = cuda_ms(lambda: fn(up_bf, us_bf, ux), iters=5, warmup=1)
        log(f"# time U-Net {name} bf16 B=8 {FACE}x{FACE}: {ms:.3f} ms = "
            f"{8000 / ms:.1f} frames/s")
    del ux

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
    dev_k, _ = profile_steps(lambda: step(state, tbatch, draws),
                             f"train step bf16 B={TRAIN_B}", t_train[True])
    dev_p, _ = profile_steps(lambda: plain_step(state, tbatch, draws),
                             f"plain-path train step bf16 B={TRAIN_B}",
                             t_train[False])
    log(f"# profile device time per step, plain path minus kernel path: "
        f"{dev_p - dev_k:.3f} ms")

    # serving throughput: the Renderer (full-frame U-Net) and the
    # StaticSceneRenderer (U-Net on the crop) at the same batches
    for bsz in (8, 32, 64):
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
        if bsz <= 32:
            sms = cuda_ms(lambda: static(bb["audio"], bb["index"]),
                          iters=iters, warmup=1)
            log(f"# static scene bf16 batch {bsz}: {sms:.2f} ms/batch = "
                f"{bsz * 1000 / sms:.1f} frames/s ({ms / sms:.2f}x the "
                f"Renderer) on {card}")
        if bsz == 8:
            dev_ms, n_launch = profile_steps(
                lambda: renderer(bb, geo["lip_x"], geo["lip_y"]),
                "Renderer bf16 batch 8", ms, steps=3)
            log(f"# Renderer bf16 batch 8: {n_launch} kernel launches and "
                f"{dev_ms:.2f} ms of device time a batch")
            profile_steps(lambda: static(bb["audio"], bb["index"]),
                          "static scene bf16 batch 8", sms, steps=3)
        del bb

    pallas = "speech2lip_tpu/ops/pallas/"
    kernels = []
    for name, source, replaces, path in (
            ("fused_mlp", "fused_mlp.cu", "fused_mlp.py:80", "render"),
            ("window_sample", "window_sample.cu", "window_sample.py:114",
             "render"),
            ("fused_block", "fused_block.cu", "conv_hcw.py:867", "render"),
            ("fused_mlp_one_frame", "fused_mlp.cu", "fused_mlp.py:153",
             "render_pixels"),
            ("hat_sample_dsrc", "hat_sample.cu", "hat_sample.py:143", "train"),
            ("hat_sample_dgrid", "hat_sample.cu", "hat_sample.py:174",
             "train"),
            ("conv3x3_hcw", "fused_block.cu", "conv_hcw.py:207",
             "apply_infer_hcw"),
            ("double_conv_hcw", "double_conv.cu", "conv_hcw.py:403",
             "apply_infer_dconv"),
            ("conv3x3_infer", "fused_block.cu", "conv_block.py:63",
             "apply_infer_pallas")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"speech2lip_tpu_torch/csrc/{source}",
                        "replaces": pallas + replaces, "path": path,
                        "launches": launches[name],
                        "max_abs_err": errs[(name, bf)], **rows[name]})
    for dn in ("bf16", "int8"):
        kernels.append({"name": f"dot_probe_{dn}", "route": "cuda",
                        "source": "speech2lip_tpu_torch/csrc/dot_probe.cu",
                        "replaces": "tools/bench_int8_dot.py:44",
                        "path": "bench_int8_dot",
                        "launches": k8_launches[dn],
                        "max_abs_err": k8_err[dn], **rows[f"dot_probe_{dn}"]})
    require(len(kernels) == 11 and all(k["launches"] > 0 for k in kernels),
            "a kernel was not launched on its path")
    log(f"# train bf16 kernel vs plain path worst rel {train_err:.3g}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
