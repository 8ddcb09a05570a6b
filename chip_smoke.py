"""Smoke run of the PyTorch/CUDA port (speech2lip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, at first use), checks each
against its plain PyTorch version at May shapes (500x500 face, 120x80 lip)
in float32 and bfloat16, renders three batches of 8 frames through the
port's Renderer in bfloat16 on random parameters made from a seed (and
checks that the kernels carried them), compares one batch with the plain
path, and times the kernels and the slice with CUDA events.  Needs one CUDA
device; without one it exits non-zero before printing any result.

The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel's launches on the main path, error and times.
"""

from __future__ import annotations

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
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws
    from speech2lip_tpu_torch.ops.kernels.conv_block import fold_bn

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
        y = unet_light._double_conv(up_bf[name], us_bf[name], x)
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
         "replaces": "speech2lip_tpu/ops/pallas/fused_mlp.py:80",
         "launches": launches["fused_mlp"],
         "max_abs_err": errs[("fused_mlp", bf)],
         "ms": t_k1[0], "plain_ms": t_k1[1]},
        {"name": "window_sample", "route": "cuda",
         "source": "speech2lip_tpu_torch/csrc/window_sample.cu",
         "replaces": "speech2lip_tpu/ops/pallas/window_sample.py:114",
         "launches": launches["window_sample"],
         "max_abs_err": errs[("window_sample", bf)],
         "ms": t_k2[0], "plain_ms": t_k2[1]},
        {"name": "fused_block", "route": "cuda",
         "source": "speech2lip_tpu_torch/csrc/fused_block.cu",
         "replaces": "speech2lip_tpu/ops/pallas/conv_hcw.py:867",
         "launches": launches["fused_block"],
         "max_abs_err": errs[("fused_block", bf)],
         "ms": t_k3[0], "plain_ms": t_k3[1]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
