"""Per-stage render profile at May geometry (counterpart of the JAX
package's ``tools/bench_components.py``; informational, no benchmark cell).

    python -m speech2lip_tpu_torch.tools.bench_components [--device cuda|cpu]

Times a ``Renderer`` batch as a whole and by stage, each stage on the
inputs the renderer gives it (the rendered lip image and the composited
U-Net input of the batch's plain render, made once by ``build``): the lip
MLP (K1 ``fused_mlp``), the composite (K2 ``window_sample``), the U-Net
(five K3 ``fused_block`` blocks), and beside them the plain U-Net's cuDNN
forward (``unet_light.apply``), a timing row without a plain call.  On the card: batch 32 in bfloat16 through the
kernels; on the CPU: batch 2 in float32 through the kernels' plain
versions.  Each stage is timed by CUDA events (a wall clock on the CPU):
one warm-up call, then the best of ``REPEATS`` runs of ``ITERS`` calls;
its launches are counted on one call.

``build(device, size)`` returns the stages, each with its kernel call and
its plain call (``use_kernels=False``; None for the plain U-Net) on the
same inputs; ``run(bench)``
times them and returns the rows.  ``main(argv, size=(face, lip_h,
lip_w))`` does both; ``size`` shrinks the geometry for a CPU.
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import torch

MAY = (500, 80, 120)      # face, lip_h, lip_w
ITERS, REPEATS = 20, 3
STAGES = ("full render", "lip MLP", "composite", "U-Net", "U-Net plain")


def launch_counts() -> dict:
    from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
    from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws
    return {"fused_mlp": kmlp.launches, "window_sample": kws.launches,
            "fused_block": kfb.launches}


def build(device, size=None) -> SimpleNamespace:
    """The stages at batch 32 in bfloat16 on the card (2 in float32
    elsewhere): ``stages[name] = (kernel call, plain call)``."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.config import default_config
    from speech2lip_tpu_torch.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch.data.windows import compute_warp_window
    from speech2lip_tpu_torch.infer.renderer import (cast_tree,
                                                     render_face_batch,
                                                     render_lip_batch)
    from speech2lip_tpu_torch.models import talking_face as tf
    from speech2lip_tpu_torch.models import unet_light

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    b = 32 if on_card else 2
    dt = torch.bfloat16 if on_card else torch.float32
    face, lip_h, lip_w = size or MAY
    cfg = default_config()
    cfg["model"]["canonical_depth_height"] = face
    cfg["model"]["canonical_depth_width"] = face
    raw, geo = synthetic_batch(b, face=face, lip_h=lip_h, lip_w=lip_w)
    box = tf.expanded_lip_box(lip_h, lip_w, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window([raw["coord"][i] for i in range(b)], box,
                                 face, face, margin=16)
    p, up, us = (cast_tree(t, dev, dt) for t in weights.random_params(
        0, cfg=cfg))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    lx, ly = geo["lip_x"], geo["lip_y"]
    comp_in = [batch[k].to(dt) for k in ("rgb_face_zero", "rgb_face_ori",
                                         "mask_lip_canonical")]
    # the composite's and the U-Net's inputs: those of the plain render
    with torch.no_grad():
        lip = render_lip_batch(p, batch["audio"], batch["index"].float(),
                               lip_h, lip_w, compute_dtype=dt).to(dt)
        x = tf.post_fusion_composite(lip, *comp_in, batch["coord"], lx, ly,
                                     window=window)[0].to(dt)

    def full(k):
        return lambda: render_face_batch(
            p, up, us, batch, lip_x=lx, lip_y=ly, lip_h=lip_h, lip_w=lip_w,
            use_kernels=k, compute_dtype=dt, window=window)["face"]

    def mlp(k):
        return lambda: render_lip_batch(p, batch["audio"],
                                        batch["index"].float(), lip_h,
                                        lip_w, use_kernels=k,
                                        compute_dtype=dt)

    def comp(k):
        return lambda: tf.post_fusion_composite(
            lip, *comp_in, batch["coord"], lx, ly, window=window,
            use_kernels=k)[0]

    unet_plain = lambda: unet_light.apply(up, us, x)[0]
    unet = ((lambda: unet_light.apply_infer_fused(up, us, x)) if on_card
            else unet_plain)
    stages = {"full render": (full(on_card), full(False)),
              "lip MLP": (mlp(on_card), mlp(False)),
              "composite": (comp(on_card), comp(False)),
              "U-Net": (unet, unet_plain),
              "U-Net plain": (unet_plain, None)}
    return SimpleNamespace(device=dev, batch=b, dtype=dt, face=face,
                           stages=stages)


def _best_ms(fn, dev) -> float:
    """Best of ``REPEATS`` means over ``ITERS`` calls, after a warm-up."""
    fn()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(REPEATS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            ms = start.elapsed_time(end) / ITERS
        else:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                fn()
            ms = 1e3 * (time.perf_counter() - t0) / ITERS
        best = min(best, ms)
    return best


def run(bench: SimpleNamespace) -> dict:
    """{stage: {"ms", "launches"}} of the kernel calls, printed as the
    JAX tool prints them."""
    rows = {}
    with torch.no_grad():
        for name in STAGES:
            fn = bench.stages[name][0]
            ms = _best_ms(fn, bench.device)
            before = launch_counts()
            fn()
            if bench.device.type == "cuda":
                torch.cuda.synchronize(bench.device)
            after = launch_counts()
            rows[name] = {"ms": ms, "launches": {
                k: after[k] - before[k] for k in after}}
    b = bench.batch
    print(f"# batch {b}, {str(bench.dtype).split('.')[-1]}, face "
          f"{bench.face}^2, device {bench.device}", flush=True)
    full = rows["full render"]["ms"]
    print(f"full render   : {full:7.2f} ms/batch ({b / full * 1e3:6.1f} "
          "fps)", flush=True)
    print(f"  lip MLP     : {rows['lip MLP']['ms']:7.2f} ms", flush=True)
    print(f"  composite   : {rows['composite']['ms']:7.2f} ms", flush=True)
    print(f"  U-Net       : {rows['U-Net']['ms']:7.2f} ms  (plain cuDNN "
          f"forward: {rows['U-Net plain']['ms']:.2f} ms)", flush=True)
    print("# launches per call: " + "; ".join(
        f"{k} {v['launches']}" for k, v in rows.items()), flush=True)
    return rows


def main(argv=None, size=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    from speech2lip_tpu_torch.infer.renderer import resolve_device
    return run(build(resolve_device(args.device), size))


if __name__ == "__main__":
    main()
