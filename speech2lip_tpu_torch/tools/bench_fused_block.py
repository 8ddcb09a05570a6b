"""Time K3 (``fused_block``) conv by conv at the serving cells' shapes on
the card.

    python -m speech2lip_tpu_torch.tools.bench_fused_block [--iters N]

Two geometries, bfloat16, the U-Net's block weights from a seed
(``weights.random_params``):

- ``dub``: batch 32 at 500 x 500 (the ``Renderer``'s full frame);
- ``avatar``: batch 8 at 268 x 320 (the static scene's crop at May's lip
  box).

Each of the five blocks is two launches of the conv kernel, as
``fused_block`` makes them: conv1 reads the concat of x and the upsampled
source, conv2 writes the 2x2 pool.  Each of the ten launches is timed
alone by CUDA events around a CUDA graph of ``--iters`` launches, replayed
(device time, no dispatch), and its rate is its 2 x 9 x cin x cout
operations a pixel over that time.  Each block's output through
``fused_block`` is checked against ``fused_block_plain`` on two images
(max|diff| over max(1, max|plain|) within 1e-2).  Prints one line per conv
and per geometry (the ten convs' sum, its share of the 989 TFLOP/s bf16
peak) and a JSON line with every number.  Runs on the card only.  The
package it times is the first ``speech2lip_tpu_torch`` on the path, named
in the JSON, so one call can time two trees in turns (``PYTHONPATH=<tree>
python <this file>``).
"""

from __future__ import annotations

import argparse
import json

import torch

GEOMETRIES = {"dub": (32, 500, 500), "avatar": (8, 268, 320)}
# (block, level, cin of x, cin of the upsampled source, pool); level l is
# the input's size halved l times
BLOCKS = [("inc", 0, 3, 0, True), ("down1", 1, 64, 0, True),
          ("down2", 2, 128, 0, False), ("up1", 1, 128, 128, False),
          ("up2", 0, 64, 64, False)]
PEAK_BF16 = 989e12  # NVIDIA H100 SXM, dense bf16 tensor cores
BOUND = 1e-2
SEED = 0


def convs(dev, b, h, w):
    """[(name, launch, ops, block)] of the ten convs at batch b on h x w:
    ``launch()`` runs the conv kernel once; ``block`` is the block's
    ``(args, kwargs)`` for ``fused_block`` (on the conv1 entry)."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.ops.kernels import _build
    from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
    from speech2lip_tpu_torch.ops.kernels.conv_block import fold_bn

    dt = torch.bfloat16
    _, up, us = weights.random_params(SEED, device=dev, dtype=dt)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fn = _build.library().conv3x3_bn_relu_bf16
    out = []
    for name, lv, cx, cl, pool in BLOCKS:
        p, s = up[name], us[name]
        s1, b1 = fold_bn(p["bn1"], s["bn1"])
        s2, b2 = fold_bn(p["bn2"], s["bn2"])
        hh, ww = h >> lv, w >> lv
        x = torch.rand(b, hh, ww, cx, device=dev, generator=gen).to(dt)
        lo = (torch.rand(b, hh // 2, ww // 2, cl, device=dev,
                         generator=gen).to(dt) if cl else None)
        w1, w2 = p["conv1"]["w"].contiguous(), p["conv2"]["w"].contiguous()
        cmid, cout = w1.shape[3], w2.shape[3]
        mid = torch.empty(b, hh, ww, cmid, device=dev, dtype=dt)
        o = torch.empty(b, hh, ww, cout, device=dev, dtype=dt)
        po = (torch.empty(b, hh // 2, ww // 2, cout, device=dev, dtype=dt)
              if pool else None)
        a1 = (x, lo, w1, s1.float(), b1.float(), mid, None)
        a2 = (mid, None, w2, s2.float(), b2.float(), o, po)
        px = b * hh * ww
        block = ((x, w1, s1.float(), b1.float(), w2, s2.float(), b2.float()),
                 dict(up=lo, pool=pool))
        out.append((f"{name}.1", lambda a=a1: kfb._launch(fn, *a),
                    2.0 * px * 9 * (cx + cl) * cmid, block))
        out.append((f"{name}.2", lambda a=a2: kfb._launch(fn, *a),
                    2.0 * px * 9 * cmid * cout, None))
    return out


def device_ms(launch, iters: int) -> float:
    """Device time of one launch: a CUDA graph of ``iters`` launches,
    replayed once to warm up, then timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            launch()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(block) -> float:
    """fused_block against fused_block_plain on the block's first two
    images; the error relative to max(1, max|plain|)."""
    from speech2lip_tpu_torch.ops.kernels import fused_block as kfb

    args, kw = block
    args = tuple(t[:2] if i == 0 else t for i, t in enumerate(args))
    kw = dict(kw, up=None if kw["up"] is None else kw["up"][:2])
    got, ref = kfb.fused_block(*args, **kw), kfb.fused_block_plain(*args, **kw)
    pairs = zip(got, ref) if kw["pool"] else [(got, ref)]
    err = 0.0
    for g, r in pairs:
        g, r = g.float(), r.float()
        err = max(err, float((g - r).abs().max())
                  / max(1.0, float(r.abs().max())))
    return err


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    import speech2lip_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_fused_block needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    res = {"package": speech2lip_tpu_torch.__file__,
           "device": torch.cuda.get_device_name(0), "iters": args.iters,
           "geometries": {}}
    for geo, (b, h, w) in GEOMETRIES.items():
        rows, total_ms, total_ops, worst = {}, 0.0, 0.0, 0.0
        for name, launch, ops, block in convs(dev, b, h, w):
            ms = device_ms(launch, args.iters)
            if block is not None:
                worst = max(worst, check(block))
            rows[name] = {"ms": ms, "tflops": ops / ms / 1e9}
            total_ms += ms
            total_ops += ops
            print(f"{geo} {name}: {ms:.4f} ms, {ops / ms / 1e9:.1f} TFLOP/s")
        pct = 100.0 * total_ops / PEAK_BF16 / (total_ms / 1e3)
        print(f"{geo} ten convs (b {b}, {h}x{w}): {total_ms:.4f} ms, "
              f"{total_ops / total_ms / 1e9:.1f} TFLOP/s, {pct:.2f}% of peak; "
              f"worst block error {worst:.3g} (bound {BOUND})")
        res["geometries"][geo] = {"batch": b, "h": h, "w": w, "convs": rows,
                                  "total_ms": total_ms, "peak_pct": pct,
                                  "worst_err": worst}
        if worst >= BOUND:
            raise SystemExit(f"{geo}: K3 differs from its plain version "
                             f"({worst:.3g})")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
