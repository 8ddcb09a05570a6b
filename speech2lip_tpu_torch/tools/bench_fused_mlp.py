"""Time K1 (``fused_mlp``) at the renderer's and ``render_pixels``' shapes
on the card.

    python -m speech2lip_tpu_torch.tools.bench_fused_mlp

Two cases, bfloat16, random weights from a seed (``weights.random_params``):

- ``k1``: the ``Renderer``'s call, the May lip's 120x80 uv grid (9,600
  rows, Fourier features of degree 10) through 8 frames;
- ``k1b``: ``render_pixels``' call, one frame over the 4-offset ensemble
  of 9,600 seeded pixel coordinates in the rows (38,400);
- ``wave132`` and ``wave33``: one frame over 132 and 33 row tiles of 128
  (16,896 and 4,224 of the k1b rows), one wave of the bf16 kernel's
  persistent blocks on the H100's 132 SMs with every SM, or a quarter of
  them, streaming the weights from L2: equal times say the L2 is not
  what bounds a tile.

Each gets ``bench_window_sample``'s two times by CUDA events, the call time
(eager calls, dispatch included) and the device time (a CUDA graph of
calls, replayed), in turns (the order above, then reversed), each the
mean of its two turns, plus the kernel's time in a profile; and the host's enqueue time
of a call (the wrapper, the C entry and the launch, no synchronisation).
Each output is checked against ``fused_mlp_plain`` (max|diff| over
max(1, max|plain|) within 1e-2).  Prints one line per case and a JSON
line with every number and the bound of each case (its operations at the
H100's 989 TFLOP/s bf16 peak).  Runs on the card only.  The package it
times is the first ``speech2lip_tpu_torch`` on the path, named in the
JSON, so one call can time two trees in turns
(``PYTHONPATH=<tree> python <this file>``).
"""

from __future__ import annotations

import json
import time

import torch

LIP_H, LIP_W, FRAMES, OFFSETS, SEED = 80, 120, 8, 4, 0
TILE_ROWS = 128  # the bf16 kernel's row tile
PEAK_BF16 = 989e12  # NVIDIA H100 SXM, dense bf16 tensor cores
BOUND = 1e-2
ENQUEUE_CALLS = 20


def cases(dev, dtype=torch.bfloat16) -> dict:
    """{name: the fused_mlp arguments} of the cases above."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.ops.coords import get_coords
    from speech2lip_tpu_torch.ops.embedders import fourier_embed

    tp, _, _ = weights.random_params(SEED, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    trunk = tp["trunk"]
    shared = (tp["fc_uv"]["w"], tp["fc_uv_skip"]["w"],
              [l["w"] for l in trunk], [l["b"].float() for l in trunk],
              tp["output"]["w"], tp["output"]["b"].float())

    def args(uv, frames):
        base = torch.randn(frames, 256, device=dev, generator=gen)
        skip = torch.randn(frames, 256, device=dev, generator=gen)
        return (uv.contiguous(), (tp["fc_uv"]["b"].float() + base).contiguous(),
                (tp["fc_uv_skip"]["b"].float() + skip).contiguous(), *shared)

    grid = get_coords(LIP_W, LIP_H, dtype=dtype, device=dev)
    pixels = torch.rand(OFFSETS * LIP_H * LIP_W, 2, device=dev, generator=gen)
    rows = fourier_embed(pixels, 10).to(dtype)
    return {"k1": args(fourier_embed(grid, 10), FRAMES), "k1b": args(rows, 1),
            "wave132": args(rows[:132 * TILE_ROWS], 1),
            "wave33": args(rows[:33 * TILE_ROWS], 1)}


def ops(a) -> float:
    """Operations the call needs (``chip_smoke.py``'s count): the entry
    and skip projections of the N shared rows once, the trunk and the
    head per frame."""
    n, frames = a[0].shape[0], a[1].shape[0]
    return 2.0 * n * (a[3].numel() + a[4].numel()
                      + frames * (sum(w.numel() for w in a[5])
                                  + a[7].numel()))


def enqueue_ms(fn, calls: int = ENQUEUE_CALLS) -> float:
    """Host ms per call of ``calls`` calls issued with no synchronisation
    in between (the device queue is far from full)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1000.0 / calls
    torch.cuda.synchronize()
    return ms


def run() -> dict:
    import speech2lip_tpu_torch
    from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
    from speech2lip_tpu_torch.tools.bench_window_sample import in_turns

    if not torch.cuda.is_available():
        raise RuntimeError("bench_fused_mlp: no CUDA device")
    dev = torch.device("cuda")
    args = cases(dev)
    fns = {name: (lambda a=a: kmlp.fused_mlp(*a)) for name, a in args.items()}
    errs = {}
    for name, a in args.items():
        got, ref = kmlp.fused_mlp(*a), kmlp.fused_mlp_plain(*a)
        errs[name] = (float((got - ref.float()).abs().max())
                      / max(1.0, float(ref.abs().max())))
        if not (torch.isfinite(got).all() and errs[name] <= BOUND):
            raise RuntimeError(f"bench_fused_mlp: {name} off its plain "
                               f"version by {errs[name]:.3g}")
    times = in_turns(fns)
    for name, fn in fns.items():
        times[name]["enqueue_ms"] = enqueue_ms(fn)
        times[name]["bound_ms"] = ops(args[name]) / PEAK_BF16 * 1e3
    for name, t in times.items():
        prof = ("not in the trace" if t["profiled_ms"] is None
                else f"{t['profiled_ms']:.4f} ms")
        print(f"# {name}: call {t['call_ms']:.4f} ms, device (graph) "
              f"{t['device_ms']:.4f} ms, kernel in the profile {prof}, "
              f"enqueue {t['enqueue_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms", flush=True)
    return {"package": speech2lip_tpu_torch.__file__,
            "device": torch.cuda.get_device_name(0),
            "shapes": {n: [list(a[0].shape), a[1].shape[0]]
                       for n, a in args.items()},
            "rel_errors": errs, "times": times}


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
