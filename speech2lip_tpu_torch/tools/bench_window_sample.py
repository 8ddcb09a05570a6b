"""Time K2 (window_sample) beside F.grid_sample and the composite's window
sample, at May geometry on the card.

    python -m speech2lip_tpu_torch.tools.bench_window_sample

May geometry: a 500x500 face, the 120x80 lip's expanded box, batch 8, the
warp window of ``compute_warp_window(margin=16)`` on the synthetic batch's
coord grid; the source is a seeded bfloat16 frame.  Three functions:

- ``kernel``: ``window_sample`` on the box's crop and the window's grid,
  both as contiguous copies made outside the timed call;
- ``library``: ``F.grid_sample`` on the crop as a float32 NCHW copy, the
  grid renormalised to it (one dtype for source and grid; made outside
  the timed call), bilinear, zeros outside;
- ``composite``: ``talking_face._sample_box_region`` with the kernels on,
  as the ``Renderer``'s composite calls it: the frame and the coord grid
  as they come, so whatever the port copies before its launch is timed.

Each gets two times, both by CUDA events:
- the call time: ``CALLS`` eager calls between two events, over the count,
  so the host's dispatch is in it when it is slower than the device;
- the device time: one CUDA graph capturing ``GRAPH_CALLS`` calls,
  replayed between two events, over the count.

They are taken in turns, kernel, library, composite, then composite,
library, kernel, and each is the mean of its two turns.  A profiler pass
over eager calls adds each function's kernel time from the trace.

Prints one line per function and a JSON line with every number.  Runs on
the card only.  The package it times is the first ``speech2lip_tpu_torch``
on the path; the JSON names its file, so the same script can time two
trees in turns (``PYTHONPATH=<tree> python <this file>``).
"""

from __future__ import annotations

import json

import torch

FACE, LIP_H, LIP_W, MARGIN, BATCH, SEED = 500, 80, 120, 16, 8, 0
CALLS = 20         # eager calls per call-time reading
GRAPH_CALLS = 100  # calls captured in one graph per device-time reading


def call_ms(fn, iters: int = CALLS, warmup: int = 2) -> float:
    """Mean ms per call of ``iters`` eager calls between two CUDA events."""
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


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = 3) -> float:
    """Device ms per call: one CUDA graph of ``calls`` calls of ``fn``,
    replayed ``replays`` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def profiled_ms(fn, calls: int = CALLS) -> float:
    """Device ms per call from torch.profiler: the summed durations of the
    kernels ``calls`` eager calls launch, over the count (None when the
    trace holds no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            total += e.self_cuda_time_total if t is None else t
    return total / 1000.0 / calls if total else None


def in_turns(fns: dict) -> dict:
    """{name: {"call_ms", "device_ms", "profiled_ms"}}: call and device
    time in the order of ``fns``, then in the reverse order, averaged."""
    names = list(fns)
    got = {n: {"call_ms": [], "device_ms": []} for n in names}
    for order in (names, names[::-1]):
        for n in order:
            got[n]["call_ms"].append(call_ms(fns[n]))
            got[n]["device_ms"].append(graph_ms(fns[n]))
    return {n: {"call_ms": sum(v["call_ms"]) / 2,
                "device_ms": sum(v["device_ms"]) / 2,
                "call_ms_turns": v["call_ms"],
                "device_ms_turns": v["device_ms"],
                "profiled_ms": profiled_ms(fns[n])}
            for n, v in got.items()}


def crop_grid(grid, y_off, x_off, h, w, hs, ws):
    """grid [B, P, 2] normalised to the full h x w image (align_corners
    False), renormalised to the [hs, ws] crop at (y_off, x_off): [B, 1, P,
    2] for F.grid_sample."""
    ix = ((grid[..., 0] + 1) * w - 1) / 2 - x_off
    iy = ((grid[..., 1] + 1) * h - 1) / 2 - y_off
    return torch.stack([(2 * ix + 1) / ws - 1, (2 * iy + 1) / hs - 1],
                       -1)[:, None]


def may_inputs(dev, dtype=torch.bfloat16):
    """(frame [B, FACE, FACE, 3] in dtype, coord [B, FACE, FACE, 2]
    float32, box, window) at May geometry."""
    from speech2lip_tpu_torch.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch.data.windows import compute_warp_window
    from speech2lip_tpu_torch.models import talking_face as tf

    raw, geo = synthetic_batch(BATCH, face=FACE, lip_h=LIP_H, lip_w=LIP_W,
                               seed=SEED)
    box = tf.expanded_lip_box(LIP_H, LIP_W, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window([raw["coord"][i] for i in range(BATCH)],
                                 box, FACE, FACE, margin=MARGIN)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frame = torch.rand(BATCH, FACE, FACE, 3, device=dev,
                       generator=gen).to(dtype)
    coord = torch.from_numpy(raw["coord"]).to(dev)
    return frame, coord, box, window


def run(dtype=torch.bfloat16) -> dict:
    import torch.nn.functional as F

    import speech2lip_tpu_torch
    from speech2lip_tpu_torch.models import talking_face as tf
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws

    if not torch.cuda.is_available():
        raise RuntimeError("bench_window_sample: no CUDA device")
    dev = torch.device("cuda")
    frame, coord, box, window = may_inputs(dev, dtype)
    x0b, x1b, y0b, y1b = box
    wy0, wx0, wh, ww = window
    crop = frame[:, y0b - 1:y1b + 1, x0b - 1:x1b + 1]
    grid_w = coord[:, wy0:wy0 + wh, wx0:wx0 + ww]
    src = crop.contiguous()
    grid = grid_w.reshape(BATCH, wh * ww, 2).contiguous()
    geom = (y0b - 1, x0b - 1, FACE, FACE)
    src32 = src.float().permute(0, 3, 1, 2).contiguous()
    g4 = crop_grid(grid, *geom, *src.shape[1:3])
    fns = {
        "kernel": lambda: kws.window_sample(src, grid, *geom),
        "library": lambda: F.grid_sample(src32, g4, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=False),
        "composite": lambda: tf._sample_box_region(
            frame, grid_w, box, FACE, FACE, use_kernels=True),
    }
    out = fns["kernel"]()
    ref = kws.window_sample_plain(src, grid, *geom)
    lib = fns["library"]()[:, :, 0].transpose(1, 2)
    comp = fns["composite"]().reshape(out.shape)
    torch.cuda.synchronize()
    errs = {"kernel_vs_plain": float((out.float() - ref.float()).abs().max()),
            "kernel_vs_library": float((out.float() - lib).abs().max()),
            "composite_vs_kernel": float((comp.float()
                                          - out.float()).abs().max())}
    times = in_turns(fns)
    result = {
        "package": speech2lip_tpu_torch.__file__,
        "device": torch.cuda.get_device_name(0),
        "dtype": str(dtype).split(".")[1],
        "crop": list(src.shape), "window": list(window),
        "points": BATCH * wh * ww, "errors": errs, "times": times}
    for name, t in times.items():
        prof = ("not in the trace" if t["profiled_ms"] is None
                else f"{t['profiled_ms']:.4f} ms")
        print(f"# {name}: call {t['call_ms']:.4f} ms, device (graph) "
              f"{t['device_ms']:.4f} ms, kernels in the profile {prof}",
              flush=True)
    return result


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
