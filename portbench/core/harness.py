"""One run of one cell: set-up, the measured window, the metrics, the check
of what the window produced, the result's last line.

``run`` is what ``portbench/run.py`` calls after its look for the card;
tests call it on the CPU with a cell whose sizes they shrink.
"""

from __future__ import annotations

import contextlib
import importlib
import math
import sys
import time
from typing import Any, Dict

from portbench.core import device as D
from portbench.core import trace as T
from portbench.core.registry import Cell, metric_module
from portbench.reference import compare

FORBIDDEN = ("jax", "jaxlib", "flax", "speech2lip_tpu")


def forbidden_modules() -> list:
    """Loaded modules of the JAX package or JAX, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def read_counters(modules) -> Dict[str, int]:
    """The program's counters that the metric modules name (``COUNTER``,
    ``<module>:<attribute>``), as they stand now."""
    out = {}
    for mod in modules:
        key = getattr(mod, "COUNTER", None)
        if key:
            name, attr = key.split(":")
            out[key] = int(getattr(importlib.import_module(name), attr))
    return out


def device_window(cell: Cell, device) -> bool:
    """Whether a run of the cell records the device's activity over its
    window even untraced: on the card, where one of the cell's end-to-end
    metrics is read from the device trace (its ``source`` is
    ``device_trace``; its reader is ``metrics/<name>.py``)."""
    return device.type == "cuda" and any(
        m["source"] == "device_trace" for m in cell.end_to_end)


def untraced(name: str):
    """The harness's span outside a traced run: nothing."""
    return contextlib.nullcontext()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict[str, Any]:
    """The result object of one run (not printed).  A traffic mix's
    ``host_threads`` holds the CPU thread pools to that many threads."""
    with D.host_threads(cell.traffic.get("host_threads")):
        return _run(cell, seed, seconds, trace, device, t_start)


def _run(cell: Cell, seed: int, seconds: float, trace: bool, device,
         t_start: float) -> Dict[str, Any]:
    import torch
    mod = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    # a traced run reads the per-layer metrics; an untraced one its
    # end-to-end metrics, those of the device trace by their readers
    recorded = trace or device_window(cell, device)
    rec = T.Recorder(device) if recorded else None
    sess = mod.Session(cell, seed, device, rec or untraced)
    D.log(f"setup start, imports and device: "
          f"{time.perf_counter() - t_start:.3f} s")
    sess.setup()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    prof = None
    wanted = (cell.per_layer if trace else
              [m for m in cell.end_to_end if m["source"] == "device_trace"])
    readers = ({m["name"]: metric_module(m["name"], cell.root)
                for m in wanted} if recorded else {})
    counted = read_counters(readers.values())
    if recorded:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                   else ProfilerActivity.CPU])
        prof.__enter__()
    try:
        sess.window_run(seconds)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    counters = {k: v - counted[k] for k, v in
                read_counters(readers.values()).items()}
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    peak = max(setup_peak, window_peak) if cuda else 0

    tr = T.from_profiler(prof, rec) if prof is not None else None
    metrics: Dict[str, Dict[str, Any]] = {}
    ctx: Dict[str, Any] = {}
    if recorded:
        ctx = sess.context()
        ctx.update(trace=tr, window_peak_bytes=window_peak, cell=cell.name,
                   counters=counters)
    if not trace:
        e2e = dict(sess.end_to_end(), setup_s=setup_s)
        for k, v in e2e.items():
            D.log(f"window {k} {v:.6g}")
        for m in cell.end_to_end:
            v = e2e.get(m["name"])
            if v is None and m["name"] in readers:
                v = readers[m["name"]].read(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    sess.release()
    numbers = sess.check()
    checks = compare.judge(numbers, cell.limits)
    out: Dict[str, Any] = {
        "correct": compare.passed(checks),
        "attempted": int(sess.attempted()),
        "failed": 0,
        "metrics": metrics,
        "device": D.describe(device, cell.chips, peak,
                             tr if trace else None),
    }
    if trace and tr is not None:
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out


def report_checks(checks: Dict[str, Dict[str, float]]) -> None:
    """Each compared number beside its limit, as the last lines of
    standard error."""
    for k, c in checks.items():
        D.log(f"check {k} {c['value']:.6g} limit {c['limit']:.6g} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")
