"""Reduction of a ``torch.profiler`` trace of the measured window to the
device's busy time, kernel times by name and idle gaps by what the host
was doing.

The profiler records the device's activity alone (CUDA activity, no host
operations: recording every host operation slowed the launch-bound avatar
by a third and took seconds to read back per second of window).  The
harness's own host phases are ``Recorder`` spans on the host clock; two
marker kernels launched on an idle device at the window's edges pin that
clock to the trace's.  Busy time is the union of the device's activity
intervals (kernels, copies, sets) inside the window, so overlapping kernels
count once.  An idle gap is an interval of the window that no device
activity covers; it is named by the harness span that was running at its
midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "window"
MARKER = "spin_kernel"   # torch.cuda._sleep's kernel
MARK_CYCLES = 1000


class Recorder:
    """The harness's host spans (name, start_ns, end_ns) of a traced run;
    entering and leaving the ``window`` span launches a marker kernel on
    the idle device and notes the host time of its launch."""

    def __init__(self, device):
        self.device = device
        self.spans: List[Tuple[str, int, int]] = []
        self.window: Optional[Tuple[int, int]] = None
        self.marks: List[int] = []

    def _mark(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
            self.marks.append(time.perf_counter_ns())
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if name == WINDOW:
            self._mark()
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            if name == WINDOW:
                self.window = (t0, t1)
                self._mark()
            else:
                self.spans.append((name, t0, t1))


class Trace:
    def __init__(self, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]],
                 window: Tuple[float, float]):
        """device: (name, start_us, end_us) of each device activity;
        host: (name, start_us, end_us) of the harness's spans; window:
        (start_us, end_us) of the measured window; one clock."""
        w0, w1 = window
        self.window = window
        self.device = sorted((n, max(s, w0), min(e, w1)) for n, s, e in device
                             if e > w0 and s < w1)
        self.host = host
        self.union = _union([(s, e) for _, s, e in self.device])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union) / 1e6

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the activities whose name holds ``pattern``."""
        return sum(e - s for n, s, e in self.device if pattern in n) / 1e6

    def kernel_count(self, pattern: str) -> int:
        return sum(1 for n, _, _ in self.device if pattern in n)

    def top_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            tot[n[:160]] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle seconds of the window by the harness span running at each
        gap's midpoint."""
        w0, w1 = self.window
        gaps, t = [], w0
        for s, e in self.union:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        spans = sorted((s, e, n) for n, s, e in self.host)
        tot: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            name = _innermost(spans, 0.5 * (s + e)) or "between spans"
            tot[name] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:k]]


def _union(intervals):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(intervals, t) -> Optional[str]:
    """The name of the latest-starting interval (start, end, name) that
    holds t: the innermost of nested ones."""
    i = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    # walk back over intervals that started earlier; stop after a bounded
    # look, since host ops do not nest deeply
    for j in range(i, max(-1, i - 64), -1):
        s, e, n = intervals[j]
        if s <= t <= e:
            return n
    return None


def from_profiler(prof, rec: Recorder) -> Optional[Trace]:
    """A ``Trace`` of a finished ``torch.profiler.profile`` and the
    harness's ``Recorder``; None where the window or, on the card, its
    markers are missing."""
    from torch.autograd import DeviceType
    if rec.window is None:
        return None
    device, marks = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU or e.is_user_annotation():
            continue
        name = e.name()
        if MARKER in name:
            marks.append(e.start_ns())
        else:
            device.append((name, e.start_ns(), e.end_ns()))
    offset = 0
    if rec.marks:
        if not marks:
            return None
        offset = min(marks) - rec.marks[0]
    us = lambda t: (t - offset) / 1e3
    return Trace([(n, us(a), us(b)) for n, a, b in device],
                 [(n, a / 1e3, b / 1e3) for n, a, b in rec.spans],
                 (rec.window[0] / 1e3, rec.window[1] / 1e3))
