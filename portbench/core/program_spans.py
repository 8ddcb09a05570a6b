"""The program's own spans (``speech2lip_tpu_torch.core.spans``) in a traced
window: self time and device-idle time by span name.

Importing this module turns the program's tracing on.  The harness loads
the metric readers, which import it, only for a traced run, after set-up
and before the window, so an untraced run records nothing.  A program
without the span module records nothing either, and every reading is then
``None``.

The spans are on ``time.perf_counter_ns``, the clock of the harness's
``Recorder``, which the trace's two marker kernels pin to the device's
clock; so a device-idle gap of the window is put down to the program span
the host was in at the gap's midpoint, as ``Trace.idle_gaps`` does with the
harness's own spans.  Kept: the spans of the main thread, the one that
enqueues the work, that start inside the window.  A window's spans are
reduced once for all its readers and then cleared, so they do not pile up
across runs in one process.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench.core import trace as T

try:
    from speech2lip_tpu_torch.core import spans
except ImportError:          # a program that records no spans
    spans = None
else:
    spans.enable()


class Window:
    """One window's program spans, reduced: ``self_us`` and ``idle_us``
    by span name."""

    def __init__(self, records, tr):
        """records: (id, parent_id, name, start_ns, end_ns, thread_id);
        tr: the window's ``Trace`` (host clock in µs)."""
        main = threading.main_thread().ident
        w0, w1 = tr.window
        us = [(r[0], r[1], r[2], r[3] / 1e3, r[4] / 1e3) for r in records
              if r[5] == main]
        kids: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
        for _, parent, _, s, e in us:
            if parent is not None:
                kids[parent].append((s, e))
        self.spans = [(i, n, s, e) for i, _, n, s, e in us if w0 <= s <= w1]
        self.self_us: Dict[str, float] = defaultdict(float)
        for i, n, s, e in self.spans:
            self.self_us[n] += self_time(s, e, kids.get(i, ()))
        self.idle_us: Dict[str, float] = defaultdict(float)
        held = sorted((s, e, n) for _, n, s, e in self.spans)
        for s, e in idle_gaps(tr):
            name = T._innermost(held, 0.5 * (s + e))
            if name is not None:
                self.idle_us[name] += e - s


def self_time(start: float, end: float, children) -> float:
    """A span's duration less the part of it its children's intervals
    cover (overlaps counted once)."""
    covered = sum(b - a for a, b in T._union(
        [(max(a, start), min(b, end)) for a, b in children
         if b > start and a < end]))
    return (end - start) - covered


def idle_gaps(tr) -> List[Tuple[float, float]]:
    """The window's intervals (µs) that no device activity covers."""
    w0, w1 = tr.window
    gaps, t = [], w0
    for s, e in tr.union:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


_reduced: Dict[Tuple[float, float], Optional[Window]] = {}


def window(ctx) -> Optional[Window]:
    """The traced window's program spans, reduced once; None where the
    program recorded no span in the window."""
    tr = ctx.get("trace")
    if tr is None or spans is None:
        return None
    key = tuple(tr.window)
    if key not in _reduced:
        _reduced.clear()
        w = Window(spans.records(), tr)
        spans.clear()
        _reduced[key] = w if w.spans else None
    return _reduced[key]


def self_ms(ctx, name: str, per: str) -> Optional[float]:
    """Self time of the spans called ``name`` in ms per ``ctx[per]``
    (the window's batches or iterations); 0.0 where the window holds
    spans but none of that name."""
    w, n = window(ctx), ctx.get(per)
    if w is None or not n:
        return None
    return w.self_us.get(name, 0.0) / 1e3 / n


def idle_ms(ctx, name: str, per: str) -> Optional[float]:
    """Device-idle time while the host was in a span called ``name``
    (innermost), in ms per ``ctx[per]``; None where the trace holds no
    device activity."""
    w, n, tr = window(ctx), ctx.get(per), ctx.get("trace")
    if w is None or not n or tr.busy_s <= 0:
        return None
    return w.idle_us.get(name, 0.0) / 1e3 / n
