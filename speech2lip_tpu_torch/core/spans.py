"""Host spans of the port's own work: a serving batch by stage, a training
batch's host assembly by part and a train step by part.

``span(name)`` is a context manager around one piece of host work.  Tracing
is off by default, and then ``span`` returns one shared object that does
nothing: no allocation, no clock read, no lock.  ``enable()`` turns it on;
each span then records ``Record(id, parent_id, name, start_ns, end_ns,
thread_id)`` on ``time.perf_counter_ns``.  The parent is the innermost span
still open on the same thread (``None`` for a root), so the spans of one
batch or step hang under one root.  ``records()`` returns what was
recorded and ``clear()`` drops it; nothing is written to disk.

A span reads the host clock alone: it never synchronises the device and
never touches a tensor, so on the card it measures the host's enqueue and
blocking, not the device's work.

The spans, by root:

- ``render``: one batch of ``infer.renderer.Renderer`` or
  ``infer.static_scene.StaticSceneRenderer``; children ``render.lip`` (the
  audio encoder, the frame features, the uv embedding and the lip MLP),
  ``render.composite`` (the paste and blend with the windowed warp) and
  ``render.unet`` (the post-fusion U-Net; on the static scene also the
  crop and the paste into the static face).  On a batch that replays the
  renderer's CUDA graphs (``infer.graphs``) each child holds its stage's
  replay, and the root the input copies and the output copies.
- ``build``: one batch's host assembly in ``train.trainer.batch_iterator``;
  children ``build.read`` (a frame's lip JPEG, face JPEG and coord grid,
  or the wait for them from the prefetcher), ``build.warp`` (the two
  black-hole warps), ``build.sync_extras`` (the sync loss's windows) and
  ``build.stack`` (the collation).
- ``build.copy``: ``train.trainer.to_device``, a root of its own.
- ``step``: one call of the step of ``train.train_step.make_train_step``;
  children ``step.forward`` (the losses), ``step.backward`` (the
  gradients) and ``step.update`` (twice a step: the gradients' mean, the
  metrics and the gradient norm, then Adam and the new leaves).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional


class Record(NamedTuple):
    id: int
    parent_id: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    thread_id: int


_enabled = False
_records: List[Record] = []
_ids = itertools.count(1)
_open = threading.local()


class _Off:
    """The span of a disabled tracer."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent_id", "start_ns", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent_id = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.stack = stack
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        _records.append(Record(self.id, self.parent_id, self.name,
                               self.start_ns, end, threading.get_ident()))
        return False


def span(name: str):
    """A context manager that records ``name``'s host interval while
    tracing is on, and does nothing while it is off."""
    if not _enabled:
        return _OFF
    return _Span(name)


def enable(on: bool = True) -> None:
    """Turn tracing on (or off, with ``on=False``)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def records() -> List[Record]:
    """The spans recorded since the last ``clear``, in the order they
    ended."""
    return list(_records)


def clear() -> None:
    _records.clear()
