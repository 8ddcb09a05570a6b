"""CUDA graphs of a serving batch: each render stage captured once per input
key and replayed, so the card no longer waits on the host's launches.

A renderer writes its batch once, as a body ``body(stage, inputs) ->
outputs`` whose device work all runs inside ``with stage(name):`` blocks
(``render.lip``, ``render.composite``, ``render.unet``).  Run eagerly, the
body gets ``spans.span`` as ``stage``.  ``StageGraphs`` runs the same body
once under capture, each block into a CUDA graph of its own (one memory
pool for the three, captured in order), and from then on replays the
graphs in those spans: the same kernels on the same values in the same
order, launched once.

When a graph engages (``plan``): only on a CUDA device; the key is taken
from the input itself (``input_key``: the shapes and dtypes of the batch's
tensors, plus the renderer's static values such as the lip offset).  The
first call with a key runs eagerly; the second consecutive call with it
captures and replays; later calls with it replay.  A call with another key
runs eagerly, and a new key replaces the held graphs only once it arrives
on two consecutive calls.  So a stream of equal batches replays, and a
ragged last batch runs eagerly without evicting them.

Static inputs: every replayed call copies its inputs into buffers in the
dtype the body's first op casts them to (``dtypes``), so the copy replaces
that cast (``copy_`` rounds as ``.to`` does) and the body's cast is then a
no-op.  Outputs are copied out of the pool, so a later replay never
overwrites what an earlier call returned.

Counters: ``replays`` counts the batches served by a replay, ``captures``
the keys captured.  A replay runs no Python, so each stage's replay
advances the kernels' ``launches`` counters by what its capture added to
them (the capture itself launches nothing, so it leaves them as they
were).  A ``StageGraphs`` serves one call at a time.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import torch

from speech2lip_tpu_torch.core import spans
from speech2lip_tpu_torch.ops.kernels import (fused_block, fused_mlp,
                                              window_sample)

replays = 0   # batches served by a replay of their stages' graphs
captures = 0  # input keys whose stage graphs were captured

# the kernel launch counters a serving batch advances
_COUNTERS = ((fused_mlp, "launches"), (window_sample, "launches"),
             (fused_block, "launches"))

EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"


def plan(held, last, key) -> str:
    """What a call with ``key`` does, given the key whose graphs are held
    (None: none) and the previous call's key: ``REPLAY`` the held graphs,
    ``CAPTURE`` new ones (the second consecutive call of a key not held),
    or run ``EAGER``."""
    if key == held:
        return REPLAY
    if key == last:
        return CAPTURE
    return EAGER


def input_key(inputs: Dict[str, Any], *static) -> tuple:
    """The key of a call: each input's name, shape and dtype (tensors or
    arrays), then ``static`` (values the body reads as Python numbers)."""
    return tuple((k, tuple(v.shape), str(v.dtype))
                 for k, v in inputs.items()) + static


def _counts():
    return [getattr(mod, attr) for mod, attr in _COUNTERS]


class StageGraphs:
    """One key's stage graphs of a renderer on ``device``; eager on any
    device but CUDA."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on = self.device.type == "cuda"
        self.held = None      # the key whose graphs are held
        self.last = None      # the previous call's key
        self._graphs = []     # [(span name, CUDAGraph, launch deltas)]
        self._static: Dict[str, torch.Tensor] = {}
        self._outputs: Dict[str, torch.Tensor] = {}
        self._pool = None

    def __call__(self, key, inputs: Dict[str, Any],
                 dtypes: Dict[str, Optional[torch.dtype]],
                 body: Callable) -> Dict[str, torch.Tensor]:
        """``body(stage, inputs)`` for this call, eagerly or by replay.
        inputs: name -> tensor or array; dtypes: name -> the dtype its
        static buffer holds (None: the input's own)."""
        global replays
        action = plan(self.held, self.last, key) if self.on else EAGER
        self.last = key
        if action == EAGER:
            return body(spans.span, inputs)
        src = {k: torch.as_tensor(v) for k, v in inputs.items()}
        if action == CAPTURE:
            self._capture(key, src, dtypes, body)
        for k, v in src.items():
            self._static[k].copy_(v)
        for name, graph, deltas in self._graphs:
            with spans.span(name):
                graph.replay()
            for (mod, attr), d in zip(_COUNTERS, deltas):
                setattr(mod, attr, getattr(mod, attr) + d)
        replays += 1
        return {k: v.clone() for k, v in self._outputs.items()}

    def _capture(self, key, src, dtypes, body) -> None:
        global captures
        self.held, self._graphs, self._outputs = None, [], {}
        self._static = {k: torch.empty(v.shape, device=self.device,
                                       dtype=dtypes.get(k) or v.dtype)
                        for k, v in src.items()}
        self._pool = torch.cuda.graph_pool_handle()
        self._outputs = body(self._capturing, self._static)
        self.held = key
        captures += 1

    @contextlib.contextmanager
    def _capturing(self, name: str):
        """The ``stage`` of a capture: the block becomes a graph of its
        own in the shared pool; the launch counters it advanced are put
        back and kept as its replays' deltas."""
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                yield
        finally:
            deltas = [a - b for a, b in zip(_counts(), before)]
            for (mod, attr), b in zip(_COUNTERS, before):
                setattr(mod, attr, b)
        self._graphs.append((name, graph, deltas))
