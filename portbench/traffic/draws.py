"""Seeds and the training step's random draws.

Every stream of a run (weights, frames, samples checked, draws, frame
order) comes from ``--seed`` through its own ``numpy.random.SeedSequence``
child, so two streams never share a generator and the same seed gives the
same run.  The step's draws follow the program's layout (the train step
takes them as tensors): the ensemble's shift ``lip.eps_u`` uniform [B], the
black-hole fields ``hole1``/``hole2`` normal [B, H, W, 1], the
augmentation's coin ``apply_u``, a uniform scalar, and in the sync stage
the window's shifts ``sync_lip.eps_u`` uniform [B * T], b-major, drawn
after the others as the step's ``draw_noise`` draws them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

STREAMS = ("weights", "frames", "check", "draws", "order", "syncnet")


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of ``stream`` for run seed ``seed`` (any integer)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64),
                                 STREAMS.index(stream)])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def step_draws(gen: torch.Generator, batch: int, face_h: int, face_w: int,
               device, blackaug: bool = True, sync_frames: int = 0
               ) -> Dict[str, Any]:
    """One step's draws; ``sync_frames`` (B * T, the sync stage's) adds
    ``sync_lip`` after the stage-1 draws."""
    kw = dict(device=device, generator=gen)
    d: Dict[str, Any] = {"lip": {"eps_u": torch.rand(batch, **kw)}}
    if blackaug:
        d["hole1"] = torch.randn(batch, face_h, face_w, 1, **kw)
        d["hole2"] = torch.randn(batch, face_h, face_w, 1, **kw)
        d["apply_u"] = torch.rand((), **kw)
    if sync_frames:
        d["sync_lip"] = {"eps_u": torch.rand(sync_frames, **kw)}
    return d
