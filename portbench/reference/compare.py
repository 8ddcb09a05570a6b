"""The numbers ``correct`` compares: gaps between what the program produced
and what the plain reference computes from the same inputs."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import torch


def rms_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst frame's ||got - ref|| / ||ref|| (frames on axis 0)."""
    if got is None or got.shape != ref.shape:
        return math.inf
    got, ref = got.float(), ref.float()
    d = (got - ref).flatten(1).norm(dim=1)
    n = ref.flatten(1).norm(dim=1).clamp_min(1e-30)
    v = float((d / n).max())
    return v if math.isfinite(v) else math.inf


def max_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|."""
    if got is None or got.shape != ref.shape:
        return math.inf
    got, ref = got.float(), ref.float()
    v = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    return v if math.isfinite(v) else math.inf


def rms_ratio(got, ref, base) -> float:
    """The worst frame's ||got - ref|| over ||base - ref||: the gap to the
    float32 reference in units of the gap that the configuration's own
    rounding (``base``, the reference computed in it) makes there."""
    if got is None or got.shape != ref.shape:
        return math.inf
    ref = ref.float()
    d = (got.float() - ref).flatten(1).norm(dim=1)
    n = (base.float() - ref).flatten(1).norm(dim=1).clamp_min(1e-30)
    v = float((d / n).max())
    return v if math.isfinite(v) else math.inf


def max_ratio(got, ref, base) -> float:
    """max |got - ref| over max |base - ref|."""
    if got is None or got.shape != ref.shape:
        return math.inf
    ref = ref.float()
    v = float((got.float() - ref).abs().max()
              / (base.float() - ref).abs().max().clamp_min(1e-30))
    return v if math.isfinite(v) else math.inf


def worst(values: Iterable[float]) -> float:
    vals: List[float] = list(values)
    return max(vals) if vals else math.inf


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """{name: {value, limit}} of every limit; a number the run did not
    produce reads inf."""
    return {k: {"value": float(numbers.get(k, math.inf)),
                "limit": float(lim)} for k, lim in limits.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())
