"""The card: the check that refuses to run without one, and what a result
says about it."""

from __future__ import annotations

import contextlib
import subprocess
import sys
from typing import Any, Dict, Optional


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> None:
    """Raise ``NoCard`` unless CUDA is available with at least ``n``
    devices: the benchmark measures the card and never the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} CUDA devices, "
                     f"{torch.cuda.device_count()} found")


@contextlib.contextmanager
def host_threads(n: Optional[int]):
    """PyTorch's intra-op pool and OpenCV's held to ``n`` CPU threads, and
    restored after; ``None`` leaves them as they are."""
    if not n:
        yield
        return
    import torch
    try:
        import cv2
    except ImportError:
        cv2 = None
    before = (torch.get_num_threads(), cv2.getNumThreads() if cv2 else None)
    torch.set_num_threads(int(n))
    if cv2:
        cv2.setNumThreads(int(n))
    try:
        yield
    finally:
        torch.set_num_threads(before[0])
        if cv2:
            cv2.setNumThreads(before[1])


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts by ``nvidia-smi``; None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(device, count: int, peak_bytes: int,
             trace=None) -> Dict[str, Any]:
    """The result's ``device`` object."""
    import torch
    d: Dict[str, Any] = {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        d["busy_s"] = trace.busy_s
        d["window_s"] = trace.window_s
    if device.type == "cuda":
        d["power_limit_w"] = power_limit_w()
    return d


class Phases:
    """Logs each set-up phase's seconds to standard error (synchronised,
    so a phase's device work counts in it)."""

    def __init__(self, device):
        import time
        self.device, self.clock = device, time.perf_counter
        self.t = self.clock()

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        t = self.clock()
        log(f"setup {name}: {t - self.t:.3f} s")
        self.t = t


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
