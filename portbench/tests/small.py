"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test can run: the same
configuration and traffic files, with the face, the lip crop, the batch and
the identity shrunk.  Only tests use them."""

from __future__ import annotations

import copy

import torch

from portbench.core import registry
from portbench.core.harness import untraced

SERVE = {"face": 64, "lip": (20, 30, 16, 24)}
AVATAR = {"face": 320, "lip": (128, 150, 48, 64)}  # a crop under 90%
CPU = torch.device("cpu")


def cell(name: str, face=None, lip=None, bench=None, root=registry.ROOT):
    c = registry.Cell(name, bench or registry.benchmark(root), root)
    size = AVATAR if "avatar" in name else SERVE
    face = face or size["face"]
    lip = dict(zip("xyhw", lip or size["lip"]))
    conf = copy.deepcopy(c.config)
    conf["geometry"] = {"face": face, "lip": lip}
    conf["config"]["data"]["height"] = lip["h"]
    conf["config"]["data"]["width"] = lip["w"]
    c.config = conf
    t = copy.deepcopy(c.traffic)
    if t["driver"] == "serve":
        t.update(batch=4, frames=24, warmup_batches=1,
                 check={"batches": 2, "within": 3})
    else:
        conf["identity_frames"] = 12
        t["identity"].update(face=face, lip=lip)
    c.traffic = t
    return c


def session(c, seed: int = 1234):
    import importlib
    mod = importlib.import_module(f"portbench.drivers.{c.traffic['driver']}")
    return mod.Session(c, seed, CPU, untraced)
