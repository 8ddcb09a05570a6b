"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test can run: the same
configuration and traffic files, shrunk by the rule of the cell's driver
(its module's ``small``).  Only tests use them."""

from __future__ import annotations

import torch

from portbench.calibrate import driver
from portbench.core import registry
from portbench.core.harness import untraced

CPU = torch.device("cpu")


def cell(name: str, bench=None, root=registry.ROOT):
    c = registry.Cell(name, bench or registry.benchmark(root), root)
    c.config, c.traffic = driver(c).small(c.config, c.traffic)
    return c


def session(c, seed: int = 1234):
    return driver(c).Session(c, seed, CPU, untraced)
