"""Everything the harness finds by name.

``BENCHMARK.json`` (the checkout's root) names each cell's configuration
and traffic mix and the metrics of each cell; each of those has files of
its own under ``portbench/``, found by that name:

- ``configs/<config>.json``: the configuration as it is run (the
  ``file`` of its ``configs`` entry);
- ``workloads/<traffic>.json``: the traffic mix, parameters that one
  driver (its ``driver`` key: a module of ``portbench/drivers``) reads;
- ``limits/<cell>.json``: the limit of each number ``correct`` compares;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  and the program's counter it reads, if any (``COUNTER``); also the
  reader of an end-to-end metric whose ``source`` is ``device_trace``;
- the configuration's ``reference`` key: the plain reference module that
  its cells are checked against, a path from the checkout's root
  (``reference_module``).

A later cell, configuration or metric is new files and entries, never an
edit of a file here.  A training configuration also states its stage: its
``start_iter`` (the iteration its statics are built at, 0 where absent:
past ``sync_start_iter`` the sync loss is on, past
``postnet_freeze_iter`` the U-Net frozen), its ``weights`` draw
(``traffic/weights.py``: ``init`` where absent, ``served`` for a trained
model) and its ``reference`` module (``reference/train.py`` says what such
a module provides).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parents[1]      # portbench/
ROOT = HERE.parent                              # the checkout


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


class Cell:
    """One ``workloads`` entry of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, bench: Dict[str, Any], root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        confs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = confs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(root / "portbench" / "workloads"
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(root / "portbench" / "limits"
                                / f"{name}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = _for_cell(bench["end_to_end"], name)
        self.per_layer = _for_cell(bench["per_layer"], name)
        self.root = root
        # what a run writes once per checkout (the training identity)
        self.build_dir = root / "build" / "portbench"


def _for_cell(metrics: List[Dict[str, Any]], cell: str):
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, root: Path = ROOT):
    """``portbench/metrics/<name>.py``: its ``read(ctx)`` and, where the
    metric reads one of the program's counters, ``COUNTER``."""
    return _load(root / "portbench" / "metrics" / f"{name}.py",
                 "portbench_metric_" + name)


def reference_module(path: str, root: Path = ROOT):
    """The reference module at ``path`` (from the checkout's root, as a
    configuration's ``reference`` key names it)."""
    return _load(root / path, "portbench_reference_" + Path(path).stem)
