"""Readings that the limits of ``correct`` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 2

In one process (the kernels build once), for each seed: the cell's set-up,
a short window at the cell's own load, then the numbers ``correct``
compares, of the program against the plain reference; for each control
seed also the same numbers with the reference computed one precision step
below the configuration's put in the program's place (the precision the
cell's driver names: ``fp8`` for a bfloat16 stage, ``tf32`` for a float32
one).  One JSON line a seed.  The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import run as bench_run  # noqa: E402


def driver(cell):
    """The cell's driver module: its traffic's ``driver``, a module of
    ``portbench.drivers``."""
    return importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")


def control_precision(cell) -> str:
    """The precision of the cell's control, as its driver names it: one
    step below the configuration's, or a name of the driver's own that its
    ``Session.control`` reads."""
    return driver(cell).control_precision(cell)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    bench_run._env()
    import torch
    from portbench.core import device as D
    from portbench.core import registry
    cell = registry.Cell(args.workload, registry.benchmark(ROOT), ROOT)
    D.require_cards(cell.chips)
    dev = torch.device("cuda", 0)
    mod = driver(cell)
    prec = mod.control_precision(cell)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += sorted(ctrl - set(seeds))
    for seed in seeds:
        t0 = time.perf_counter()
        sess = mod.Session(cell, seed, dev,
                           lambda name: contextlib.nullcontext())
        sess.setup()
        sess.window_run(args.seconds)
        sess.release()
        line = {"seed": seed, "program": sess.check()}
        if getattr(sess, "diag", None):
            line["program_diag"] = sess.diag
        if seed in ctrl:
            line["control"] = sess.control(prec)
            line["control_precision"] = prec
            if getattr(sess, "diag", None):
                line["control_diag"] = sess.diag
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del sess
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
