"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  Builds its inputs and weights from ``--seed``, warms up (set-up,
reported as ``setup_s``), measures for ``--seconds``, then checks what the
window produced against the plain reference.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones read from a profiler trace of the window), ``device`` and,
traced, ``breakdown``; the compared numbers with their limits come last,
under ``checks``, and again as the last lines of standard error.  Without
the card, or with fewer cards than the cell needs, it exits non-zero and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench" / "cache"


def _env() -> None:
    """Fixed cache directories inside the checkout, before torch loads."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("USE_FLAX", "0")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    from portbench.core import device as D
    from portbench.core import harness, registry
    cell = registry.Cell(args.workload, registry.benchmark(ROOT), ROOT)
    try:
        D.require_cards(cell.chips)
    except D.NoCard as e:
        D.log(f"portbench: {e}")
        return 3
    import torch
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), dev,
                      T_START)
    bad = harness.forbidden_modules()
    if bad:
        D.log(f"portbench: the run loaded {bad}; the benchmark measures the "
              "PyTorch port alone")
        return 4
    print(json.dumps(out), flush=True)
    harness.report_checks(out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
