"""The control: the plain reference computed one precision step below the
configuration's, as the cell's driver names it (fp8 for the bfloat16
serving cells, TF32 for the float32 training cell), put in the program's
place, comes out not correct under each cell's limits, while the program
comes out correct; in every cell of ``BENCHMARK.json``.  At a size a CPU
test run holds; ``portbench/calibrate.py`` reads the same on the card at
the cells' own sizes."""

import pytest

from portbench.calibrate import control_precision
from portbench.core import registry
from portbench.reference import compare
from portbench.tests import small


@pytest.mark.parametrize(
    "name", [w["name"] for w in registry.benchmark()["workloads"]])
def test_control_is_not_correct(name, tmp_path):
    c = small.cell(name)
    c.build_dir = tmp_path
    s = small.session(c, seed=2 ** 31 + 57)
    s.setup()
    s.window_run(0.2)
    s.release()
    assert compare.passed(compare.judge(s.check(), c.limits))
    ctrl = compare.judge(s.control(control_precision(c)), c.limits)
    assert not compare.passed(ctrl), ctrl
