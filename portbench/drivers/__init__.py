"""The drivers: each module here runs the cells whose traffic mix names it
(the mix's ``driver`` key), and the harness, the calibration and the tests
ask it by that name alone.  A driver module provides:

- ``Session(cell, seed, device, span)``: ``setup()``, ``window_run(s)``,
  ``end_to_end()``, ``context()``, ``release()``, ``check()``,
  ``control(precision)`` and ``attempted()``, as ``core/harness.py`` and
  ``calibrate.py`` call them;
- ``small(config, traffic) -> (config, traffic)``: copies cut to sizes a
  CPU test runs (``tests/small.py``);
- ``control_precision(cell) -> str``: the precision its ``control`` takes
  for the cell's control, one step below the configuration's (a name of
  the driver's own where its ``control`` reads one).

A new driver is a new module here, with its traffic mixes naming it.
"""
