"""Device milliseconds an iteration, end to end: the time in which an
operation ran on the card (the union of the window's device intervals in
the profiler's trace, so overlaps count once) over every iteration the
window finished, read in an untraced run (``harness.device_window``).  It
is the card's work an iteration, the iteration's time once the host keeps
the card fed; unlike the host clock's ``iter_ms.train`` it does not swing
with the speed of a shared host's CPU.  Silent where the window holds no
device activity (the CPU)."""


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("iters")
    if tr is None or not n or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / n
