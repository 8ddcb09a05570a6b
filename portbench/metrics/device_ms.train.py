"""Device milliseconds an iteration: the time in which an operation ran on
the device (the union of the trace's intervals, so overlaps count once)
over the iterations of the traced window.  It reads no host clock, so it
stays steady where the host's speed swings ``iter_ms``."""


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("iters")
    if tr is None or not n or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / n
