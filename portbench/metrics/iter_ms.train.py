"""Host milliseconds an iteration: the traced window over the iterations
finished in it (the batch build, the copy, the step's draws and the
synchronised step), on the host clock.  The training iteration is
host-bound, so it swings with the speed of the host's CPU from run to run
by more than an end-to-end bound may hold; ``iter_device_ms`` stands end
to end."""


def read(ctx):
    t, n = ctx.get("window_s"), ctx.get("iters")
    return 1e3 * t / n if t and n else None
