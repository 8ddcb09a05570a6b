"""Host milliseconds a serving batch spends in the composite (the paste and
blend with the windowed warp, K2, and the casts beside it): the self time
of the program's ``render.composite`` spans (their duration less their
child spans) over the window's batches.  It times the enqueue, not the
device."""

from portbench.core import program_spans as P


def read(ctx):
    return P.self_ms(ctx, "render.composite", "batches")
