"""Device-idle milliseconds a serving batch while the host was in the
composite (the paste and blend with the windowed warp, K2, and the casts
beside it): the trace's idle gaps whose midpoint falls in a
``render.composite`` span, the innermost program span there, over the
window's batches."""

from portbench.core import program_spans as P


def read(ctx):
    return P.idle_ms(ctx, "render.composite", "batches")
