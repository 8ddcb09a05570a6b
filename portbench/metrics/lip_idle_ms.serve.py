"""Device-idle milliseconds a serving batch while the host was in the lip
render (the audio encoder, the frame features, the uv embedding and the
lip MLP, K1): the trace's idle gaps whose midpoint falls in a
``render.lip`` span, the innermost program span there, over the window's
batches."""

from portbench.core import program_spans as P


def read(ctx):
    return P.idle_ms(ctx, "render.lip", "batches")
