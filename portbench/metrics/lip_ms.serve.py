"""Host milliseconds a serving batch spends in the lip render (the audio
encoder, the frame features, the uv embedding and the lip MLP, K1): the
self time of the program's ``render.lip`` spans (their duration less their
child spans) over the window's batches.  It times the enqueue, not the
device."""

from portbench.core import program_spans as P


def read(ctx):
    return P.self_ms(ctx, "render.lip", "batches")
