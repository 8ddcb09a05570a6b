"""Host milliseconds an iteration spends in a frame's own files (the lip
JPEG, the face JPEG and the coord grid, or the wait for them from the
prefetcher): the self time of the program's ``build.read`` spans (their
duration less their child spans) over the window's iterations."""

from portbench.core import program_spans as P


def read(ctx):
    return P.self_ms(ctx, "build.read", "iters")
