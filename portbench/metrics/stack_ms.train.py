"""Host milliseconds an iteration spends in the collation of the frames into
a batch (``stack_batch``): the self time of the program's ``build.stack``
spans (their duration less their child spans) over the window's
iterations."""

from portbench.core import program_spans as P


def read(ctx):
    return P.self_ms(ctx, "build.stack", "iters")
