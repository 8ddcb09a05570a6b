"""Host milliseconds an iteration spends in the copy of the batch to the card
(``train.trainer.to_device``): the self time of the program's
``build.copy`` spans (their duration less their child spans) over the
window's iterations."""

from portbench.core import program_spans as P


def read(ctx):
    return P.self_ms(ctx, "build.copy", "iters")
