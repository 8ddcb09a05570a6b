"""Host milliseconds an iteration spends in the two black-hole warps
(``LipDataset.blackaug_statics``): the self time of the program's
``build.warp`` spans (their duration less their child spans) over the
window's iterations."""

from portbench.core import program_spans as P


def read(ctx):
    return P.self_ms(ctx, "build.warp", "iters")
