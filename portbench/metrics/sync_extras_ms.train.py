"""Host milliseconds an iteration spends in the sync loss's extras
(``LipDataset._sync_extras``: a mel window, five coord grids, five JPEG
reads): the self time of the program's ``build.sync_extras`` spans (their
duration less their child spans) over the window's iterations."""

from portbench.core import program_spans as P


def read(ctx):
    return P.self_ms(ctx, "build.sync_extras", "iters")
