"""Host milliseconds an iteration spends in the step's losses
(``compute_losses``, LPIPS included): the self time of the program's
``step.forward`` spans (their duration less their child spans) over the
window's iterations."""

from portbench.core import program_spans as P


def read(ctx):
    return P.self_ms(ctx, "step.forward", "iters")
