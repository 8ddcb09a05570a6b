"""Host milliseconds an iteration spends in the step's gradients
(``torch.autograd.grad``): the self time of the program's
``step.backward`` spans (their duration less their child spans) over the
window's iterations."""

from portbench.core import program_spans as P


def read(ctx):
    return P.self_ms(ctx, "step.backward", "iters")
