"""Host milliseconds an iteration spends in the step's update (the gradients'
mean, the metrics, the gradient norm, Adam and the new leaves): the self
time of the program's ``step.update`` spans (their duration less their
child spans) over the window's iterations."""

from portbench.core import program_spans as P


def read(ctx):
    return P.self_ms(ctx, "step.update", "iters")
