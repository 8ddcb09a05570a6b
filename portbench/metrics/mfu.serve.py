"""The whole step's share of the card's peak: the model operations of the
work finished in the window (``portbench/counts/flops.py``) over the
window times the peak of the type the cell computes in."""

from portbench.counts.flops import PEAK


def read(ctx):
    ops, t = ctx.get("model_ops"), ctx.get("window_s")
    if not ops or not t:
        return None
    return 100.0 * ops / (t * PEAK[ctx["peak"]])
