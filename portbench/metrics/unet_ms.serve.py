"""Host milliseconds a serving batch spends in the post-fusion U-Net (five K3
blocks and ``outc``; on the static scene also the crop and the paste into
the static face): the self time of the program's ``render.unet`` spans
(their duration less their child spans) over the window's batches.  It
times the enqueue, not the device."""

from portbench.core import program_spans as P


def read(ctx):
    return P.self_ms(ctx, "render.unet", "batches")
