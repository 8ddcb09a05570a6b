"""Device-idle milliseconds a serving batch while the host was in the
post-fusion U-Net (five K3 blocks and ``outc``; on the static scene also
the crop and the paste into the static face): the trace's idle gaps whose
midpoint falls in a ``render.unet`` span, the innermost program span
there, over the window's batches."""

from portbench.core import program_spans as P


def read(ctx):
    return P.idle_ms(ctx, "render.unet", "batches")
