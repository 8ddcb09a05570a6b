"""The fused_block kernel's share of its roofline: the least time the card could
take for the calls the window made (portbench/counts/flops.py: the
larger of operations over the bf16 peak and bytes over the HBM rate),
summed, over the device time of its launches in the trace (kernel names
holding ``PATTERN``).  Silent where the trace holds fewer of them than
the port's own count of the window's calls that launched the kernel
(``COUNTER``, each such call launches at least one): a dropped record
would read as speed; silent too where no call launched it."""

COUNTER = "speech2lip_tpu_torch.ops.kernels.fused_block:launches"
PATTERN = "conv3x3_kernel"


def read(ctx):
    tr, k = ctx.get("trace"), ctx.get("kernels", {}).get("fused_block")
    calls = ctx.get("counters", {}).get(COUNTER)
    if tr is None or not k or not calls:
        return None
    t = tr.kernel_seconds(PATTERN)
    if t <= 0 or tr.kernel_count(PATTERN) < calls:
        return None
    return 100.0 * k["bound_s"] / t
