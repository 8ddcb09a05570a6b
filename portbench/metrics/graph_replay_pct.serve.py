"""Share of the window's serving batches that replayed their render stages'
CUDA graphs: 100 x the window's delta of the program's ``replays`` counter
over the window's batches.  Silent where the program has no such counter
(``COUNTER`` is then None, and the harness reads nothing), and where the
trace holds no device activity: the graphs engage only on the card."""

import importlib.util

COUNTER = ("speech2lip_tpu_torch.infer.graphs:replays"
           if importlib.util.find_spec("speech2lip_tpu_torch.infer.graphs")
           else None)


def read(ctx):
    n, b, tr = (ctx.get("counters", {}).get(COUNTER), ctx.get("batches"),
                ctx.get("trace"))
    if COUNTER is None or n is None or not b:
        return None
    if tr is not None and tr.busy_s <= 0:
        return None
    return 100.0 * n / b
