"""Host milliseconds from the call of the train step (with its draws) to
its synchronised end, mean over the window's iterations."""


def read(ctx):
    v = ctx["spans"].get("step") or []
    return 1e3 * sum(v) / len(v) if v else None
