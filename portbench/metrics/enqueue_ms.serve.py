"""Host milliseconds a batch spends in the serving entry's call before it
returns (the launches it enqueues), mean over the window's batches."""


def read(ctx):
    v = ctx["spans"].get("enqueue") or []
    return 1e3 * sum(v) / len(v) if v else None
