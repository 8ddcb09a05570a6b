"""Host milliseconds from asking the training loop for a batch to its
tensors on the card, mean over the window's iterations."""


def read(ctx):
    v = ctx["spans"].get("batch_build") or []
    return 1e3 * sum(v) / len(v) if v else None
