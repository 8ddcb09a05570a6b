"""The window's peak of device memory held by PyTorch's allocator
(``max_memory_allocated`` after ``reset_peak_memory_stats``), GiB."""


def read(ctx):
    b = ctx.get("window_peak_bytes")
    return b / 2 ** 30 if b else None
