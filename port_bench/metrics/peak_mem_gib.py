"""``torch.cuda.max_memory_allocated()`` after the window, reset once the
weights were made: engine, deployment, warm-up and window (GiB)."""


def read(win):
    return win.peak_bytes / 2 ** 30 if win.peak_bytes else None
