"""The window's length over the engine ticks it ran (``engine.ticks``
read at both edges), ms."""


def read(win):
    ticks = win.work()["ticks"]
    return win.seconds * 1e3 / ticks if ticks else None
