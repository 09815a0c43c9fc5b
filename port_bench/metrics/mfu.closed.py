"""The whole model step's share of the card's peak: the least time the
window's prefill chunks and decode steps could take
(``Window.least_step_seconds``, the frozen formulas of
``benchlib/cost.py``) over the window's length (%)."""


def read(win):
    t = win.least_step_seconds()
    return 100.0 * t / win.seconds if t else None
