"""95th percentile, over every request due in the window, of
(finished - first token) / (tokens - 1) (ms)."""
from benchlib.stats import percentile


def read(win):
    xs = win.tpot_ms()
    return percentile(xs, 95) if xs else None
