"""95th percentile, over every request due in the window, of its
admission (``Request.admitted_at``) minus the time it was due (ms)."""
from benchlib.stats import percentile


def read(win):
    return percentile(win.latencies_ms("admitted_at"), 95) \
        if win.requests else None
