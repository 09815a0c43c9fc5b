"""95th percentile, over every request due in the window, of its first
token's time minus the time it was due (ms)."""
from benchlib.stats import percentile


def read(win):
    return percentile(win.latencies_ms("first_token_at"), 95) \
        if win.requests else None
