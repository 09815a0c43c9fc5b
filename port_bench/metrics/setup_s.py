"""Process start to the window's start: imports, weights, deployment,
warm-up, the traffic's own set-up and lead-in (s)."""


def read(win):
    return win.setup_s
