"""Share of the traced window in which no operation ran on the device
(%)."""


def read(win):
    p = win.profile
    if not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
