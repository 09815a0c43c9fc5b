"""Prompt tokens attached from the radix (``Request.kv_shared_tokens``)
over all prompt tokens, of the window's requests (%)."""


def read(win):
    s = win.prefix_share()
    return None if s is None else 100.0 * s
