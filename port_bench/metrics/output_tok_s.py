"""Output tokens committed between the window's edges, over its length;
a request that straddles an edge counts only its tokens inside."""


def read(win):
    return win.work()["tokens"] / win.seconds
