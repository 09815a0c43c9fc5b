"""The flash forward kernel's share of its roofline over the window's
prefill chunks: for each chunk the larger of its visible pairs' FLOPs
over the peak and its bytes (queries, outputs, the keys and values up to
its last position) over the bandwidth, summed, over the kernel's device
time in the trace (%)."""
from benchlib import cost

KERNEL = "flash_fwd"


def read(win):
    t = win.kernel_s(KERNEL)
    chunks = win.work()["chunks"]
    if t is None or not chunks:
        return None
    m = win.model
    least = sum(cost.step_seconds(
        cost.attention_flops(m, cost.causal_pairs(a, n)),
        cost.flash_bytes(m, a, n)) for a, n in chunks)
    return 100.0 * least / t
