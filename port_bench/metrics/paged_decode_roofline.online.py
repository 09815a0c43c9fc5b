"""The paged decode kernel's share of its roofline: the least time its
calls in the window could take (each row-step's q and output, the keys
and values it attends, its page-table entries; its FLOPs) over the
kernel's device time in the trace (%)."""
from benchlib import cost

KERNEL = "paged_attention_kernel"


def read(win):
    t = win.kernel_s(KERNEL)
    w = win.work()
    if t is None or not w["rows"]:
        return None
    m = win.model
    least = cost.step_seconds(
        cost.attention_flops(m, w["keys"]),
        cost.paged_decode_bytes(m, w["rows"], w["keys"], w["pages"]))
    return 100.0 * least / t
