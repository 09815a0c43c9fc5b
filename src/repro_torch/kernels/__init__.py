"""Hand-written CUDA kernels of the port, their plain versions and the
device dispatch between them (``ops``)."""

# the launch counter of each kernel wrapper: (module, function) by name
_WRAPPERS = {
    "flash_attention": ("flash_attention", "flash_attention"),
    "paged_decode_attention": ("paged_decode_attention",
                               "paged_decode_attention"),
    "paged_verify_attention": ("paged_verify_attention",
                               "paged_verify_attention"),
    "decode_attention": ("decode_attention", "decode_attention"),
    "decode_attention_lse": ("decode_attention", "decode_attention_lse"),
    "flash_attention_bwd_dq": ("flash_attention_bwd",
                               "flash_attention_bwd_dq"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                "flash_attention_bwd_dkv"),
    "ssd_scan": ("ssd_scan", "ssd_scan"),
    "rmsnorm": ("rmsnorm", "rmsnorm"),
}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name.  A wrapper
    counts each call of its C entry: under CUDA-graph capture that is the
    launch the graph records and repeats at every replay, not one that
    ran."""
    import importlib

    return {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{mod}"), fn).launches
        for name, (mod, fn) in _WRAPPERS.items()}
