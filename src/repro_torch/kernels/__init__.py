"""Hand-written CUDA kernels of the port, their plain versions and the
device dispatch between them (``ops``)."""

# The (key, value) head dims each attention kernel instantiates, by kind:
# the wrappers read their kind's entry and raise on any other pair (the
# CUDA ``run()`` switches hold the same lists).  Values are as wide as
# keys but for MLA's: its prefill's q/k 192 over v 128 (deepseek-v2-236b)
# and 48 over 32 (its reduced config), and its absorbed decode's latent
# keys of 576 over values of 512 (48 over 32 reduced).  D 16 is the JAX
# examples' four heads of 16, 48 and 80 the encoders', 192 and 256
# nemotron-4-340b's and gemma-2b's.
_SQUARE = (16, 32, 64, 128, 192, 256)
ATTENTION_DIMS = {
    # the flash forward and its dq and dk/dv kernels
    "flash": tuple((d, d) for d in sorted(_SQUARE + (48, 80)))
    + ((192, 128), (48, 32)),
    # paged decode and verify (csrc/paged_attention.cuh)
    "paged": tuple((d, d) for d in _SQUARE),
    # dense decode: the same template, and MLA's kernels at (576, 512)
    "decode": tuple((d, d) for d in _SQUARE) + ((48, 32), (576, 512)),
}

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
