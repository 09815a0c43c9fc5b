"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The sub-package layout mirrors ``src/repro/`` so each module's counterpart
is found by the same path.  This package imports torch, numpy and the
standard library only — never JAX and never ``repro``.
"""
