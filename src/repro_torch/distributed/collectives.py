"""Hierarchical collectives for the multi-pod mesh, as
``repro.distributed.collectives``.

The ``pod`` axis of the 2 x 16 x 16 mesh is the slow link.
``cross_pod_psum_int8`` sums a value over it with an int8 payload:
quantize per block, all-gather the int8 blocks and their f32 scales over
``pod``, then dequantize and sum locally.  For S pods the wire carries
(S−1)/S · (bytes/4 + scales) against 2(S−1)/S · bytes for a ring
all-reduce.  With ``optim.grad.compress_decompress``'s error feedback the
quantization noise is unbiased over steps.

The axis names resolve against the current rules' mesh
(``sharding.use_rules``) or the ``mesh`` passed; an axis of one rank sends
nothing (the payload is still quantized and dequantized).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd


def quantize_block(x: torch.Tensor, block: int = 256):
    """``x`` flattened, zero-padded to whole blocks of ``block`` → (int8
    ``[blocks, block]``, f32 scales ``[blocks, 1]``): ``max|b|/127``, at
    least 1e-12, rounding half to even."""
    flat = x.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_block(q: torch.Tensor, scale: torch.Tensor, shape
                     ) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(tuple(shape))


def _comm(mesh):
    c = spmd.comm_of(mesh) if mesh is not None else spmd.current()
    if c is None:
        raise ValueError("collectives need a mesh: pass mesh= or run "
                         "inside sharding.use_rules(mesh)")
    return c


def cross_pod_psum_int8(x: torch.Tensor, axis_name: str = "pod",
                        block: int = 256, *, mesh=None) -> torch.Tensor:
    """Sum over ``axis_name`` with an int8 + scales payload."""
    group = _comm(mesh).group((axis_name,))
    q, scale = quantize_block(x, block)
    q_all = spmd.all_gather_dim(q[None], 0, group)     # [S, blocks, block]
    s_all = spmd.all_gather_dim(scale[None], 0, group)
    total = torch.sum(q_all.to(torch.float32) * s_all, dim=0).reshape(-1)
    return total[:x.numel()].reshape(x.shape).to(x.dtype)


def hierarchical_psum(x: torch.Tensor, *, fast_axes=("data",),
                      pod_axis: str = "pod", int8_cross_pod: bool = True,
                      block: int = 256, mesh=None) -> torch.Tensor:
    """Reduce within the pod at full precision, across pods compressed."""
    c = _comm(mesh)
    y = spmd.all_reduce(x, c.group(tuple(fast_axes)))
    if int8_cross_pod:
        return cross_pod_psum_int8(y, pod_axis, block, mesh=c.mesh)
    return spmd.all_reduce(y, c.group((pod_axis,)))
