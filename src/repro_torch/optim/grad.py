"""Gradient utilities, as ``repro.optim.grad``: microbatch accumulation
and int8 error-feedback compression.

``accumulate_grads`` takes the gradients of the parameter leaves with
``torch.autograd.grad``; the ``lax.scan`` over microbatches becomes a
Python loop with the same sums in the same order.  ``compress_decompress``
is the quantize → dequantize round trip of the cross-pod gradient payload;
sending it across pods waits for sharding (ROADMAP Queue A item 13).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.tree import flatten_with_path, tree_map, unflatten_like


def _grads(loss_fn: Callable, params, batch):
    """Every leaf must get a gradient: one that gets none means the graph
    was cut on the way to the loss, and is an error, not a zero."""
    (loss, metrics) = loss_fn(params, batch)
    flat = flatten_with_path(params)
    gs = torch.autograd.grad(loss, [p for _, p in flat], allow_unused=True)
    missing = [path for (path, _), g in zip(flat, gs) if g is None]
    if missing:
        raise ValueError(f"the loss has no gradient for "
                         f"{', '.join(missing)}: the autograd graph is cut "
                         f"before these leaves")
    grads = unflatten_like(params, gs)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def accumulate_grads(loss_fn: Callable, params, batch, num_microbatches: int):
    """Split the batch along dim 0 into microbatches and sum their
    gradients in f32.  Returns ``((loss, metrics_mean), grads)`` matching
    a single big-batch call.  The parameter leaves must require grad."""
    if num_microbatches <= 1:
        return _grads(loss_fn, params, batch)
    n = num_microbatches
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not split into {n} "
                             f"microbatches")
    micro = [{k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]
              for k, x in batch.items()} for i in range(n)]
    (loss, metrics), g0 = _grads(loss_fn, params, micro[0])
    grads = tree_map(lambda p, g: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device) + g,
                     params, g0)
    for mb in micro[1:]:
        (l_i, m_i), g = _grads(loss_fn, params, mb)
        grads = tree_map(torch.add, grads, g)
        loss = loss + l_i
        metrics = {k: metrics[k] + m_i[k] for k in metrics}
    grads = tree_map(lambda g: g / float(n), grads)
    return (loss / float(n), {k: v / float(n) for k, v in metrics.items()}), \
        grads


def compress_decompress(grads, *, block: int = 1024,
                        residual: Optional[Any] = None) -> Tuple[Any, Any]:
    """int8 block quantization with error feedback.  Returns
    (quantized-then-dequantized grads in f32, new residual)."""
    def one(g, r):
        gf = g.to(torch.float32)
        if r is not None:
            gf = gf + r
        flat = gf.reshape(-1)
        pad = (-flat.numel()) % block
        fp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
        scale = torch.clamp(torch.amax(torch.abs(fp), dim=1, keepdim=True)
                            / 127.0, min=1e-12)
        q = torch.clamp(torch.round(fp / scale), -127, 127)
        deq = (q * scale).reshape(-1)[:flat.numel()].reshape(g.shape)
        return deq, gf - deq

    if residual is None:
        out = tree_map(lambda g: one(g, None), grads)
    else:
        out = tree_map(one, grads, residual)
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))
