"""Roofline terms of one step, counted by running it (``repro.roofline.
analysis``'s counterpart, with the compiled HLO replaced by a
``TorchDispatchMode`` over the step itself).

  compute term    = FLOPs_per_rank / PEAK_FLOPS
  memory term     = HBM_bytes_per_rank / HBM_BW
  collective term = wire_bytes_per_rank / LINK_BW

``count()`` runs a step under the mode, on ``meta`` tensors (the
dry-run: no memory, no values) or on the card, and counts:
- FLOPs: each aten op by ``torch.utils.flop_counter``'s registered
  formulas (products and convolutions; elementwise ops count 0);
- bytes, raw: every op's tensor inputs and outputs (views and
  uninitialised allocations move nothing);
- bytes, fused: the deployment model of ``parse_hbm_bytes``: the ops that
  stream device memory whatever fuses around them (products,
  gather/scatter/index, sort and scans, concatenation and padding,
  reductions and softmax, copies, collectives) charged their inputs and
  outputs, elementwise ops and dtype casts taken as fused into them;
- ``attn_io``: the part of the fused bytes in f32 tensors of 4 or more
  dims whose last two are both at least 512 (attention logits, which
  the kernels keep on chip);
- collectives: each ``c10d`` op the ``distributed.spmd`` calls reach, its
  group size from its process group, wire bytes by the ring factors of
  ``parse_collectives`` (all-reduce 2(s−1)/s of the operand, all-gather
  (s−1)/s of the output, reduce-scatter (s−1)/s of the input, all-to-all
  (s−1)/s, a broadcast or point-to-point its operand);
- memory: a live-bytes tracker keyed on storages, each freed when its
  storage is released: the step's arguments, its outputs, the outputs
  that are arguments updated in place (``alias_bytes``), and the peak of
  live bytes less the arguments (``temp_bytes``).

Kernels (``attn_impl``): ``"kernel"`` counts each hand-written kernel's
call by its own formulas (``kernels.cost``: the work the kernel does,
causal and window masks included, each input read once and each output
written once) and nothing of what runs inside it, the plain version's
T² scores included, so a step counts the same on ``meta`` as on the
card.  ``"ref"`` counts the plain versions' aten ops, as the JAX
package's naive baseline does; on the card the kernels are not aten ops,
so ``"ref"`` refuses a call on CUDA tensors.

Constants are one H100 SXM's (NVIDIA's data sheet, dense, without
sparsity): 989 TFLOP/s bf16, 3.35 TB/s HBM3, and NVLink 4's 900 GB/s a
card, 450 GB/s each way, as the link rate.  A group that spans nodes
rides a slower fabric, which the collective term does not model.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost

PEAK_FLOPS = 989e12          # bf16, dense, per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s each way, NVLink 4

# ops that stream device memory (charged in the fused model), by packet
# name; every other op is elementwise or a view
_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "convolution",
           "convolution_backward", "_scaled_mm", "_grouped_mm"}
_INDEX = {"gather", "scatter", "scatter_add", "scatter_reduce", "index",
          "_unsafe_index", "index_put", "index_put_", "_index_put_impl_",
          "_unsafe_index_put", "index_select", "index_add", "index_copy",
          "embedding", "embedding_dense_backward", "take", "slice_scatter",
          "select_scatter", "diagonal_scatter", "masked_scatter",
          "scatter_", "scatter_add_", "scatter_reduce_", "index_add_",
          "index_copy_", "masked_select", "nonzero"}
_SORT = {"sort", "topk", "argsort", "kthvalue", "cumsum", "cumprod",
         "cummax", "cummin", "logcumsumexp"}
_CAT = {"cat", "stack", "constant_pad_nd", "pad", "repeat"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
           "prod", "logsumexp", "var", "var_mean", "std", "std_mean",
           "norm", "linalg_vector_norm", "_softmax", "_log_softmax",
           "_softmax_backward_data", "_log_softmax_backward_data",
           "nll_loss_forward", "nll_loss_backward", "all", "any",
           "count_nonzero"}
_COPY = {"copy_", "clone", "_copy_from", "_to_copy", "copy",
         "_reshape_copy", "expand_copy", "permute_copy"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "set_", "resize_"}
# c10d op name -> the collective kind of ``parse_collectives``
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute",
}


def _tensors(x):
    """The tensors in an argument or result (lists and tuples walked)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_attn_logits(t: torch.Tensor) -> bool:
    """[B, H, (G,) Tq, Tk]-shaped f32: attention score traffic that the
    kernels keep on chip."""
    return (t.dtype == torch.float32 and t.dim() >= 4
            and t.shape[-1] >= 512 and t.shape[-2] >= 512)


def _group_size(args) -> int:
    from torch._C._distributed_c10d import ProcessGroup

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except RuntimeError:        # a ReduceOp, not a group
                continue
    return 1


@dataclasses.dataclass
class CollectiveStats:
    # per-rank operand bytes by collective kind
    operand_bytes: Dict[str, int]
    # modeled on-the-wire bytes per rank (ring factors)
    wire_bytes: float
    count: Dict[str, int]

    def total_operand(self) -> int:
        return sum(self.operand_bytes.values())


def collective_bytes(kind: str, out_bytes: int, s: int):
    """(operand bytes, wire bytes) of one collective of ``kind`` whose
    output is ``out_bytes`` over a group of ``s``: the ring factors of
    ``repro.roofline.analysis.parse_collectives``."""
    s = max(s, 1)
    ring = (s - 1) / s if s > 1 else 0.0
    if kind == "all-reduce":
        return out_bytes, 2.0 * ring * out_bytes
    if kind == "all-gather":
        return out_bytes // s, ring * out_bytes
    if kind == "reduce-scatter":
        return out_bytes * s, ring * out_bytes * s
    if kind == "all-to-all":
        return out_bytes, ring * out_bytes
    return out_bytes, float(out_bytes)       # collective-permute


class _Counting(TorchDispatchMode):
    """The mode ``counting`` enters; its state is the counts."""

    def __init__(self, attn_impl: str):
        super().__init__()
        if attn_impl not in ("ref", "kernel"):
            raise ValueError(f"attn_impl {attn_impl!r}: 'ref' or 'kernel'")
        self.attn_impl = attn_impl
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_fused = 0.0
        self.attn_io = 0.0
        self.op_bytes: Dict[str, int] = collections.Counter()
        self.op_count: Dict[str, int] = collections.Counter()
        self.wire = 0.0
        self.kernels: Dict[str, list] = {}
        self._quiet = 0
        # live storages: key -> bytes; the arguments' keys
        self._live: Dict[int, int] = {}
        self._args: Dict[int, int] = {}
        self.current = 0
        self.peak = 0

    # -- memory ------------------------------------------------------------

    def _track(self, result) -> None:
        for t in _tensors(result):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._args:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.current += n
            self.peak = max(self.peak, self.current)
            weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        n = self._live.pop(key, None)
        if n is not None:
            self.current -= n

    def arguments(self, args) -> int:
        """Register the step's arguments (live throughout); their bytes."""
        for t in _tensors(args):
            st = t.untyped_storage()
            if st._cdata not in self._args:
                self._args[st._cdata] = st.nbytes()
        self.current = self.peak = 0
        return sum(self._args.values())

    # -- kernels -----------------------------------------------------------

    def kernel_call(self, name, flops, nbytes, run, inputs):
        if self.attn_impl == "ref":
            if any(t.is_cuda for t in _tensors(inputs)):
                raise RuntimeError(
                    f"attn_impl='ref' counts the plain versions' aten ops, "
                    f"which run on meta or the CPU; {name} got CUDA tensors "
                    f"(count the card's step with attn_impl='kernel')")
            return run()
        self._quiet += 1
        try:
            out = run()
        finally:
            self._quiet -= 1
        self.flops += flops
        self.bytes += nbytes
        self.bytes_fused += nbytes
        calls = self.kernels.setdefault(name, [0, 0.0, 0.0])
        calls[0] += 1
        calls[1] += flops
        calls[2] += nbytes
        self._track(out)
        return out

    # -- ops ---------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns == "c10d":
            self._collective(name, args, out)
            return out
        if name in _FREE or func.is_view:
            self._track(out)
            return out
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += f(*args, **kwargs, out_val=out)
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.bytes += moved
        if self._charged(name, ins, outs):
            self.bytes_fused += moved
            self.attn_io += sum(_nbytes(t) for t in ins + outs
                                if _is_attn_logits(t))
        self._track(out)
        return out

    @staticmethod
    def _charged(name: str, ins, outs) -> bool:
        if name in _MATMUL or name in _INDEX or name in _SORT \
                or name in _CAT:
            return True
        if name in ("max", "min"):
            # aten.max / min also name the elementwise binary forms
            return bool(outs) and outs[0].numel() < ins[0].numel()
        if name in _REDUCE:
            return True
        if name in _COPY:
            # a dtype cast is elementwise (fused into its consumer); a copy
            # of the same dtype moves bytes
            return name != "_to_copy" or ins[0].dtype == outs[0].dtype
        return False

    def _collective(self, name: str, args, out) -> None:
        kind = _C10D.get(name)
        if kind is None:                 # barrier, monitoring: no payload
            return
        # the first argument holds the result: the outputs of the gather,
        # scatter and all-to-all forms, the tensors reduced or sent in
        # place by the others (read and written)
        out_bytes = sum(map(_nbytes, _tensors(args[0])))
        operand, wire = collective_bytes(kind, out_bytes, _group_size(args))
        self.op_bytes[kind] += operand
        self.op_count[kind] += 1
        self.wire += wire
        moved = sum(map(_nbytes, _tensors(args[:2]))) \
            if isinstance(args[1], (torch.Tensor, list)) else 2 * out_bytes
        self.bytes += moved
        self.bytes_fused += moved

    # -- results -----------------------------------------------------------

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.op_bytes), self.wire,
                               dict(self.op_count))


class Counted:
    """What ``counting`` saw: ``cost()`` and ``memory()``, the JAX
    ``cost_analysis()`` and ``memory_analysis()`` keys where they carry
    over, and the kernels' calls by name."""

    def __init__(self, mode: _Counting, argument_bytes: int):
        self.mode = mode
        self.argument_bytes = argument_bytes
        self.output_bytes = 0
        self.alias_bytes = 0

    def outputs(self, result) -> None:
        """Register the step's result: its storages' bytes, and those that
        are arguments (updated in place)."""
        seen = set()
        for t in _tensors(result):
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            self.output_bytes += st.nbytes()
            if st._cdata in self.mode._args:
                self.alias_bytes += st.nbytes()

    def cost(self) -> dict:
        m = self.mode
        return {"flops": m.flops, "bytes": m.bytes,
                "bytes_fused": m.bytes_fused, "attn_io": m.attn_io,
                "collectives": m.collectives(),
                "kernels": {k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                            for k, v in m.kernels.items()}}

    def memory(self) -> dict:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.mode.peak,
                "alias_bytes": self.alias_bytes,
                "peak_bytes": self.argument_bytes + self.mode.peak}


def count(step, args, attn_impl: str = "kernel") -> Counted:
    """Run ``step(*args)`` once under the counting mode: its FLOPs, bytes,
    collectives and memory (the arguments live throughout; the temporary
    peak is the most live bytes beyond them)."""
    mode = _Counting(attn_impl)
    seen = Counted(mode, mode.arguments(args))
    prev = cost._counter
    cost._counter = mode
    try:
        with mode:
            out = step(*args)
        seen.outputs(out)
    finally:
        cost._counter = prev
    return seen


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float          # raw: every op's inputs and outputs
    bytes_fused_per_device: float    # the fused model (drives the term)
    attn_io_bytes_per_device: float  # its part in attention logits
    collective: CollectiveStats
    compute_s: float
    memory_s: float                  # raw
    memory_fused_s: float            # fused (drives the bottleneck)
    memory_projected_s: float        # fused less attention logits
    collective_s: float
    bottleneck: str
    model_flops: float            # 6·N·D (or 6·N_active·D) global
    useful_flops_ratio: float     # model_flops / (flops_per_device × chips)

    def floor_s(self) -> float:
        """The least time the card could take: the larger of the compute
        and the fused memory terms."""
        return max(self.compute_s, self.memory_fused_s)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["collective"] = dataclasses.asdict(self.collective)
        return d


def analyze(*, flops_per_device: float, bytes_per_device: float,
            num_devices: int, model_flops: float = 0.0,
            bytes_fused_per_device: Optional[float] = None,
            attn_io_bytes: float = 0.0,
            collective: Optional[CollectiveStats] = None) -> Roofline:
    """The JAX ``analyze`` with the collectives passed in (the JAX one
    parses them from the HLO text)."""
    coll = collective or CollectiveStats({}, 0.0, {})
    if bytes_fused_per_device is None:
        bytes_fused_per_device = bytes_per_device
    ct = flops_per_device / PEAK_FLOPS
    mt = bytes_per_device / HBM_BW
    mtf = bytes_fused_per_device / HBM_BW
    mtp = max(bytes_fused_per_device - attn_io_bytes, 0.0) / HBM_BW
    lt = coll.wire_bytes / LINK_BW
    terms = {"compute": ct, "memory": mtf, "collective": lt}
    bottleneck = max(terms, key=terms.get)
    global_flops = flops_per_device * num_devices
    ratio = (model_flops / global_flops) if global_flops else 0.0
    return Roofline(flops_per_device, bytes_per_device,
                    bytes_fused_per_device, attn_io_bytes, coll, ct, mt, mtf,
                    mtp, lt, bottleneck, model_flops, ratio)


def model_flops_estimate(cfg, shape) -> float:
    """6·N·D for train (N = active parameters, D = tokens); 2·N·D for
    prefill; a decode step 2·N a sequence plus attention over the cache."""
    tokens = shape.global_batch * shape.seq_len
    n = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    per_tok = 2.0 * n
    attn_layers = cfg.num_layers
    if cfg.family == "hybrid":
        attn_layers = cfg.num_layers // cfg.hybrid_attn_every
    attn = 0.0
    if cfg.attn_type in ("full", "swa"):
        win = cfg.sliding_window if cfg.sliding_window > 0 else shape.seq_len
        kv = min(shape.seq_len, win)
        attn = (4.0 * cfg.num_heads * cfg.head_dim_ * kv) * attn_layers
    elif cfg.attn_type == "mla":
        lat = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        attn = (4.0 * cfg.num_heads * lat * shape.seq_len) * attn_layers
    return (per_tok + attn) * shape.global_batch
