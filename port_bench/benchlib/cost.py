"""The yardstick's arithmetic: the card's peaks and what the work of a
window needs, from its shapes alone.

Frozen here so that a change to the program cannot move it.  The
formulas are those of the port's ``kernels/cost.py`` (attention FLOPs
2·(D + Dv) a visible (query, key) pair a query head; each input read
once, each output written once) and its ``roofline/analysis.py`` peaks,
applied to what a dense decoder's serving step needs: the rows and keys
the requests hold, never the padding, the idle slots or the table's
unused span that the program may also compute.
"""
from __future__ import annotations

# one NVIDIA H100 SXM (the data sheet, dense, at its 700 W limit)
PEAK_FLOPS = 989e12          # bf16
HBM_BW = 3.35e12             # bytes/s
BF16 = 2


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def layer_matmul_params(m: dict) -> int:
    """Weights one layer multiplies each token by: q, k, v, o and the
    MLP's matrices."""
    d, H, Hkv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        head_dim(m)
    mats = 3 if m["activation"] in ("swiglu", "geglu") else 2
    return 2 * d * H * hd + 2 * d * Hkv * hd + mats * d * m["d_ff"]


def layer_params(m: dict) -> int:
    """Every weight of one layer: its matrices, norms and qk-norm scales."""
    d = m["d_model"]
    norms = 2 * d * (2 if m["norm"] == "layernorm" else 1)
    qk = 2 * head_dim(m) if m.get("qk_norm") else 0
    return layer_matmul_params(m) + norms + qk


def head_params(m: dict) -> int:
    return m["d_model"] * m["vocab_size"]


def attention_flops(m: dict, pairs: float) -> float:
    """All layers' q·kᵀ and p·v over ``pairs`` visible (query, key) pairs
    of one sequence."""
    return 2.0 * m["num_layers"] * m["num_heads"] * pairs * 2 * head_dim(m)


def causal_pairs(start: int, n: int) -> int:
    """Pairs of ``n`` queries at positions ``start..start+n-1`` over every
    key at or before each."""
    return n * start + n * (n + 1) // 2


def chunk_flops(m: dict, start: int, n: int) -> float:
    """One prefill chunk of ``n`` prompt tokens from position ``start``:
    the layers' products, the attention, and the head for the one row
    whose logits the step returns."""
    return 2.0 * n * m["num_layers"] * layer_matmul_params(m) + \
        attention_flops(m, causal_pairs(start, n)) + 2.0 * head_params(m)


def kv_bytes_per_token(m: dict) -> int:
    """Keys and values of one token over every layer, bf16."""
    return 2 * m["num_layers"] * m["num_kv_heads"] * head_dim(m) * BF16


def decode_flops(m: dict, rows: int, keys: int) -> float:
    """Decode steps: ``rows`` row-steps in all, attending ``keys`` keys in
    all (each row's cache and its new token)."""
    per_row = m["num_layers"] * layer_matmul_params(m) + head_params(m)
    return 2.0 * rows * per_row + attention_flops(m, keys)


def decode_bytes(m: dict, steps: int, rows: int, keys: int) -> float:
    """Decode steps: each step reads every layer's weights and the head
    once; each row-step reads its embedding row, its keys and values,
    writes its new token's, and writes its logits."""
    weights = (m["num_layers"] * layer_params(m) + head_params(m)
               + m["d_model"]) * BF16
    kvt = kv_bytes_per_token(m)
    per_row = m["d_model"] * BF16 + kvt + m["vocab_size"] * BF16
    return steps * weights + rows * per_row + keys * kvt


def paged_decode_bytes(m: dict, rows: int, keys: int, pages: int) -> float:
    """The paged decode kernel's calls, every layer: each row-step's q
    and output, the keys and values it attends, its page-table entries
    and its length."""
    hd = head_dim(m)
    L = m["num_layers"]
    q_out = 2 * m["num_heads"] * hd * BF16
    return L * (rows * (q_out + 4) + keys * 2 * m["num_kv_heads"] * hd
                * BF16 + pages * 4)


def flash_bytes(m: dict, start: int, n: int) -> float:
    """One prefill chunk's flash calls, every layer: its queries and
    outputs, and the keys and values of every position up to its last."""
    hd = head_dim(m)
    return m["num_layers"] * (2 * n * m["num_heads"] * hd * BF16
                              + (start + n) * 2 * m["num_kv_heads"] * hd
                              * BF16)


def step_seconds(flops: float, nbytes: float = 0.0) -> float:
    """The least time the card could take: the larger of the FLOPs over
    the peak and the bytes over the bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)
