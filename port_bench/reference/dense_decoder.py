"""Plain reference of the dense decoder the benchmark serves, and the
weights it hands to both sides.

A configuration file names this module under ``"reference"``.  It holds
three things, and imports nothing but ``torch``:

- ``layout(model)``: the parameter tree the program takes through
  ``params=`` (leaf names and shapes), worked out from the configuration's
  sizes alone;
- ``make_weights(model, seed, device)``: that tree drawn on ``device``
  from ``seed`` in bf16, one ``normal_`` call a stacked leaf;
- ``logits(weights, model, seqs, precision)``: the forward pass of each
  token sequence from position 0, in float32 with TF32 off (or, for the
  control, with every matrix product's inputs rounded to fp8 e4m3 with a
  scale a row or a column), returning the logits at the positions asked
  for.  It runs layer by layer over all the sequences at once, casting one
  weight matrix at a time to float32, so that it fits beside the bf16
  weights on the card.

The equations are those of the published models as the configurations
state them: pre-norm blocks, x + attn(norm1(x)), then x + mlp(norm2(x));
LayerNorm (``"layernorm"``) or RMSNorm; an RMSNorm over the head dim of
q and k where ``qk_norm`` is set; rotary embeddings over the two halves
of the head dim with ``rope_theta``; grouped-query attention, causal,
scaled by head_dim ** -0.5; a squared-ReLU MLP (``"relu2"``) or SwiGLU;
a final norm and an untied head.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

FP8_MAX = 448.0          # the largest finite float8_e4m3fn


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def layout(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """Flat ``{"embed/embedding": (shape, kind, std)}``: ``kind`` is
    ``normal`` (zero mean), ``scale`` (one plus the noise) or ``bias``."""
    L, d, H, Hkv = m["num_layers"], m["d_model"], m["num_heads"], \
        m["num_kv_heads"]
    hd, dff, V = _hd(m), m["d_ff"], m["vocab_size"]
    out = {"embed/embedding": ((V, d), "normal", 1.0)}
    b = "stack/blocks/"
    out[b + "attn/w_q"] = ((L, d, H, hd), "normal", d ** -0.5)
    out[b + "attn/w_k"] = ((L, d, Hkv, hd), "normal", d ** -0.5)
    out[b + "attn/w_v"] = ((L, d, Hkv, hd), "normal", d ** -0.5)
    out[b + "attn/w_o"] = ((L, H, hd, d), "normal", (H * hd) ** -0.5)
    if m.get("qk_norm"):
        out[b + "attn/q_norm"] = ((L, hd), "scale", 0.1)
        out[b + "attn/k_norm"] = ((L, hd), "scale", 0.1)
    for n in ("norm1", "norm2"):
        out[b + n + "/scale"] = ((L, d), "scale", 0.1)
        if m["norm"] == "layernorm":
            out[b + n + "/bias"] = ((L, d), "bias", 0.1)
    if m["activation"] == "swiglu":
        out[b + "mlp/w_gate"] = ((L, d, dff), "normal", d ** -0.5)
    elif m["activation"] != "relu2":
        raise ValueError(f"activation {m['activation']!r} has no reference")
    out[b + "mlp/w_up"] = ((L, d, dff), "normal", d ** -0.5)
    out[b + "mlp/w_down"] = ((L, dff, d), "normal", dff ** -0.5)
    out["stack/final_norm/scale"] = ((d,), "scale", 0.1)
    if m["norm"] == "layernorm":
        out["stack/final_norm/bias"] = ((d,), "bias", 0.1)
    out["head/w_head"] = ((d, V), "normal", d ** -0.5)
    return out


def make_weights(m: dict, seed: int, device) -> dict:
    """The nested parameter tree, bf16, drawn on ``device`` by one
    generator seeded with ``seed``: the same seed gives the same weights."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    tree: dict = {}
    for path, (shape, kind, std) in layout(m).items():
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        t.normal_(1.0 if kind == "scale" else 0.0, std, generator=gen)
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = t
    return tree


def _leaf(w: dict, path: str):
    for p in path.split("/"):
        w = w[p]
    return w


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8_e4m3fn with one scale along ``dim`` (the
    largest magnitude maps to 448), returned in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    q = (x / s).to(torch.float8_e4m3fn)
    return q.float().mul_(s)


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x [T, in] (f32) @ w [in, out] (any dtype) in float32; the control
    rounds x a row and w a column to fp8 first."""
    wf = w.float()
    if fp8:
        return _fp8(x, -1) @ _fp8(wf, 0)
    return x @ wf


def _norm(x, scale, bias, kind: str, eps: float):
    if kind == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * scale.float() + \
            bias.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * \
        scale.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, D]: rotary embedding over the halves of D at positions
    0..T-1."""
    T, D = x.shape[0], x.shape[-1]
    half = D // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal grouped-query attention: q [T, H, D], k/v [T, Hkv, D] →
    [T, H, D], one KV head's query group at a time."""
    T, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for g in range(Hkv):
        qg = q[:, g * G:(g + 1) * G].transpose(0, 1)          # [G, T, D]
        s = qg @ k[:, g].T * D ** -0.5                          # [G, T, T]
        s = s.masked_fill(~mask, float("-inf"))
        out[:, g * G:(g + 1) * G] = (torch.softmax(s, -1) @ v[:, g]) \
            .transpose(0, 1)
    return out


def logits(weights: dict, m: dict, seqs: Sequence[Tuple[torch.Tensor, int]],
           precision: str = "float32", vocab_block: int = 32768
           ) -> List[torch.Tensor]:
    """For each ``(tokens [T] int, first)``: the float32 logits [T - first,
    V] at positions ``first..T-1`` (each row predicts the next token).
    ``precision`` is ``"float32"`` (TF32 off) or ``"fp8"``, the control."""
    if precision not in ("float32", "fp8"):
        raise ValueError(f"precision {precision!r}")
    fp8 = precision == "fp8"
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits(weights, m, seqs, fp8, vocab_block)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def _logits(weights, m, seqs, fp8: bool, vocab_block: int):
    L, H, Hkv, hd = m["num_layers"], m["num_heads"], m["num_kv_heads"], \
        _hd(m)
    eps, kind = m["norm_eps"], m["norm"]
    emb = _leaf(weights, "embed/embedding")
    xs = [emb[t.long().to(emb.device)].float() for t, _ in seqs]
    blk = _leaf(weights, "stack/blocks")

    def norm(x, name, i):
        p = blk[name]
        return _norm(x, p["scale"][i], p["bias"][i] if "bias" in p else None,
                     kind, eps)

    for i in range(L):
        a = blk["attn"]
        hs = [norm(x, "norm1", i) for x in xs]
        flat = {n: a[n][i].reshape(a[n].shape[1], -1)
                for n in ("w_q", "w_k", "w_v")}
        for j, h in enumerate(hs):
            T = h.shape[0]
            q = _mm(h, flat["w_q"], fp8).view(T, H, hd)
            k = _mm(h, flat["w_k"], fp8).view(T, Hkv, hd)
            v = _mm(h, flat["w_v"], fp8).view(T, Hkv, hd)
            if m.get("qk_norm"):
                q = _norm(q, a["q_norm"][i], None, "rmsnorm", eps)
                k = _norm(k, a["k_norm"][i], None, "rmsnorm", eps)
            q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
            o = _attention(q, k, v).reshape(T, H * hd)
            xs[j] = xs[j] + _mm(o, a["w_o"][i].reshape(H * hd, -1), fp8)
        mlp = blk["mlp"]
        for j, x in enumerate(xs):
            h = norm(x, "norm2", i)
            up = _mm(h, mlp["w_up"][i], fp8)
            if m["activation"] == "swiglu":
                g = _mm(h, mlp["w_gate"][i], fp8)
                act = torch.nn.functional.silu(g) * up
            else:
                act = torch.square(torch.relu(up))
            xs[j] = x + _mm(act, mlp["w_down"][i], fp8)
    fn = _leaf(weights, "stack/final_norm")
    head = _leaf(weights, "head/w_head")
    out = []
    for x, (_, first) in zip(xs, seqs):
        h = _norm(x[first:], fn["scale"], fn.get("bias"), kind, eps)
        out.append(torch.cat([_mm(h, head[:, c:c + vocab_block], fp8)
                              for c in range(0, head.shape[1], vocab_block)],
                             -1))
    return out


def served_gap(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each served token's reference logit lies below the
    reference's best at its position: ``ref`` [n, V], ``tokens`` [n]."""
    got = ref.gather(1, tokens.long().to(ref.device)[:, None])[:, 0]
    return ref.max(-1).values - got


def n_params(m: dict) -> int:
    return sum(math.prod(s) for s, _, _ in layout(m).values())
