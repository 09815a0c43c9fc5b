"""Plain PyTorch versions of the attention kernels.

Counterparts of ``repro.kernels.ref``, with the same conventions:
``NEG_INF = -0.7 * f32max`` for masked logits, probabilities explicitly
zeroed where masked, and a row with no valid key gives 0.  The CPU path
of ``kernels.ops`` runs these, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def mha(
    q: torch.Tensor,                  # [B, Tq, Hq, D]
    k: torch.Tensor,                  # [B, Tk, Hkv, D]
    v: torch.Tensor,                  # [B, Tk, Hkv, Dv]
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_positions: Optional[torch.Tensor] = None,   # [B, Tq]
    kv_positions: Optional[torch.Tensor] = None,  # [B, Tk]
    kv_valid_len: Optional[torch.Tensor] = None,  # [B]
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Tq, device=dev)[None].expand(B, Tq)
    if kv_positions is None:
        kv_positions = torch.arange(Tk, device=dev)[None].expand(B, Tk)

    qf = q.float() * scale
    # [B, Hkv, G, Tq, D] x [B, Hkv, Tk, D] -> [B, Hkv, G, Tq, Tk]
    qf = qf.reshape(B, Tq, Hkv, groups, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap

    qp = q_positions[:, None, None, :, None].long()
    kp = kv_positions[:, None, None, None, :].long()
    mask = torch.ones_like(logits, dtype=torch.bool)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (qp - kp < window)
    if kv_valid_len is not None:
        mask = mask & (kp < kv_valid_len.long()[:, None, None, None, None])
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask, probs, 0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vf)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, vf.shape[-1])
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,                  # [B, Hq, D]
    k_cache: torch.Tensor,            # [B, S, Hkv, D]
    v_cache: torch.Tensor,            # [B, S, Hkv, Dv]
    cache_len: torch.Tensor,          # [B] valid slots (incl. the new token)
    *,
    softcap: float = 0.0,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    groups = Hq // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    qf = (q.float() * scale).reshape(B, Hkv, groups, D)
    kf = k_cache.float().permute(0, 2, 1, 3)          # [B, Hkv, S, D]
    vf = v_cache.float().permute(0, 2, 1, 3)
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, kf)
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    clen = cache_len.long()[:, None, None, None]
    mask = pos < clen
    if window > 0:
        mask = mask & (pos >= clen - window)
    mask = mask.expand_as(logits)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.where(mask, torch.softmax(logits, dim=-1), 0.0)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, vf)
    return out.reshape(B, Hq, vf.shape[-1]).to(q.dtype)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """``[P, page, ...]`` pool + ``[B, MP]`` table → ``[B, MP*page, ...]``."""
    g = pages[page_table.long()]                    # [B, MP, page, ...]
    B, MP, page = g.shape[:3]
    return g.reshape(B, MP * page, *g.shape[3:])


def dequantize_pages(pages: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 pool ``[P, page, Hkv, D]`` + scales ``[P, page, Hkv]`` → f32."""
    return pages.float() * scale.float()[..., None]


def _gather_kv(k_pages, v_pages, page_table, k_scale, v_scale):
    """Dense K and V of every table row (dequantized to f32 for int8)."""
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    if k_scale is not None:
        k = dequantize_pages(k, gather_pages(k_scale, page_table))
        v = dequantize_pages(v, gather_pages(v_scale, page_table))
    return k, v


def paged_decode_attention(
    q: torch.Tensor,                  # [B, Hq, D]
    k_pages: torch.Tensor,            # [P, page, Hkv, D]
    v_pages: torch.Tensor,            # [P, page, Hkv, Dv]
    page_table: torch.Tensor,         # [B, MP] int32
    cache_len: torch.Tensor,          # [B] valid tokens (incl. the new one)
    *,
    softcap: float = 0.0,
    window: int = 0,
    sm_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # [P, page, Hkv] f32 (int8)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather the pages into a dense cache, then dense decode (int8 pools
    are dequantized first; the kernel folds the same scales in)."""
    k, v = _gather_kv(k_pages, v_pages, page_table, k_scale, v_scale)
    return decode_attention(q, k, v, cache_len, softcap=softcap,
                            window=window, sm_scale=sm_scale)


def paged_verify_attention(
    q: torch.Tensor,                  # [B, K1, Hq, D] the K1 newest tokens
    k_pages: torch.Tensor,            # [P, page, Hkv, D]
    v_pages: torch.Tensor,            # [P, page, Hkv, Dv]
    page_table: torch.Tensor,         # [B, MP] int32
    cache_len: torch.Tensor,          # [B] valid tokens (incl. all K1 new ones)
    *,
    softcap: float = 0.0,
    window: int = 0,
    sm_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # [P, page, Hkv] f32 (int8)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The speculative verify pass: gather (and dequantize) the pages, then
    causal ``mha`` with query ``i`` at ``cache_len - K1 + i`` over keys
    valid below ``cache_len``."""
    k, v = _gather_kv(k_pages, v_pages, page_table, k_scale, v_scale)
    K1 = q.shape[1]
    clen = cache_len.long()
    q_pos = clen[:, None] - K1 + torch.arange(K1, device=q.device)[None]
    return mha(q, k, v, causal=True, window=window, softcap=softcap,
               q_positions=q_pos, kv_valid_len=clen, sm_scale=sm_scale)
