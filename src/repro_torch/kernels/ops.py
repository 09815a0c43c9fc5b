"""Dispatch by tensor device: a CUDA tensor goes to the hand-written CUDA
kernel (which raises on what it does not take), a CPU tensor goes to the
plain PyTorch version in ``ref.py``.  There is no fallback between the
two: a CUDA tensor never reaches a plain version.  Flash attention goes
through its autograd function on both devices, so the train-mode forward
carries gradients (through the backward kernels on the card); the decode
kernels are forward-only."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention as _da
from repro_torch.kernels.flash_attention_bwd import flash_mha
from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention as _pda
from repro_torch.kernels.paged_verify_attention import \
    paged_verify_attention as _pva


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_positions=None,
                    kv_positions=None, kv_valid_len=None,
                    sm_scale: Optional[float] = None):
    """[B,Tq,Hq,D] x [B,Tk,Hkv,D] -> [B,Tq,Hq,D].  GQA broadcast inside;
    ``kv_positions=None`` means positions equal key indices.
    Differentiable in q, k and v (``flash_mha``)."""
    return flash_mha(q, k, v, causal=causal, window=window, softcap=softcap,
                     q_positions=q_positions, kv_positions=kv_positions,
                     kv_valid_len=kv_valid_len, sm_scale=sm_scale)


def paged_decode_attention(q, k_pages, v_pages, page_table, cache_len, *,
                           softcap: float = 0.0, window: int = 0,
                           sm_scale: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """One-token query [B,Hq,D] against a paged pool [P,page,Hkv,D]
    gathered through ``page_table`` [B,MP]; int8 pools carry scales."""
    kw = dict(softcap=softcap, window=window, sm_scale=sm_scale,
              k_scale=k_scale, v_scale=v_scale)
    if q.is_cuda:
        return _pda(q, k_pages, v_pages, page_table, cache_len, **kw)
    return ref.paged_decode_attention(q, k_pages, v_pages, page_table,
                                      cache_len, **kw)


def paged_verify_attention(q, k_pages, v_pages, page_table, cache_len, *,
                           softcap: float = 0.0, window: int = 0,
                           sm_scale: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """K1 query tokens [B,K1,Hq,D] at ``cache_len - K1 + i``, causal over a
    paged pool [P,page,Hkv,D] gathered through ``page_table`` [B,MP]."""
    kw = dict(softcap=softcap, window=window, sm_scale=sm_scale,
              k_scale=k_scale, v_scale=v_scale)
    if q.is_cuda:
        return _pva(q, k_pages, v_pages, page_table, cache_len, **kw)
    return ref.paged_verify_attention(q, k_pages, v_pages, page_table,
                                      cache_len, **kw)


def decode_attention(q, k_cache, v_cache, cache_len, *, softcap: float = 0.0,
                     window: int = 0, sm_scale: Optional[float] = None):
    """One-token query [B,Hq,D] against a dense cache [B,S,Hkv,D] valid
    below ``cache_len``."""
    kw = dict(softcap=softcap, window=window, sm_scale=sm_scale)
    if q.is_cuda:
        return _da(q, k_cache, v_cache, cache_len, **kw)
    return ref.decode_attention(q, k_cache, v_cache, cache_len, **kw)
