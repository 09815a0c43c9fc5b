// Multi-token verify attention through a page table, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// `src/repro/kernels/paged_verify_attention.py:paged_verify_attention`
// (`_kernel`).  Same function: the K1 query tokens q [B,K1,Hq,D] of a
// speculative verify pass against the page pools [P,page,Hkv,D] gathered
// through page_table [B,MP].  `cache_len` already counts all K1 new tokens,
// so query i sits at qpos = cache_len - K1 + i and sees keys at
// `pos <= qpos` (and `pos > qpos - window` with a window); the softcap,
// the f32 accumulator, the 0 of a row with no visible key and the int8
// scales are as in the TPU kernel (`paged_verify_attention.py:56-59`,
// `:75-76`).
//
// What bounds it on an H100: bytes.  Each (sequence, KV head) needs its
// cached K and V once and does 4·K1·G·D FLOP per key: for tinyllama's G 8
// and K1 5 about 10 FLOP per byte in bf16, so the floor is the KV bytes
// over 3.35 TB/s.
//
// What holds it back now: as for the decode kernel, the latency of one
// block's dependent steps; over long caches the products of its 40 rows,
// which one warp of four takes two row tiles of.  See
// `paged_attention.cuh`.
//
// Design: the kernel of `paged_attention.cuh`.  All R = K1·G rows of a
// (sequence, KV head), up to 64, share each block of its cluster, so a
// verify pass reads each sequence's KV once, as the TPU kernel does
// (`paged_verify_attention.py:30-31`); more rows take more row groups.

#include "paged_attention.cuh"

namespace {
constexpr int kMaxK1 = 8;                      // spec_k_max <= 7
}

// Plain C entry point, loaded with ctypes.  q [B,K1,Hq,D] with 1 <= K1 <= 8;
// the other arguments as for `paged_decode_attention_fwd`.
extern "C" int paged_verify_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, void* o, const void* page_table,
    const void* cache_len, int B, int K1, int Hq,
    int Hkv, int D, int page, int MP, int q_dtype, int kv_dtype, int window,
    float softcap, float sm_scale, void* stream) {
  if (K1 > kMaxK1) return (int)cudaErrorInvalidValue;
  return paged::run<paged_verify>(
      {q, k_pages, v_pages, k_scale, v_scale, o, page_table, cache_len, B, K1,
       Hq, Hkv, D, page, MP, q_dtype, kv_dtype, window, softcap, sm_scale,
       static_cast<cudaStream_t>(stream)});
}
