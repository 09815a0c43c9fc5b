// One-token decode attention through a page table, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// `src/repro/kernels/paged_decode_attention.py:paged_decode_attention`
// (`_kernel`).  Same function: q [B,Hq,D] against the page pools
// [P,page,Hkv,D] gathered through page_table [B,MP], keys valid where
// `pos < cache_len` (and `pos >= cache_len - window` with a window), the
// logit softcap after scaling, an f32 accumulator and an output of 0 for a
// row with no valid key; on int8 pools the per-token scales fold in as in
// the TPU kernel (`paged_decode_attention.py:51`, `:70`).
//
// What bounds it on an H100: bytes.  Each (sequence, KV head) reads its
// cached K and V once and does 4·G·D FLOP per key, about 2 FLOP per byte
// for tinyllama's G = 8 in bf16: the floor is the KV bytes over 3.35 TB/s.
//
// What holds it back now: the latency of the few dependent steps of one
// block (the length, the keys, the exchange of partials and one cluster
// barrier), not its bytes or products.  See `paged_attention.cuh`.
//
// Design: the kernel of `paged_attention.cuh` with one query token
// (K1 = 1): the keys of each (sequence, KV head) shared by a cluster of
// blocks sized to the grid and combined in the same launch through distributed
// shared memory, all G rows of a KV head in one block, bf16 products on
// the tensor cores.

#include "paged_attention.cuh"

// Plain C entry point, loaded with ctypes.  q_dtype: 0 = float32,
// 1 = bfloat16; kv_dtype: 0 = the q dtype, 2 = int8 (k_scale and v_scale
// [P,page,Hkv] f32 then required).  page_table [B,MP] and cache_len [B] are
// int32.  All tensors contiguous, the pools 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, void* o, const void* page_table,
    const void* cache_len, int B, int Hq, int Hkv, int D,
    int page, int MP, int q_dtype, int kv_dtype, int window, float softcap,
    float sm_scale, void* stream) {
  return paged::run<paged_decode>(
      {q, k_pages, v_pages, k_scale, v_scale, o, page_table, cache_len, B, 1,
       Hq, Hkv, D, D, page, MP, q_dtype, kv_dtype, window, softcap, sm_scale,
       static_cast<cudaStream_t>(stream)});
}
