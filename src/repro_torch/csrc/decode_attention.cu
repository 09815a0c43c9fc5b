// One-token decode attention over a dense cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/decode_attention.py:
// decode_attention` (`_kernel`).  Same function: q [B,Hq,D] against the
// dense caches k/v [B,S,Hkv,D], keys valid where `pos < min(cache_len, S)`
// (and `pos >= cache_len - window` with a window), the logit softcap after
// scaling, an f32 accumulator and an output of 0 for a row with no valid
// key.  Two serving paths call it: the speculative draft at every draft
// decode step over its slot cache (`serving/spec_decode.py`; tinyllama's
// G 8), and zamba2's shared attention block at every decode step over its
// dense slots (`models/attention.py:decode_step`; G 1).  Values as wide as
// keys only (Dv == D); the MLA absorbed decode, whose values are
// narrower, is not ported.
//
// What bounds it on an H100: bytes.  Each (sequence, KV head) reads its
// valid K and V once and does 4·G·D FLOP per key: 2 FLOP per byte at the
// draft's G 8 in bf16, 0.25 at zamba2's G 1, far below the card's ~295,
// so the floor is the valid KV bytes over 3.35 TB/s: under 1 µs for the
// draft (B 8, Hkv 4, lengths 36-543), about 6 µs for zamba2 (Hkv 32).
//
// What holds it back now: at the draft's shape, as for the paged kernel,
// the latency of a block's short chain (the length, the keys, the
// exchange and the combine); at zamba2's, the same chain and then the KV
// streaming at about three quarters of the memory rate (`PERF.md` §6).
//
// Design: the kernel of `paged_attention.cuh` with one query token, its
// `dense_decode` kind reading a dense cache as B pages of S keys through
// the identity table, computed in place of a table slice (the key at `pos`
// of sequence b is row (b·S + pos)·Hkv + h), so a block goes from its
// length straight to its keys.  The keys of each (sequence, KV head) are
// shared by a cluster of blocks sized to the grid, as the paged kernels'
// are (one block, and no cluster, when the (sequence, KV head) pairs
// alone fill the card, as zamba2's 256 do), combined in the same launch;
// all G rows of a KV head in one block, bf16 products on the tensor
// cores.

#include "paged_attention.cuh"

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16, the same for q and the caches.  q [B,Hq,D], k/v caches
// [B,S,Hkv,D], cache_len [B] int32.  All tensors contiguous, the caches
// 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, void* o,
                                    const void* cache_len, int B, int S,
                                    int Hq, int Hkv, int D, int dtype,
                                    int window, float softcap,
                                    float sm_scale, void* stream) {
  return paged::run<dense_decode>(
      {q, k_cache, v_cache, nullptr, nullptr, o, nullptr, cache_len, B, 1,
       Hq, Hkv, D, S, 1, dtype, 0, window, softcap, sm_scale,
       static_cast<cudaStream_t>(stream)});
}
