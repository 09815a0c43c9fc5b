// One-token decode attention over a dense cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/decode_attention.py:
// decode_attention` (`_kernel`).  Same function: q [B,Hq,D] against the
// dense caches k/v [B,S,Hkv,D], keys valid where `pos < cache_len` (and
// `pos >= cache_len - window` with a window), the logit softcap after
// scaling, an f32 accumulator and an output of 0 for a row with no valid
// key.  The speculative draft model calls it at every draft decode step
// over its slot cache (`serving/spec_decode.py`).  Values as wide as keys
// only (Dv == D); the MLA absorbed decode, whose values are narrower, is
// not ported.
//
// What bounds it on an H100: bytes.  Each (sequence, KV head) reads its
// valid K and V once and does 4·G·D FLOP per key, about 2 FLOP per byte
// for G = 8 in bf16, far below the card's balance point, so the floor is
// the valid KV bytes over 3.35 TB/s.  As with the paged decode kernel, the
// draft's small batch (8 sequences x 4 KV heads = 32 blocks) keeps this
// first version far from that floor.
// What holds it back now: latency, for that reason; a split of the key
// range with a log-sum-exp combine would fill the card.
//
// Design.  The paged decode kernel's block with a dense row map: one block
// of 4 warps per (KV head, sequence, group of 8 query heads) loops over
// tiles of 32 keys only up to min(cache_len, S), from the first tile the
// window lets through.  The Pallas wrapper pads S to its key block
// (`decode_attention.py:82-87`); here the loop bound masks the ragged edge
// instead, and nothing past it is loaded.  A key's row in the cache is
// ((b·S + pos)·Hkv + h): the head stride is the cache's, not a pool's.
// Tiles come through the shared `KVTileLoader` (16-byte loads one tile
// ahead) and the online-softmax step of attention_common.cuh.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;   // query heads per block

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * D + 2 * kBK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, T* __restrict__ o,
    const int* __restrict__ cache_len, int S, int Hq, int Hkv, int G,
    int window, float softcap, float sm_scale) {
  constexpr int C = D / 32;
  constexpr int RW = kRowsPerWarp;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);    // [kRows][D], scaled
  float* kT_s = q_s + kRows * D;                   // [D][kBK], K transposed
  float* v_s = kT_s + kBK * D;                     // [kBK][D]

  const int h = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[i] = g0 + r < G
                 ? to_f32(q[((size_t)b * Hq + h * G + g0 + r) * D + d]) *
                       sm_scale
                 : 0.f;
  }
  __syncthreads();

  const int valid = cache_len[b];
  const int n_keys = max(0, min(valid, S));
  const int first = window > 0 ? max(0, valid - window) : 0;
  // (cache row, KV head) of the key at `pos`
  auto row = [&](int pos) { return ((size_t)b * S + pos) * Hkv + h; };
  KVTileLoader<T, D, kThreads, false> tiles;

  float m[RW], l[RW], acc[RW][C];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[rr][c] = 0.f;
  }

  const int k_begin = (first / kBK) * kBK;
  if (k_begin < n_keys)
    tiles.fetch(k_cache, v_cache, nullptr, nullptr, k_begin, n_keys, row);
  for (int k0 = k_begin; k0 < n_keys; k0 += kBK) {
    __syncthreads();                           // previous tile consumed
    tiles.stash(kT_s, v_s, nullptr, nullptr);
    __syncthreads();
    if (k0 + kBK < n_keys)                     // in flight during compute
      tiles.fetch(k_cache, v_cache, nullptr, nullptr, k0 + kBK, n_keys, row);

    const int pos = k0 + lane;
    float s[RW];
    bool ok[RW];
    qk_tile<D, RW>(q_s + warp * RW * D, kT_s, s);
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      s[rr] = softcap_logit(s[rr], softcap);
      ok[rr] = pos < n_keys && pos >= first;
    }
    softmax_pv_tile<D, RW, false>(s, ok, 1.f, v_s, m, l, acc);
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = g0 + warp * RW + rr;
    if (r >= G) continue;
    const size_t out_row = (size_t)b * Hq + h * G + r;
    const bool empty = l[rr] == 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      store(o + out_row * D + c * 32 + lane,
            empty ? 0.f : acc[rr][c] / l[rr]);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  const void* clen;
  int B, S, Hq, Hkv, window;
  float softcap, sm_scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(const Args& a) {
  const int G = a.Hq / a.Hkv;
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.Hkv, a.B, (G + kRows - 1) / kRows), kThreads, smem,
           a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<const int*>(a.clen), a.S, a.Hq, a.Hkv, G, a.window,
      a.softcap, a.sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const Args& a) {
  switch (D) {
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

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
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Args a{q, k_cache, v_cache, o, cache_len, B, S, Hq, Hkv, window,
               softcap, sm_scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = dtype == 0   ? by_dim<float>(D, a)
                    : dtype == 1 ? by_dim<__nv_bfloat16>(D, a)
                                 : cudaErrorInvalidValue;
  return (int)err;
}
