// One-token decode attention through a page table, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// `src/repro/kernels/paged_decode_attention.py:paged_decode_attention`
// (`_kernel`).  Same function: q [B,Hq,D] against the page pools
// [P,page,Hkv,D] gathered through page_table [B,MP], keys valid where
// `pos < cache_len` (and `pos >= cache_len - window` with a window), the
// logit softcap after scaling, an f32 accumulator and an output of 0 for a
// row with no valid key.  On int8 pools the per-token scales
// k_scale/v_scale [P,page,Hkv] fold in as in the TPU kernel: the k-scale
// multiplies the logits before the softcap, the v-scale multiplies p after
// the `l` update (`paged_decode_attention.py:51`, `:70`).
//
// What bounds it on an H100: bytes.  Each (sequence, KV head) reads its
// cached K and V once and does 4·G·D FLOP per cached token, about 2 FLOP
// per byte for tinyllama's G = 8 in bf16, far below the card's ~295
// FLOP/byte balance point, so the floor is the KV bytes over 3.35 TB/s.
// At the serving path's small batch (8 sequences x 4 KV heads = 32 blocks)
// this first version cannot reach that floor: too few blocks are in flight
// to keep the memory system busy, each walking its keys one tile at a
// time.
// What holds it back now: latency, for that reason, and products in f32
// on the CUDA cores.  Splitting the key range over several blocks with a
// log-sum-exp combine is the later fix.
//
// Design.  One block of 4 warps per (KV head, sequence, group of 8 query
// heads) holds the query rows that share the KV head.  The block copies its
// own page-table row into shared memory (where the TPU kernel prefetches
// the table into SMEM for the BlockSpec index maps) and loops over tiles of
// 32 keys only up to min(cache_len, MP*page) — the Pallas grid walks all
// MP pages.  A tile may straddle pages of any size: each key finds its own
// physical page and offset.  Tiles are fetched with 16-byte loads into
// registers one tile ahead, so the next tile's loads overlap the current
// tile's arithmetic.  Keys past the valid length are not loaded but zeroed,
// and p is masked as well as the logits, so stale page rows can never
// reach the accumulator (0·x stays 0).  In a tile each lane owns one key
// for the logits of its warp's 2 rows and D/32 output columns for P·V,
// through the tile loader and softmax step of attention_common.cuh.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;   // query heads per block

template <int D>
size_t smem_bytes(int MP) {
  return sizeof(float) * (kRows * D + 2 * kBK * D + 2 * kBK) +
         sizeof(int) * MP;
}

template <typename TQ, typename TKV, int D, bool SCALED>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, TQ* __restrict__ o,
    const int* __restrict__ page_table, const int* __restrict__ cache_len,
    int Hq, int Hkv, int G, int page, int MP, int window, float softcap,
    float sm_scale) {
  constexpr int C = D / 32;
  constexpr int RW = kRowsPerWarp;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);    // [kRows][D], scaled
  float* kT_s = q_s + kRows * D;                   // [D][kBK], K transposed
  float* v_s = kT_s + kBK * D;                     // [kBK][D]
  float* ks_s = v_s + kBK * D;                     // [kBK]
  float* vs_s = ks_s + kBK;                        // [kBK]
  int* table_s = reinterpret_cast<int*>(vs_s + kBK);   // [MP]

  const int h = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[i] = g0 + r < G
                 ? to_f32(q[((size_t)b * Hq + h * G + g0 + r) * D + d]) *
                       sm_scale
                 : 0.f;
  }
  for (int i = threadIdx.x; i < MP; i += kThreads)
    table_s[i] = page_table[(size_t)b * MP + i];
  __syncthreads();

  const int valid = cache_len[b];
  const int n_keys = max(0, min(valid, MP * page));
  const int first = window > 0 ? max(0, valid - window) : 0;
  // (pool row, KV head) of the key at `pos`
  auto row = [&](int pos) {
    return ((size_t)table_s[pos / page] * page + pos % page) * Hkv + h;
  };
  KVTileLoader<TKV, D, kThreads, SCALED> tiles;

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
    tiles.fetch(k_pages, v_pages, k_scale, v_scale, k_begin, n_keys, row);
  for (int k0 = k_begin; k0 < n_keys; k0 += kBK) {
    __syncthreads();                           // previous tile consumed
    tiles.stash(kT_s, v_s, ks_s, vs_s);
    __syncthreads();
    if (k0 + kBK < n_keys)                     // in flight during compute
      tiles.fetch(k_pages, v_pages, k_scale, v_scale, k0 + kBK, n_keys, row);

    const int pos = k0 + lane;
    float s[RW];
    bool ok[RW];
    qk_tile<D, RW>(q_s + warp * RW * D, kT_s, s);
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      if (SCALED) s[rr] *= ks_s[lane];       // q·(k·s) == (q·k)·s
      s[rr] = softcap_logit(s[rr], softcap);
      ok[rr] = pos < n_keys && pos >= first;
    }
    softmax_pv_tile<D, RW, SCALED>(s, ok, SCALED ? vs_s[lane] : 1.f, v_s, m,
                                   l, acc);
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = g0 + warp * RW + rr;
    if (r >= G) continue;
    const size_t row = (size_t)b * Hq + h * G + r;
    const bool empty = l[rr] == 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      store(o + row * D + c * 32 + lane, empty ? 0.f : acc[rr][c] / l[rr]);
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs;
  void* o;
  const void *table, *clen;
  int B, Hq, Hkv, page, MP, window;
  float softcap, sm_scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, bool SCALED>
cudaError_t launch(const Args& a) {
  const int G = a.Hq / a.Hkv;
  const size_t smem = smem_bytes<D>(a.MP);
  auto kernel = paged_decode_kernel<TQ, TKV, D, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.Hkv, a.B, (G + kRows - 1) / kRows), kThreads, smem,
           a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<TQ*>(a.o),
      static_cast<const int*>(a.table), static_cast<const int*>(a.clen),
      a.Hq, a.Hkv, G, a.page, a.MP, a.window, a.softcap, a.sm_scale);
  return cudaGetLastError();
}

// kv_dtype: 0 = same as q, 2 = int8 (with scales)
template <typename TQ, int D>
cudaError_t by_kv(int kv_dtype, const Args& a) {
  if (kv_dtype == 0) return launch<TQ, TQ, D, false>(a);
  if (kv_dtype == 2) return launch<TQ, int8_t, D, true>(a);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t by_dim(int D, int kv_dtype, const Args& a) {
  switch (D) {
    case 32: return by_kv<TQ, 32>(kv_dtype, a);
    case 64: return by_kv<TQ, 64>(kv_dtype, a);
    case 128: return by_kv<TQ, 128>(kv_dtype, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q_dtype: 0 = float32,
// 1 = bfloat16; kv_dtype: 0 = the q dtype, 2 = int8 (k_scale and v_scale
// [P,page,Hkv] f32 then required).  page_table [B,MP] and cache_len [B] are
// int32.  All tensors contiguous, the pools 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, void* o, const void* page_table,
    const void* cache_len, int B, int Hq, int Hkv, int D, int page, int MP,
    int q_dtype, int kv_dtype, int window, float softcap, float sm_scale,
    void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || page <= 0 || MP <= 0)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Args a{q, k_pages, v_pages, k_scale, v_scale, o, page_table,
               cache_len, B, Hq, Hkv, page, MP, window, softcap, sm_scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = q_dtype == 0   ? by_dim<float>(D, kv_dtype, a)
                    : q_dtype == 1 ? by_dim<__nv_bfloat16>(D, kv_dtype, a)
                                   : cudaErrorInvalidValue;
  return (int)err;
}
