// Multi-token verify attention through a page table, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// `src/repro/kernels/paged_verify_attention.py:paged_verify_attention`
// (`_kernel`).  Same function: the K1 query tokens q [B,K1,Hq,D] of a
// speculative verify pass against the page pools [P,page,Hkv,D] gathered
// through page_table [B,MP].  `cache_len` already counts all K1 new tokens,
// so query i sits at qpos = cache_len - K1 + i and sees keys at
// `pos <= qpos` (and `pos > qpos - window` with a window).  The logit
// softcap applies after scaling, the accumulator is f32 and a row with no
// visible key gives 0.  On int8 pools the per-token scales k_scale/v_scale
// [P,page,Hkv] fold in as in the TPU kernel: the k-scale multiplies the
// logits before the softcap, the v-scale multiplies p after the `l` update
// (`paged_verify_attention.py:56-59`, `:75-76`).
//
// What bounds it on an H100: bytes.  Each (sequence, KV head) needs its
// cached K and V once and does 4·K1·G·D FLOP per cached token: for
// tinyllama's G = 8 and K1 = 5 about 10 FLOP per byte in bf16, far below the
// card's ~295 FLOP/byte balance point, so the floor is the KV bytes over
// 3.35 TB/s.  This first version, like the paged decode kernel it grows
// from, cannot reach that floor at the serving batch: too few blocks, each
// walking its keys one tile at a time.
// What holds it back now: latency, for that reason, and the K1 reads of
// the KV a pass that the row split below makes (see Design).
//
// Design.  The paged decode kernel's block, applied to the R = K1·G query
// rows of one (sequence, KV head).  Rows are laid out as the JAX wrapper
// lays them out (`paged_verify_attention.py:113`): row r = i·G + g is query
// token i = r / G of head kvh·G + g.  One block of 4 warps per (KV head,
// sequence, group of 8 rows): the 8 rows of a block share each K/V tile in
// shared memory, but the R rows of one (sequence, KV head) are split over
// ceil(R / 8) blocks, each of which streams that sequence's KV itself.
// With tinyllama's G = 8 a block holds one query token's heads, so a
// verify pass reads the KV K1 times (whether the re-reads come from L2 is
// not measured).  One block over all R rows is the next step for speed
// (ROADMAP Queue A).  The block copies its page-table row into shared
// memory and loops over 32-key tiles only up to the last key any of its
// rows can see (at most min(cache_len, MP*page)), starting, with a window,
// at the first tile any row can see.  Keys at or past cache_len are never
// loaded: a rejected speculative suffix of an earlier round and the trash
// page of unowned rows lie there.  Tiles come through the shared
// `KVTileLoader` (16-byte loads one tile ahead) and the online-softmax step
// of attention_common.cuh; each row applies its own causal limit, and p is
// masked as well as the logits.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kMaxK1 = 8;                      // spec_k_max <= 7

template <int D>
size_t smem_bytes(int MP) {
  return sizeof(float) * (kRows * D + 2 * kBK * D + 2 * kBK) +
         sizeof(int) * MP;
}

template <typename TQ, typename TKV, int D, bool SCALED>
__global__ void __launch_bounds__(kThreads) paged_verify_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, TQ* __restrict__ o,
    const int* __restrict__ page_table, const int* __restrict__ cache_len,
    int K1, int Hq, int Hkv, int G, int page, int MP, int window,
    float softcap, float sm_scale) {
  constexpr int C = D / 32;
  constexpr int RW = kRowsPerWarp;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);    // [kRows][D], scaled
  float* kT_s = q_s + kRows * D;                   // [D][kBK], K transposed
  float* v_s = kT_s + kBK * D;                     // [kBK][D]
  float* ks_s = v_s + kBK * D;                     // [kBK]
  float* vs_s = ks_s + kBK;                        // [kBK]
  int* table_s = reinterpret_cast<int*>(vs_s + kBK);   // [MP]

  const int h = blockIdx.x, b = blockIdx.y, r0 = blockIdx.z * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int R = K1 * G;
  // block row r is row r0 + r of the (sequence, KV head): query token
  // (r0 + r) / G of head h * G + (r0 + r) % G
  auto q_row = [&](int r) {
    const int rr = r0 + r;
    return ((size_t)b * K1 + rr / G) * Hq + h * G + rr % G;
  };

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[i] = r0 + r < R ? to_f32(q[q_row(r) * D + d]) * sm_scale : 0.f;
  }
  for (int i = threadIdx.x; i < MP; i += kThreads)
    table_s[i] = page_table[(size_t)b * MP + i];
  __syncthreads();

  const int valid = cache_len[b];
  const int base = valid - K1;                     // qpos of query token 0
  const int qi_lo = r0 / G, qi_hi = min(R - 1, r0 + kRows - 1) / G;
  // keys any row of this block can see: [first, n_keys)
  const int n_keys = max(0, min(min(valid, MP * page), base + qi_hi + 1));
  const int first = window > 0 ? max(0, base + qi_lo - window + 1) : 0;
  // (pool row, KV head) of the key at `pos`
  auto row = [&](int pos) {
    return ((size_t)table_s[pos / page] * page + pos % page) * Hkv + h;
  };
  KVTileLoader<TKV, D, kThreads, SCALED> tiles;

  float m[RW], l[RW], acc[RW][C];
  int qpos[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[rr][c] = 0.f;
    const int r = r0 + warp * RW + rr;
    qpos[rr] = r < R ? base + r / G : -1;          // a dead row sees nothing
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
      ok[rr] = pos < n_keys && pos <= qpos[rr] &&
               (window <= 0 || pos > qpos[rr] - window);
    }
    softmax_pv_tile<D, RW, SCALED>(s, ok, SCALED ? vs_s[lane] : 1.f, v_s, m,
                                   l, acc);
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp * RW + rr;
    if (r0 + r >= R) continue;
    const size_t out_row = q_row(r);
    const bool empty = l[rr] == 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      store(o + out_row * D + c * 32 + lane,
            empty ? 0.f : acc[rr][c] / l[rr]);
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs;
  void* o;
  const void *table, *clen;
  int B, K1, Hq, Hkv, page, MP, window;
  float softcap, sm_scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, bool SCALED>
cudaError_t launch(const Args& a) {
  const int G = a.Hq / a.Hkv;
  const size_t smem = smem_bytes<D>(a.MP);
  auto kernel = paged_verify_kernel<TQ, TKV, D, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.Hkv, a.B, (a.K1 * G + kRows - 1) / kRows), kThreads, smem,
           a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<TQ*>(a.o),
      static_cast<const int*>(a.table), static_cast<const int*>(a.clen),
      a.K1, a.Hq, a.Hkv, G, a.page, a.MP, a.window, a.softcap, a.sm_scale);
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

// Plain C entry point, loaded with ctypes.  q [B,K1,Hq,D] with 1 <= K1 <= 8;
// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = the q dtype, 2 = int8
// (k_scale and v_scale [P,page,Hkv] f32 then required).  page_table [B,MP]
// and cache_len [B] are int32.  All tensors contiguous, the pools 16-byte
// aligned.  Returns cudaGetLastError() after the launch.
extern "C" int paged_verify_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, void* o, const void* page_table,
    const void* cache_len, int B, int K1, int Hq, int Hkv, int D, int page,
    int MP, int q_dtype, int kv_dtype, int window, float softcap,
    float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || page <= 0 || MP <= 0 || K1 < 1 ||
      K1 > kMaxK1)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Args a{q, k_pages, v_pages, k_scale, v_scale, o, page_table,
               cache_len, B, K1, Hq, Hkv, page, MP, window, softcap,
               sm_scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = q_dtype == 0   ? by_dim<float>(D, kv_dtype, a)
                    : q_dtype == 1 ? by_dim<__nv_bfloat16>(D, kv_dtype, a)
                                   : cudaErrorInvalidValue;
  return (int)err;
}
