// Blocked causal GQA attention with online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/flash_attention.py:flash_attention`
// (`_kernel`).  Same function: q [B,Tq,Hq,D] against k [B,Tk,Hkv,D] and
// v [B,Tk,Hkv,D], explicit int32 query/key positions, the masks
// `kp <= qp` (causal), `qp - kp < window` and `kp < kv_valid_len`, the
// logit softcap `tanh(s/c)*c` after scaling, an f32 accumulator, an output
// of 0 for a row with no valid key, and the optional f32 log-sum-exp.
//
// What bounds it on an H100: at the serving path's shapes (a 16-64 token
// prefill chunk of tinyllama, G = 8 query heads per KV head, a gathered
// span of at most 1024 keys) the work is a few hundred MFLOP over about a
// MB, so the card's floor is under a microsecond either way.  What bounds
// this version is latency: a few dozen blocks for 132 SMs, each walking its
// keys tile by tile, with the products in f32 on the CUDA cores (far below
// the 989 TFLOP/s of the bf16 tensor cores).
//
// Design.  One block per (query tile, KV head [, head group], batch): its
// 32 query rows are `32/G` consecutive positions times the G query heads
// that share the KV head, so each K/V tile in shared memory serves all of
// them (the GQA map of `flash_attention.py:135-136`; more than 32 heads per
// KV head split over head groups).  The sequential KV grid axis of the TPU
// kernel becomes a loop inside the block over tiles of 32 keys.  Tiles are
// fetched with 16-byte loads into registers one tile ahead, so the next
// tile's loads are in flight while the current one is computed.  In a tile
// each lane owns one key for the logits of its warp's 4 rows (q broadcast
// from shared memory four values at a time, K stored transposed so the 32
// lanes hit 32 banks) and D/32 output columns for P·V, where each V value
// read serves all 4 rows and the probabilities pass by shuffles.
// The ragged edges are bounds masks, not padding: a key past Tk never
// counts, which is what the JAX wrapper's sentinel positions give
// (`flash_attention.py:112-122`).  When the key positions are the key
// indices (kv_pos == nullptr) the loop stops at the last key any row of
// the block can see (causal bound and kv_valid_len), so a prefill chunk
// reads only the cached prefix it attends to.  No wgmma/TMA yet.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * D + 2 * kBK * D) +
         sizeof(int) * (kBK + kRows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos,
                 const int* __restrict__ valid_len, int Tq, int Tk, int Hq,
                 int Hkv, int G, int GB, int tq_per_block, int causal,
                 int window, float softcap, float sm_scale) {
  constexpr int C = D / 32;             // output columns per lane
  constexpr int RW = kRowsPerWarp;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int RV = D / VEC;           // loads per key row
  constexpr int TV = kBK * RV;          // loads per tile (K or V)
  constexpr int NV = (TV + kThreads - 1) / kThreads;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kRows][D], pre-scaled
  float* kT_s = q_s + kRows * D;              // [D][kBK], K transposed
  float* v_s = kT_s + kBK * D;                // [kBK][D]
  int* kp_s = reinterpret_cast<int*>(v_s + kBK * D);   // [kBK]
  int* qp_s = kp_s + kBK;                     // [kRows]

  const int b = blockIdx.z;
  const int h = blockIdx.y % Hkv, hg = blockIdx.y / Hkv;
  const int t0 = blockIdx.x * tq_per_block;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrows = tq_per_block * GB;

  // row r: query position t0 + r / GB of head h * G + hg * GB + r % GB
  auto row_head = [&](int r) { return hg * GB + r % GB; };
  auto row_live = [&](int r) {
    return r < nrows && t0 + r / GB < Tq && row_head(r) < G;
  };
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (row_live(r))
      x = to_f32(q[(((size_t)b * Tq + t0 + r / GB) * Hq + h * G +
                    row_head(r)) * D + d]) * sm_scale;
    q_s[i] = x;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    qp_s[r] = row_live(r) ? q_pos[(size_t)b * Tq + t0 + r / GB] : -1;
  __syncthreads();

  const int vlen = valid_len ? valid_len[b] : Tk;
  int n_keys = Tk;
  if (kv_pos == nullptr) {    // key position == key index: bound the loop
    if (valid_len) n_keys = min(n_keys, vlen);
    if (causal) {
      int mx = -1;
      for (int r = 0; r < kRows; ++r) mx = max(mx, qp_s[r]);
      n_keys = min(n_keys, mx + 1);
    }
    n_keys = max(n_keys, 0);
  }

  // The next tile, staged in registers while the current one is computed.
  // K is spread key-fastest over the threads (its transposed store then
  // hits 32 banks), V chunk-fastest (whole rows per thread group).
  uint4 kreg[NV], vreg[NV];
  int kpreg = 0;
  auto row_off = [&](int kj) { return (((size_t)b * Tk + kj) * Hkv + h) * D; };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int kk = k0 + idx % kBK, vk = k0 + idx / RV;
      kreg[n] = vreg[n] = make_uint4(0, 0, 0, 0);
      if (idx < TV && kk < n_keys)
        kreg[n] = load16(k + row_off(kk) + (idx / kBK) * VEC);
      if (idx < TV && vk < n_keys)
        vreg[n] = load16(v + row_off(vk) + (idx % RV) * VEC);
    }
    if (threadIdx.x < kBK) {
      const int kj = k0 + threadIdx.x;
      kpreg = kj < n_keys ? (kv_pos ? kv_pos[(size_t)b * Tk + kj] : kj) : 0;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      if (idx >= TV) continue;
      const int kc = (idx / kBK) * VEC, kj = idx % kBK;
      const int vj = idx / RV, vc = (idx % RV) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kT_s[(kc + e) * kBK + kj] = elem<T>(kreg[n], e);
        v_s[vj * D + vc + e] = elem<T>(vreg[n], e);
      }
    }
    if (threadIdx.x < kBK) kp_s[threadIdx.x] = kpreg;
  };

  float m[RW], l[RW], acc[RW][C];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[rr][c] = 0.f;
  }

  if (n_keys > 0) fetch(0);
  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();                          // previous tile consumed
    stash();
    __syncthreads();
    if (k0 + kBK < n_keys) fetch(k0 + kBK);   // in flight during compute

    const bool in_range = k0 + lane < n_keys;
    const int kp = kp_s[lane];
    float s[RW];
    bool ok[RW];
    qk_tile<D, RW>(q_s + warp * RW * D, kT_s, s);
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      s[rr] = softcap_logit(s[rr], softcap);
      const int qp = qp_s[warp * RW + rr];
      ok[rr] = in_range;
      if (causal) ok[rr] = ok[rr] && kp <= qp;
      if (window > 0) ok[rr] = ok[rr] && (qp - kp < window);
      if (valid_len) ok[rr] = ok[rr] && kp < vlen;
    }
    softmax_pv_tile<D, RW, false>(s, ok, 1.f, v_s, m, l, acc);
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp * RW + rr;
    if (!row_live(r)) continue;
    const size_t row =
        ((size_t)b * Tq + t0 + r / GB) * Hq + h * G + row_head(r);
    const bool empty = l[rr] == 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      store(o + row * D + c * 32 + lane, empty ? 0.f : acc[rr][c] / l[rr]);
    if (lse != nullptr && lane == 0)
      lse[row] = m[rr] + logf(empty ? 1.f : l[rr]);
  }
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  const void *q_pos, *kv_pos, *valid_len;
  int B, Tq, Tk, Hq, Hkv, causal, window;
  float softcap, sm_scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(const Args& a) {
  const int G = a.Hq / a.Hkv;
  const int GB = G < kRows ? G : kRows;       // heads per block
  const int n_groups = (G + GB - 1) / GB;
  const int tq_per_block = kRows / GB;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + tq_per_block - 1) / tq_per_block,
                  a.Hkv * n_groups, a.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), static_cast<const int*>(a.q_pos),
      static_cast<const int*>(a.kv_pos),
      static_cast<const int*>(a.valid_len), a.Tq, a.Tk, a.Hq, a.Hkv, G, GB,
      tq_per_block, a.causal, a.window, a.softcap, a.sm_scale);
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

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// q_pos [B,Tq] int32 is required; kv_pos [B,Tk] int32 may be null (positions
// = indices); valid_len [B] int32 and lse [B,Tq,Hq] f32 may be null.  All
// tensors contiguous, q/k/v 16-byte aligned.  Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const void* q_pos, const void* kv_pos,
                                   const void* valid_len, int B, int Tq,
                                   int Tk, int Hq, int Hkv, int D, int dtype,
                                   int causal, int window, float softcap,
                                   float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (Tq == 0 || B == 0) return (int)cudaSuccess;
  const Args a{q, k, v, o, lse, q_pos, kv_pos, valid_len, B, Tq, Tk, Hq,
               Hkv, causal, window, softcap, sm_scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = dtype == 0   ? by_dim<float>(D, a)
                    : dtype == 1 ? by_dim<__nv_bfloat16>(D, a)
                                 : cudaErrorInvalidValue;
  return (int)err;
}
