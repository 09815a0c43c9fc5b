// Flash attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel.
//
// Replaces the TPU kernels of `src/repro/kernels/flash_attention_bwd.py`:
// `_dq_kernel` (launched at :198) and `_dkv_kernel` (launched at :228).
// Same function: from q [B,Tq,Hq,D], k/v [B,Tk,Hkv,D], the forward's f32
// log-sum-exp lse [B,Tq,Hq], the output's gradient do [B,Tq,Hq,D] and
// dsum = rowsum(do·o) [B,Tq,Hq] (one PyTorch reduction in the wrapper, as
// the JAX wrapper computes it outside its kernels, :168), recompute
//   s  = (q·scale)·kᵀ, soft-capped as tanh(s/c)·c,
//   p  = exp(s − lse) where the mask holds, else 0 (a select, never a
//        multiply: a row with no valid key has lse = NEG_INF, so the
//        exponent would overflow and 0·inf give NaN),
//   ds = p·(do·vᵀ − dsum), times 1 − tanh² with a softcap,
// and write dq = ds·k·scale [B,Tq,Hq,D] and dk = dsᵀ·(q·scale),
// dv = pᵀ·do [B,Tk,Hkv,D], dk and dv summed over the G query heads of a
// KV head.  Masks `kp <= qp` (causal), `qp − kp < window` and
// `kp < kv_valid_len`, explicit int32 positions; ragged edges are bounds
// masks, not padding.  Products and sums in f32, outputs in the input
// dtype.
//
// What bounds it on an H100: at the training shape (B 8, T 1024, Hq 32,
// Hkv 4, D 64, bf16, causal) the dq kernel does 3 products and the dk/dv
// kernel 4 over the 134 M (query, key) pairs the causal mask keeps, 52
// and 69 GFLOP, against about 150 MB of q, k, v, o, do, dq, dk and dv:
// both are bound by operations (0.05 and 0.07 ms at the 989 TFLOP/s of
// the bf16 tensor cores).  This first version runs its products in f32
// on the CUDA cores (67 TFLOP/s at most) and, with explicit key
// positions, as training passes them, computes every tile and masks:
// tensor cores (mma.sync / wgmma), TMA and causal tile skipping are
// later work.
//
// Layout.  The sequential grid axis of each TPU kernel becomes a loop
// inside one block, so each sum stays in registers: no atomics, and the
// same result from run to run.
//  - dq: one block per (query tile, KV head [, head group], batch), rows
//    laid out as in the forward kernel (`flash_attention.cu`): 32 rows,
//    `32/G` consecutive positions times the G query heads of one KV head
//    (more than 32 heads per KV head split over head groups).  The block
//    loops over 32-key tiles; each warp owns 4 rows, each lane one key of
//    the tile for s and do·vᵀ, then D/32 columns of dq for ds·k, with ds
//    passed by shuffles.
//  - dk/dv: one block per (32-key tile, KV head, batch).  Its query rows
//    are (position, head) pairs `R = t·G + g` of the G heads of its KV
//    head; it loops over them 32 at a time, which covers every query
//    tile and, inside it, the G heads (the group sum the JAX grid does
//    over n_q·G steps).  Each warp owns 4 keys, each lane one query row
//    for s and do·vᵀ, then D/32 columns of dk and dv.
// Tiles sit in shared memory row-major in f32 with rows padded to D + 1
// words, so a lane reading its own row and a warp reading one row across
// its lanes both hit 32 banks.  Global loads are 16 bytes a thread.
// When the key positions are the key indices (kv_pos == nullptr) a block
// skips key tiles (dq) or query rows (dk/dv) that it provably cannot see.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = 4;             // rows (dq) or keys (dk/dv) a warp owns
constexpr int kTile = kWarps * kPerWarp;   // 32 rows or keys per tile

template <int D>
constexpr int kPad = D + 1;             // shared-memory row stride, words

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kTile * kPad<D> + 4 * kTile);
}

// Loads kTile rows of D values into shared memory (row-major, stride
// D + 1, times `scale`), 16 bytes a thread: `src(r)` is row r's first
// element, or nullptr for a row outside the tensor (stored as zeros).
template <typename T, int D, typename Src>
__device__ __forceinline__ void load_tile(float* dst, Src src, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RV = D / VEC;           // loads per row
  for (int idx = threadIdx.x; idx < kTile * RV; idx += kThreads) {
    const int r = idx / RV, c = (idx % RV) * VEC;
    const T* p = src(r);
    const uint4 u = p ? load16(p + c) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * kPad<D> + c + e] = elem<T>(u, e) * scale;
  }
}

// s = a_row · b_lane and t = c_row · d_lane for the kPerWarp rows this
// warp owns of `a`/`c` (broadcast reads) against this lane's row of
// `b`/`d`: the two products every backward step starts with.
template <int D>
__device__ __forceinline__ void two_dots(const float* a, const float* b,
                                         const float* c, const float* d,
                                         float (&s)[kPerWarp],
                                         float (&t)[kPerWarp]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) s[i] = t[i] = 0.f;
#pragma unroll 8
  for (int x = 0; x < D; ++x) {
    const float bx = b[lane * kPad<D> + x], dx = d[lane * kPad<D> + x];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      s[i] = fmaf(a[i * kPad<D> + x], bx, s[i]);
      t[i] = fmaf(c[i * kPad<D> + x], dx, t[i]);
    }
  }
}

// acc[i][col] += Σ_j w_j[i] · m[j][col] over the 32 rows j of `m`, where
// lane j holds w[i] for row j (passed by shuffles) and this lane owns
// the columns col = cc·32 + lane.
template <int D>
__device__ __forceinline__ void acc_rows(const float (&w)[kPerWarp],
                                         const float* m,
                                         float (&acc)[kPerWarp][D / 32]) {
  const int lane = threadIdx.x % 32;
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    float mv[D / 32];
#pragma unroll
    for (int cc = 0; cc < D / 32; ++cc) mv[cc] = m[j * kPad<D> + cc * 32 + lane];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const float wj = __shfl_sync(kFull, w[i], j);
#pragma unroll
      for (int cc = 0; cc < D / 32; ++cc) acc[i][cc] = fmaf(wj, mv[cc], acc[i][cc]);
    }
  }
}

struct Masks {
  int causal, window, vlen;             // vlen < 0: no valid-length mask
  __device__ __forceinline__ bool ok(int qp, int kp) const {
    bool v = true;
    if (causal) v = v && kp <= qp;
    if (window > 0) v = v && qp - kp < window;
    if (vlen >= 0) v = v && kp < vlen;
    return v;
  }
};

// p and ds of one (query row, key) pair from its two products.
__device__ __forceinline__ void p_ds(float s_raw, float dp, float lse,
                                     float dsum, bool ok, float softcap,
                                     float& p, float& ds) {
  float s = s_raw, dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(s_raw / softcap);
    s = t * softcap;
    dcap = 1.f - t * t;
  }
  p = ok ? expf(s - lse) : 0.f;
  ds = p * (dp - dsum) * dcap;
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos,
                    const int* __restrict__ valid_len, T* __restrict__ dq,
                    int Tq, int Tk, int Hq, int Hkv, int G, int GB,
                    int tq_per_block, int causal, int window, float softcap,
                    float sm_scale) {
  constexpr int C = D / 32;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kTile][D+1], q·scale
  float* do_s = q_s + kTile * kPad<D>;           // [kTile][D+1]
  float* k_s = do_s + kTile * kPad<D>;           // [kTile][D+1]
  float* v_s = k_s + kTile * kPad<D>;            // [kTile][D+1]
  float* lse_s = v_s + kTile * kPad<D>;          // [kTile]
  float* dsum_s = lse_s + kTile;                  // [kTile]
  int* qp_s = reinterpret_cast<int*>(dsum_s + kTile);   // [kTile]
  int* kp_s = qp_s + kTile;                       // [kTile]

  const int b = blockIdx.z;
  const int h = blockIdx.y % Hkv, hg = blockIdx.y / Hkv;
  const int t0 = blockIdx.x * tq_per_block;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrows = tq_per_block * GB;

  // row r: query position t0 + r / GB of head h * G + hg * GB + r % GB,
  // the forward kernel's map; one function for loads and stores
  auto row_live = [&](int r) {
    return r < nrows && t0 + r / GB < Tq && hg * GB + r % GB < G;
  };
  auto row_index = [&](int r) {   // index into [B, Tq, Hq]
    return ((size_t)b * Tq + t0 + r / GB) * Hq + h * G + hg * GB + r % GB;
  };
  load_tile<T, D>(q_s, [&](int r) {
    return row_live(r) ? q + row_index(r) * D : nullptr; }, sm_scale);
  load_tile<T, D>(do_s, [&](int r) {
    return row_live(r) ? dout + row_index(r) * D : nullptr; }, 1.f);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool live = row_live(r);
    lse_s[r] = live ? lse[row_index(r)] : 0.f;
    dsum_s[r] = live ? dsum[row_index(r)] : 0.f;
    qp_s[r] = live ? q_pos[(size_t)b * Tq + t0 + r / GB] : 0;
  }
  __syncthreads();

  const Masks mk{causal, window, valid_len ? valid_len[b] : -1};
  int n_keys = Tk;
  if (kv_pos == nullptr) {    // key position == key index: bound the loop
    if (mk.vlen >= 0) n_keys = min(n_keys, mk.vlen);
    if (causal) {
      int mx = -1;
      for (int r = 0; r < kTile; ++r)
        if (row_live(r)) mx = max(mx, qp_s[r]);
      n_keys = min(n_keys, mx + 1);
    }
    n_keys = max(n_keys, 0);
  }

  float acc[kPerWarp][C];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
    for (int cc = 0; cc < C; ++cc) acc[i][cc] = 0.f;

  auto key_row = [&](const T* base, int kj) -> const T* {
    return kj < n_keys ? base + (((size_t)b * Tk + kj) * Hkv + h) * D
                       : nullptr;
  };
  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    __syncthreads();                           // previous tile consumed
    load_tile<T, D>(k_s, [&](int j) { return key_row(k, k0 + j); }, 1.f);
    load_tile<T, D>(v_s, [&](int j) { return key_row(v, k0 + j); }, 1.f);
    if (threadIdx.x < kTile) {
      const int kj = k0 + threadIdx.x;
      kp_s[threadIdx.x] =
          kj < n_keys ? (kv_pos ? kv_pos[(size_t)b * Tk + kj] : kj) : 0;
    }
    __syncthreads();

    float s[kPerWarp], dp[kPerWarp], ds[kPerWarp];
    two_dots<D>(q_s + warp * kPerWarp * kPad<D>, k_s,
                do_s + warp * kPerWarp * kPad<D>, v_s, s, dp);
    const bool key_live = k0 + lane < n_keys;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int r = warp * kPerWarp + i;
      const bool ok = key_live && row_live(r) && mk.ok(qp_s[r], kp_s[lane]);
      float p;
      p_ds(s[i], dp[i], lse_s[r], dsum_s[r], ok, softcap, p, ds[i]);
    }
    acc_rows<D>(ds, k_s, acc);
  }

#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int r = warp * kPerWarp + i;
    if (!row_live(r)) continue;
#pragma unroll
    for (int cc = 0; cc < C; ++cc)
      store(dq + row_index(r) * D + cc * 32 + lane, acc[i][cc] * sm_scale);
  }
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos,
                     const int* __restrict__ valid_len, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int Tk, int Hq, int Hkv,
                     int G, int causal, int window, float softcap,
                     float sm_scale) {
  constexpr int C = D / 32;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [kTile][D+1]
  float* v_s = k_s + kTile * kPad<D>;            // [kTile][D+1]
  float* q_s = v_s + kTile * kPad<D>;            // [kTile][D+1], q·scale
  float* do_s = q_s + kTile * kPad<D>;           // [kTile][D+1]
  float* lse_s = do_s + kTile * kPad<D>;         // [kTile]
  float* dsum_s = lse_s + kTile;                  // [kTile]
  int* qp_s = reinterpret_cast<int*>(dsum_s + kTile);   // [kTile]
  int* kp_s = qp_s + kTile;                       // [kTile]

  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_rows = Tq * G;

  auto key_live = [&](int j) { return k0 + j < Tk; };
  auto key_index = [&](int j) {   // row index into [B, Tk, Hkv]
    return ((size_t)b * Tk + k0 + j) * Hkv + h;
  };
  load_tile<T, D>(k_s, [&](int j) {
    return key_live(j) ? k + key_index(j) * D : nullptr; }, 1.f);
  load_tile<T, D>(v_s, [&](int j) {
    return key_live(j) ? v + key_index(j) * D : nullptr; }, 1.f);
  if (threadIdx.x < kTile) {
    const int kj = k0 + threadIdx.x;
    kp_s[threadIdx.x] =
        kj < Tk ? (kv_pos ? kv_pos[(size_t)b * Tk + kj] : kj) : 0;
  }

  const Masks mk{causal, window, valid_len ? valid_len[b] : -1};
  // key position == key index: a tile past kv_valid_len is never seen
  const bool tile_dead = kv_pos == nullptr && mk.vlen >= 0 && k0 >= mk.vlen;

  float dk_acc[kPerWarp][C], dv_acc[kPerWarp][C];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
    for (int cc = 0; cc < C; ++cc) dk_acc[i][cc] = dv_acc[i][cc] = 0.f;

  // query row R = t * G + g: position t of head h * G + g
  auto q_index = [&](int R) {     // index into [B, Tq, Hq]
    return ((size_t)b * Tq + R / G) * Hq + h * G + R % G;
  };
  for (int R0 = 0; R0 < n_rows && !tile_dead; R0 += kTile) {
    __syncthreads();                           // previous rows consumed
    if (threadIdx.x < kTile) {
      const int R = R0 + threadIdx.x;
      const bool live = R < n_rows;
      lse_s[threadIdx.x] = live ? lse[q_index(R)] : 0.f;
      dsum_s[threadIdx.x] = live ? dsum[q_index(R)] : 0.f;
      qp_s[threadIdx.x] = live ? q_pos[(size_t)b * Tq + R / G] : 0;
    }
    __syncthreads();
    if (kv_pos == nullptr) {   // skip rows that see none of these keys
      bool sees = false;
      if (threadIdx.x < kTile && R0 + threadIdx.x < n_rows) {
        const int qp = qp_s[threadIdx.x];
        const int last = min(k0 + kTile, Tk) - 1;
        sees = (!causal || k0 <= qp) && (window <= 0 || qp - last < window);
      }
      if (!__syncthreads_or(sees)) continue;
    }
    load_tile<T, D>(q_s, [&](int r) {
      return R0 + r < n_rows ? q + q_index(R0 + r) * D : nullptr; },
      sm_scale);
    load_tile<T, D>(do_s, [&](int r) {
      return R0 + r < n_rows ? dout + q_index(R0 + r) * D : nullptr; }, 1.f);
    __syncthreads();

    // this lane is query row R0 + lane against the warp's 4 keys
    float s[kPerWarp], dp[kPerWarp], p[kPerWarp], ds[kPerWarp];
    two_dots<D>(k_s + warp * kPerWarp * kPad<D>, q_s,
                v_s + warp * kPerWarp * kPad<D>, do_s, s, dp);
    const bool row_live = R0 + lane < n_rows;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int j = warp * kPerWarp + i;
      const bool ok = row_live && key_live(j) && mk.ok(qp_s[lane], kp_s[j]);
      p_ds(s[i], dp[i], lse_s[lane], dsum_s[lane], ok, softcap, p[i], ds[i]);
    }
    acc_rows<D>(p, do_s, dv_acc);
    acc_rows<D>(ds, q_s, dk_acc);
  }

#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int j = warp * kPerWarp + i;
    if (!key_live(j)) continue;
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      store(dk + key_index(j) * D + cc * 32 + lane, dk_acc[i][cc]);
      store(dv + key_index(j) * D + cc * 32 + lane, dv_acc[i][cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *dsum, *q_pos, *kv_pos, *valid_len;
  void *dq, *dk, *dv;
  int B, Tq, Tk, Hq, Hkv, causal, window;
  float softcap, sm_scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const int G = a.Hq / a.Hkv;
  const int GB = G < kTile ? G : kTile;       // heads per block
  const int n_groups = (G + GB - 1) / GB;
  const int tq_per_block = kTile / GB;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + tq_per_block - 1) / tq_per_block,
                  a.Hkv * n_groups, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.kv_pos),
      static_cast<const int*>(a.valid_len), static_cast<T*>(a.dq), a.Tq,
      a.Tk, a.Hq, a.Hkv, G, GB, tq_per_block, a.causal, a.window,
      a.softcap, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + kTile - 1) / kTile, a.Hkv, a.B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.kv_pos),
      static_cast<const int*>(a.valid_len), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Tq, a.Tk, a.Hq, a.Hkv, a.Hq / a.Hkv,
      a.causal, a.window, a.softcap, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, bool DQ>
cudaError_t by_dim(int D, const Args& a) {
  switch (D) {
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int run(const Args& a, int D, int dtype) {
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Tq == 0 || a.Tk == 0) return (int)cudaSuccess;
  cudaError_t err = dtype == 0   ? by_dim<float, DQ>(D, a)
                    : dtype == 1 ? by_dim<__nv_bfloat16, DQ>(D, a)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16, for q, k, v, dout and the outputs alike.  lse and dsum
// [B,Tq,Hq] f32 and q_pos [B,Tq] int32 are required; kv_pos [B,Tk] int32
// (null: positions = indices) and valid_len [B] int32 may be null.  All
// tensors contiguous, q/k/v/dout 16-byte aligned.  With Tq or Tk of 0 the
// outputs are left as they are (the wrapper zero-fills them).  Each
// returns cudaGetLastError() after its launch.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, const void* q_pos, const void* kv_pos,
    const void* valid_len, void* dq, int B, int Tq, int Tk, int Hq, int Hkv,
    int D, int dtype, int causal, int window, float softcap, float sm_scale,
    void* stream) {
  const Args a{q, k, v, dout, lse, dsum, q_pos, kv_pos, valid_len, dq,
               nullptr, nullptr, B, Tq, Tk, Hq, Hkv, causal, window, softcap,
               sm_scale, static_cast<cudaStream_t>(stream)};
  return run<true>(a, D, dtype);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, const void* q_pos, const void* kv_pos,
    const void* valid_len, void* dk, void* dv, int B, int Tq, int Tk, int Hq,
    int Hkv, int D, int dtype, int causal, int window, float softcap,
    float sm_scale, void* stream) {
  const Args a{q, k, v, dout, lse, dsum, q_pos, kv_pos, valid_len, nullptr,
               dk, dv, B, Tq, Tk, Hq, Hkv, causal, window, softcap, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, D, dtype);
}
