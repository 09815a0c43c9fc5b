// Flash attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel, in bf16 on the tensor cores (wgmma) and in fp32 on the
// CUDA cores.
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
// masks, not padding.  Sums in f32, outputs in the input dtype.
//
// What bounds it on an H100: at the training shape (B 8, T 1024, Hq 32,
// Hkv 4, D 64, bf16, causal) the dq kernel does 3 products and the dk/dv
// kernel 4 over the 134 M (query, key) pairs the causal mask keeps, 52
// and 69 GFLOP, against about 150 MB of q, k, v, o, do, dq, dk and dv:
// both are bound by operations (0.05 and 0.07 ms at the 989 TFLOP/s of
// the bf16 tensor cores).
//
// What the design does about it (bf16):
//  - Tensor cores.  Every product is a `wgmma` of 64 rows: s and do·vᵀ
//    (m64n64k16, both operands from shared memory), then dq += ds·k,
//    dv += pᵀ·do and dk += dsᵀ·q (m64nDk16, the bf16-rounded p or ds
//    straight from the f32 accumulator registers as the A operand, the
//    tile in shared memory as an MN-major B).  The scale multiplies the
//    f32 sums (s, and dq and dk at the end), never the bf16 operands.
//  - Tile skipping from the positions themselves.  Before its loop a
//    block reduces the least and largest position of the live rows and
//    keys of every tile pair it will meet and classes each pair: skipped
//    when no pair can be kept (`causal && kp_min > qp_max`,
//    `qp_min − kp_max >= window`, `kp_min >= kv_valid_len`), computed
//    without the per-element mask when every pair is kept and the tile
//    has no ragged edge, else masked.  No host sync, and nothing assumes
//    that positions are indices: at the train step's causal T 1024 about
//    half the 64 x 64 tiles are computed.
//  - K and V shared across the G heads.  A dq block's 64 rows are 64/G
//    positions times the G heads of one KV head (the forward kernel's map),
//    and a dk/dv block loops over all Tq·G rows of its KV head, so each
//    K/V tile in shared memory serves every head that reads it, and the
//    group sum stays in registers: no atomics, the same result from run
//    to run.
//  - Copies.  Tiles arrive by 16-byte `cp.async` into a two-stage ring in
//    the 128-byte swizzled layout `wgmma` reads (64-byte at D 32), the
//    next tile in flight while the current one is computed; rows outside
//    the tensor are zero-filled, never read.
//  - Little arithmetic between the products: p = 2^(s·scale·log2e −
//    lse·log2e) is one FMA and one `ex2.approx`, the mask and softcap code
//    only in the tiles that need them, and p is computed while do·vᵀ is
//    still on the tensor cores (dk/dv: ds while pᵀ·do is).
//  - Order.  The blocks that under a causal mask have the most tiles are
//    launched first (dq: the last query tile; dk/dv: the first key tile),
//    since the longest block bounds the kernel.
// What holds it back now: latency.  Three dq or two dk/dv blocks of one
// warpgroup fit an SM at D 64 (registers), and each runs its tile as a
// chain (two products, the softmax, two more, two barriers), so the
// tensor cores idle most of the time; the dk/dv block of the first key
// tile walks every row tile and spans most of the kernel.  Left for later: a producer warp
// with TMA and warp specialisation (the next tile's products under this
// tile's softmax), a persistent grid balancing the causal triangle, and
// dq fused into the dk/dv kernel with a deterministic reduction.
//
// Layout (bf16).  One warpgroup of 128 threads a block.
//  - dq: one block per (64-row query tile, KV head [, head group],
//    batch); rows `r` are position t0 + r / GB of head h·G + hg·GB + r % GB
//    with GB = min(G, 64).  q and do are loaded once; the block loops over
//    the 64-key tiles it does not skip.
//  - dk/dv: one block per (64-key tile, KV head, batch), K and V loaded
//    once; it loops over the query rows R = t·G + g of its KV head, 64 at
//    a time, with their lse, dsum and positions.
//
// fp32 stays on the CUDA cores: a bf16 or TF32 product would miss the
// 2e-5 tolerance of the fp32 checks and the golden training replay.
// Those kernels (32-row tiles in shared memory padded to D + 1 words,
// 16-byte loads) class their tiles the same way and skip the empty ones.
//
// The masks, the tile planning and the wgmma, copy and ring helpers live
// in `flash_common.cuh`, shared with the forward kernel.

#include "flash_common.cuh"

// This file's own code sits in anonymous namespaces inside `flash`.
namespace flash {

// ---------------------------------------------------------------------------
// fp32: the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {
namespace {

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

// p and ds of one (query row, key) pair from its two products (s scaled,
// q having been loaded times the scale).
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

// Loads kTile rows of D values into shared memory (row-major, stride
// D + 1, times `scale`), 16 bytes a thread: `src(r)` is row r's first
// element, or nullptr for a row outside the tensor (stored as zeros).
template <int D, typename Src>
__device__ __forceinline__ void load_tile(float* dst, Src src, float scale) {
  constexpr int RV = D / 4;             // loads per row
  for (int idx = threadIdx.x; idx < kTile * RV; idx += kThreads) {
    const int r = idx / RV, c = (idx % RV) * 4;
    const float* p = src(r);
    const uint4 u = p ? load16(p + c) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[r * kPad<D> + c + e] = elem<float>(u, e) * scale;
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

// dq: one block per (32-row query tile, KV head [, head group], batch),
// rows laid out as in the forward kernel; it loops over the 32-key tiles
// it does not skip.  Each warp owns 4 rows, each lane one key of the tile
// for s and do·vᵀ, then D/32 columns of dq for ds·k, with ds passed by
// shuffles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos,
                    const int* __restrict__ valid_len, float* __restrict__ dq,
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
  load_tile<D>(q_s, [&](int r) {
    return row_live(r) ? q + row_index(r) * D : nullptr; }, sm_scale);
  load_tile<D>(do_s, [&](int r) {
    return row_live(r) ? dout + row_index(r) * D : nullptr; }, 1.f);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool live = row_live(r);
    lse_s[r] = live ? lse[row_index(r)] : 0.f;
    dsum_s[r] = live ? dsum[row_index(r)] : 0.f;
    qp_s[r] = live ? q_pos[(size_t)b * Tq + t0 + r / GB] : 0;
  }
  __syncthreads();

  const Masks mk{causal, window, valid_len ? valid_len[b] : -1};
  int qmin, qmax;
  bool rows_whole;
  live_bounds(kTile, row_live, [&](int r) { return qp_s[r]; }, qmin, qmax,
              rows_whole);

  float acc[kPerWarp][C];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
    for (int cc = 0; cc < C; ++cc) acc[i][cc] = 0.f;

  auto key_row = [&](const float* base, int kj) -> const float* {
    return kj < Tk ? base + (((size_t)b * Tk + kj) * Hkv + h) * D : nullptr;
  };
  for (int k0 = 0; k0 < Tk; k0 += kTile) {
    __syncthreads();                           // previous tile consumed
    if (threadIdx.x < kTile) {
      const int kj = k0 + threadIdx.x;
      kp_s[threadIdx.x] =
          kj < Tk ? (kv_pos ? kv_pos[(size_t)b * Tk + kj] : kj) : 0;
    }
    __syncthreads();
    int kmin, kmax;
    bool keys_whole;
    live_bounds(kTile, [&](int j) { return k0 + j < Tk; },
                [&](int j) { return kp_s[j]; }, kmin, kmax, keys_whole);
    const int cls = tile_class(mk, qmin, qmax, kmin, kmax,
                               !(rows_whole && keys_whole));
    if (cls == kTileSkip) continue;                // uniform over the block
    load_tile<D>(k_s, [&](int j) { return key_row(k, k0 + j); }, 1.f);
    load_tile<D>(v_s, [&](int j) { return key_row(v, k0 + j); }, 1.f);
    __syncthreads();

    float s[kPerWarp], dp[kPerWarp], ds[kPerWarp];
    two_dots<D>(q_s + warp * kPerWarp * kPad<D>, k_s,
                do_s + warp * kPerWarp * kPad<D>, v_s, s, dp);
    const bool key_live = k0 + lane < Tk;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int r = warp * kPerWarp + i;
      const bool ok = cls == kTileFull ||
                      (key_live && row_live(r) && mk.ok(qp_s[r], kp_s[lane]));
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
      dq[row_index(r) * D + cc * 32 + lane] = acc[i][cc] * sm_scale;
  }
}

// dk/dv: one block per (32-key tile, KV head, batch).  Its query rows are
// (position, head) pairs `R = t·G + g` of the G heads of its KV head; it
// loops over them 32 at a time, skipping the row tiles that see none of
// its keys.  Each warp owns 4 keys, each lane one query row for s and
// do·vᵀ, then D/32 columns of dk and dv.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos,
                     const int* __restrict__ valid_len,
                     float* __restrict__ dk, float* __restrict__ dv, int Tq,
                     int Tk, int Hq, int Hkv, int G, int causal, int window,
                     float softcap, float sm_scale) {
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
  load_tile<D>(k_s, [&](int j) {
    return key_live(j) ? k + key_index(j) * D : nullptr; }, 1.f);
  load_tile<D>(v_s, [&](int j) {
    return key_live(j) ? v + key_index(j) * D : nullptr; }, 1.f);
  if (threadIdx.x < kTile) {
    const int kj = k0 + threadIdx.x;
    kp_s[threadIdx.x] =
        kj < Tk ? (kv_pos ? kv_pos[(size_t)b * Tk + kj] : kj) : 0;
  }
  __syncthreads();

  const Masks mk{causal, window, valid_len ? valid_len[b] : -1};
  int kmin, kmax;
  bool keys_whole;
  live_bounds(kTile, key_live, [&](int j) { return kp_s[j]; }, kmin, kmax,
              keys_whole);

  float dk_acc[kPerWarp][C], dv_acc[kPerWarp][C];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
    for (int cc = 0; cc < C; ++cc) dk_acc[i][cc] = dv_acc[i][cc] = 0.f;

  // query row R = t * G + g: position t of head h * G + g
  auto q_index = [&](int R) {     // index into [B, Tq, Hq]
    return ((size_t)b * Tq + R / G) * Hq + h * G + R % G;
  };
  for (int R0 = 0; R0 < n_rows; R0 += kTile) {
    __syncthreads();                           // previous rows consumed
    if (threadIdx.x < kTile) {
      const int R = R0 + threadIdx.x;
      const bool live = R < n_rows;
      lse_s[threadIdx.x] = live ? lse[q_index(R)] : 0.f;
      dsum_s[threadIdx.x] = live ? dsum[q_index(R)] : 0.f;
      qp_s[threadIdx.x] = live ? q_pos[(size_t)b * Tq + R / G] : 0;
    }
    __syncthreads();
    int qmin, qmax;
    bool rows_whole;
    live_bounds(kTile, [&](int r) { return R0 + r < n_rows; },
                [&](int r) { return qp_s[r]; }, qmin, qmax, rows_whole);
    const int cls = tile_class(mk, qmin, qmax, kmin, kmax,
                               !(rows_whole && keys_whole));
    if (cls == kTileSkip) continue;                // uniform over the block
    load_tile<D>(q_s, [&](int r) {
      return R0 + r < n_rows ? q + q_index(R0 + r) * D : nullptr; },
      sm_scale);
    load_tile<D>(do_s, [&](int r) {
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
      const bool ok = cls == kTileFull ||
                      (row_live && key_live(j) && mk.ok(qp_s[lane], kp_s[j]));
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
      dk[key_index(j) * D + cc * 32 + lane] = dk_acc[i][cc];
      dv[key_index(j) * D + cc * 32 + lane] = dv_acc[i][cc];
    }
  }
}

}  // namespace
}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

namespace wg {
namespace {

// The softmax gradient of a 64 x 64 tile in the accumulator map, in
// place.  `lse2(i, col)` and `dsum(i, col)` are lse·log2e and dsum of the
// query row of element (acc_row(i), col), `ok(i, col)` whether the masks
// keep the pair (read only when MASKED: the select comes before any use,
// so a row with lse = NEG_INF gives exact zeros).
//   p_tile:  s ← p = 2^(s·scale·log2e − lse·log2e)
//   ds_tile: dp ← ds = p·(dp − dsum)
//   capped:  both at once with the softcap, ds times 1 − tanh².
template <bool MASKED, typename Lse, typename Ok>
__device__ __forceinline__ void p_tile(float (&s)[32], float scale_log2,
                                       Lse lse2, Ok ok) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c, col = acc_col(j, c);
        const float p = ex2(fmaf(s[e], scale_log2, -lse2(i, col)));
        s[e] = !MASKED || ok(i, col) ? p : 0.f;
      }
}

template <typename Dsum>
__device__ __forceinline__ void ds_tile(const float (&p)[32],
                                        float (&dp)[32], Dsum dsum) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        dp[e] = p[e] * (dp[e] - dsum(i, acc_col(j, c)));
      }
}

template <bool MASKED, typename Lse, typename Dsum, typename Ok>
__device__ __forceinline__ void capped_tile(float (&s)[32], float (&dp)[32],
                                            float scale, float softcap,
                                            Lse lse2, Dsum dsum, Ok ok) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c, col = acc_col(j, c);
        const float t = tanhf(s[e] * scale / softcap);
        float p = ex2(fmaf(t * softcap, kLog2e, -lse2(i, col)));
        p = !MASKED || ok(i, col) ? p : 0.f;
        s[e] = p;
        dp[e] = p * (dp[e] - dsum(i, col)) * (1.f - t * t);
      }
}

// Shared memory of each kernel, from a 1024-byte aligned base: six
// [64, D] tiles (dq: q, do, then k and v of two stages; dk/dv: k, v,
// then q and do of two stages), 2 x 3 x 64 words of per-row scalars, and
// a class byte a tile.
template <int D>
size_t smem_bytes(int n_tiles) {
  return 1024 + 6 * Tile<D>::BYTES + 6 * kT * sizeof(int) + n_tiles;
}

// dq: one block per (64-row query tile, KV head [, head group], batch),
// the last query tile first (under a causal mask it has the most keys).
template <int D>
__global__ void __launch_bounds__(kWG)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ kv_pos,
                          const int* __restrict__ valid_len,
                          bf16* __restrict__ dq, int Tq, int Tk, int Hq,
                          int Hkv, int G, Div gb, int tq_per_block,
                          int causal, int window, float softcap,
                          float sm_scale) {
  using L = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t q_s = smem_u32(sm), do_s = q_s + L::BYTES;
  auto k_s = [&](int st) { return q_s + (2 + 2 * st) * L::BYTES; };
  auto v_s = [&](int st) { return k_s(st) + L::BYTES; };
  int* kp_s = reinterpret_cast<int*>(sm + 6 * L::BYTES);     // [2][64]
  uint8_t* cls = sm + 6 * L::BYTES + 6 * kT * sizeof(int);   // [n_tiles]

  const int b = blockIdx.z;
  const int h = blockIdx.y % Hkv, hg = blockIdx.y / Hkv;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * tq_per_block;
  const int nrows = tq_per_block * gb.d;
  const int n_tiles = (Tk + kT - 1) / kT;

  // row r: query position t0 + r / GB of head h * G + hg * GB + r % GB
  auto row_live = [&](int r) {
    return r < nrows && t0 + gb.div(r) < Tq && hg * gb.d + gb.mod(r) < G;
  };
  auto row_index = [&](int r) {   // index into [B, Tq, Hq]
    return ((size_t)b * Tq + t0 + gb.div(r)) * Hq + h * G + hg * gb.d +
           gb.mod(r);
  };
  auto row_pos = [&](int r) {
    return q_pos[(size_t)b * Tq + t0 + gb.div(r)];
  };
  cp_tile<D>(q_s, [&](int r) {
    return row_live(r) ? q + row_index(r) * D : nullptr; }, q);
  cp_tile<D>(do_s, [&](int r) {
    return row_live(r) ? dout + row_index(r) * D : nullptr; }, q);
  cp_commit();

  // this thread's two accumulator rows
  float lse2_r[2], dsum_r[2];
  int qp_r[2];
  bool live_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = acc_row(i);
    live_r[i] = row_live(r);
    lse2_r[i] = live_r[i] ? lse[row_index(r)] * kLog2e : 0.f;
    dsum_r[i] = live_r[i] ? dsum[row_index(r)] : 0.f;
    qp_r[i] = live_r[i] ? row_pos(r) : 0;
  }

  const Masks mk{causal, window, valid_len ? valid_len[b] : -1};
  int qmin, qmax;
  bool rows_whole;
  live_bounds(kT, row_live, row_pos, qmin, qmax, rows_whole);
  auto key_pos = [&](int j) {
    return kv_pos ? kv_pos[(size_t)b * Tk + j] : j;
  };
  plan_tiles<kT, kWG, true>(cls, Tk, key_pos, qmin, qmax, rows_whole, mk);

  auto load_keys = [&](int n, int st) {
    const int k0 = n * kT;
    auto rows = [&](const bf16* base) {
      return [=](int j) -> const bf16* {
        return k0 + j < Tk ? base + (((size_t)b * Tk + k0 + j) * Hkv + h) * D
                           : nullptr;
      };
    };
    cp_tile<D>(k_s(st), rows(k), k);
    cp_tile<D>(v_s(st), rows(v), k);
    if (threadIdx.x < kT) {
      const int j = k0 + threadIdx.x;
      int* dst = kp_s + st * kT + threadIdx.x;
      if (kv_pos)
        cp_async4(smem_u32(dst), kv_pos + (size_t)b * Tk + min(j, Tk - 1),
                  j < Tk);
      else
        *dst = j;
    }
  };

  const float scale_log2 = sm_scale * kLog2e;
  auto lse2 = [&](int i, int) { return lse2_r[i]; };
  auto dsum_of = [&](int i, int) { return dsum_r[i]; };
  float acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
  __syncthreads();                              // the classes are written
  Ring ring(cls, n_tiles, load_keys);
  while (ring.more()) {
    const int st = ring.wait(load_keys), n = ring.n;   // q and do are in too

    // s = q·kᵀ and dp = do·vᵀ, [64 rows, 64 keys] each, as two groups
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(s, L::kmajor(q_s, ks), L::kmajor(k_s(st), ks), ks > 0);
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(dp, L::kmajor(do_s, ks), L::kmajor(v_s(st), ks), ks > 0);
    wg_commit();

    const int k0 = n * kT;
    const int* kp = kp_s + st * kT;
    auto ok = [&](int i, int col) {
      return live_r[i] && k0 + col < Tk && mk.ok(qp_r[i], kp[col]);
    };
    const bool full = cls[n] == kTileFull;
    if (softcap > 0.f) {
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (full)
        capped_tile<false>(s, dp, sm_scale, softcap, lse2, dsum_of, ok);
      else
        capped_tile<true>(s, dp, sm_scale, softcap, lse2, dsum_of, ok);
    } else {                  // p while do·vᵀ is still on the tensor cores
      wg_wait<1>();
      fence_regs(s);
      if (full)
        p_tile<false>(s, scale_log2, lse2, ok);
      else
        p_tile<true>(s, scale_log2, lse2, ok);
      wg_wait<0>();
      fence_regs(dp);
      ds_tile(s, dp, dsum_of);
    }
    uint32_t a[4][4];
    to_a(dp, a);

    // dq += ds·k: k's 64 rows are the reduction
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs(acc, a[ks], L::mnmajor(k_s(st), ks));
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(a);
    ring.next();
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live_r[i]) continue;
    bf16* out = dq + row_index(acc_row(i)) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + acc_col(j, 0)) =
          pack_bf16(acc[4 * j + 2 * i] * sm_scale,
                    acc[4 * j + 2 * i + 1] * sm_scale);
  }
}

// dk/dv: one block per (KV head, batch, 64-key tile) over the Tq·G query
// rows R = t·G + g of its KV head, the first key tiles first: under a
// causal mask they have the most rows, and the longest block bounds the
// kernel's time.
template <int D>
__global__ void __launch_bounds__(kWG)
flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           const int* __restrict__ q_pos,
                           const int* __restrict__ kv_pos,
                           const int* __restrict__ valid_len,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int Tq, int Tk, int Hq, int Hkv, Div g,
                           int causal, int window, float softcap,
                           float sm_scale) {
  using L = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t k_s = smem_u32(sm), v_s = k_s + L::BYTES;
  auto q_s = [&](int st) { return k_s + (2 + 2 * st) * L::BYTES; };
  auto do_s = [&](int st) { return q_s(st) + L::BYTES; };
  float* lse_s = reinterpret_cast<float*>(sm + 6 * L::BYTES);   // [2][64]
  float* dsum_s = lse_s + 2 * kT;                                // [2][64]
  int* qp_s = reinterpret_cast<int*>(dsum_s + 2 * kT);           // [2][64]
  uint8_t* cls = sm + 6 * L::BYTES + 6 * kT * sizeof(int);      // [n_tiles]

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kT;
  const int n_rows = Tq * g.d;
  const int n_tiles = (n_rows + kT - 1) / kT;

  auto key_live = [&](int j) { return k0 + j < Tk; };
  auto key_index = [&](int j) {   // row index into [B, Tk, Hkv]
    return ((size_t)b * Tk + k0 + j) * Hkv + h;
  };
  auto key_pos = [&](int j) {
    return kv_pos ? kv_pos[(size_t)b * Tk + k0 + j] : k0 + j;
  };
  cp_tile<D>(k_s, [&](int j) {
    return key_live(j) ? k + key_index(j) * D : nullptr; }, k);
  cp_tile<D>(v_s, [&](int j) {
    return key_live(j) ? v + key_index(j) * D : nullptr; }, k);
  cp_commit();

  // this thread's two accumulator rows (keys)
  int kp_r[2];
  bool live_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    live_r[i] = key_live(acc_row(i));
    kp_r[i] = live_r[i] ? key_pos(acc_row(i)) : 0;
  }

  const Masks mk{causal, window, valid_len ? valid_len[b] : -1};
  int kmin, kmax;
  bool keys_whole;
  live_bounds(kT, key_live, key_pos, kmin, kmax, keys_whole);
  // query row R = t * G + g: position t of head h * G + g
  auto q_index = [&](int R) {     // index into [B, Tq, Hq]
    return ((size_t)b * Tq + g.div(R)) * Hq + h * g.d + g.mod(R);
  };
  auto row_pos = [&](int R) { return q_pos[(size_t)b * Tq + g.div(R)]; };
  plan_tiles<kT, kWG, false>(cls, n_rows, row_pos, kmin, kmax, keys_whole,
                             mk);

  auto load_rows = [&](int n, int st) {
    const int R0 = n * kT;
    auto rows = [&](const bf16* base) {
      return [=](int r) -> const bf16* {
        return R0 + r < n_rows ? base + q_index(R0 + r) * D : nullptr;
      };
    };
    cp_tile<D>(q_s(st), rows(q), q);
    cp_tile<D>(do_s(st), rows(dout), q);
    // lse, dsum and the position of each row: [3][2 stages][64] words
    const uint32_t sc = smem_u32(lse_s);
    for (int x = threadIdx.x; x < 3 * kT; x += kWG) {
      const int which = x / kT, r = x % kT, R = R0 + r;
      const bool live = R < n_rows;
      const int Rc = live ? R : 0;
      const void* src = which == 0   ? (const void*)(lse + q_index(Rc))
                        : which == 1 ? (const void*)(dsum + q_index(Rc))
                                     : (const void*)(q_pos + (size_t)b * Tq +
                                                     g.div(Rc));
      cp_async4(sc + ((which * 2 + st) * kT + r) * 4, src, live);
    }
  };

  const float scale_log2 = sm_scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
  __syncthreads();                              // the classes are written
  Ring ring(cls, n_tiles, load_rows);
  while (ring.more()) {
    const int st = ring.wait(load_rows), n = ring.n;   // k and v are in too

    // sᵀ = k·qᵀ and dpᵀ = v·doᵀ, [64 keys, 64 rows] each, as two groups
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(s, L::kmajor(k_s, ks), L::kmajor(q_s(st), ks), ks > 0);
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(dp, L::kmajor(v_s, ks), L::kmajor(do_s(st), ks), ks > 0);
    wg_commit();

    const int R0 = n * kT;
    const float* lse_t = lse_s + st * kT;
    const float* dsum_t = dsum_s + st * kT;
    const int* qp_t = qp_s + st * kT;
    auto lse2 = [&](int, int col) { return lse_t[col] * kLog2e; };
    auto dsum_of = [&](int, int col) { return dsum_t[col]; };
    auto ok = [&](int i, int col) {
      return live_r[i] && R0 + col < n_rows && mk.ok(qp_t[col], kp_r[i]);
    };
    const bool full = cls[n] == kTileFull;
    uint32_t a_p[4][4], a_ds[4][4];
    // dv += pᵀ·do and dk += dsᵀ·q: the tile's 64 rows are the reduction
    auto dv_mma = [&] {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs(dv_acc, a_p[ks], L::mnmajor(do_s(st), ks));
    };
    auto dk_mma = [&] {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs(dk_acc, a_ds[ks], L::mnmajor(q_s(st), ks));
    };
    if (softcap > 0.f) {
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (full)
        capped_tile<false>(s, dp, sm_scale, softcap, lse2, dsum_of, ok);
      else
        capped_tile<true>(s, dp, sm_scale, softcap, lse2, dsum_of, ok);
      to_a(s, a_p);
      to_a(dp, a_ds);
      wg_fence();
      dv_mma();
      dk_mma();
      wg_commit();
    } else {    // p, then pᵀ·do on the tensor cores while ds is computed
      wg_wait<1>();
      fence_regs(s);
      if (full)
        p_tile<false>(s, scale_log2, lse2, ok);
      else
        p_tile<true>(s, scale_log2, lse2, ok);
      to_a(s, a_p);
      wg_fence();
      dv_mma();
      wg_commit();
      wg_wait<1>();                             // dpᵀ is in
      fence_regs(dp);
      ds_tile(s, dp, dsum_of);
      to_a(dp, a_ds);
      wg_fence();
      dk_mma();
      wg_commit();
    }
    wg_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(a_p);
    fence_regs(a_ds);
    ring.next();
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live_r[i]) continue;
    const size_t row = key_index(acc_row(i)) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = acc_col(j, 0);
      *reinterpret_cast<uint32_t*>(dk + row + col) =
          pack_bf16(dk_acc[4 * j + 2 * i] * sm_scale,
                    dk_acc[4 * j + 2 * i + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + row + col) =
          pack_bf16(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

}  // namespace
}  // namespace wg

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

namespace {

struct Args {
  const void *q, *k, *v, *dout, *lse, *dsum, *q_pos, *kv_pos, *valid_len;
  void *dq, *dk, *dv;
  int B, Tq, Tk, Hq, Hkv, causal, window;
  float softcap, sm_scale;
  cudaStream_t stream;
};

#define BWD_COMMON_ARGS(T)                                                 \
  static_cast<const T*>(a.q), static_cast<const T*>(a.k),                  \
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),           \
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum), \
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.kv_pos), \
      static_cast<const int*>(a.valid_len)

template <int D>
cudaError_t launch_dq_f32(const Args& a) {
  const RowMap m(a.Hq, a.Hkv, f32::kTile);
  constexpr size_t smem = f32::smem_bytes<D>();
  cudaError_t err = set_smem(f32::flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  f32::flash_bwd_dq_kernel<D><<<m.grid(a.B, a.Tq, a.Hkv), f32::kThreads, smem, a.stream>>>(
      BWD_COMMON_ARGS(float), static_cast<float*>(a.dq), a.Tq, a.Tk, a.Hq,
      a.Hkv, m.G, m.GB, m.tq_per_block, a.causal, a.window, a.softcap,
      a.sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a) {
  constexpr size_t smem = f32::smem_bytes<D>();
  cudaError_t err = set_smem(f32::flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + f32::kTile - 1) / f32::kTile, a.Hkv, a.B);
  f32::flash_bwd_dkv_kernel<D><<<grid, f32::kThreads, smem, a.stream>>>(
      BWD_COMMON_ARGS(float), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.Tq, a.Tk, a.Hq, a.Hkv, a.Hq / a.Hkv,
      a.causal, a.window, a.softcap, a.sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const Args& a) {
  const RowMap m(a.Hq, a.Hkv, wg::kT);
  const size_t smem = wg::smem_bytes<D>((a.Tk + wg::kT - 1) / wg::kT);
  cudaError_t err = set_smem(wg::flash_bwd_dq_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  wg::flash_bwd_dq_wgmma_kernel<D><<<m.grid(a.B, a.Tq, a.Hkv), wg::kWG, smem, a.stream>>>(
      BWD_COMMON_ARGS(bf16), static_cast<bf16*>(a.dq), a.Tq, a.Tk, a.Hq,
      a.Hkv, m.G, divisor(m.GB), m.tq_per_block, a.causal, a.window,
      a.softcap, a.sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const Args& a) {
  const int G = a.Hq / a.Hkv;
  const long long n_rows = (long long)a.Tq * G;
  if (n_rows > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = wg::smem_bytes<D>((int)((n_rows + wg::kT - 1) / wg::kT));
  cudaError_t err = set_smem(wg::flash_bwd_dkv_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hkv, a.B, (a.Tk + wg::kT - 1) / wg::kT);
  wg::flash_bwd_dkv_wgmma_kernel<D><<<grid, wg::kWG, smem, a.stream>>>(
      BWD_COMMON_ARGS(bf16), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.Tq, a.Tk, a.Hq, a.Hkv, divisor(G),
      a.causal, a.window, a.softcap, a.sm_scale);
  return cudaGetLastError();
}

#undef BWD_COMMON_ARGS

// bf16 takes the tensor-core kernels, fp32 the CUDA-core ones
template <bool DQ, int D>
cudaError_t launch(const Args& a, int dtype) {
  switch (dtype) {
    case 0: return DQ ? launch_dq_f32<D>(a) : launch_dkv_f32<D>(a);
    case 1: return DQ ? launch_dq_bf16<D>(a) : launch_dkv_bf16<D>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int run(const Args& a, int D, int dtype) {
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Tq == 0 || a.Tk == 0) return (int)cudaSuccess;
  switch (D) {
    case 32: return (int)launch<DQ, 32>(a, dtype);
    case 64: return (int)launch<DQ, 64>(a, dtype);
    case 128: return (int)launch<DQ, 128>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace flash

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
  const flash::Args a{q, k, v, dout, lse, dsum, q_pos, kv_pos, valid_len,
                      dq, nullptr, nullptr, B, Tq, Tk, Hq, Hkv, causal,
                      window, softcap, sm_scale,
                      static_cast<cudaStream_t>(stream)};
  return flash::run<true>(a, D, dtype);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, const void* q_pos, const void* kv_pos,
    const void* valid_len, void* dk, void* dv, int B, int Tq, int Tk, int Hq,
    int Hkv, int D, int dtype, int causal, int window, float softcap,
    float sm_scale, void* stream) {
  const flash::Args a{q, k, v, dout, lse, dsum, q_pos, kv_pos, valid_len,
                      nullptr, dk, dv, B, Tq, Tk, Hq, Hkv, causal, window,
                      softcap, sm_scale, static_cast<cudaStream_t>(stream)};
  return flash::run<false>(a, D, dtype);
}
