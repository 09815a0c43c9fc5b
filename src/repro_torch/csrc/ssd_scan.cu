// Mamba2 SSD chunk scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/ssd_scan.py:ssd_scan`
// (`_kernel`).  Same function, per (sequence b, head h):
//   y_t = C_t · h_t,   h_t = exp(A·dt_t) h_{t-1} + dt_t B_t x_tᵀ,
// computed chunk by chunk in the state-space-dual form: within a chunk of
// Q rows, with cum the inclusive cumsum of dt·A,
//   y_i = Σ_{j<=i} (C_i·B_j) exp(cum_i − cum_j) dt_j x_j
//         + exp(cum_i) C_i·S
//   S  <- exp(cum_last) S + Σ_j exp(cum_last − cum_j) B_j (dt_j x_j)ᵀ
// where S [N, P] is the f32 state entering the chunk.  x, B and C are bf16
// or f32, dt and A f32; y is in x's dtype, the optional initial state and
// the final state [B, H, P, N] are f32.  Head h reads group
// h / (H/G) of B and C (`ssd_scan.py:113`).
//
// What bounds it on an H100: bytes.  A 64-token prefill chunk of
// mamba2-2.7b (80 heads, P 64, N 128) moves about 6.6 MB (the f32 state
// in and out dominates), 2 µs at 3.35 TB/s; the 0.23 GFLOP of products
// its data needs would take the tensor cores 0.24 µs.  This first version
// runs them as f32 FMAs from shared memory, one block per (head,
// sequence), so the FMA issue rate of 80 SMs is what it meets (PERF.md
// has its time against that bound).
// What holds it back now: those f32 FMAs and the idle SMs; tensor-core
// products and a split over P are for later.
//
// Design.  The TPU kernel's sequential chunk axis (grid (B·H, nC),
// `ssd_scan.py:111`) becomes a loop inside one block of 256 threads per
// (head, sequence): the [N, P] state stays in shared memory across chunks
// and never goes through device memory.  The Pallas body holds the whole
// [Q, Q] `C·Bᵀ ∘ L` in VMEM (256 KB in f32 at Q 256, more than an SM's
// shared memory); here the chunk is cut into tiles of 64 query rows, and
// each tile loops over the 64-row key tiles at or below it, with the
// chunk's cum in shared memory.  L is selected before the exponent
// (`j <= i ? exp(cum_i − cum_j) : 0`), so the overflow above the
// diagonal never meets a 0.  The JAX wrapper pads the tail with dt = 0
// and x = 0 (`ssd_scan.py:92-100`); here the loops stop at the last valid
// row of the chunk, which gives the same kept rows and the same final
// state (cum_last is the cum of the last valid row, which padding would
// repeat).  Rows of B and C are padded to N + 1 floats in shared memory,
// so the lanes of a warp reading 32 key rows hit 32 banks.
// Occupancy: one block per SM (about 134 KB of shared memory at P 64,
// N 128, Q 256); a batch-1 prefill launches H blocks (80 for mamba2,
// 64 for zamba2) on 132 SMs.  Splitting P over blocks is for later.

#include "attention_common.cuh"

namespace {

using attn::store;
using attn::to_f32;

constexpr int kThreads = 256;
constexpr int kRows = 64;               // query rows and key rows per tile

constexpr size_t smem_floats(int P, int N, int Q) {
  return (size_t)N * P                  // state S [N][P]
         + Q                            // cum of the chunk
         + Q                            // dt of the chunk
         + 2 * kRows * (N + 1)          // C tile, B tile [kRows][N + 1]
         + kRows * P                    // dt·x tile [kRows][P]
         + kRows * kRows;               // (C·Bᵀ ∘ L) tile [kRows][kRows]
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ s0,
    T* __restrict__ y, float* __restrict__ s_fin, int L, int H, int G,
    int Q) {
  constexpr int kYPer = kRows * P / kThreads;   // y entries per thread
  constexpr int kSPer = N * P / kThreads;       // state entries per thread
  static_assert(kYPer * kThreads == kRows * P, "P must be a multiple of 4");
  static_assert(kSPer * kThreads == N * P, "N·P must be a multiple of 256");
  extern __shared__ float4 smem4[];
  float* sS = reinterpret_cast<float*>(smem4);  // [N][P]
  float* sCum = sS + N * P;                      // [Q]
  float* sDt = sCum + Q;                         // [Q]
  float* sC = sDt + Q;                           // [kRows][N + 1]
  float* sB = sC + kRows * (N + 1);              // [kRows][N + 1]
  float* sX = sB + kRows * (N + 1);              // [kRows][P], dt·x
  float* sG = sX + kRows * P;                    // [kRows][kRows]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int g = h / (H / G);
  const float a = A[h];
  // element offsets of (b, t, h, 0) in x/y and of (b, t, g, 0) in B/C
  auto xrow = [&](int t) {
    return ((size_t)b * L + t) * H * P + (size_t)h * P;
  };
  auto brow = [&](int t) {
    return ((size_t)b * L + t) * G * N + (size_t)g * N;
  };
  const size_t sbase = ((size_t)b * H + h) * P * N;   // state [P][N]

  for (int i = tid; i < N * P; i += kThreads) {   // global [P][N] -> [N][P]
    const int p = i / N, n = i % N;
    sS[n * P + p] = s0 != nullptr ? s0[sbase + i] : 0.f;
  }

  // a key tile: rows j0.. of B (times exp(cum_end − cum_j) when `to_end`)
  // and dt·x, zero past `rows`
  auto load_keys = [&](int c0, int j0, int rows, bool to_end, float cum_end) {
    for (int i = tid; i < kRows * N; i += kThreads) {
      const int j = i / N, n = i % N;
      float v = 0.f;
      if (j0 + j < rows) {
        v = to_f32(Bm[brow(c0 + j0 + j) + n]);
        if (to_end) v *= expf(cum_end - sCum[j0 + j]);
      }
      sB[j * (N + 1) + n] = v;
    }
    for (int i = tid; i < kRows * P; i += kThreads) {
      const int j = i / P, p = i % P;
      sX[i] = j0 + j < rows
                  ? to_f32(x[xrow(c0 + j0 + j) + p]) * sDt[j0 + j]
                  : 0.f;
    }
  };

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int rows = min(Q, L - c0);
    __syncthreads();                       // the previous chunk is done
    for (int t = tid; t < rows; t += kThreads)
      sDt[t] = dt[((size_t)b * L + c0 + t) * H + h];
    __syncthreads();
    if (tid == 0) {                        // inclusive cumsum of dt·A
      float c = 0.f;
      for (int t = 0; t < rows; ++t) {
        c += sDt[t] * a;
        sCum[t] = c;
      }
    }
    __syncthreads();

    for (int q0 = 0; q0 < rows; q0 += kRows) {
      for (int i = tid; i < kRows * N; i += kThreads) {
        const int r = i / N, n = i % N;
        sC[r * (N + 1) + n] =
            q0 + r < rows ? to_f32(Cm[brow(c0 + q0 + r) + n]) : 0.f;
      }
      __syncthreads();
      // from the state entering the chunk: exp(cum_i) C_i·S
      float acc[kYPer];
#pragma unroll
      for (int k = 0; k < kYPer; ++k) {
        const int e = tid + k * kThreads, r = e / P, p = e % P;
        float s = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n)
          s = fmaf(sC[r * (N + 1) + n], sS[n * P + p], s);
        acc[k] = q0 + r < rows ? expf(sCum[q0 + r]) * s : 0.f;
      }
      // within the chunk: key tiles up to the last row of this query tile
      const int k_end = min(q0 + kRows, rows);
      for (int j0 = 0; j0 < k_end; j0 += kRows) {
        __syncthreads();                   // sB/sX/sG of the last tile read
        load_keys(c0, j0, rows, false, 0.f);
        __syncthreads();
        for (int i = tid; i < kRows * kRows; i += kThreads) {
          const int r = i / kRows, j = i % kRows;
          const int qi = q0 + r, kj = j0 + j;
          float v = 0.f;
          if (kj <= qi && qi < rows) {     // select before the exponent
            float s = 0.f;
#pragma unroll 8
            for (int n = 0; n < N; ++n)
              s = fmaf(sC[r * (N + 1) + n], sB[j * (N + 1) + n], s);
            v = s * expf(sCum[qi] - sCum[kj]);
          }
          sG[i] = v;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kYPer; ++k) {
          const int e = tid + k * kThreads, r = e / P, p = e % P;
          float s = 0.f;
#pragma unroll 8
          for (int j = 0; j < kRows; ++j)
            s = fmaf(sG[r * kRows + j], sX[j * P + p], s);
          acc[k] += s;
        }
      }
#pragma unroll
      for (int k = 0; k < kYPer; ++k) {
        const int e = tid + k * kThreads, r = e / P, p = e % P;
        if (q0 + r < rows) store(y + xrow(c0 + q0 + r) + p, acc[k]);
      }
      __syncthreads();                     // sC read by every thread
    }

    // the state leaving the chunk
    const float cum_last = sCum[rows - 1];
    float upd[kSPer];
#pragma unroll
    for (int k = 0; k < kSPer; ++k) upd[k] = 0.f;
    for (int j0 = 0; j0 < rows; j0 += kRows) {
      __syncthreads();
      load_keys(c0, j0, rows, true, cum_last);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kSPer; ++k) {
        const int e = tid + k * kThreads, n = e / P, p = e % P;
        float s = 0.f;
#pragma unroll 8
        for (int j = 0; j < kRows; ++j)
          s = fmaf(sB[j * (N + 1) + n], sX[j * P + p], s);
        upd[k] += s;
      }
    }
    const float decay = expf(cum_last);
#pragma unroll
    for (int k = 0; k < kSPer; ++k) {     // each thread owns its entries
      const int e = tid + k * kThreads;
      sS[e] = decay * sS[e] + upd[k];
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads) {   // [N][P] -> global [P][N]
    const int p = i / N, n = i % N;
    s_fin[sbase + i] = sS[n * P + p];
  }
}

struct Args {
  const void *x, *dt, *A, *B, *C, *s0;
  void *y, *s_fin;
  int batch, L, H, G, Q;
  cudaStream_t stream;
};

template <typename T, int P, int N>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_floats(P, N, a.Q) * sizeof(float);
  auto kernel = ssd_scan_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.H, a.batch), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.B),
      static_cast<const T*>(a.C), static_cast<const float*>(a.s0),
      static_cast<T*>(a.y), static_cast<float*>(a.s_fin), a.L, a.H, a.G,
      a.Q);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t by_state(int N, const Args& a) {
  switch (N) {
    case 16: return launch<T, P, 16>(a);
    case 32: return launch<T, P, 32>(a);
    case 64: return launch<T, P, 64>(a);
    case 128: return launch<T, P, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_head(int P, int N, const Args& a) {
  switch (P) {
    case 16: return by_state<T, 16>(N, a);
    case 32: return by_state<T, 32>(N, a);
    case 64: return by_state<T, 64>(N, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16, for x, B, C and y; dt [batch,L,H] and A [H] are float32,
// s0 (may be null: a zero initial state) and s_fin [batch,H,P,N] float32.
// x [batch,L,H,P], B/C [batch,L,G,N], all contiguous.  Q is the chunk.
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, const void* s0,
                            void* y, void* s_fin, int batch, int L, int H,
                            int G, int P, int N, int Q, int dtype,
                            void* stream) {
  if (G <= 0 || H % G != 0 || Q <= 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || H == 0) return (int)cudaSuccess;
  const Args a{x, dt, A, B, C, s0, y, s_fin, batch, L, H, G, Q,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = dtype == 0   ? by_head<float>(P, N, a)
                    : dtype == 1 ? by_head<__nv_bfloat16>(P, N, a)
                                 : cudaErrorInvalidValue;
  return (int)err;
}
