// Row-wise RMSNorm, for Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/rmsnorm.py:rmsnorm`
// (`_kernel`).  Same function: for each row of x [rows, d], the mean of
// squares and its rsqrt in f32, then the products in x's dtype,
// `x * inv.to(dt) * scale.to(dt)`: in bf16 each product is rounded to
// bf16, as the Pallas kernel and `models/layers.py:_rmsnorm_fwd` do (not
// the one rounding of `ref.rmsnorm`).  scale [d] comes in x's dtype (the
// wrapper casts it).  The serving path of the SSM families runs it for
// the block norms, the gated out-norm over d_inner and the final norm.
// A second form takes each row's f32 mean of squares from outside (`ms`
// [rows]) and skips the sum: a Mamba2 layer split over a model axis
// holds d_inner / tp channels of a row, sums their squares, all-reduces
// the sum over the axis and normalizes its channels by the whole row's
// statistics (`models/mamba2.py`).
//
// What bounds it on an H100: bytes.  Each row is read once and written
// once, 2 FLOP-ish per byte; the floor is 2·rows·d·sizeof(x) over
// 3.35 TB/s.
// What holds it back now: latency.  At the serving shapes (8 or 64 rows
// of 2048-5120) the launch, one round trip to memory and the block's
// reduction are its time, 1-3 µs over an empty kernel's (PERF.md); the
// cure for that is fusing it into its neighbours.
//
// Design.  One block a row, and one read of each row: each thread keeps
// its share of the row in registers (up to kRegUnits 16-byte vectors)
// between the sum of squares and the write, and loads scale once, as
// vectors.  Threads a block: half its vectors, rounded up to a warp (at
// most 512, so that 128 registers a thread hold its share without
// spilling).  16-byte vectors need d·sizeof(x) % 16 == 0 and 16-byte
// aligned x, scale and out; otherwise the same kernel runs on single
// elements (a thread then keeps up to kRegUnits elements).  A row longer
// than the registers hold (more than 4096 vectors a block) reads its
// rest twice.  Splitting a row over a thread-block cluster of 2-8 blocks,
// the partial sums met through distributed shared memory, was measured
// against one block a row at the decode shapes and was slower at each
// (PERF.md).

#include "attention_common.cuh"

namespace {

using attn::to_f32;
using attn::warp_sum;

constexpr int kMaxThreads = 512;
constexpr int kRegUnits = 8;            // units a thread keeps in registers

// x rounded to T and back: `inv.to(dt)` and each product in x's dtype
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A unit of a row: a 16-byte vector of E = 16 / sizeof(T) elements, or
// one element (E = 1) where the vectors do not fit.
template <typename T, bool VEC>
struct Unit {
  using type = uint4;
  static constexpr int E = 16 / sizeof(T);
  static __device__ __forceinline__ float get(const uint4& u, int e) {
    return to_f32(reinterpret_cast<const T*>(&u)[e]);
  }
  static __device__ __forceinline__ void set(uint4& u, int e, float v) {
    attn::store(reinterpret_cast<T*>(&u) + e, v);
  }
};
template <typename T>
struct Unit<T, false> {
  using type = T;
  static constexpr int E = 1;
  static __device__ __forceinline__ float get(const T& u, int) {
    return to_f32(u);
  }
  static __device__ __forceinline__ void set(T& u, int, float v) {
    attn::store(&u, v);
  }
};

// Block `row` normalizes one row of d / E units, by its own mean of
// squares or, where `ms` is given, by ms[row].
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_kernel(
    const T* __restrict__ x, const T* __restrict__ scale,
    const float* __restrict__ ms, T* __restrict__ out, int d, float eps) {
  using U = Unit<T, VEC>;
  using V = typename U::type;
  constexpr int E = U::E;
  __shared__ float part[kMaxThreads / 32];
  __shared__ float row_ss;
  const int nthr = blockDim.x, nu = d / E;
  const size_t row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  V* orow = reinterpret_cast<V*>(out + row * d);
  const V* sc = reinterpret_cast<const V*>(scale);

  V v[kRegUnits];
#pragma unroll
  for (int k = 0; k < kRegUnits; ++k) {
    const int i = threadIdx.x + k * nthr;
    if (i < nu) v[k] = xr[i];
  }
  float mean;
  if (ms != nullptr) {                 // the row's statistics from outside
    mean = ms[row];
  } else {
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kRegUnits; ++k) {
      const int i = threadIdx.x + k * nthr;
      if (i < nu)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float f = U::get(v[k], e);
          ss = fmaf(f, f, ss);
        }
    }
    // the rest of a row longer than the registers hold
    for (int i = threadIdx.x + kRegUnits * nthr; i < nu; i += nthr) {
      const V t = xr[i];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float f = U::get(t, e);
        ss = fmaf(f, f, ss);
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      ss = lane < nthr / 32 ? part[lane] : 0.f;
      ss = warp_sum(ss);
      if (lane == 0) row_ss = ss;
    }
    __syncthreads();
    mean = row_ss / d;
  }
  const float inv = round_to(1.f / sqrtf(mean + eps), x);

  auto norm = [&](const V& xv, const V& sv) {
    V o;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float t = round_to(U::get(xv, e) * inv, x);
      U::set(o, e, t * U::get(sv, e));
    }
    return o;
  };
#pragma unroll
  for (int k = 0; k < kRegUnits; ++k) {
    const int i = threadIdx.x + k * nthr;
    if (i < nu) orow[i] = norm(v[k], sc[i]);
  }
  for (int i = threadIdx.x + kRegUnits * nthr; i < nu; i += nthr)
    orow[i] = norm(xr[i], sc[i]);
}

// Rows of d elements of T, one block a row of `threads` threads: half the
// row's units, rounded up to a warp, at most kMaxThreads.
template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* scale, const float* ms,
                   void* out, int rows, int d, float eps,
                   cudaStream_t stream) {
  const int nu = d / Unit<T, VEC>::E;
  const int threads = min(kMaxThreads, max(32, ((nu + 1) / 2 + 31) / 32 * 32));
  rmsnorm_kernel<T, VEC><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), ms,
      static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

// 16-byte vectors where a row is whole vectors and every pointer is
// 16-byte aligned, else single elements
template <typename T>
cudaError_t launch(const void* x, const void* scale, const float* ms,
                   void* out, int rows, int d, float eps, bool aligned,
                   cudaStream_t stream) {
  return aligned && (d * sizeof(T)) % 16 == 0
             ? launch<T, true>(x, scale, ms, out, rows, d, eps, stream)
             : launch<T, false>(x, scale, ms, out, rows, d, eps, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16, the same for x [rows, d], scale [d] and out [rows, d]; all
// contiguous.  ms: null, or each row's f32 mean of squares [rows].
// Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, const void* ms,
                           void* out, int rows, int d, float eps, int dtype,
                           void* stream) {
  if (d <= 0 || rows < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const bool aligned = aligned16(x) && aligned16(scale) && aligned16(out);
  const float* m = static_cast<const float*>(ms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? launch<float>(x, scale, m, out, rows, d, eps, aligned, s)
                   : launch<__nv_bfloat16>(x, scale, m, out, rows, d, eps,
                                           aligned, s));
}
