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
//
// What bounds it on an H100: bytes.  It reads each row once (the second
// pass finds the row in L1/L2) and writes it once, 2 FLOP-ish per byte;
// the floor is 2·rows·d·sizeof(x) over 3.35 TB/s.
// What holds it back now: at the decode shapes (8 rows) the launch, not
// the bytes, is its time; the cure is fusing it into its neighbours.
//
// Design.  One block of 256 threads per row: each thread sums the squares
// of a strided share of the row in f32, a warp-shuffle and shared-memory
// reduction gives the row's sum, and the same threads write the
// normalized row.  The TPU kernel's row blocks of 128 (padded,
// `rmsnorm.py:34-37`) are not needed: a block is one row, so there is no
// ragged edge.

#include "attention_common.cuh"

namespace {

using attn::store;
using attn::to_f32;
using attn::warp_sum;

constexpr int kThreads = 256;

// x rounded to T and back: `inv.to(dt)` and each product in x's dtype
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const T* __restrict__ x, const T* __restrict__ scale,
    T* __restrict__ out, int d, float eps) {
  __shared__ float part[kThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? part[lane] : 0.f;
    ss = warp_sum(ss);
    if (lane == 0) part[0] = ss;
  }
  __syncthreads();
  const float inv = round_to(1.f / sqrtf(part[0] / d + eps), xr);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float t = round_to(to_f32(xr[i]) * inv, xr);
    store(orow + i, t * to_f32(scale[i]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16, the same for x [rows, d], scale [d] and out [rows, d]; all
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int rows, int d, float eps, int dtype,
                           void* stream) {
  if (d <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0   ? launch<float>(x, scale, out, rows, d, eps, s)
      : dtype == 1 ? launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
