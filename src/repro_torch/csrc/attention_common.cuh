// Helpers shared by the kernels of this directory (the SSD scan and
// RMSNorm take the element conversions and the warp sum; the rest is the
// attention kernels'): element
// conversions, 16-byte vector loads, warp reductions, the masking
// constant of the JAX kernels (`NEG_INF = -0.7 * f32max`), the logit
// softcap and the online-softmax tile step.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBK = 32;                 // keys per tile: one per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Element e of a 16-byte vector holding 16 / sizeof(T) values of type T.
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int e) {
  return to_f32(reinterpret_cast<const T*>(&u)[e]);
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The logit softcap of the JAX kernels, `tanh(s/c)*c` when c > 0.
__device__ __forceinline__ float softcap_logit(float s, float softcap) {
  return softcap > 0.f ? tanhf(s / softcap) * softcap : s;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Logits of RW query rows (pre-scaled, row-major in shared memory) against
// the 32 keys of a tile, one key per lane.  K is stored transposed,
// kT_s[d * 32 + key], so the lanes read 32 banks; each q value is a
// broadcast, four at a time.
template <int D, int RW>
__device__ __forceinline__ void qk_tile(const float* q_rows,
                                        const float* kT_s, float (&s)[RW]) {
  const int lane = threadIdx.x % 32;
  const float4* q4 = reinterpret_cast<const float4*>(q_rows);
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) s[rr] = 0.f;
#pragma unroll 4
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float k0 = kT_s[(4 * d4 + 0) * 32 + lane];
    const float k1 = kT_s[(4 * d4 + 1) * 32 + lane];
    const float k2 = kT_s[(4 * d4 + 2) * 32 + lane];
    const float k3 = kT_s[(4 * d4 + 3) * 32 + lane];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const float4 qv = q4[rr * (D / 4) + d4];
      s[rr] = fmaf(qv.x, k0, s[rr]);
      s[rr] = fmaf(qv.y, k1, s[rr]);
      s[rr] = fmaf(qv.z, k2, s[rr]);
      s[rr] = fmaf(qv.w, k3, s[rr]);
    }
  }
}

// One online-softmax step for RW query rows over a 32-key tile: `s` are
// this lane's logits, `ok` whether its key is visible to each row.  P·V
// accumulates into this lane's D/32 columns; each V value read from
// shared memory serves all RW rows.  With SCALED (int8 pools) the v-scale
// multiplies p after the l update.
template <int D, int RW, bool SCALED>
__device__ __forceinline__ void softmax_pv_tile(
    const float (&s)[RW], const bool (&ok)[RW], float vscale,
    const float* v_s, float (&m)[RW], float (&l)[RW],
    float (&acc)[RW][D / 32]) {
  const int lane = threadIdx.x % 32;
  float p[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const float sr = ok[rr] ? s[rr] : kNegInf;
    const float m_new = fmaxf(m[rr], warp_max(sr));
    p[rr] = ok[rr] ? expf(sr - m_new) : 0.f;   // p masked, not only s
    const float corr = expf(m[rr] - m_new);
    l[rr] = l[rr] * corr + warp_sum(p[rr]);
    m[rr] = m_new;
    if (SCALED) p[rr] *= vscale;              // p·(v·s) == (p·s)·v
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[rr][c] *= corr;
  }
#pragma unroll 4
  for (int j = 0; j < kBK; ++j) {
    float vv[D / 32];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) vv[c] = v_s[j * D + c * 32 + lane];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const float pj = __shfl_sync(kFull, p[rr], j);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[rr][c] = fmaf(pj, vv[c], acc[rr][c]);
    }
  }
}

}  // namespace attn
