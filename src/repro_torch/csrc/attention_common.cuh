// Helpers shared by the kernels of this directory (the SSD scan and
// RMSNorm take the element conversions and the warp sum; the rest is the
// attention kernels'): element
// conversions, 16-byte vector loads, warp reductions, the masking
// constant of the JAX kernels (`NEG_INF = -0.7 * f32max`), the logit
// softcap, the online-softmax tile step and the K/V tile loader of the
// decode-style kernels (16-byte loads one tile ahead, int8 scales).
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

// Brings 32-key tiles of K and V (and, with SCALED, their per-token int8
// scales) from device memory into shared memory for a block of THREADS
// threads.  `fetch` issues a tile's 16-byte loads into registers, `stash`
// writes them to shared memory (K transposed, kT_s[d * 32 + key]; V
// row-major), so a caller fetches the next tile before computing the
// current one and the loads overlap the arithmetic.  `row(pos)` gives the
// (token, KV head) row of key `pos`: its K/V values start at row * D and
// its scale sits at row.  Keys at or past `n_keys` are not loaded but
// zeroed, so stale rows (a rejected speculative suffix, the trash page)
// never reach shared memory.  K is spread key-fastest over the threads
// (its transposed store hits 32 banks), V chunk-fastest.
template <typename TKV, int D, int THREADS, bool SCALED>
struct KVTileLoader {
  static constexpr int VEC = 16 / sizeof(TKV);   // elements per 16-byte load
  static constexpr int RV = D / VEC;             // loads per key row
  static constexpr int TV = kBK * RV;            // loads per tile (K or V)
  static constexpr int NV = (TV + THREADS - 1) / THREADS;
  uint4 kreg[NV], vreg[NV];
  float ksreg = 0.f, vsreg = 0.f;

  template <typename Row>
  __device__ __forceinline__ void fetch(const TKV* __restrict__ k,
                                        const TKV* __restrict__ v,
                                        const float* __restrict__ ks,
                                        const float* __restrict__ vs, int k0,
                                        int n_keys, Row row) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int idx = threadIdx.x + n * THREADS;
      const int kpos = k0 + idx % kBK, vpos = k0 + idx / RV;
      kreg[n] = vreg[n] = make_uint4(0, 0, 0, 0);
      if (idx < TV && kpos < n_keys)
        kreg[n] = load16(k + row(kpos) * D + (idx / kBK) * VEC);
      if (idx < TV && vpos < n_keys)
        vreg[n] = load16(v + row(vpos) * D + (idx % RV) * VEC);
    }
    if (SCALED && threadIdx.x < kBK) {
      const int pos = k0 + threadIdx.x;
      ksreg = vsreg = 0.f;
      if (pos < n_keys) {
        ksreg = ks[row(pos)];
        vsreg = vs[row(pos)];
      }
    }
  }

  __device__ __forceinline__ void stash(float* kT_s, float* v_s, float* ks_s,
                                        float* vs_s) const {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int idx = threadIdx.x + n * THREADS;
      if (idx >= TV) continue;
      const int kc = (idx / kBK) * VEC, kj = idx % kBK;
      const int vj = idx / RV, vc = (idx % RV) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kT_s[(kc + e) * kBK + kj] = elem<TKV>(kreg[n], e);
        v_s[vj * D + vc + e] = elem<TKV>(vreg[n], e);
      }
    }
    if (SCALED && threadIdx.x < kBK) {
      ks_s[threadIdx.x] = ksreg;
      vs_s[threadIdx.x] = vsreg;
    }
  }
};

}  // namespace attn
