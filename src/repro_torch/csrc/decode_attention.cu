// One-token decode attention over a dense cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/decode_attention.py:
// decode_attention` (`_kernel`).  Same function: q [B,Hq,D] against the
// dense caches k/v [B,S,Hkv,D], keys valid where `pos < min(cache_len, S)`
// (and `pos >= cache_len - window` with a window), the logit softcap after
// scaling, an f32 accumulator and an output of 0 for a row with no valid
// key.  Two serving paths call it: the speculative draft at every draft
// decode step over its slot cache (`serving/spec_decode.py`; tinyllama's
// G 8), and zamba2's shared attention block at every decode step over its
// dense slots (`models/attention.py:decode_step`; G 1).  Values as wide as
// keys only (Dv == D); the MLA absorbed decode, whose values are
// narrower, is not ported.
//
// What bounds it on an H100: bytes.  Each (sequence, KV head) reads its
// valid K and V once and does 4·G·D FLOP per key: 2 FLOP per byte at the
// draft's G 8 in bf16, 0.25 at zamba2's G 1, far below the card's ~295,
// so the floor is the valid KV bytes over 3.35 TB/s: under 1 µs for the
// draft (B 8, Hkv 4, lengths 36-543), about 6 µs for zamba2 (Hkv 32).
//
// What holds it back now: at the draft's shape, as for the paged kernel,
// the latency of a block's short chain (the length, the keys, the
// exchange and the combine); at zamba2's, the same chain and then the KV
// streaming at about three quarters of the memory rate (`PERF.md` §6).
//
// Design: the kernel of `paged_attention.cuh` with one query token, its
// `dense_decode` kind reading a dense cache as B pages of S keys through
// the identity table, computed in place of a table slice (the key at `pos`
// of sequence b is row (b·S + pos)·Hkv + h), so a block goes from its
// length straight to its keys.  The keys of each (sequence, KV head) are
// shared by a cluster of blocks sized to the grid, as the paged kernels'
// are (one block, and no cluster, when the (sequence, KV head) pairs
// alone fill the card, as zamba2's 256 do), combined in the same launch;
// all G rows of a KV head in one block, bf16 products on the tensor
// cores.
//
// MLA's absorbed decode (deepseek-v2-236b, `src/repro/models/attention.py:
// 429-454`) calls the same function with keys of DK = 576 columns (the
// latent c_kv and k_rope), values of DV = 512 (c_kv), one KV head and G =
// 128 query heads.  The template above holds Dv = D, and a block's [64,
// 512] f32 accumulator would be 256 floats a thread on its 4 warps, so
// that shape runs the kernels of namespace `mla` below instead:
//  - What bounds it: per key and sequence it reads 576·2 + 512·2 = 2176 B
//    (bf16) and does 128·2·(576 + 512) = 278 528 FLOP, 128 FLOP a byte,
//    under the card's ~295: bytes.  8 full caches of 4096 keys are 71.3 MB,
//    0.0213 ms at 3.35 TB/s.
//  - bf16: a block takes 64 query heads of one sequence (two blocks for
//    G 128) and a share of its keys, on two warpgroups.  Each computes the
//    logits of all 64 rows, s = q·kᵀ over the 576 key columns (36 k16
//    steps of `wgmma` m64n64k16 from the swizzled q and K tiles), and the
//    online softmax, and owns 256 of the 512 output columns (two m64n128
//    accumulators from p in registers and the V tile): the logits are
//    computed twice, not four times, and no p passes between them.
//    Shared memory holds q, one K and one V tile (72 + 72 + 64 KB), so
//    the next K tile streams in during this tile's softmax and p·v, and
//    the next V tile during the next q·kᵀ.
//  - fp32: the CUDA cores (the 2e-5 tolerance), 32 rows a block on 8 warps,
//    a lane per key for the logits and 16 output columns per lane, over
//    32-key tiles loaded before each is computed.
//  - Both split the valid key range of a sequence over `mla_splits`
//    blocks sized to fill the card (a share of at least 256 keys at full
//    S); with more than one the partials (the rows' unnormalised
//    output, max in base 2 and sum) go to an f32 workspace that a second
//    kernel merges by the log-sum-exp rule.  A row with no valid key
//    gives exactly 0.

#include <type_traits>

#include "paged_attention.cuh"

namespace mla {
namespace {

using namespace attn;
using bf16 = __nv_bfloat16;
namespace wg = flash::wg;

constexpr int DK = 576, DV = 512;
constexpr int kSplitKeys = 256;      // the least share of S a split takes
constexpr int kSMs = 132;

// The key range [lo, hi) of split `split` of `nsplit` over sequence b:
// the valid keys below min(cache_len, S) (from cache_len - window with a
// window) in even shares of whole `tile`s.
struct Range {
  int lo, hi;
  __device__ Range(const int* clen, int b, int S, int window, int split,
                   int nsplit, int tile) {
    const int len = __ldg(clen + b);
    const int n_keys = max(0, min(len, S));
    const int first = window > 0 ? max(0, len - window) : 0;
    const int span = max(0, n_keys - first);
    const int share = ((span + nsplit - 1) / nsplit + tile - 1) / tile * tile;
    lo = first + split * share;
    hi = min(n_keys, lo + share);
  }
};

// the workspace of a split call: the partial outputs [B·Hq, nsplit, DV],
// then (max in base 2, sum) [B·Hq, nsplit, 2]
__device__ __forceinline__ float* partial_o(float* ws, size_t row, int split,
                                            int nsplit) {
  return ws + (row * nsplit + split) * DV;
}
__device__ __forceinline__ float* partial_ml(float* ws, int rows, size_t row,
                                             int split, int nsplit) {
  return ws + (size_t)rows * nsplit * DV + (row * nsplit + split) * 2;
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = wg::kT;           // query heads a block: one wgmma M
constexpr int kWGs = 2, kThreads = wg::kWG * kWGs, DW = DV / kWGs;
using LK = wg::Tile<DK>;
using LV = wg::Tile<DV>;
constexpr size_t kSmem = 1024 + 2 * LK::BYTES + LV::BYTES;

// One online-softmax step over a 64-key tile in the accumulator map of
// `flash_attention.cu`'s `softmax_tile`, with this warpgroup's two
// m64n128 output accumulators rescaled together; keys at or past `nvalid`
// and dead rows are dropped (u = -inf, p exactly 0).
template <bool CAPPED>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&o0)[64],
                                             float (&o1)[64], float (&m)[2],
                                             float (&l)[2], float f,
                                             float scale, float softcap,
                                             int nvalid,
                                             const bool (&live)[2]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        float u = CAPPED ? tanhf(s[e] * scale / softcap) * softcap : s[e];
        if (!live[i] || wg::acc_col(j, c) >= nvalid) u = -INFINITY;
        s[e] = u;
        mx[i] = fmaxf(mx[i], u);
      }
  bool need = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    need |= (mx[i] - m[i]) * f > 8.f;
  }
  if (__any_sync(kFull, need)) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      const float corr = wg::ex2((m[i] - m_new) * f);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          o0[4 * j + 2 * i + c] *= corr;
          o1[4 * j + 2 * i + c] *= corr;
        }
    }
  }
  float mf[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) mf[i] = fmaxf(m[i] * f, kNegInf);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        const float p = wg::ex2(fmaf(s[e], f, -mf[i]));
        s[e] = p;
        l[i] += p;
      }
}

// One block per (key share, KV head and group of 64 query heads,
// sequence).  Thread t of warpgroup w holds rows 16·(t/32) + (t%32)/4 and
// 8 more, and output columns 256·w + the m64n128 map, twice.
__global__ void __launch_bounds__(kThreads, 1)
mla_dense_decode_wgmma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ o, float* __restrict__ ws,
                              const int* __restrict__ clen, int S, int Hq,
                              int Hkv, int G, int window, float softcap,
                              float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = wg::aligned_smem(smem_raw);
  const uint32_t q_s = wg::smem_u32(sm), k_s = q_s + LK::BYTES,
                 v_s = k_s + LK::BYTES;
  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.z;
  const int RG = (G + kRows - 1) / kRows;
  const int h = blockIdx.y / RG, g0 = (blockIdx.y % RG) * kRows;
  const Range rng(clen, b, S, window, split, nsplit, wg::kT);
  const int lo = rng.lo, hi = rng.hi;
  const int n_tiles = hi > lo ? (hi - lo + wg::kT - 1) / wg::kT : 0;

  // block row r is query head h·G + g0 + r of sequence b
  auto live = [&](int r) { return g0 + r < G; };
  auto q_row = [&](int r) { return (size_t)b * Hq + h * G + g0 + r; };
  wg::cp_tile<DK, kThreads>(q_s, [&](int r) {
    return live(r) ? q + q_row(r) * DK : nullptr; }, q);
  // key j of sequence b, KV head h: row (b·S + j)·Hkv + h of the caches
  const size_t row0 = (size_t)b * S * Hkv + h;
  auto load = [&](auto L, uint32_t dst, const bf16* src, int n) {
    using T = decltype(L);
    constexpr int W = T::value, CPR = W / 8, NC = wg::kT * CPR / kThreads;
    static_assert(NC * kThreads == wg::kT * CPR, "whole rounds of chunks");
    const int k0 = lo + n * wg::kT;
    // not unrolled: unrolled, the chunks' addresses (34 a thread, loop
    // invariants since K and V have one buffer each) stay in registers
    // and the kernel spills (255 registers, 148 B; 219 and none rolled)
#pragma unroll 1
    for (int it = 0; it < NC; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int r = idx / CPR, c = (idx % CPR) * 8, j = k0 + r;
      const bool in = j < hi;
      const uint32_t off = W == DK ? LK::offset(r, c) : LV::offset(r, c);
      wg::cp_async16(dst + off,
                     src + (row0 + (size_t)(in ? j : lo) * Hkv) * W + c, in);
    }
  };
  using KW = std::integral_constant<int, DK>;
  using VW = std::integral_constant<int, DV>;
  // groups in flight: q with K(0), V(0); then K(n+1) once every warpgroup
  // is past q·K(n)ᵀ, V(n+1) once past p·V(n)
  if (n_tiles > 0) load(KW{}, k_s, k, 0);
  wg::cp_commit();
  if (n_tiles > 0) load(VW{}, v_s, v, 0);
  wg::cp_commit();

  const int wgi = threadIdx.x / wg::kWG, wt = threadIdx.x % wg::kWG;
  bool live_r[2];
  int row_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_r[i] = 16 * (wt / 32) + (wt % 32) / 4 + 8 * i;
    live_r[i] = live(row_r[i]);
  }
  // this warpgroup's columns [256·wgi, 256·wgi + 256): two m64n128 slices
  const uint32_t v_col = (wgi * DW / LV::W) * (wg::kT * LV::SW);
  const uint32_t v_half = (128 / LV::W) * (wg::kT * LV::SW);
  const float f = softcap > 0.f ? wg::kLog2e : sm_scale * wg::kLog2e;
  float acc0[64], acc1[64], s[32];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 64; ++e) acc0[e] = acc1[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    wg::cp_wait<1>();                               // q and K(n) are in
    wg::fence_async_smem();
    __syncthreads();
    wg::wg_fence();
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks)
      wg::wgmma_ss_n64(s, LK::kmajor(q_s, ks), LK::kmajor(k_s, ks), ks > 0);
    wg::wg_commit();
    wg::wg_wait<0>();
    wg::fence_regs(s);
    __syncthreads();                                // K(n) is free
    if (n + 1 < n_tiles) load(KW{}, k_s, k, n + 1);
    wg::cp_commit();

    const int nvalid = hi - (lo + n * wg::kT);
    if (softcap > 0.f)
      softmax_step<true>(s, acc0, acc1, m, l, f, sm_scale, softcap, nvalid,
                         live_r);
    else
      softmax_step<false>(s, acc0, acc1, m, l, f, sm_scale, softcap, nvalid,
                          live_r);
    uint32_t a[4][4];
    wg::to_a(s, a);

    wg::cp_wait<1>();                               // V(n) is in
    wg::fence_async_smem();
    __syncthreads();
    wg::wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wg::wgmma_rs(acc0, a[ks], LV::mnmajor(v_s + v_col, ks));
      wg::wgmma_rs(acc1, a[ks], LV::mnmajor(v_s + v_col + v_half, ks));
    }
    wg::wg_commit();
    wg::wg_wait<0>();
    wg::fence_regs(acc0);
    wg::fence_regs(acc1);
    wg::fence_regs(a);
    __syncthreads();                                // V(n) is free
    if (n + 1 < n_tiles) load(VW{}, v_s, v, n + 1);
    wg::cp_commit();
  }
  wg::cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
  const int rows = gridDim.z * Hq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live_r[i]) continue;
    const size_t row = q_row(row_r[i]);
    const int c0 = wgi * DW;
    if (ws == nullptr) {                  // one split: the output itself
      const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
      bf16* out = o + row * DV + c0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = wg::acc_col(j, 0);
        *reinterpret_cast<uint32_t*>(out + c) = wg::pack_bf16(
            acc0[4 * j + 2 * i] * inv, acc0[4 * j + 2 * i + 1] * inv);
        *reinterpret_cast<uint32_t*>(out + 128 + c) = wg::pack_bf16(
            acc1[4 * j + 2 * i] * inv, acc1[4 * j + 2 * i + 1] * inv);
      }
      continue;
    }
    float* po = partial_o(ws, row, split, nsplit) + c0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = wg::acc_col(j, 0);
      *reinterpret_cast<float2*>(po + c) =
          make_float2(acc0[4 * j + 2 * i], acc0[4 * j + 2 * i + 1]);
      *reinterpret_cast<float2*>(po + 128 + c) =
          make_float2(acc1[4 * j + 2 * i], acc1[4 * j + 2 * i + 1]);
    }
    if (wgi == 0 && threadIdx.x % 4 == 0)
      *reinterpret_cast<float2*>(partial_ml(ws, rows, row, split, nsplit)) =
          make_float2(fmaxf(m[i] * f, kNegInf), l[i]);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kWarps = 8, kThreads = kWarps * 32, RW = 4;
constexpr int kRows = kWarps * RW;      // query heads a block
constexpr int C = kLaneCols<DV>;        // output columns a lane: 16
constexpr size_t kSmem = sizeof(float) * (kRows * DK + DK * kBK + kBK * DV);

// One block per (key share, KV head and group of 32 query heads,
// sequence); warp w holds rows 4·w .. 4·w + 3, lane x key x of a tile and
// output columns x, x + 32, ...
__global__ void __launch_bounds__(kThreads, 1)
mla_dense_decode_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ ws,
                            const int* __restrict__ clen, int S, int Hq,
                            int Hkv, int G, int window, float softcap,
                            float sm_scale) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kRows][DK], pre-scaled
  float* kT_s = q_s + kRows * DK;                 // [DK][kBK]
  float* v_s = kT_s + DK * kBK;                   // [kBK][DV]
  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.z;
  const int RG = (G + kRows - 1) / kRows;
  const int h = blockIdx.y / RG, g0 = (blockIdx.y % RG) * kRows;
  const Range rng(clen, b, S, window, split, nsplit, kBK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  auto live = [&](int r) { return g0 + r < G; };
  auto q_row = [&](int r) { return (size_t)b * Hq + h * G + g0 + r; };
  for (int i = threadIdx.x; i < kRows * DK; i += kThreads) {
    const int r = i / DK, d = i % DK;
    q_s[i] = live(r) ? q[q_row(r) * DK + d] * sm_scale : 0.f;
  }
  const size_t row0 = (size_t)b * S * Hkv + h;
  float m[RW], l[RW], acc[RW][C];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[rr][c] = 0.f;
  }
  for (int k0 = rng.lo; k0 < rng.hi; k0 += kBK) {
    __syncthreads();                              // the last tile consumed
    for (int i = threadIdx.x; i < kBK * (DK / 4); i += kThreads) {
      const int kj = i % kBK, c = (i / kBK) * 4, j = k0 + kj;
      const uint4 x = j < rng.hi ? load16(k + (row0 + (size_t)j * Hkv) * DK + c)
                                 : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) kT_s[(c + e) * kBK + kj] = elem<float>(x, e);
    }
    for (int i = threadIdx.x; i < kBK * (DV / 4); i += kThreads) {
      const int vj = i / (DV / 4), c = (i % (DV / 4)) * 4, j = k0 + vj;
      const uint4 x = j < rng.hi ? load16(v + (row0 + (size_t)j * Hkv) * DV + c)
                                 : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(v_s + vj * DV + c) = x;
    }
    __syncthreads();
    float s[RW];
    bool ok[RW];
    qk_tile<DK, RW>(q_s + warp * RW * DK, kT_s, s);
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      s[rr] = softcap_logit(s[rr], softcap);
      ok[rr] = live(warp * RW + rr) && k0 + lane < rng.hi;
    }
    softmax_pv_tile<DV, RW, false>(s, ok, 1.f, v_s, m, l, acc);
  }
  const int rows = gridDim.z * Hq;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp * RW + rr;
    if (!live(r)) continue;
    const size_t row = q_row(r);
    if (ws == nullptr) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        o[row * DV + c * 32 + lane] = l[rr] == 0.f ? 0.f : acc[rr][c] / l[rr];
      continue;
    }
    float* po = partial_o(ws, row, split, nsplit);
#pragma unroll
    for (int c = 0; c < C; ++c) po[c * 32 + lane] = acc[rr][c];
    if (lane == 0)
      *reinterpret_cast<float2*>(partial_ml(ws, rows, row, split, nsplit)) =
          make_float2(fmaxf(m[rr] * wg::kLog2e, kNegInf), l[rr]);
  }
}

}  // namespace f32

// The partials of a row's splits merged by the log-sum-exp rule: M = max
// m_s, L = Σ l_s·2^(m_s − M), o = Σ o_s·2^(m_s − M) / L, 0 where L = 0.
template <typename T>
__global__ void __launch_bounds__(128)
mla_dense_decode_combine_kernel(const float* __restrict__ ws,
                                T* __restrict__ o, int rows, int nsplit) {
  const size_t row = blockIdx.x;
  const float* ml = partial_ml(const_cast<float*>(ws), rows, row, 0, nsplit);
  float M = kNegInf;
  for (int sp = 0; sp < nsplit; ++sp) M = fmaxf(M, ml[2 * sp]);
  float L = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) L += ml[2 * sp + 1] * exp2f(ml[2 * sp] - M);
  const float* po = partial_o(const_cast<float*>(ws), row, 0, nsplit);
  for (int d = threadIdx.x; d < DV; d += blockDim.x) {
    float A = 0.f;
    for (int sp = 0; sp < nsplit; ++sp)
      A = fmaf(po[(size_t)sp * DV + d], exp2f(ml[2 * sp] - M), A);
    store(o + row * DV + d, L == 0.f ? 0.f : A / L);
  }
}

// blocks a (sequence, KV head) splits its keys over: enough to put one
// block on each SM, at most one a `kSplitKeys` of S
int splits(int B, int S, int Hq, int Hkv, int dtype) {
  if (Hkv <= 0 || Hq % Hkv != 0) return 1;
  const int rows = dtype == 1 ? tc::kRows : f32::kRows;
  const int G = Hq / Hkv;
  const int groups = B * Hkv * ((G + rows - 1) / rows);
  int n = groups > 0 ? kSMs / groups : 1;
  n = min(n, (S + kSplitKeys - 1) / kSplitKeys);
  return max(n, 1);
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int threads, int rows_a_block,
                   const void* q, const void* k, const void* v, void* o,
                   void* ws, const void* clen, int B, int S, int Hq, int Hkv,
                   int nsplit, int window, float softcap, float sm_scale,
                   cudaStream_t stream) {
  cudaError_t err = flash::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv, RG = (G + rows_a_block - 1) / rows_a_block;
  float* w = nsplit > 1 ? static_cast<float*>(ws) : nullptr;
  kernel<<<dim3(nsplit, Hkv * RG, B), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), w,
      static_cast<const int*>(clen), S, Hq, Hkv, G, window, softcap,
      sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || w == nullptr) return err;
  mla_dense_decode_combine_kernel<T><<<B * Hq, 128, 0, stream>>>(
      w, static_cast<T*>(o), B * Hq, nsplit);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mla

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16, the same for q and the caches.  q [B,Hq,D], k/v caches
// [B,S,Hkv,D], cache_len [B] int32.  All tensors contiguous, the caches
// 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, void* o,
                                    const void* cache_len, int B, int S,
                                    int Hq, int Hkv, int D, int dtype,
                                    int window, float softcap,
                                    float sm_scale, void* stream) {
  return paged::run<dense_decode>(
      {q, k_cache, v_cache, nullptr, nullptr, o, nullptr, cache_len, B, 1,
       Hq, Hkv, D, S, 1, dtype, 0, window, softcap, sm_scale,
       static_cast<cudaStream_t>(stream)});
}

// MLA's shape: q [B,Hq,576], k [B,S,Hkv,576], v [B,S,Hkv,512], o
// [B,Hq,512].  `mla_decode_splits` gives the number of key shares the
// call takes; with more than one, `ws` must hold B·Hq·nsplit·514 floats.
extern "C" int mla_decode_splits(int B, int S, int Hq, int Hkv, int dtype) {
  return mla::splits(B, S, Hq, Hkv, dtype);
}

extern "C" int mla_decode_attention_fwd(const void* q, const void* k_cache,
                                        const void* v_cache, void* o,
                                        void* ws, const void* cache_len,
                                        int B, int S, int Hq, int Hkv,
                                        int nsplit, int dtype, int window,
                                        float softcap, float sm_scale,
                                        void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || nsplit < 1 || (nsplit > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0) return (int)cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)mla::launch<float>(
          mla::f32::mla_dense_decode_f32_kernel, mla::f32::kSmem,
          mla::f32::kThreads, mla::f32::kRows, q, k_cache, v_cache, o, ws,
          cache_len, B, S, Hq, Hkv, nsplit, window, softcap, sm_scale, st);
    case 1:
      return (int)mla::launch<__nv_bfloat16>(
          mla::tc::mla_dense_decode_wgmma_kernel, mla::tc::kSmem,
          mla::tc::kThreads, mla::tc::kRows, q, k_cache, v_cache, o, ws,
          cache_len, B, S, Hq, Hkv, nsplit, window, softcap, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
