// The kernel of paged decode, paged verify and dense decode attention,
// for Hopper (sm_90a).  `paged_decode_attention.cu`,
// `paged_verify_attention.cu` and `decode_attention.cu` each instantiate
// it behind their own C entry point; decode is verify with one query token
// (K1 = 1), and a dense cache [B,S,Hkv,D] is a pool of B pages of S keys
// read through the identity table, which the `dense_decode` kind computes
// in place of a table slice (its key at `pos` of sequence b sits at row
// (b·S + pos)·Hkv + h).
//
// Function.  The R = K1·G query rows of one (sequence, KV head), laid out
// as the JAX wrapper lays them out (row r = i·G + g is query token i of
// head kvh·G + g), against the page pools [P,page,Hkv,D] gathered through
// page_table [B,MP].  `cache_len` counts all K1 new tokens, so token i
// sits at qpos = cache_len - K1 + i and sees the keys at pos <= qpos (and
// pos > qpos - window with a window), below min(cache_len, MP·page).  The
// logit softcap `tanh(s/c)·c` applies after scaling, `NEG_INF =
// -0.7·f32max` masks, p is masked as well as s, the accumulator is f32 and
// a row with no visible key gives 0.  On int8 pools the per-token scales
// [P,page,Hkv] fold in as in the TPU kernels: the k-scale multiplies the
// logits before the softcap, the v-scale multiplies p after the `l`
// update.
//
// What bounds it on an H100: bytes.  Each (sequence, KV head) needs its
// visible K and V once and does 4·R·D FLOP per key: at tinyllama's G 8 and
// D 64 in bf16, 2 FLOP per byte for decode and 10 for a K1 5 verify pass,
// far below the card's ~295 FLOP/byte, so the floor is the KV bytes over
// 3.35 TB/s: 0.7 µs for a decode tick's layer at B 8 and lengths up to
// 543, under the ~5 µs that any launch costs when timed with events.
//
// What holds it back now: latency.  A block walks a chain of dependent
// steps, each a round trip to memory or a barrier: the cache length (with
// q beside it), its page-table slice (none for a dense cache), its keys,
// 1-4 tiles of products, the partials' exchange, one cluster barrier that
// waits for the slowest block, and the combine; then the launch itself.
// Only long caches
// (lengths in the thousands) make the key loop the larger part, and there
// a verify pass's products (40 rows on 4 warps, one warp taking two row
// tiles) bound it before the bytes do.
//
// Design.
// - The split: the visible key range [first, n_keys) of each (sequence,
//   KV head, group of up to 64 query rows) is shared by a thread-block
//   cluster of cl blocks in even shares of a multiple of 16 keys, cl
//   sized to the grid (`cluster_size`): 4 at the decode serving shape
//   (B 8, Hkv 4, lengths 36-543: 128 blocks of 1-3 tiles), 8 for a
//   verify pass there or over 4096 keys, 16 at B 1 or at gemma-2b's one
//   KV head, and 1 at zamba2's 256 (sequence, KV head) pairs of one
//   row.  One block a pair takes no cluster at all: its warps' partials
//   meet in its own shared memory after one block barrier.
// - The combine happens in the same launch, through distributed shared
//   memory: every warp writes its rows' (m, l, acc) straight into the
//   shared memory of the block that owns the row (row r: block r % cl),
//   one cluster barrier later each block merges its own rows by the
//   log-sum-exp rule (m* = max m_i, l = Σ l_i·2^(m_i − m*), o = Σ acc_i·
//   2^(m_i − m*) / l; the logits are kept in base 2, so p is one `ex2`)
//   and writes them out.  No workspace, no atomic, no second pass.  A
//   share with no visible key for a row contributes m = NEG_INF and l = 0
//   (weight 2^(NEG_INF − m*) = 0, or 1 times nothing when every share is
//   empty), so a row whose l is 0 gives exactly 0.  Every block arrives
//   on the cluster barrier as it starts and waits on it before its first
//   remote store, so no store reaches a block that has not started.
// - The block: 4 warps, all R rows of its row group (up to 64), so the KV
//   of a (sequence, KV head) is read once a call for every K1·G row.  It
//   asks for q and the cache length at once, then (paged kinds) for its
//   slice of the page table.  K and V come into shared memory in their own
//   dtype by 16-byte cp.async, 64 keys a tile, in a ring of 3 stages (2 in
//   fp32), each key finding its page through the table (or its dense row).
//   Keys at or past the block's end are not loaded but zero-filled, and
//   masked, so stale rows never reach a product.  int8 tiles widen to the
//   compute dtype in shared memory (exactly: an int8 value fits bf16's 8
//   significant bits).
// - Warps split a tile's keys 4 ways (up to 16 rows: one or two n8 row
//   tiles a warp), or 2 or 1 ways with the rows split over the rest (KW
//   key slices × 4/KW row partitions); each warp keeps its own online
//   softmax, one max and rescale a tile, over its keys.
// - bf16: products on the tensor cores, `mma.sync.m16n8k16` with keys as
//   M: Sᵀ = K·qᵀ (q's fragments held in registers), then Oᵀ = Vᵀ·Pᵀ with D
//   as M and p, rounded to bf16 once, as the B operand.  The accumulator
//   of Sᵀ holds a thread's p at the (key, row) places that `movmatrix`
//   transposes into exactly the B fragment of the second product, so p
//   never goes through shared memory.  fp32: the same fragment ownership
//   computed by f32 FMAs on the CUDA cores (no TF32; the 2e-5 tolerance
//   and the fp32 golden streams need it), with the one warp layout that
//   takes any row count past 8.
// - D 192 and 256 (nemotron-4-340b's and gemma-2b's heads): a block keeps
//   q in shared memory for its own rows only (8-64 by its warp layout,
//   not always 64), the ring has 2 stages (of 32-key tiles in fp32), a
//   warp takes one row tile, and more than 32 rows (gemma's K1 5 verify
//   at G 8: 40) go to more row groups, each reading the KV again.  The
//   largest block, gemma's decode over int8 pools in a cluster of 16,
//   takes 205 KB.
// - Measured against (`PERF.md` §6): splits of 64 keys at fixed
//   places combined by the last block to finish through an f32 workspace
//   and an atomic counter, 1.4-2.9x slower at every timed shape.
#pragma once

#include <cooperative_groups.h>

#include "flash_common.cuh"

// The entry points' kinds: each names its kernel in profiles, and
// `kDense` selects the dense row map in place of the page table.
struct paged_decode { static constexpr bool kDense = false; };
struct paged_verify { static constexpr bool kDense = false; };
struct dense_decode { static constexpr bool kDense = true; };

namespace paged {
namespace {

using namespace attn;
using bf16 = __nv_bfloat16;
using flash::wg::cp_async16;
using flash::wg::cp_async4;
using flash::wg::cp_commit;
using flash::wg::cp_wait;
using flash::wg::ex2;
using flash::wg::kLog2e;
using flash::wg::smem_u32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// The query rows of a block (a row group) when each warp takes NTW row
// tiles of 8 and a tile's keys are split KW ways: 8, 16, 32 or 64.
template <int NTW, int KW>
constexpr int kRows = 8 * NTW * kWarps / KW;

// Byte offsets of a block's shared memory.  TC is the compute dtype (the
// q dtype), TKV the pools'; QR query rows.  The ring holds NS stages of K
// and V tiles of KT keys in the pools' dtype; for int8 they widen into
// one compute tile each.  Up to D 128 a tile is 64 keys in 3 stages (2 in
// fp32); at D 192 and 256 two stages, of 32 keys in fp32, keep the block
// within 227 KB (bf16 at D 256: 4 tiles of 33 KB, against 6 that would
// not fit).  The block's slice of the page table follows (none for a
// dense cache), then the inbox that the cluster's warps write their
// partials of this block's rows into.  Compute rows are padded by 16
// bytes, so the 8 rows an ldmatrix reads start in different bank groups.
template <typename TC, typename TKV, int D, int QR>
struct Layout {
  static constexpr bool kScaled = sizeof(TKV) == 1;
  static constexpr bool kWide = D > 128;
  static constexpr int KT = kWide && sizeof(TC) == 4 ? 32 : 64;   // keys
  static constexpr int NS = sizeof(TC) == 2 && !kWide ? 3 : 2;
  static constexpr int CS = D + 16 / (int)sizeof(TC);     // compute stride
  static constexpr int RS = kScaled ? D : CS;             // ring stride
  static constexpr size_t Q = 0;
  static constexpr size_t RING = Q + (size_t)QR * CS * sizeof(TC);
  static constexpr size_t TILE = (size_t)KT * RS * sizeof(TKV);
  static constexpr size_t CONV = RING + NS * 2 * TILE;
  static constexpr size_t SC =
      CONV + (kScaled ? 2 * (size_t)KT * CS * sizeof(TC) : 0);
  static constexpr size_t TAB = SC + (kScaled ? NS * 2 * KT * 4 : 0);
  // [cl·KW sources][rows a block owns][D + 2]: acc, then m and l
  static __host__ __device__ size_t INBOX(int tab) {
    return (TAB + 4 * (size_t)tab + 15) / 16 * 16;
  }
  static size_t bytes(int tab, int sources, int rows) {
    return INBOX(tab) + 4 * (size_t)sources * rows * (D + 2);
  }
};

struct Params {
  const void *q, *kp, *vp;
  const float *ks, *vs;            // int8 pools only
  void* o;
  const int *table, *clen;
  int K1, Hq, Hkv, G, R, RG, page, MP, window;
  int tab;                         // table entries a block copies, at most
  float softcap, sm_scale;
};  // a dense cache: page = S, MP = 1, no table

// ---------------------------------------------------------------------------
// a warp's products over 16 keys: Sᵀ = K·qᵀ into s[j][e], Oᵀ += Vᵀ·Pᵀ into
// acc[md][j][e].  Element e of row tile j is key kb + lane/4 + 8·(e/2) and
// query row 8·rt[j] + 2·(lane%4) + e%2 in s, column 16·md + lane/4 +
// 8·(e/2) and the same row in acc: the m16n8 accumulator's places.
// ---------------------------------------------------------------------------

template <typename TC, int D, int NTW>
struct Products;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, lane l giving the address of row l % 8 of
// matrix l / 8; `.trans` delivers each one transposed.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// Two values as bf16 (the lower column in the low half), and an 8 x 8
// bf16 matrix held a row pair per thread, transposed across the warp.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

template <int D, int NTW>
struct Products<bf16, D, NTW> {
  static constexpr int CS = D + 8;
  uint32_t qf[NTW][D / 16][2];      // qᵀ as the B operand, per k16 step

  __device__ __forceinline__ void load_q(const bf16* q_s,
                                         const int (&rt)[NTW]) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t r[4];
        ldsm4(r, smem_u32(q_s + (8 * rt[j] + lane % 8) * CS + 32 * kk +
                          (lane / 8) * 8));
        qf[j][2 * kk][0] = r[0];
        qf[j][2 * kk][1] = r[1];
        qf[j][2 * kk + 1][0] = r[2];
        qf[j][2 * kk + 1][1] = r[3];
      }
  }

  __device__ __forceinline__ void qk(const bf16* k_t, int kb,
                                     float (&s)[NTW][4]) const {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* row = k_t + (kb + lane % 8 + ((lane / 8) & 1) * 8) * CS +
                      (lane / 16) * 8;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldsm4(a, smem_u32(row + 16 * ks));
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        mma_bf16(s[j], a, qf[j][ks][0], qf[j][ks][1]);
    }
  }

  __device__ __forceinline__ void pv(const bf16* v_t, int kb,
                                     const float (&p)[NTW][4],
                                     float (&acc)[D / 16][NTW][4]) const {
    const int lane = threadIdx.x % 32;
    uint32_t b[NTW][2];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      b[j][0] = movmatrix_t(pack_bf16(p[j][0], p[j][1]));
      b[j][1] = movmatrix_t(pack_bf16(p[j][2], p[j][3]));
    }
    const bf16* row = v_t + (kb + lane % 8 + (lane / 16) * 8) * CS +
                      ((lane / 8) & 1) * 8;
#pragma unroll
    for (int md = 0; md < D / 16; ++md) {
      uint32_t a[4];
      ldsm4t(a, smem_u32(row + 16 * md));
#pragma unroll
      for (int j = 0; j < NTW; ++j) mma_bf16(acc[md][j], a, b[j][0], b[j][1]);
    }
  }
};

template <int D, int NTW>
struct Products<float, D, NTW> {
  static constexpr int CS = D + 4;
  const float* q_s;
  int rt[NTW];

  __device__ __forceinline__ void load_q(const float* q, const int (&r)[NTW]) {
    q_s = q;
#pragma unroll
    for (int j = 0; j < NTW; ++j) rt[j] = r[j];
  }

  __device__ __forceinline__ void qk(const float* k_t, int kb,
                                     float (&s)[NTW][4]) const {
    const int lane = threadIdx.x % 32;
    const float* k0 = k_t + (kb + lane / 4) * CS;
    const float* k1 = k0 + 8 * CS;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const float* q0 = q_s + (8 * rt[j] + 2 * (lane % 4)) * CS;
      const float* q1 = q0 + CS;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(k0 + d);
        const float4 c = *reinterpret_cast<const float4*>(k1 + d);
        const float4 x = *reinterpret_cast<const float4*>(q0 + d);
        const float4 y = *reinterpret_cast<const float4*>(q1 + d);
        s0 = fmaf(a.x, x.x, fmaf(a.y, x.y, fmaf(a.z, x.z, fmaf(a.w, x.w, s0))));
        s1 = fmaf(a.x, y.x, fmaf(a.y, y.y, fmaf(a.z, y.z, fmaf(a.w, y.w, s1))));
        s2 = fmaf(c.x, x.x, fmaf(c.y, x.y, fmaf(c.z, x.z, fmaf(c.w, x.w, s2))));
        s3 = fmaf(c.x, y.x, fmaf(c.y, y.y, fmaf(c.z, y.z, fmaf(c.w, y.w, s3))));
      }
      s[j][0] = s0;
      s[j][1] = s1;
      s[j][2] = s2;
      s[j][3] = s3;
    }
  }

  // p of key kk and kk + 8 for this thread's two rows comes from lane
  // 4·kk + lane%4, which holds exactly those four values
  __device__ __forceinline__ void pv(const float* v_t, int kb,
                                     const float (&p)[NTW][4],
                                     float (&acc)[D / 16][NTW][4]) const {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int src = 4 * kk + lane % 4;
      float pk[NTW][4];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pk[j][e] = __shfl_sync(kFull, p[j][e], src);
      const float* va = v_t + (kb + kk) * CS + lane / 4;
      const float* vb = va + 8 * CS;
#pragma unroll
      for (int md = 0; md < D / 16; ++md)
#pragma unroll
        for (int dh = 0; dh < 2; ++dh) {
          const float a = va[16 * md + 8 * dh], c = vb[16 * md + 8 * dh];
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            acc[md][j][2 * dh] =
                fmaf(pk[j][0], a, fmaf(pk[j][2], c, acc[md][j][2 * dh]));
            acc[md][j][2 * dh + 1] =
                fmaf(pk[j][1], a, fmaf(pk[j][3], c, acc[md][j][2 * dh + 1]));
          }
        }
    }
  }
};

// widens a stage's int8 K and V tiles of KT keys into the compute tiles
template <typename TC, int D, int KT>
__device__ __forceinline__ void widen(const int8_t* k8, const int8_t* v8,
                                      TC* kc, TC* vc) {
  constexpr int CPR = D / 16, CS = D + 16 / (int)sizeof(TC);
  for (int i = threadIdx.x; i < 2 * KT * CPR; i += kThreads) {
    const int t = i / (KT * CPR), j = i % (KT * CPR);
    const int key = j / CPR, c = (j % CPR) * 16;
    const uint4 u =
        *reinterpret_cast<const uint4*>((t ? v8 : k8) + key * D + c);
    const int8_t* x = reinterpret_cast<const int8_t*>(&u);
    TC* dst = (t ? vc : kc) + key * CS + c;
    if constexpr (sizeof(TC) == 2) {
      uint32_t w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = pack_bf16(x[2 * e], x[2 * e + 1]);
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        reinterpret_cast<float4*>(dst)[e] =
            make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2], x[4 * e + 3]);
    }
  }
}

// One block per (share, KV head and row group, sequence): grid (cl,
// Hkv·RG, B) in clusters of (cl, 1, 1), or no cluster when cl is 1.  NTW
// row tiles of 8 a warp, KW key slices a tile.  `Kind` names the entry
// point (`paged_decode`, `paged_verify`, `dense_decode`) in profiles and
// picks the row map.
template <typename Kind, typename TC, typename TKV, int D, int NTW, int KW>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(TC) == 2 && D <= 64 ? 3 : 2)
    paged_attention_kernel(
    const Params p) {
  constexpr int QR = kRows<NTW, KW>;
  using L = Layout<TC, TKV, D, QR>;
  constexpr bool SCALED = L::kScaled, DENSE = Kind::kDense;
  constexpr int NS = L::NS, CS = L::CS, RS = L::RS, MD = D / 16, KT = L::KT;
  extern __shared__ __align__(16) uint8_t smem[];
  TC* q_s = reinterpret_cast<TC*>(smem + L::Q);
  int* tab_s = reinterpret_cast<int*>(smem + L::TAB);
  const TC* q = static_cast<const TC*>(p.q);
  const TKV* kp = static_cast<const TKV*>(p.kp);
  const TKV* vp = static_cast<const TKV*>(p.vp);
  TC* o = static_cast<TC*>(p.o);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y / p.RG, rg = blockIdx.y % p.RG;
  const int r_lo = rg * QR, Rb = min(QR, p.R - r_lo);
  // block row r is row r_lo + r of (b, h): query token (r_lo + r) / G of
  // head h·G + (r_lo + r) % G
  auto q_row = [&](int r) {
    const int rr = r_lo + r;
    return ((size_t)b * p.K1 + rr / p.G) * p.Hq + h * p.G + rr % p.G;
  };

  // this block has started (the combine writes into the others' shared
  // memory); q comes in while the length does
  const int cl = (int)gridDim.x, rank = (int)blockIdx.x;
  const bool clustered = cl > 1;
  if (clustered)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int valid = __ldg(p.clen + b);
  constexpr int QV = 16 / (int)sizeof(TC), QC = D / QV;
  for (int i = tid; i < QR * QC; i += kThreads) {
    const int r = i / QC, c = (i % QC) * QV;
    const bool ok = r < Rb;
    cp_async16(smem_u32(q_s + r * CS + c), ok ? q + q_row(r) * D + c : q, ok);
  }
  cp_commit();

  // the keys some row of this block sees, and this block's share of them:
  // the cluster is the grid's x
  const int base = valid - p.K1;                   // qpos of token 0
  const int n_keys = max(0, min(min(valid, p.MP * p.page),
                                base + (r_lo + Rb - 1) / p.G + 1));
  const int first = p.window > 0 ? max(0, base + r_lo / p.G - p.window + 1)
                                 : 0;
  const int share =
      ((max(0, n_keys - first) + gridDim.x - 1) / gridDim.x + 15) / 16 * 16;
  const int lo = first + rank * share;
  const int hi = min(n_keys, lo + share);
  // the table entries of this share (a dense cache needs none)
  const int pg0 = lo / p.page;
  if constexpr (!DENSE) {
    const int npg = hi > lo ? (hi - 1) / p.page - pg0 + 1 : 0;
    for (int i = tid; i < npg; i += kThreads)
      tab_s[i] = p.table[(size_t)b * p.MP + pg0 + i];
    __syncthreads();
  }
  // (pool row, KV head) of the key at `pos`: page b of a dense cache
  auto row_of = [&](int pos) -> size_t {
    if constexpr (DENSE) {
      return ((size_t)b * p.page + pos) * p.Hkv + h;
    } else {
      const int pi = pos / p.page;
      return ((size_t)tab_s[pi - pg0] * p.page + (pos - pi * p.page)) *
                 p.Hkv + h;
    }
  };
  auto ring = [&](int st, int t) {
    return reinterpret_cast<TKV*>(smem + L::RING + (2 * st + t) * L::TILE);
  };
  float* sc_s = reinterpret_cast<float*>(smem + L::SC);   // [NS][2][KT]
  auto load = [&](int n, int st) {
    constexpr int VEC = 16 / (int)sizeof(TKV), CPR = D / VEC;
    const int k0 = lo + n * KT;
    TKV* kd = ring(st, 0);
    TKV* vd = ring(st, 1);
    for (int i = tid; i < KT * CPR; i += kThreads) {
      const int key = i / CPR, c = (i % CPR) * VEC, pos = k0 + key;
      const bool ok = pos < hi;
      const size_t off = ok ? row_of(pos) * D + c : 0;
      cp_async16(smem_u32(kd + key * RS + c), kp + off, ok);
      cp_async16(smem_u32(vd + key * RS + c), vp + off, ok);
    }
    if (SCALED && tid < KT) {
      const int pos = k0 + tid;
      const bool ok = pos < hi;
      const size_t r = ok ? row_of(pos) : 0;
      cp_async4(smem_u32(sc_s + st * 2 * KT + tid), p.ks + r, ok);
      cp_async4(smem_u32(sc_s + (st * 2 + 1) * KT + tid), p.vs + r, ok);
    }
  };

  // warps: KW key slices of a tile (MT m16 tiles each) times kWarps / KW
  // row partitions
  constexpr int MT = KT / KW / 16;
  static_assert(MT >= 1, "a warp's key slice is whole m16 tiles");
  const int NT = (Rb + 7) / 8;
  const int ks = warp % KW, rp = warp / KW;
  int rt[NTW], qpos[NTW][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    rt[j] = rp + j * (kWarps / KW);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = 8 * rt[j] + 2 * (lane % 4) + c;
      qpos[j][c] = r < Rb ? base + (r_lo + r) / p.G : -1;   // dead: nothing
    }
  }
  float m[NTW][2], l[NTW][2], acc[MD][NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      m[j][c] = kNegInf;
      l[j][c] = 0.f;
    }
#pragma unroll
    for (int md = 0; md < MD; ++md)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[md][j][e] = 0.f;
  }

  const int n_tiles = hi > lo ? (hi - lo + KT - 1) / KT : 0;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_commit();
  }
  Products<TC, D, NTW> mm;
  cp_wait<NS - 1>();                               // q is in
  __syncthreads();
  mm.load_q(q_s, rt);
  TC* kc = reinterpret_cast<TC*>(smem + L::CONV);
  TC* vc = kc + KT * CS;
  for (int n = 0; n < n_tiles; ++n) {
    cp_wait<NS - 2>();                             // tile n is in
    __syncthreads();                               // and n - 1 consumed
    if (n + NS - 1 < n_tiles) load(n + NS - 1, (n + NS - 1) % NS);
    cp_commit();
    const int st = n % NS, k0 = lo + n * KT;
    const float* ksc = sc_s + st * 2 * KT;
    const float* vsc = ksc + KT;
    const TC* kt = reinterpret_cast<const TC*>(ring(st, 0));
    const TC* vt = reinterpret_cast<const TC*>(ring(st, 1));
    if constexpr (SCALED) {
      widen<TC, D, KT>(reinterpret_cast<const int8_t*>(ring(st, 0)),
                   reinterpret_cast<const int8_t*>(ring(st, 1)), kc, vc);
      __syncthreads();
      kt = kc;
      vt = vc;
    }
    // this warp's MT m16 tiles of keys, then one softmax step over them
    const int kb = ks * MT * 16;
    if (k0 + kb >= hi) continue;                   // no key of them loaded
    float s[MT][NTW][4];
    bool ok[MT][NTW][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (k0 + kb + 16 * i < hi) mm.qk(kt, kb + 16 * i, s[i]);
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + 16 * i + lane / 4 + 8 * (e >> 1);
          const int pos = k0 + key, qp = qpos[j][e & 1];
          ok[i][j][e] = pos < hi && pos <= qp &&
                        (p.window <= 0 || pos > qp - p.window);
          float x = s[i][j][e] * p.sm_scale;
          if (SCALED) x *= ksc[key];               // q·(k·s) == (q·k)·s
          x = softcap_logit(x, p.softcap) * kLog2e;  // in base 2 from here
          s[i][j][e] = ok[i][j][e] ? x : kNegInf;
        }
    }
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mx = fmaxf(mx, fmaxf(s[i][j][c], s[i][j][c + 2]));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_new = fmaxf(m[j][c], mx);
        const float corr = ex2(m[j][c] - m_new);
        m[j][c] = m_new;
        l[j][c] *= corr;
#pragma unroll
        for (int md = 0; md < MD; ++md) {
          acc[md][j][c] *= corr;
          acc[md][j][c + 2] *= corr;
        }
      }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (k0 + kb + 16 * i >= hi) break;           // p is 0 past the end
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = ok[i][j][e] ? ex2(s[i][j][e] - m[j][e & 1]) : 0.f;
          l[j][e & 1] += pe;                       // this thread's keys
          s[i][j][e] =
              SCALED ? pe * vsc[kb + 16 * i + lane / 4 + 8 * (e >> 1)] : pe;
        }
      mm.pv(vt, kb + 16 * i, s[i], acc);
    }
  }

  // each row's l, summed over the 8 lanes that hold its keys
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[j][c] += __shfl_xor_sync(kFull, l[j][c], off);
  // every warp's partial straight into the inbox of the block that owns
  // the row (row r: block r % cl), then one cluster barrier, and each
  // block combines its own rows from its own shared memory (with no
  // cluster, the block's own inbox and a block barrier)
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rpo = (Rb + cl - 1) / cl, src = rank * KW + ks;
  float* inbox = reinterpret_cast<float*>(smem + L::INBOX(p.tab));
  if (clustered) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    if (rt[j] >= NT) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = 8 * rt[j] + 2 * (lane % 4) + c;
      if (r >= Rb) continue;
      float* dst =
          (clustered ? cluster.map_shared_rank(inbox, r % cl) : inbox) +
          (src * rpo + r / cl) * (D + 2);
      if (lane < 4) {
        dst[D] = m[j][c];
        dst[D + 1] = l[j][c];
      }
#pragma unroll
      for (int md = 0; md < MD; ++md)
#pragma unroll
        for (int dh = 0; dh < 2; ++dh)
          dst[16 * md + lane / 4 + 8 * dh] = acc[md][j][2 * dh + c];
    }
  }
  if (clustered)
    cluster.sync();
  else
    __syncthreads();
  const int ns = cl * KW, pstride = rpo * (D + 2);
  for (int e = tid; e < rpo * D; e += kThreads) {
    const int lr = e / D, d = e % D, r = rank + cl * lr;
    if (r >= Rb) break;
    const float* in = inbox + lr * (D + 2);
    float M = kNegInf, Ls = 0.f, A = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < ns; ++sp) M = fmaxf(M, in[sp * pstride + D]);
#pragma unroll 8
    for (int sp = 0; sp < ns; ++sp) {
      const float* part = in + sp * pstride;
      const float w = ex2(part[D] - M);
      Ls = fmaf(part[D + 1], w, Ls);
      A = fmaf(part[d], w, A);
    }
    store(o + q_row(r) * D + d, Ls == 0.f ? 0.f : A / Ls);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Call {
  const void *q, *kp, *vp, *ks, *vs;
  void* o;
  const void *table, *clen;
  int B, K1, Hq, Hkv, D, page, MP, q_dtype, kv_dtype, window;
  float softcap, sm_scale;
  cudaStream_t stream;
};

// table entries a block's keys can span: at most `keys` in a row
inline int table_slice(int MP, int keys, int page) {
  const int n = keys / page + 2;
  return n < MP ? n : MP;
}

// The cluster: as many blocks a (sequence, KV head, row group), up to 16,
// as keep the grid within one block an SM, and twice that (two an SM) when
// a block would still walk 4096 or more (row, key) pairs over the longest
// key range a sequence can have (the lengths are on the card).  Measured
// at every size 1-16 in turns (`PERF.md` §6; H100 80GB HBM3 at 700 W,
// ms): paged decode at 32 groups over 1024 keys 4: 0.0118 against
// 8: 0.0122, over 4096 keys 8: 0.0217 against 4: 0.0262; verify at K1 5
// (40 rows) 8: 0.0154 against 4: 0.0170; dense decode at the draft's 32
// groups 4: 0.0107 against 8: 0.0114, at zamba2's 256 groups of one row 1:
// 0.0137 against 2: 0.0156; at 4 groups (B 1) verify 16: 0.0120 against
// 8: 0.0131.
inline int cluster_size(int groups, int rows, int keys) {
  int cl = 16;
  while (cl > 1 && groups * cl > 132) cl /= 2;
  if (cl < 16 && rows * (keys / cl) >= 4096) cl *= 2;
  return cl;
}

template <typename Kind, typename TC, typename TKV, int D, int NTW, int KW>
cudaError_t launch(const Call& c, Params p) {
  constexpr int QR = kRows<NTW, KW>;
  using L = Layout<TC, TKV, D, QR>;
  p.RG = (p.R + QR - 1) / QR;
  const int rows = p.R < QR ? p.R : QR;
  const int cl = cluster_size(c.B * c.Hkv * p.RG, rows, c.MP * c.page);
  const int share = ((c.MP * c.page + cl - 1) / cl + 15) / 16 * 16;
  p.tab = Kind::kDense ? 0 : table_slice(c.MP, share, c.page);
  const size_t smem = L::bytes(p.tab, cl * KW, (rows + cl - 1) / cl);
  auto kernel = paged_attention_kernel<Kind, TC, TKV, D, NTW, KW>;
  cudaError_t err = flash::set_smem(kernel, smem);
  if (err == cudaSuccess && cl > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, c.Hkv * p.RG, c.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = c.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How a block's warps share its rows: up to 8 rows one row tile a warp and
// the keys split 4 ways; more rows two tiles a warp, the keys split 4, 2 or
// 1 ways so that the 4 warps cover every row tile (fp32: only the last).
// At D 192 and 256 a warp takes one row tile (its accumulators are D/4
// floats a thread, and two tiles' would spill): the keys split 4 ways up
// to 8 rows (bf16), 2 up to 16, else 1 way over row groups of 32.  An
// fp32 tile of 32 keys splits at most 2 ways.
template <typename Kind, typename TC, typename TKV, int D>
cudaError_t by_rows(const Call& c, const Params& p) {
  if constexpr (D > 128) {
    if constexpr (sizeof(TC) == 2)
      if (p.R <= 8) return launch<Kind, TC, TKV, D, 1, 4>(c, p);
    if (p.R <= 16) return launch<Kind, TC, TKV, D, 1, 2>(c, p);
    return launch<Kind, TC, TKV, D, 1, 1>(c, p);
  } else {
    if (p.R <= 8) return launch<Kind, TC, TKV, D, 1, 4>(c, p);
    if constexpr (sizeof(TC) == 2) {
      if (p.R <= 16) return launch<Kind, TC, TKV, D, 2, 4>(c, p);
      if (p.R <= 32) return launch<Kind, TC, TKV, D, 2, 2>(c, p);
    }
    return launch<Kind, TC, TKV, D, 2, 1>(c, p);
  }
}

template <typename Kind, typename TC, int D>
cudaError_t by_kv(const Call& c, const Params& p) {
  if (c.kv_dtype == 0) return by_rows<Kind, TC, TC, D>(c, p);
  if constexpr (!Kind::kDense)     // a dense cache is in the q dtype
    if (c.kv_dtype == 2) return by_rows<Kind, TC, int8_t, D>(c, p);
  return cudaErrorInvalidValue;
}

template <typename Kind, typename TC>
cudaError_t by_dim(const Call& c, const Params& p) {
  switch (c.D) {
    case 32: return by_kv<Kind, TC, 32>(c, p);
    case 64: return by_kv<Kind, TC, 64>(c, p);
    case 128: return by_kv<Kind, TC, 128>(c, p);
    case 192: return by_kv<Kind, TC, 192>(c, p);
    case 256: return by_kv<Kind, TC, 256>(c, p);
    default: return cudaErrorInvalidValue;
  }
}

// Checks a call, fills the kernel's parameters and launches it.
template <typename Kind>
int run(const Call& c) {
  if (c.Hkv <= 0 || c.Hq % c.Hkv != 0 || c.page <= 0 || c.MP <= 0 ||
      c.K1 < 1)
    return (int)cudaErrorInvalidValue;
  if (c.kv_dtype == 2 && (c.ks == nullptr || c.vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (c.B == 0) return (int)cudaSuccess;
  Params p{};
  p.q = c.q;
  p.kp = c.kp;
  p.vp = c.vp;
  p.ks = static_cast<const float*>(c.ks);
  p.vs = static_cast<const float*>(c.vs);
  p.o = c.o;
  p.table = static_cast<const int*>(c.table);
  p.clen = static_cast<const int*>(c.clen);
  p.K1 = c.K1;
  p.Hq = c.Hq;
  p.Hkv = c.Hkv;
  p.G = c.Hq / c.Hkv;
  p.R = c.K1 * p.G;      // row groups: by the block's rows, at launch
  p.page = c.page;
  p.MP = c.MP;
  p.window = c.window;
  p.softcap = c.softcap;
  p.sm_scale = c.sm_scale;
  cudaError_t err = c.q_dtype == 0   ? by_dim<Kind, float>(c, p)
                    : c.q_dtype == 1 ? by_dim<Kind, bf16>(c, p)
                                     : cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace
}  // namespace paged
