// Flash attention forward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma), fp32 on the CUDA cores.
//
// Replaces the TPU kernel `src/repro/kernels/flash_attention.py:
// flash_attention` (`_kernel`, launched at :142).  Same function: q
// [B,Tq,Hq,D] against k [B,Tk,Hkv,D] and v [B,Tk,Hkv,D] over GQA heads,
// explicit int32 query and key positions, the masks `kp <= qp` (causal),
// `qp - kp < window` and `kp < kv_valid_len`, the logit softcap
// `tanh(s/c)*c` after scaling, an f32 accumulator, an output of 0 for a
// row with no kept key, and the optional f32 log-sum-exp (natural log,
// `NEG_INF + log 1` for such a row, which the backward's select relies
// on).  Output in the input dtype; ragged edges are bounds masks, not the
// JAX wrapper's sentinel padding (`flash_attention.py:112-122`).
//
// What bounds it on an H100:
//  - At the train step's shape (B 8, T 1024, Hq 32, Hkv 4, D 64, bf16,
//    causal) the mask keeps 134.3 M (query, key) pairs; two products of
//    2·64 FLOP on each make 34.4 GFLOP, 0.035 ms at the 989 TFLOP/s of
//    the bf16 tensor cores, against about 77 MB of q, k, v, o and lse,
//    0.023 ms at 3.35 TB/s: bound by operations.
//  - At the serving path's shape (a 64-token prefill chunk of tinyllama,
//    B 1, G 8, over a gathered span of at most 1024 keys) the work is a
//    few hundred MFLOP over about a MB, under a microsecond either way:
//    what bounds it is latency.  32 blocks of 64 rows for 132 SMs, each
//    walking its key tiles one after the other.
//
// What the design does about it (bf16):
//  - Tensor cores.  One warpgroup of 128 threads a block and 64 query
//    rows, as the backward's dq kernel: s = q·kᵀ is a `wgmma` m64n64k16
//    with both operands from 128-byte swizzled shared memory (64-byte at
//    D 32) into f32 accumulators, and o += p·v a m64nDk16 with p packed to
//    bf16 straight from those accumulators as the A operand and the V
//    tile as an MN-major B: p never touches shared memory.  The scale
//    multiplies the f32 sum, never the bf16 operand, so the logits `lse`
//    describes are the ones the backward recomputes.
//  - Online softmax in registers.  Each thread holds two rows' worth of
//    the accumulator map; a row's max is reduced over the 4 lanes that
//    hold it, its sum stays per lane until the end, p is one FMA and one
//    `ex2.approx` from the raw logit, and o and the sums are rescaled only
//    when a row's max grows by more than 2^8 (a warp vote), which after
//    the first tiles is rare.  Masked logits are -inf against a finite
//    running max, so they give exact zeros; softcap and mask code run
//    only in the tiles that need them.
//  - Tile skipping from the positions themselves.  Before its loop a
//    block reduces the least and largest position of its live rows and of
//    every 64-key tile (one `redux.sync` each, `plan_key_tiles` of
//    flash_common.cuh) and classes each tile:
//    skipped when no pair can be kept, computed without the per-element
//    mask when every pair is kept and the tile has no ragged edge, else
//    masked.  No host sync, and nothing assumes that positions are
//    indices: the train step's forward (explicit positions) skips the
//    empty half of the causal triangle.  With index positions (a serving
//    chunk) the bounds are the tile's ends, and no key at or past the
//    valid length is read.
//  - K and V shared across the G heads.  A block's rows are 64/G positions
//    times the G heads of one KV head (GB = min(G, 64) heads, more split
//    over head groups), so each K/V tile in shared memory serves every
//    head that reads it.
//  - Copies.  K and V tiles arrive by 16-byte `cp.async` into a two-stage
//    ring, the next tile in flight while the current one is computed, each
//    thread's addresses in the swizzled tile worked out once; rows outside
//    the tensor are zero-filled, never read, and a full tile loads no key
//    positions.  The blocks that have the most tiles under a causal mask
//    (the last query tiles) launch first.
// What holds it back now: latency.  Each tile is a chain (the copies'
// wait and a barrier, q·kᵀ, the softmax, p·v, a barrier) in which the
// softmax takes the most time, and four blocks an SM (103 registers a
// thread at D 64) do not hide it; at the train shape a block has 8.5
// tiles on average, so its planning before the first one weighs too.
// Measured and not kept: three and four ring stages, the next tile's
// q·kᵀ under this tile's softmax, two warpgroups a block sharing K and V,
// and five blocks an SM (registers spill).  Left for later: a producer
// warp with TMA, a persistent grid, and a split of the key range over
// several blocks with a combine pass for short chunks.
//
// fp32 stays on the CUDA cores: a bf16 or TF32 product would miss the
// 2e-5 tolerance of the fp32 checks and the golden training replay.  That
// kernel (32 query rows and 32-key tiles, 16-byte loads into registers
// one tile ahead, K stored transposed so the lanes hit 32 banks) classes
// its tiles the same way and skips the ones that hold no kept pair.

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
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block

// q, K transposed and V tiles, the key and row positions, a class byte a
// 32-key tile
template <int D>
size_t smem_bytes(int n_tiles) {
  return sizeof(float) * (kRows * D + 2 * kBK * D) +
         sizeof(int) * (kBK + kRows) + n_tiles;
}

// One block per (32-row query tile, KV head [, head group], batch); its
// rows are `32/GB` positions times GB heads of one KV head.  In a tile
// each lane owns one key for the logits of its warp's 4 rows and D/32
// output columns for p·v, where each V value read serves all 4 rows and
// the probabilities pass by shuffles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos,
                 const int* __restrict__ valid_len, int Tq, int Tk, int Hq,
                 int Hkv, int G, int GB, int tq_per_block, int causal,
                 int window, float softcap, float sm_scale) {
  constexpr int C = D / 32;             // output columns per lane
  constexpr int RW = kRowsPerWarp;
  constexpr int VEC = 4;                // elements per 16-byte load
  constexpr int RV = D / VEC;           // loads per key row
  constexpr int TV = kBK * RV;          // loads per tile (K or V)
  constexpr int NV = (TV + kThreads - 1) / kThreads;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kRows][D], pre-scaled
  float* kT_s = q_s + kRows * D;              // [D][kBK], K transposed
  float* v_s = kT_s + kBK * D;                // [kBK][D]
  int* kp_s = reinterpret_cast<int*>(v_s + kBK * D);   // [kBK]
  int* qp_s = kp_s + kBK;                     // [kRows]
  uint8_t* cls = reinterpret_cast<uint8_t*>(qp_s + kRows);   // [n_tiles]

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
      x = q[(((size_t)b * Tq + t0 + r / GB) * Hq + h * G + row_head(r)) * D +
            d] * sm_scale;
    q_s[i] = x;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    qp_s[r] = row_live(r) ? q_pos[(size_t)b * Tq + t0 + r / GB] : -1;
  __syncthreads();

  // Index positions stop at the valid length; then plan the key tiles.
  const Masks mk{causal, window, valid_len ? valid_len[b] : -1};
  const int n_keys = kv_pos || !valid_len ? Tk : max(0, min(Tk, mk.vlen));
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  int qmin, qmax;
  bool rows_whole;
  live_bounds(kRows, row_live, [&](int r) { return qp_s[r]; }, qmin, qmax,
              rows_whole);
  plan_key_tiles<kBK, kThreads>(cls, n_keys,
                                kv_pos ? kv_pos + (size_t)b * Tk : nullptr,
                                qmin, qmax, rows_whole, mk);
  __syncthreads();

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
        kT_s[(kc + e) * kBK + kj] = elem<float>(kreg[n], e);
        v_s[vj * D + vc + e] = elem<float>(vreg[n], e);
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

  int n = next_live_tile(cls, n_tiles, 0);
  if (n < n_tiles) fetch(n * kBK);
  while (n < n_tiles) {
    __syncthreads();                          // previous tile consumed
    stash();
    __syncthreads();
    const int next = next_live_tile(cls, n_tiles, n + 1);
    if (next < n_tiles) fetch(next * kBK);    // in flight during compute

    const bool full = cls[n] == kTileFull;
    const bool in_range = n * kBK + lane < n_keys;
    const int kp = kp_s[lane];
    float s[RW];
    bool ok[RW];
    qk_tile<D, RW>(q_s + warp * RW * D, kT_s, s);
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      s[rr] = softcap_logit(s[rr], softcap);
      ok[rr] = full || (in_range && mk.ok(qp_s[warp * RW + rr], kp));
    }
    softmax_pv_tile<D, RW, false>(s, ok, 1.f, v_s, m, l, acc);
    n = next;
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
      o[row * D + c * 32 + lane] = empty ? 0.f : acc[rr][c] / l[rr];
    if (lse != nullptr && lane == 0)
      lse[row] = m[rr] + logf(empty ? 1.f : l[rr]);
  }
}

}  // namespace
}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

namespace wg {
namespace {

// The q tile, then K and V of two stages, from a 1024-byte aligned base;
// 2 x 64 key positions and a class byte a key tile.
template <int D>
size_t smem_bytes(int n_tiles) {
  return 1024 + 5 * Tile<D>::BYTES + 2 * kT * sizeof(int) + n_tiles;
}

// One online-softmax step over a 64-key tile in the accumulator map.  The
// logit of element e in log2 units is u·f: u = s and f = scale·log2e, or
// with a softcap u = tanh(s·scale/c)·c and f = log2e.  The running max `m`
// is kept in u (f > 0 keeps the order), so p = 2^(u·f − m·f) is one FMA and
// one `ex2.approx`, and `s` becomes p in place.  `m` moves only when a
// row's tile max passes it by more than 8 in log2 units, so p <= 2^8, which
// the f32 sums and the bf16 p hold without loss of range; then, once a
// vote finds such a row in the warp, `l` (this lane's part of the running
// sum) and `o` are rescaled.  Any m that bounds the logits to within 2^8
// gives the same o / l and lse = m·f / log2e + ln l.  `ok(i, col)` says
// whether the masks keep the pair of element (acc_row(i), col) (read only
// when MASKED); a dropped pair has u = -inf, whose p is exactly 0.
template <bool MASKED, bool CAPPED, int N, typename Ok>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&o)[N],
                                             float (&m)[2], float (&l)[2],
                                             float f, float scale,
                                             float softcap, Ok ok) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        float u = CAPPED ? tanhf(s[e] * scale / softcap) * softcap : s[e];
        if (MASKED && !ok(i, acc_col(j, c))) u = -INFINITY;
        s[e] = u;
        mx[i] = fmaxf(mx[i], u);
      }
  bool need = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the 4 lanes of a quad hold one row
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    need |= (mx[i] - m[i]) * f > 8.f;
  }
  if (__any_sync(kFull, need)) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      const float corr = ex2((m[i] - m_new) * f);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) o[4 * j + 2 * i + c] *= corr;
    }
  }
  // finite for a row with no kept key yet (m = NEG_INF), so that a
  // dropped pair's FMA is -inf, never NaN
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
        const float p = ex2(fmaf(s[e], f, -mf[i]));
        s[e] = p;
        l[i] += p;
      }
}

// One block per (64-row query tile, KV head [, head group], batch), the
// last query tile first (under a causal mask it has the most keys); rows
// `r` are position t0 + r / GB of head h·G + hg·GB + r % GB.  q is loaded
// once; the block loops over the 64-key tiles it does not skip.
template <int D>
__global__ void __launch_bounds__(kWG)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos,
                       const int* __restrict__ valid_len, int Tq, int Tk,
                       int Hq, int Hkv, int G, Div gb, int tq_per_block,
                       int causal, int window, float softcap,
                       float sm_scale) {
  using L = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t q_s = smem_u32(sm);
  auto k_s = [&](int st) { return q_s + (1 + 2 * st) * L::BYTES; };
  auto v_s = [&](int st) { return k_s(st) + L::BYTES; };
  int* kp_s = reinterpret_cast<int*>(sm + 5 * L::BYTES);     // [2][64]
  uint8_t* cls = sm + 5 * L::BYTES + 2 * kT * sizeof(int);   // [n_tiles]

  const int b = blockIdx.z;
  const int h = blockIdx.y % Hkv, hg = blockIdx.y / Hkv;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * tq_per_block;
  const int nrows = tq_per_block * gb.d;
  const Masks mk{causal, window, valid_len ? valid_len[b] : -1};
  // index positions stop at the valid length
  const int n_keys = kv_pos || !valid_len ? Tk : max(0, min(Tk, mk.vlen));
  const int n_tiles = (n_keys + kT - 1) / kT;

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
  cp_commit();

  // this thread's two accumulator rows
  int qp_r[2];
  bool live_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    live_r[i] = row_live(acc_row(i));
    qp_r[i] = live_r[i] ? row_pos(acc_row(i)) : 0;
  }

  int qmin, qmax;
  bool rows_whole;
  live_bounds(kT, row_live, row_pos, qmin, qmax, rows_whole);
  plan_key_tiles<kT, kWG>(cls, n_keys,
                          kv_pos ? kv_pos + (size_t)b * Tk : nullptr, qmin,
                          qmax, rows_whole, mk);

  // This thread's 16-byte chunks of a K or V tile: rows r0 + it·RS, its
  // column c0, and their places in the swizzled tile, the same for every
  // tile.
  constexpr int CPR = D / 8, RS = kWG / CPR, NC = kT / RS;
  const int r0 = threadIdx.x / CPR, c0 = (threadIdx.x % CPR) * 8;
  uint32_t dst[NC];
#pragma unroll
  for (int it = 0; it < NC; ++it) dst[it] = L::offset(r0 + it * RS, c0);
  const size_t kv0 = ((size_t)b * Tk * Hkv + h) * D + c0;
  const int stride = Hkv * D;
  auto load_keys = [&](int n, int st) {
    const int k0 = n * kT;
#pragma unroll
    for (int it = 0; it < NC; ++it) {
      const int j = k0 + r0 + it * RS;
      const bool in = j < n_keys;
      const size_t off = kv0 + (size_t)(in ? j : 0) * stride;
      cp_async16(k_s(st) + dst[it], k + off, in);
      cp_async16(v_s(st) + dst[it], v + off, in);
    }
    if (threadIdx.x < kT) {
      const int j = k0 + threadIdx.x;
      int* kp = kp_s + st * kT + threadIdx.x;
      if (!kv_pos)
        *kp = j;
      else if (cls[n] != kTileFull)      // a full tile reads no position
        cp_async4(smem_u32(kp), kv_pos + (size_t)b * Tk + min(j, Tk - 1),
                  j < n_keys);
    }
  };

  // p = 2^(u·f − m·f): u = s and f = scale·log2e, or with a softcap the
  // capped logit and f = log2e; lse = m·f / log2e + ln l
  const float f = softcap > 0.f ? kLog2e : sm_scale * kLog2e;
  const float m_scale = softcap > 0.f ? 1.f : sm_scale;
  float acc[D / 2], s[32];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  __syncthreads();                              // the classes are written
  Ring ring(cls, n_tiles, load_keys);
  while (ring.more()) {
    const int st = ring.wait(load_keys), n = ring.n;   // q is in too

    // s = q·kᵀ, [64 rows, 64 keys]
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(s, L::kmajor(q_s, ks), L::kmajor(k_s(st), ks), ks > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    const int k0 = n * kT;
    const int* kp = kp_s + st * kT;
    auto ok = [&](int i, int col) {
      return live_r[i] && k0 + col < n_keys && mk.ok(qp_r[i], kp[col]);
    };
    const bool full = cls[n] == kTileFull;
    if (softcap > 0.f) {
      if (full)
        softmax_tile<false, true>(s, acc, m, l, f, sm_scale, softcap, ok);
      else
        softmax_tile<true, true>(s, acc, m, l, f, sm_scale, softcap, ok);
    } else {
      if (full)
        softmax_tile<false, false>(s, acc, m, l, f, sm_scale, softcap,
                                   ok);
      else
        softmax_tile<true, false>(s, acc, m, l, f, sm_scale, softcap, ok);
    }
    uint32_t a[4][4];
    to_a(s, a);

    // o += p·v: v's 64 rows are the reduction
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs(acc, a[ks], L::mnmajor(v_s(st), ks));
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(a);
    ring.next();
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live_r[i]) continue;
    const size_t row = row_index(acc_row(i));
    const bool empty = l[i] == 0.f;             // no kept key: exact zeros
    const float inv = empty ? 0.f : 1.f / l[i];
    bf16* out = o + row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + acc_col(j, 0)) =
          pack_bf16(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    if (lse != nullptr && threadIdx.x % 4 == 0)
      lse[row] = empty ? kNegInf : m[i] * m_scale + logf(l[i]);
  }
}

}  // namespace
}  // namespace wg

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

namespace {

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  const void *q_pos, *kv_pos, *valid_len;
  int B, Tq, Tk, Hq, Hkv, causal, window;
  float softcap, sm_scale;
  cudaStream_t stream;
};

#define FWD_ARGS(T)                                                        \
  static_cast<const T*>(a.q), static_cast<const T*>(a.k),                  \
      static_cast<const T*>(a.v), static_cast<T*>(a.o),                    \
      static_cast<float*>(a.lse), static_cast<const int*>(a.q_pos),        \
      static_cast<const int*>(a.kv_pos),                                   \
      static_cast<const int*>(a.valid_len), a.Tq, a.Tk, a.Hq, a.Hkv

template <int D>
cudaError_t launch_f32(const Args& a) {
  const RowMap m(a.Hq, a.Hkv, f32::kRows);
  const size_t smem = f32::smem_bytes<D>((a.Tk + kBK - 1) / kBK);
  cudaError_t err = set_smem(f32::flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  f32::flash_fwd_kernel<D>
      <<<m.grid(a.B, a.Tq, a.Hkv), f32::kThreads, smem, a.stream>>>(
          FWD_ARGS(float), m.G, m.GB, m.tq_per_block, a.causal, a.window,
          a.softcap, a.sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  const RowMap m(a.Hq, a.Hkv, wg::kT);
  const size_t smem = wg::smem_bytes<D>((a.Tk + wg::kT - 1) / wg::kT);
  cudaError_t err = set_smem(wg::flash_fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  wg::flash_fwd_wgmma_kernel<D>
      <<<m.grid(a.B, a.Tq, a.Hkv), wg::kWG, smem, a.stream>>>(
          FWD_ARGS(bf16), m.G, divisor(m.GB), m.tq_per_block, a.causal,
          a.window, a.softcap, a.sm_scale);
  return cudaGetLastError();
}

#undef FWD_ARGS

// bf16 takes the tensor-core kernel, fp32 the CUDA-core one
template <int D>
cudaError_t launch(const Args& a, int dtype) {
  switch (dtype) {
    case 0: return launch_f32<D>(a);
    case 1: return launch_bf16<D>(a);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Args& a, int D, int dtype) {
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Tq == 0) return (int)cudaSuccess;
  switch (D) {
    case 32: return (int)launch<32>(a, dtype);
    case 64: return (int)launch<64>(a, dtype);
    case 128: return (int)launch<128>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace flash

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
  const flash::Args a{q, k, v, o, lse, q_pos, kv_pos, valid_len, B, Tq, Tk,
                      Hq, Hkv, causal, window, softcap, sm_scale,
                      static_cast<cudaStream_t>(stream)};
  return flash::run(a, D, dtype);
}
