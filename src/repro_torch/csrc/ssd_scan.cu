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
// where S [P, N] is the f32 state entering the chunk.  x, B and C are bf16
// or f32, dt and A f32; y is in x's dtype, the optional initial state and
// the final state [B, H, P, N] are f32.  Head h reads group
// h / (H/G) of B and C (`ssd_scan.py:113`).
//
// What bounds it on an H100: bytes.  A 64-token prefill chunk of
// mamba2-2.7b (80 heads, P 64, N 128) moves about 6.6 MB, of which the
// f32 state in and out is 5.2 MB: 2 µs at 3.35 TB/s.  The 0.23 GFLOP of
// products its data needs would take the tensor cores 0.24 µs.
// What holds it back now: latency.  A block's life is a chain: its copies
// land (the first tile's C and B are read by all 320 blocks), then the
// cumsum, four short dependent products and the stores; the warp whose
// rows end the diagonal tile does the most of C·Bᵀ and G·X.  PERF.md has
// its time beside the floor that event timing puts under any launch.
//
// Design.  The TPU kernel's sequential chunk axis (grid (B·H, nC),
// `ssd_scan.py:111`) becomes a loop inside one block, and the head dim P
// is cut into slices of PB = 16: one block per (P-slice, head,
// sequence), holding only its [PB, N] slice of the f32 state in shared
// memory, in the global [P][N] layout (no transpose), across chunks.  A
// batch-1 mamba2 chunk runs 320 blocks (slices of 32, 160 blocks, were
// slower there: PERF.md).
// Within a chunk, tiles of 64 query rows loop over the 64-row key tiles
// at or below them.  L is selected before the exponent
// (`j <= i ? exp(cum_i − cum_j) : 0`), so the overflow above the diagonal
// never meets a 0.  The JAX wrapper pads the tail with dt = 0 and x = 0
// (`ssd_scan.py:92-100`); here the loops stop at the last valid row of
// the chunk, which gives the same kept rows and the same final state
// (cum_last is the cum of the last valid row, which padding would repeat).
//
// bf16 (`ssd_scan_tc_kernel`, 4 warps, each 16 query rows of a tile),
// `mma.sync` on the tensor cores with f32 accumulators:
//   - copies: the blocks of a cluster (the P/PB slices of two heads of one
//     group, 8 blocks for mamba2) share C and B, so each block loads an
//     eighth of their rows by bulk copies multicast to all (the TMA engine,
//     an mbarrier a block); the state slice comes by bulk copies issued
//     first, x straight into registers, dt by 4-byte cp.async;
//   - each warp scans the chunk's dt·A itself with shuffles, into its own
//     copy of the cum, so no block barrier waits on the scan;
//   - G = C·Bᵀ from C and B as they arrive (exact bf16 products, m16n8k16)
//     runs first, the scan and dt·x under its latency; G is masked and
//     decayed in its registers and is the A operand of G·(dt·x) as it
//     lies (the accumulator and A fragments share their map); the warps of
//     the diagonal tile skip the key columns after their rows;
//   - dt·x is rounded to bf16 once a tile, and on the diagonal tile
//     dt·exp(cum_last − cum)·x too: the state update S += (that)ᵀ·B has
//     M = PB, one or two m16 tiles, and runs while the key tile is in
//     shared memory (each key tile is diagonal once), with B exact;
//   - C·Sᵀ keeps the state's precision: S is split into bf16 hi + lo
//     (S − hi), two products (TF32, cp.async copies, bulk copies without
//     the multicast and C·Bᵀ shared over a cluster were measured against
//     this design and lost: PERF.md);
//   - the state's decay and the new state are f32 FMAs in the
//     accumulators' registers, stored as [P][N] rows (8 bytes a lane).
// Shared rows are padded by 16 bytes (32 for the f32 state), so ldmatrix,
// the paired loads and the copies meet no bank conflict.
// fp32 (`ssd_scan_f32_kernel`, 8 warps): the same slices and layout, with
// f32 FMAs from shared memory (no TF32: the 2e-5 tolerance and the fp32
// golden streams need f32 products) and the cum in row order
// (`cumsum_in_order` says why).

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::wg::cp_async4;
using flash::wg::cp_commit;
using flash::wg::cp_wait;
using flash::wg::pack_bf16;
using flash::wg::smem_u32;

constexpr int kRows = 64;               // query rows and key rows per tile
constexpr int PB = 16;                  // the P-slice of a block

// The inclusive cumsum of dt·A over a chunk's rows, from sDt into sCum,
// by one thread in row order with the products rounded first, as the
// plain version's cumsum adds them.  exp(cum_i − cum_j) of two cums near
// −600 amplifies their last bits, so in f32 only the same order holds
// 2e-5 (a parallel scan's order missed it at 511 tokens).  The
// caller syncs before (sDt written) and after.
__device__ __forceinline__ void cumsum_in_order(const float* sDt, float* sCum,
                                                int rows, float a) {
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int i = 0; i < rows; ++i) {
      c += __fmul_rn(sDt[i], a);
      sCum[i] = c;
    }
  }
}

// The same cumsum by one warp, 32 rows a step with a shuffle scan and a
// carry, into this warp's own copy (every warp scans, so no block barrier
// is needed before a warp reads it).  bf16 only: the order differs.
__device__ __forceinline__ void warp_cumsum(const float* sDt, float* sCum,
                                            int rows, float a) {
  const int lane = threadIdx.x % 32;
  float carry = 0.f;
  for (int r0 = 0; r0 < rows; r0 += 32) {
    const int i = r0 + lane;
    float v = i < rows ? sDt[i] * a : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(attn::kFull, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (i < rows) sCum[i] = v;
    carry = __shfl_sync(attn::kFull, v, 31);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

// d += a·b, m16n8k16, bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; `.trans` delivers each one transposed.
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
__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// every thread of every block of the cluster, shared memory included
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// mbarriers and bulk copies (the TMA engine, no tensor map): `bytes` from
// global memory to this block's shared memory, or with the multicast to
// the same offset in every block of `mask`, completing on the barrier at
// the same offset in each
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar),
      "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void bulk_copy_mc(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar,
                                             uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Byte offsets of the bf16 kernel's shared memory.  Rows are padded by
// 16 bytes (32 for the f32 state): the 8 rows an ldmatrix reads, or the
// lanes of a paired load, then start in different 4-bank groups.
template <int N>
struct TcSmem {
  static constexpr int CS = N + 8;          // bf16 stride: C, B, S hi/lo
  static constexpr int XS = PB + 8;         // bf16 stride: dt·x tiles
  static constexpr int SS = N + 8;          // f32 stride: the state
  static constexpr uint32_t C = 0;
  static constexpr uint32_t B = C + kRows * CS * 2;
  static constexpr uint32_t X = B + kRows * CS * 2;
  static constexpr uint32_t XD = X + kRows * XS * 2;
  static constexpr uint32_t S = XD + kRows * XS * 2;
  static constexpr uint32_t SH = S + PB * SS * 4;
  static constexpr uint32_t SL = SH + PB * CS * 2;
  static constexpr uint32_t BAR = SL + PB * CS * 2;
  static constexpr uint32_t DT = BAR + 16;             // two mbarriers
  // then each warp's copy of the chunk's dt and of its cum
  static size_t bytes(int Q) { return DT + 8 * (size_t)Q * 4; }
};

// One block per (P-slice, head, sequence), 4 warps; three blocks an SM,
// as the launch bounds tell ptxas, so it keeps the accumulators in
// registers (left to itself it capped some instances at 128 and
// spilled).  A cluster holds the P/PB slices of one or two heads of one
// group, whose C and B rows (the same for all of them) each block loads a
// share of by bulk copies multicast to all; the state slice comes by bulk
// copies of its own.
template <int N>
__global__ void __launch_bounds__(128, 3) ssd_scan_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ s0,
    bf16* __restrict__ y, float* __restrict__ s_fin, int L, int H, int G,
    int P, int Q) {
  using SM = TcSmem<N>;
  constexpr int CS = SM::CS, XS = SM::XS, SS = SM::SS;
  constexpr int NT = N / 8;                  // n-tiles of the state
  constexpr int NTW = NT >= 4 ? NT / 4 : 1;  // a warp's n-tiles of it
  constexpr int MT = PB / 16;                // m-tiles of the state
  constexpr int PT = PB / 8;                 // n-tiles of y
  static_assert(N % 16 == 0, "N: a multiple of 16");
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  float* sS = reinterpret_cast<float*>(smem + SM::S);
  bf16* sSh = reinterpret_cast<bf16*>(smem + SM::SH);
  bf16* sSl = reinterpret_cast<bf16*>(smem + SM::SL);
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  float* sDt = reinterpret_cast<float*>(smem + SM::DT) + 2 * w * Q;
  float* sCum = sDt + Q;                   // this warp's copies
  const float a = A[h];
  // element offsets of (b, t, h, p0) in x/y and of (b, t, g, 0) in B/C
  auto xrow = [&](int t) {
    return (((size_t)b * L + t) * H + h) * P + p0;
  };
  auto brow = [&](int t) {
    return (((size_t)b * L + t) * G + g) * N;
  };
  const size_t sbase = (((size_t)b * H + h) * P + p0) * N;  // [PB][N]

  if (L == 0) {                            // no token: the state as it came
    for (int i = tid; i < PB * N; i += 128)
      s_fin[sbase + i] = s0 != nullptr ? s0[sbase + i] : 0.f;
    return;
  }
  if (s0 == nullptr) {                     // a zero state, never read
    for (int i = tid; i < PB * SS; i += 128) sS[i] = 0.f;
  }
  const uint32_t bar_t = base + SM::BAR, bar_s = bar_t + 8;
  uint32_t crank, csize, phase = 0;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(crank));
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(csize));
  if (tid == 0) {
    mbar_init(bar_t);
    mbar_init(bar_s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the barriers ready in every block before the first multicast lands
  // (the matching wait is at the first tile).  Relaxed: the fence above
  // orders the inits, and a release would wait for this thread's loads
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (s0 != nullptr && w == 1) {           // the state first: it comes
    if (lane == 0) mbar_expect(bar_s, PB * N * 4);     // from memory
    __syncwarp();
    for (int p = lane; p < PB; p += 32)
      bulk_copy(base + SM::S + p * SS * 4, s0 + sbase + p * N, N * 4, bar_s);
  }

  bool state_pending = s0 != nullptr;     // the state's copy not waited for
  bool have_state = s0 != nullptr;        // S may be nonzero
  bool first = true;
  for (int c0 = 0; c0 < L; c0 += Q) {
    const int rows = min(Q, L - c0);
    const bool last_chunk = c0 + Q >= L;
    float cum_last = 0.f;
    float upd[MT][NTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) upd[m][j][e] = 0.f;

    for (int q0 = 0; q0 < rows; q0 += kRows) {
      float accy[PT][4];
#pragma unroll
      for (int n = 0; n < PT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) accy[n][e] = 0.f;

      for (int j0 = 0; j0 <= q0; j0 += kRows) {
        const bool diag = j0 == q0;
        // this tile's x slice straight into registers: 8 values a thread,
        // row r = i / (PB / 8), zero past `rows`
        uint4 xv[PB / 16];
#pragma unroll
        for (int k = 0; k < PB / 16; ++k) {
          const int i = tid + k * 128, r = i / (PB / 8);
          xv[k] = j0 + r < rows ? attn::load16(x + xrow(c0 + j0 + r) +
                                               i % (PB / 8) * 8)
                                : make_uint4(0, 0, 0, 0);
        }
        // this warp's copy of the chunk's dt (last read before the last
        // tile's barrier)
        if (j0 == 0 && q0 == 0)
          for (int t = lane; t < rows; t += 32)
            cp_async4(smem_u32(sDt + t),
                      dt + ((size_t)b * L + c0 + t) * H + h, true);
        if (first) {
          asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
        } else {                           // every block of the cluster
          flash::wg::fence_async_smem();   // done with the last tile's C
          cluster_sync();                  // and B
        }
        first = false;
        {
          // thread i < 64 a row of C (at j0 == 0), 64 + i a row of B: the
          // rows of this block's rank in the cluster; B's rows past the
          // last one zeroed here (no copy writes them)
          const int vc = j0 == 0 ? min(kRows, rows - q0) : 0;
          const int vb = min(kRows, rows - j0);
          if (tid == 0) mbar_expect(bar_t, (vc + vb) * N * 2);
          const int r = tid % kRows, t0 = tid < kRows ? q0 : j0;
          if (r % csize == crank && r < (tid < kRows ? vc : vb))
            bulk_copy_mc(base + (tid < kRows ? SM::C : SM::B) + r * CS * 2,
                         (tid < kRows ? Cm : Bm) + brow(c0 + t0 + r), N * 2,
                         bar_t, (uint16_t)((1u << csize) - 1));
          for (int i = tid; i < (kRows - vb) * (N / 8); i += 128) {
            const int r = vb + i / (N / 8), c = i % (N / 8) * 8;
            *reinterpret_cast<uint4*>(smem + SM::B + (r * CS + c) * 2) =
                make_uint4(0, 0, 0, 0);
          }
          cp_commit();
          cp_wait<0>();
          mbar_wait(bar_t, phase);
          phase ^= 1;
        }
        __syncthreads();

        // C·Bᵀ for this warp's 16 query rows, first: the cumsum and dt·x
        // below run under its latency.  All 64 key columns (8 n-tiles);
        // on the diagonal tile none after the warp's last row.
        float accg[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) accg[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks) {
          uint32_t af[4];
          ldsm4(af, base + SM::C +
                        ((16 * w + lane % 16) * CS + ks * 16 + lane / 16 * 8) *
                            2);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            const int nt = 2 * np;         // key columns 8·nt .. 8·nt + 15
            if (diag && nt > 2 * w + 1) continue;
            uint32_t bf[4];
            ldsm4(bf, base + SM::B +
                          ((8 * nt + lane / 16 * 8 + lane % 8) * CS + ks * 16 +
                           (lane / 8) % 2 * 8) *
                              2);
            mma_bf16(accg[2 * np], af, bf[0], bf[1]);
            mma_bf16(accg[2 * np + 1], af, bf[2], bf[3]);
          }
        }
        if (q0 == 0) {
          warp_cumsum(sDt, sCum, rows, a);
          cum_last = sCum[rows - 1];
        }
        // dt·x, and on the diagonal dt·exp(cum_last − cum)·x, in bf16,
        // zero past the last row (padding would carry dt = 0)
#pragma unroll
        for (int k = 0; k < PB / 16; ++k) {
          const int i = tid + k * 128, r = i / (PB / 8), j = j0 + r;
          const int off = r * XS + i % (PB / 8) * 8;
          const float d = j < rows ? sDt[j] : 0.f;
          const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv[k]);
          uint4 o;
          uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = unpack_bf16(xw[e]);
            ow[e] = pack_bf16(d * v.x, d * v.y);
          }
          *reinterpret_cast<uint4*>(smem + SM::X + off * 2) = o;
          if (diag) {
            const float dd = j < rows ? d * __expf(cum_last - sCum[j]) : 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 v = unpack_bf16(xw[e]);
              ow[e] = pack_bf16(dd * v.x, dd * v.y);
            }
            *reinterpret_cast<uint4*>(smem + SM::XD + off * 2) = o;
          }
        }
        // G = (C·Bᵀ) ∘ L: select before the exponent, so rows past `rows`
        // and keys after the row are 0 (cum read at clamped indices, the
        // value unused)
        {
          const int qi0 = q0 + 16 * w + gq, qi1 = qi0 + 8;
          const float cq0 = sCum[min(qi0, rows - 1)];
          const float cq1 = sCum[min(qi1, rows - 1)];
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = e < 2 ? qi0 : qi1;
              const int kj = j0 + 8 * n + 2 * tq + (e & 1);
              const float ck = sCum[min(kj, rows - 1)];
              accg[n][e] = kj <= qi && qi < rows
                               ? accg[n][e] * __expf((e < 2 ? cq0 : cq1) - ck)
                               : 0.f;
            }
        }
        __syncthreads();                   // dt·x of every thread
        // y += G·(dt·x): G as the A operand, from registers, dt·x as B
        // through ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (diag && kk > w) continue;   // keys after this warp's rows
          const uint32_t af[4] = {
              pack_bf16(accg[2 * kk][0], accg[2 * kk][1]),
              pack_bf16(accg[2 * kk][2], accg[2 * kk][3]),
              pack_bf16(accg[2 * kk + 1][0], accg[2 * kk + 1][1]),
              pack_bf16(accg[2 * kk + 1][2], accg[2 * kk + 1][3])};
#pragma unroll
          for (int np = 0; np < PT / 2; ++np) {
            uint32_t bx[4];
            ldsm4t(bx, base + SM::X +
                           ((16 * kk + lane % 16) * XS + 16 * np +
                            lane / 16 * 8) *
                               2);
            mma_bf16(accy[2 * np], af, bx[0], bx[1]);
            mma_bf16(accy[2 * np + 1], af, bx[2], bx[3]);
          }
        }
        // the state update from this key tile, once (on the diagonal):
        // upd[p][n] += Σ_j (dt·decay·x)[j][p] B[j][n], this warp's n-tiles
        if (diag && w * NTW < NT) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t ax[MT][4];
#pragma unroll
            for (int m = 0; m < MT; ++m)
              ldsm4t(ax[m], base + SM::XD +
                                ((16 * kk + lane / 16 * 8 + lane % 8) * XS +
                                 16 * m + (lane / 8) % 2 * 8) *
                                    2);
#pragma unroll
            for (int j = 0; j < NTW; ++j) {
              uint32_t bb[2];
              ldsm2t(bb, base + SM::B +
                             ((16 * kk + lane % 16) * CS + 8 * (w * NTW + j)) *
                                 2);
#pragma unroll
              for (int m = 0; m < MT; ++m)
                mma_bf16(upd[m][j], ax[m], bb[0], bb[1]);
            }
          }
        }
      }

      // from the state entering the chunk: exp(cum_i)·C_i·Sᵀ
      if (state_pending) {
        mbar_wait(bar_s, 0);
        __syncthreads();
        for (int i = tid; i < PB * N; i += 128) {
          const int p = i / N, n = i % N;
          const float s = sS[p * SS + n];
          const bf16 hi = __float2bfloat16_rn(s);
          sSh[p * CS + n] = hi;
          sSl[p * CS + n] = __float2bfloat16_rn(s - __bfloat162float(hi));
        }
        __syncthreads();
        state_pending = false;
      }
      float accs[PT][4];
#pragma unroll
      for (int n = 0; n < PT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) accs[n][e] = 0.f;
      if (have_state) {
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks) {
          uint32_t af[4];
          ldsm4(af, base + SM::C +
                        ((16 * w + lane % 16) * CS + ks * 16 +
                         lane / 16 * 8) *
                            2);
#pragma unroll
          for (int np = 0; np < PT / 2; ++np) {
            const uint32_t off =
                ((16 * np + lane / 16 * 8 + lane % 8) * CS + ks * 16 +
                 (lane / 8) % 2 * 8) *
                2;
            uint32_t bh[4], bl[4];
            ldsm4(bh, base + SM::SH + off);
            ldsm4(bl, base + SM::SL + off);
            mma_bf16(accs[2 * np], af, bh[0], bh[1]);
            mma_bf16(accs[2 * np + 1], af, bh[2], bh[3]);
            mma_bf16(accs[2 * np], af, bl[0], bl[1]);
            mma_bf16(accs[2 * np + 1], af, bl[2], bl[3]);
          }
        }
      }
      {
        const int r0 = q0 + 16 * w + gq, r1 = r0 + 8;
        const float e0 = have_state ? __expf(sCum[min(r0, rows - 1)]) : 0.f;
        const float e1 = have_state ? __expf(sCum[min(r1, rows - 1)]) : 0.f;
#pragma unroll
        for (int n = 0; n < PT; ++n) {
          const int col = 8 * n + 2 * tq;
          if (r0 < rows)
            *reinterpret_cast<uint32_t*>(y + xrow(c0 + r0) + col) =
                pack_bf16(accy[n][0] + e0 * accs[n][0],
                          accy[n][1] + e0 * accs[n][1]);
          if (r1 < rows)
            *reinterpret_cast<uint32_t*>(y + xrow(c0 + r1) + col) =
                pack_bf16(accy[n][2] + e1 * accs[n][2],
                          accy[n][3] + e1 * accs[n][3]);
        }
      }
    }

    // the state leaving the chunk: S <- exp(cum_last)·S + upd, in f32
    // from the accumulators' registers; global memory after the last
    __syncthreads();                       // every read of S is done
    const float decay = expf(cum_last);
    if (w * NTW < NT) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = 16 * m + gq + 8 * half;
            const int n = 8 * (w * NTW + j) + 2 * tq;
            const float2 s = *reinterpret_cast<float2*>(sS + p * SS + n);
            const float2 v = make_float2(
                fmaf(decay, s.x, upd[m][j][2 * half]),
                fmaf(decay, s.y, upd[m][j][2 * half + 1]));
            if (last_chunk) {
              *reinterpret_cast<float2*>(s_fin + sbase + p * N + n) = v;
            } else {
              *reinterpret_cast<float2*>(sS + p * SS + n) = v;
              const __nv_bfloat162 hi = __floats2bfloat162_rn(v.x, v.y);
              const float2 hf = __bfloat1622float2(hi);
              *reinterpret_cast<__nv_bfloat162*>(sSh + p * CS + n) = hi;
              *reinterpret_cast<__nv_bfloat162*>(sSl + p * CS + n) =
                  __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
            }
          }
    }
    have_state = true;
  }
  cluster_sync();                          // no block leaves while copied to
}

// ---------------------------------------------------------------------------
// fp32: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;

template <int N>
constexpr size_t f32_smem_floats(int Q) {
  return (size_t)PB * (N + 1)           // state S [PB][N + 1]
         + 2 * kRows * (N + 1)          // C tile, B tile [kRows][N + 1]
         + 2 * kRows * PB               // dt·x, dt·decay·x [kRows][PB]
         + kRows * kRows                // (C·Bᵀ ∘ L) tile
         + 2 * (size_t)Q;               // dt and cum of the chunk
}

template <int N>
__global__ void __launch_bounds__(kF32Threads) ssd_scan_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ s_fin, int L, int H, int G,
    int P, int Q) {
  constexpr int kT = kF32Threads;
  constexpr int NS = N + 1;                  // rows of N + 1: lanes walking
  constexpr int kYPer = kRows * PB / kT;     // rows hit 32 banks
  constexpr int kSPer = PB * N / kT;
  static_assert(kYPer * kT == kRows * PB && kSPer * kT == PB * N,
                "PB·64 and PB·N must be multiples of 256");
  extern __shared__ float4 smem4[];
  float* sS = reinterpret_cast<float*>(smem4);  // [PB][NS]
  float* sC = sS + PB * NS;                      // [kRows][NS]
  float* sB = sC + kRows * NS;                   // [kRows][NS]
  float* sX = sB + kRows * NS;                   // [kRows][PB]
  float* sXd = sX + kRows * PB;                  // [kRows][PB]
  float* sG = sXd + kRows * PB;                  // [kRows][kRows]
  float* sDt = sG + kRows * kRows;               // [Q]
  float* sCum = sDt + Q;                         // [Q]

  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G), tid = threadIdx.x;
  const float a = A[h];
  auto xrow = [&](int t) {
    return (((size_t)b * L + t) * H + h) * P + p0;
  };
  auto brow = [&](int t) {
    return (((size_t)b * L + t) * G + g) * N;
  };
  const size_t sbase = (((size_t)b * H + h) * P + p0) * N;

  for (int i = tid; i < PB * N; i += kT)       // global [P][N] rows as they
    sS[i / N * NS + i % N] = s0 != nullptr ? s0[sbase + i] : 0.f;   // lie

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int rows = min(Q, L - c0);
    __syncthreads();                       // the previous chunk is done
    for (int t = tid; t < rows; t += kT)
      sDt[t] = dt[((size_t)b * L + c0 + t) * H + h];
    __syncthreads();
    cumsum_in_order(sDt, sCum, rows, a);
    __syncthreads();
    const float cum_last = sCum[rows - 1];
    float upd[kSPer];
#pragma unroll
    for (int k = 0; k < kSPer; ++k) upd[k] = 0.f;

    for (int q0 = 0; q0 < rows; q0 += kRows) {
      for (int i = tid; i < kRows * N; i += kT) {
        const int r = i / N, n = i % N;
        sC[r * NS + n] = q0 + r < rows ? Cm[brow(c0 + q0 + r) + n] : 0.f;
      }
      __syncthreads();
      // from the state entering the chunk: exp(cum_i) C_i·Sᵀ
      float acc[kYPer];
#pragma unroll
      for (int k = 0; k < kYPer; ++k) {
        const int e = tid + k * kT, r = e / PB, p = e % PB;
        float s = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n)
          s = fmaf(sC[r * NS + n], sS[p * NS + n], s);
        acc[k] = q0 + r < rows ? expf(sCum[q0 + r]) * s : 0.f;
      }
      // key tiles up to the diagonal; the diagonal one also updates the
      // state (each key tile is diagonal once)
      for (int j0 = 0; j0 <= q0; j0 += kRows) {
        const bool diag = j0 == q0;
        __syncthreads();                   // sB/sX/sG of the last tile read
        for (int i = tid; i < kRows * N; i += kT) {
          const int j = i / N, n = i % N;
          sB[j * NS + n] = j0 + j < rows ? Bm[brow(c0 + j0 + j) + n] : 0.f;
        }
        for (int i = tid; i < kRows * PB; i += kT) {
          const int j = i / PB, p = i % PB;
          const bool ok = j0 + j < rows;
          const float v = ok ? x[xrow(c0 + j0 + j) + p] * sDt[j0 + j] : 0.f;
          sX[i] = v;
          if (diag) sXd[i] = ok ? v * expf(cum_last - sCum[j0 + j]) : 0.f;
        }
        __syncthreads();
        for (int i = tid; i < kRows * kRows; i += kT) {
          const int r = i / kRows, j = i % kRows;
          const int qi = q0 + r, kj = j0 + j;
          float v = 0.f;
          if (kj <= qi && qi < rows) {     // select before the exponent
            float s = 0.f;
#pragma unroll 8
            for (int n = 0; n < N; ++n)
              s = fmaf(sC[r * NS + n], sB[j * NS + n], s);
            v = s * expf(sCum[qi] - sCum[kj]);
          }
          sG[i] = v;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kYPer; ++k) {
          const int e = tid + k * kT, r = e / PB, p = e % PB;
          float s = 0.f;
#pragma unroll 8
          for (int j = 0; j < kRows; ++j)
            s = fmaf(sG[r * kRows + j], sX[j * PB + p], s);
          acc[k] += s;
        }
        if (diag) {
#pragma unroll
          for (int k = 0; k < kSPer; ++k) {
            const int e = tid + k * kT, p = e / N, n = e % N;
            float s = 0.f;
#pragma unroll 8
            for (int j = 0; j < kRows; ++j)
              s = fmaf(sXd[j * PB + p], sB[j * NS + n], s);
            upd[k] += s;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kYPer; ++k) {
        const int e = tid + k * kT, r = e / PB, p = e % PB;
        if (q0 + r < rows) y[xrow(c0 + q0 + r) + p] = acc[k];
      }
      __syncthreads();                     // sC read by every thread
    }
    const float decay = expf(cum_last);
#pragma unroll
    for (int k = 0; k < kSPer; ++k) {     // each thread owns its entries
      const int e = tid + k * kT, i = e / N * NS + e % N;
      sS[i] = decay * sS[i] + upd[k];
    }
  }
  __syncthreads();
  for (int i = tid; i < PB * N; i += kT)
    s_fin[sbase + i] = sS[i / N * NS + i % N];
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *x, *dt, *A, *B, *C, *s0;
  void *y, *s_fin;
  int batch, L, H, G, P, Q;
  cudaStream_t stream;
};

template <int N>
cudaError_t launch_tc(const Args& a) {
  const size_t smem = TcSmem<N>::bytes(a.Q);
  auto kernel = ssd_scan_tc_kernel<N>;
  cudaError_t err = flash::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // a cluster: the slices of two heads of one group when the heads pair
  // up, else of one head; at most 8 blocks
  const int pair = a.H % 2 == 0 && (a.H / a.G) % 2 == 0 ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.P / PB, a.H, a.batch);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.P / PB;
  attr[0].val.clusterDim.y = pair;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(a.x),
      static_cast<const float*>(a.dt), static_cast<const float*>(a.A),
      static_cast<const bf16*>(a.B), static_cast<const bf16*>(a.C),
      static_cast<const float*>(a.s0), static_cast<bf16*>(a.y),
      static_cast<float*>(a.s_fin), a.L, a.H, a.G, a.P, a.Q);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int N>
cudaError_t launch_f32(const Args& a) {
  const size_t smem = f32_smem_floats<N>(a.Q) * sizeof(float);
  auto kernel = ssd_scan_f32_kernel<N>;
  cudaError_t err = flash::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.P / PB, a.H, a.batch), kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const float*>(a.B),
      static_cast<const float*>(a.C), static_cast<const float*>(a.s0),
      static_cast<float*>(a.y), static_cast<float*>(a.s_fin), a.L, a.H, a.G,
      a.P, a.Q);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t by_state(int N, const Args& a) {
  switch (N) {
    case 16: return BF16 ? launch_tc<16>(a) : launch_f32<16>(a);
    case 32: return BF16 ? launch_tc<32>(a) : launch_f32<32>(a);
    case 64: return BF16 ? launch_tc<64>(a) : launch_f32<64>(a);
    case 128: return BF16 ? launch_tc<128>(a) : launch_f32<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16, for x, B, C and y; dt [batch,L,H] and A [H] are float32,
// s0 (may be null: a zero initial state) and s_fin [batch,H,P,N] float32.
// x [batch,L,H,P], B/C [batch,L,G,N], all contiguous, x, B, C and s0
// 16-byte aligned, P a multiple of 16.  Q is the chunk.  Returns
// cudaGetLastError() after the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, const void* s0,
                            void* y, void* s_fin, int batch, int L, int H,
                            int G, int P, int N, int Q, int dtype,
                            void* stream) {
  if (G <= 0 || H % G != 0 || Q <= 0 || L < 0 || P <= 0 || P % PB != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || H == 0) return (int)cudaSuccess;
  const Args a{x, dt, A, B, C, s0, y, s_fin, batch, L, H, G, P, Q,
               static_cast<cudaStream_t>(stream)};
  return (int)(dtype == 1 ? by_state<true>(N, a) : by_state<false>(N, a));
}
