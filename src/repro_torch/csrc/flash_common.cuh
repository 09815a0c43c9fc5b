// What flash attention's forward kernel (`flash_attention.cu`) and its
// backward kernels (`flash_attention_bwd.cu`) share: the masks and the
// tile classes planned from the positions themselves (both dtypes), and
// for bf16 the `wgmma` machinery of Hopper (sm_90a): the 128-byte
// swizzled tile layout and its descriptors, 16-byte `cp.async` copies and
// their two-stage ring, the wgmma products with A from shared memory or
// from registers, the accumulator's row and column map, and `ex2.approx`.
#pragma once

#include "attention_common.cuh"

#include <limits.h>

namespace flash {

using namespace attn;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// masks and tile classes (both dtypes)
// ---------------------------------------------------------------------------

struct Masks {
  int causal, window, vlen;             // vlen < 0: no valid-length mask
  __device__ __forceinline__ bool ok(int qp, int kp) const {
    bool v = true;
    if (causal) v = v && kp <= qp;
    if (window > 0) v = v && qp - kp < window;
    if (vlen >= 0) v = v && kp < vlen;
    return v;
  }
};

enum : int { kTileSkip = 0, kTileMasked = 1, kTileFull = 2 };
static_assert(kFull == 0xffffffffu, "warp intrinsics take the full-warp mask");

// The class of a tile pair from the least and largest positions of its
// live query rows and live keys: kTileSkip when no pair can be kept, kTileFull
// when every pair is (never with a ragged edge, whose dead rows or keys
// need the mask), else kTileMasked.  Sound for any positions.
__device__ __forceinline__ int tile_class(const Masks& mk, int qmin, int qmax,
                                          int kmin, int kmax, bool ragged) {
  const long long qn = qmin, qx = qmax, kn = kmin, kx = kmax;
  if (qn > qx || kn > kx) return kTileSkip;            // no live row or key
  if (mk.causal && kn > qx) return kTileSkip;
  if (mk.window > 0 && qn - kx >= mk.window) return kTileSkip;
  if (mk.vlen >= 0 && kn >= mk.vlen) return kTileSkip;
  const bool all = !ragged && (!mk.causal || kx <= qn) &&
                   (mk.window <= 0 || qx - kn < mk.window) &&
                   (mk.vlen < 0 || kx < mk.vlen);
  return all ? kTileFull : kTileMasked;
}

// The least and largest of a warp's values, in every lane: one
// `redux.sync` each.
__device__ __forceinline__ void warp_minmax(int& mn, int& mx) {
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
}

// The least and largest position over the live ones of n items (lane,
// lane + 32, ... of one warp; every lane gets the result) and whether
// all n are live.
template <typename Live, typename Pos>
__device__ __forceinline__ void live_bounds(int n, Live live, Pos pos,
                                            int& mn, int& mx, bool& whole) {
  const int lane = threadIdx.x % 32;
  mn = INT_MAX;
  mx = INT_MIN;
  bool all = true;
  for (int i = lane; i < n; i += 32) {
    if (live(i)) {
      const int p = pos(i);
      mn = min(mn, p);
      mx = max(mx, p);
    } else {
      all = false;
    }
  }
  warp_minmax(mn, mx);
  whole = __all_sync(kFull, all);
}

// The class of every tile on the side a block of THREADS threads loops
// over (n_items items, TILE a tile, TILE a multiple of 32) against the
// block's own side [own_min, own_max]: a warp a tile, 8 tiles' loads in
// flight at once.  `pos(i)` is item i's position; ITEMS_ARE_KEYS says
// which side is which.  The caller syncs after.
template <int TILE, int THREADS, bool ITEMS_ARE_KEYS, typename Pos>
__device__ __forceinline__ void plan_tiles(uint8_t* cls, int n_items, Pos pos,
                                           int own_min, int own_max,
                                           bool own_whole, const Masks& mk) {
  constexpr int U = 8, X = TILE / 32;
  static_assert(X * 32 == TILE, "a tile is whole warps' worth of items");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (n_items + TILE - 1) / TILE;
  for (int n0 = warp * U; n0 < n_tiles; n0 += (THREADS / 32) * U) {
    int p[U][X];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int x = 0; x < X; ++x) {
        const int i = (n0 + u) * TILE + x * 32 + lane;
        p[u][x] = i < n_items ? pos(i) : 0;
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int n = n0 + u;
      int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
      for (int x = 0; x < X; ++x)
        if (n * TILE + x * 32 + lane < n_items) {
          mn = min(mn, p[u][x]);
          mx = max(mx, p[u][x]);
        }
      warp_minmax(mn, mx);
      if (lane == 0 && n < n_tiles) {
        const bool ragged = !own_whole || (n + 1) * TILE > n_items;
        cls[n] = ITEMS_ARE_KEYS
                     ? tile_class(mk, own_min, own_max, mn, mx, ragged)
                     : tile_class(mk, mn, mx, own_min, own_max, ragged);
      }
    }
  }
}

// The forward's key tiles against its rows [qmin, qmax]: from the key
// positions `kv_pos` (one batch row's), or with none, index positions,
// whose tile bounds are the tile's ends (no reduction).  The caller syncs
// after.
template <int TILE, int THREADS>
__device__ __forceinline__ void plan_key_tiles(uint8_t* cls, int n_keys,
                                               const int* kv_pos, int qmin,
                                               int qmax, bool rows_whole,
                                               const Masks& mk) {
  if (kv_pos) {
    plan_tiles<TILE, THREADS, true>(
        cls, n_keys, [&](int j) { return kv_pos[j]; }, qmin, qmax,
        rows_whole, mk);
    return;
  }
  const int n_tiles = (n_keys + TILE - 1) / TILE;
  for (int n = threadIdx.x; n < n_tiles; n += THREADS)
    cls[n] = tile_class(mk, qmin, qmax, n * TILE,
                        min(n * TILE + TILE, n_keys) - 1,
                        !rows_whole || (n + 1) * TILE > n_keys);
}

// the first tile from x on that is not skipped (n_tiles if none)
__device__ __forceinline__ int next_live_tile(const uint8_t* cls, int n_tiles,
                                              int x) {
  while (x < n_tiles && cls[x] == kTileSkip) ++x;
  return x;
}

// Kernel attributes: dynamic shared memory above the 48 KB default.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Blocks of `tile` query rows: `tile/GB` positions times GB heads of one
// KV head, more than `tile` heads a KV head split over head groups.
struct RowMap {
  int G, GB, n_groups, tq_per_block;
  RowMap(int Hq, int Hkv, int tile)
      : G(Hq / Hkv), GB(G < tile ? G : tile), n_groups((G + GB - 1) / GB),
        tq_per_block(tile / GB) {}
  dim3 grid(int B, int Tq, int Hkv) const {
    return dim3((Tq + tq_per_block - 1) / tq_per_block, Hkv * n_groups, B);
  }
};

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kT = 64;                  // rows (or keys) a tile: one wgmma M
constexpr int kWG = 128;                // one warpgroup a block

// A [64, D] bf16 tile in shared memory as wgmma reads it: D/W column
// blocks of W = SW/2 elements, each [64 rows][SW bytes] with the 16-byte
// chunks of row r XOR-swizzled by the row (SW = 128 bytes, or 64 at
// D 32).  The tile starts 1024-byte aligned.  The same tile is a K-major
// operand (its D columns are the reduction, as for s = q·kᵀ) and an
// MN-major B (its 64 rows are the reduction, as for dq = ds·k).
template <int D>
struct Tile {
  static constexpr int SW = D == 32 ? 64 : 128;
  static constexpr int W = SW / 2;
  static constexpr uint32_t BYTES = kT * D * 2;
  static constexpr uint64_t SWIZZLE = SW == 128 ? 1 : 2;   // descriptor code
  static constexpr uint32_t PHASE = SW / 16 - 1;           // row bits XORed

  // byte offset of element (r, c), c a multiple of 8
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t o = (c / W) * (kT * SW) + r * SW + (c % W) * 2;
    return o ^ (((o >> 7) & PHASE) << 4);
  }
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
           (uint64_t)(sbo >> 4) << 32 | SWIZZLE << 62;
  }
  // columns 16·ks .. 16·ks + 15 as the reduction (K-major): rows SW bytes
  // apart, 8-row groups 8·SW apart
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
    const int c = ks * 16;
    return desc(tile + (c / W) * (kT * SW) + (c % W) * 2, 16, 8 * SW);
  }
  // rows 16·ks .. 16·ks + 15 as the reduction and the D columns as N
  // (MN-major): 8-row groups 8·SW apart, column blocks kT·SW apart
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int ks) {
    return desc(tile + ks * 16 * SW, kT * SW, 8 * SW);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; with
// `valid` false nothing is read and the bytes are zeroed.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// this thread's copies, now complete, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copies one [64, D] tile into the swizzled layout at `dst`: `src(r)` is
// row r's first element, or nullptr for a row outside the tensor (zeroed;
// `any` is a valid address that is not read).
template <int D, typename Src>
__device__ __forceinline__ void cp_tile(uint32_t dst, Src src,
                                        const bf16* any) {
  constexpr int CPR = D / 8;            // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < kT * CPR / kWG; ++it) {
    const int idx = threadIdx.x + it * kWG;
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const bf16* p = src(r);
    cp_async16(dst + Tile<D>::offset(r, c), p ? p + c : any, p != nullptr);
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pins registers that an in-flight wgmma reads or writes to this point of
// the program, so the compiler neither reads an accumulator before the
// wait nor reuses an A operand's register before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// d (+)= A·B, m64n64k16, A and B from shared memory (K-major both).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A·B, m64nNk16 with N = 32, 64 or 128 (the overload by d's size):
// A from registers (bf16 pairs), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64n64 f32 accumulator `x` as the bf16 A operand of the four k16
// steps over its 64 columns: register q of step ks holds the pair
// x[8·ks + 2q], x[8·ks + 2q + 1] (the accumulator's and the A operand's
// fragments share their row and column map).
__device__ __forceinline__ void to_a(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[ks][j] = pack_bf16(x[8 * ks + 2 * j], x[8 * ks + 2 * j + 1]);
}

// The accumulator map of a m64nN wgmma: element e = 4·j + 2·i + c of
// thread t sits at row 16·(t / 32) + (t % 32) / 4 + 8·i and column
// 8·j + 2·(t % 4) + c.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * i;
}
__device__ __forceinline__ int acc_col(int j, int c) {
  return 8 * j + 2 * (threadIdx.x % 4) + c;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x / d and x % d for x >= 0, by a shift and a mask when d is a power of
// two (lg = log2 d, else -1)
struct Div {
  int d, lg;
  __device__ __forceinline__ int div(int x) const {
    return lg >= 0 ? x >> lg : x / d;
  }
  __device__ __forceinline__ int mod(int x) const {
    return lg >= 0 ? x & (d - 1) : x % d;
  }
};

// The tiles a block does not skip, in order, through a two-stage ring of
// asynchronous copies: `load(n, stage)` issues tile n's copies.  The
// constructor issues the first tile; `wait` issues the next one into the
// other stage (free since the last `next`) and returns the stage of tile
// `n` once its copies are in, visible to wgmma, and every thread is past
// the previous tile; `next` moves on once every thread is done with `n`.
struct Ring {
  const uint8_t* cls;
  int n_tiles, n, ahead, st = 0;

  __device__ __forceinline__ int seek(int x) const {
    return next_live_tile(cls, n_tiles, x);
  }
  template <typename Load>
  __device__ __forceinline__ Ring(const uint8_t* c, int nt, Load load)
      : cls(c), n_tiles(nt) {
    n = ahead = seek(0);
    if (ahead < n_tiles) load(ahead, 0);
    cp_commit();
  }
  __device__ __forceinline__ bool more() const { return n < n_tiles; }
  template <typename Load>
  __device__ __forceinline__ int wait(Load load) {
    ahead = seek(min(ahead + 1, n_tiles));
    if (ahead < n_tiles) load(ahead, st ^ 1);
    cp_commit();
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();
    return st;
  }
  __device__ __forceinline__ void next() {
    __syncthreads();
    n = seek(n + 1);
    st ^= 1;
  }
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}


}  // namespace wg

inline wg::Div divisor(int d) {
  int lg = -1;
  if ((d & (d - 1)) == 0)
    for (lg = 0; (1 << lg) < d; ++lg) {}
  return wg::Div{d, lg};
}

}  // namespace flash
