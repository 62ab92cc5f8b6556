// The TMA route of the ragged grouped SwiGLU FFN's backward for Hopper
// (sm_90a): K1 (dgrad) and K2 (wgrad) on the forward's machinery
// (moe_ffn_hopper.cuh): one producer warp keeps a ring of 128-byte-swizzled
// 64-wide tiles full with cp.async.bulk.tensor (full/empty mbarriers a
// slot), consumer warpgroups run wgmma.mma_async bf16 -> f32 from shared
// memory, and one 3-d tensor map over (E, K, N) per weight serves every
// expert. The layout is the forward's: a flat expert-sorted buffer, each
// expert's segment padded to the row tile bm, tile_group naming each
// tile's expert (or a sentinel >= E), row_off / sizes each expert's first
// row and real rows. K1's kernels also take the capacity path's layout
// (template flag BUCKETS; moe_ffn_bwd.cu): E buckets of C rows, (E, C, ·),
// the expert blockIdx.z, every bucket row computed; K2 takes it as the
// flat (E C, ·) view with expert g's rows [g C, g C + C) (WgradArgs::C).
//
//   K1, launch A (dgrad_gate): per block of ROWS rows of one tile and 64
//     columns of F, three accumulators over D: a = x W1[g], b = x W3[g]
//     (recomputed) and dh = dy W2[g]^T; then, elementwise in registers
//     (the three share one fragment layout), da = dh b s(a)(1 + a(1 -
//     s(a))), db = dh silu(a), stored in bf16 on the real rows only.
//   K1, launch B (dgrad_x): dx = da W1[g]^T + db W3[g]^T over F, one
//     accumulator; every row of the block is written, exact zeros past
//     the real rows (and whole blocks of sentinel tiles).
//   K2 (wgrad): per (column block, row block, expert), dW = A^T B summed
//     over the expert's real rows [row_off[g], row_off[g] + sizes[g]) in
//     64-row chunks, in order: dW1 = x^T da and dW3 = x^T db (one x tile
//     shared by both), then dW2 = h^T dy; an expert with no rows gets
//     exact zeros. No atomics and no split over rows: every output element
//     is one CTA's, so two runs are bit-identical.
//
// Operand layouts. The forward's rule (weights MN-major, activations
// K-major) does not hold here; each product, with wgmma's transpose flags
// (0: K-major, 1: MN-major):
//   dgrad_gate  x W1, x W3   A = x (rows, D): K-major, TA 0; B = a box of
//                            the (D, F) weight, F inner: MN-major, TB 1
//               dy W2^T      A = dy: K-major, TA 0; B = a box over W2's
//                            rows n (F) with 64 D values inner: K-major,
//                            TB 0
//   dgrad_x     da W1^T,     A = da, db (rows, F): K-major, TA 0; B = a box
//               db W3^T      over W1's / W3's rows n (D), 64 F values
//                            inner: K-major, TB 0
//   wgrad       x^T da,      A = a box of 64 buffer rows of x, 64 D values
//               x^T db       inner (M contiguous): MN-major, TA 1; B = da,
//                            db alike: MN-major, TB 1
//               h^T dy       the same with h and dy
// A K-major tile is rows of 64 values along K (a k16 step moves 32 B along
// the row; 8-row groups 1024 B apart); an MN-major tile is K rows of 64
// values along M or N (a k16 step moves 16 rows = 2048 B; every tile is 64
// wide, so LBO is unused).
//
// Ragged depth (K2). A 64-row chunk runs past the expert's last real row
// into its segment's padding rows, and those are not zeros: h is scratch
// the forward leaves unwritten past its computed rows, K1 writes da and db
// on real rows only, and dy's padding rows are whatever the caller has
// there; 0 * NaN is NaN. So before its wgmma reads the last chunk, the
// consumer zeroes rows [valid, 64) of every tile of that stage in shared
// memory (a tile row is 128 contiguous bytes, whatever the swizzle), and a
// fence.proxy.async orders those generic writes before wgmma's reads. (A
// guard that skipped the k16 steps past `valid` would be data-dependent
// control flow around wgmma, which makes ptxas serialise it; TMA's
// out-of-bounds zero fill covers only the tensor's edge, not a segment's.)
//
// What bounds them on an H100 (granite-moe-3b-a800m: E 40, D 1536, F 512).
// At 1024 tokens x top-8 (8192 rows) bytes: K1 moves 283 MB (84 us at
// 3.35 TB/s) for 64 GFLOP (65 us at 989 TFLOP/s); K2 264 MB (79 us, most
// of it the 189 MB of dW written) for 39 GFLOP. At 4096 tokens
// operations: K1 258 GFLOP (261 us), K2 155 GFLOP (156 us). The design
// keeps the tensor cores fed from the ring and writes each output tile
// once, staged in shared memory and stored with 16-byte stores.

#pragma once

#include "moe_ffn_hopper.cuh"

namespace moe_ffn_hopper_bwd {

// declared here, so that a file that also uses moe_ffn_blocks (whose BN
// and BK differ) sees no ambiguity
using moe_ffn_hopper::BK;
using moe_ffn_hopper::BN;
using moe_ffn_hopper::clampi;
using moe_ffn_hopper::fence_proxy_async;
using moe_ffn_hopper::launch_smem;
using moe_ffn_hopper::mbar_arrive;
using moe_ffn_hopper::mbar_expect_tx;
using moe_ffn_hopper::mbar_init;
using moe_ffn_hopper::mbar_wait;
using moe_ffn_hopper::smem_u32;
using moe_ffn_hopper::sw128_desc;
using moe_ffn_hopper::TILE_BYTES;
using moe_ffn_hopper::tma_load_2d;
using moe_ffn_hopper::tma_load_3d;
using moe_ffn_hopper::Wgmma;
using moe_ffn_hopper::wgmma_commit;
using moe_ffn_hopper::wgmma_fence;
using moe_ffn_hopper::wgmma_wait_all;

// K1's shared-memory plan at row block ROWS (64 rows a consumer
// warpgroup). ROWS 128: one CTA an SM (168 / 192 KB); ROWS 64: two.
template <int ROWS>
struct DgradCfg {
  static constexpr int NWG = ROWS / 64;
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int ACT_BYTES = ROWS * BK * 2;
  // launch A: the W1, W3, W2^T tiles, then x and dy
  static constexpr int GATE_STAGE = 3 * TILE_BYTES + 2 * ACT_BYTES;
  static constexpr int GATE_STAGES = ROWS == 128 ? 3 : 2;
  // launch B: the W1^T, W3^T tiles, then da and db
  static constexpr int X_STAGE = 2 * TILE_BYTES + 2 * ACT_BYTES;
  static constexpr int X_STAGES = ROWS == 128 ? 4 : 3;
  // + 1 KB so the ring can start on a 1024-byte boundary, + the barriers
  static constexpr int GATE_SMEM = 1024 + GATE_STAGES * (GATE_STAGE + 16);
  static constexpr int X_SMEM = 1024 + X_STAGES * (X_STAGE + 16);
  static_assert(ROWS == 64 || ROWS == 128, "row block");
  static_assert(GATE_SMEM <= 232448 && X_SMEM <= 232448,
                "more than a block's shared memory");
  // the epilogue stages each warpgroup's 64 x 64 tile in the ring
  static_assert(NWG * 64 * (BN + 8) * 2 <= GATE_STAGE &&
                NWG * 64 * (BN + 8) * 2 <= X_STAGE, "epilogue");
};

// K2's plan: an output tile of 128 x 64 (two consumer warpgroups of 64
// rows each), TWO B operands sharing A. (On an H100 it beat 64 x 64 and
// 128 x 128 at both training shapes: PERF.md.)
template <bool TWO>
struct WgradCfg {
  static constexpr int NWG = 2;
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int A_BYTES = NWG * TILE_BYTES;  // 64-wide blocks
  static constexpr int STAGE = A_BYTES + (TWO ? 2 : 1) * TILE_BYTES;
  // 2-4 slots in ~96 KB, so that two CTAs share an SM
  static constexpr int STAGES = clampi(98304 / STAGE, 2, 4);
  static constexpr int SMEM = 1024 + STAGES * (STAGE + 16);
  static_assert(2 * (SMEM + 1024) <= 233472, "two CTAs do not fit an SM");
  static_assert(NWG * 64 * (BN + 8) * 2 <= STAGES * STAGE, "epilogue");
};

struct DgradArgs {
  const int* tile_group;  // expert per bm tile (sentinel >= E); ragged only
  const int* row_off;     // first buffer row of each expert; ragged only
  const int* sizes;       // real rows of each expert; ragged only
  __nv_bfloat16* da;      // (T, F), real rows written
  __nv_bfloat16* db;
  __nv_bfloat16* dx;      // (T, D): ragged every row, buckets rows below C
  int D, F, E, bm;
  int C;                  // rows a bucket (BUCKETS); 0 on the ragged layout
};

struct WgradArgs {
  const int* row_off;   // ragged: each expert's first row and real rows
  const int* sizes;
  __nv_bfloat16* out1;  // (E, M, N)
  __nv_bfloat16* out3;  // the second product's, or null
  int M, N;
  int C;                // > 0: buckets, expert g's rows [g C, g C + C)
};

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// STAGES slots of STAGE bytes from `base` (1024-aligned), then a full and
// an empty mbarrier a slot.
template <int STAGES, int STAGE>
struct Ring {
  uint32_t base;
  __device__ __forceinline__ uint32_t slot(int s) const {
    return base + s * STAGE;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + STAGES * STAGE + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return full(s) + STAGES * 8;
  }
  // by one thread, before a __syncthreads()
  __device__ __forceinline__ void init(int consumer_warps) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumer_warps);  // lane 0 of each
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // producer: the slot of load `it` once it is free, its bytes announced
  __device__ __forceinline__ int acquire(int it) const {
    const int s = it % STAGES;
    if (it >= STAGES) mbar_wait(empty(s), (it / STAGES - 1) & 1);
    mbar_expect_tx(full(s), STAGE);
    return s;
  }
  // consumer: the slot of load `it` once it has landed
  __device__ __forceinline__ int wait(int it) const {
    const int s = it % STAGES;
    mbar_wait(full(s), (it / STAGES) & 1);
    return s;
  }
  __device__ __forceinline__ void release(int s, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
};

// Real rows of the row block [row0, row0 + span) of tile row0 / bm, and
// the tile's expert e (0 rows on a sentinel tile).
__device__ __forceinline__ int block_rows(const DgradArgs& a, int row0,
                                          int span, int& e) {
  e = a.tile_group[row0 / a.bm];
  if (e < 0 || e >= a.E) return 0;
  return max(0, min(a.row_off[e] + a.sizes[e] - row0, span));
}

// K1's row block number y (blockIdx.y) of ROWS rows: its expert e, its
// first row `row0` in the activations' tensor maps, its first row `flat0`
// in the flat (rows, .) outputs, and its real rows (0: nothing to do).
//   ragged: rows [ROWS y, ROWS y + ROWS) of the flat buffer, e and the
//     real rows from the plan (block_rows); row0 = flat0.
//   buckets: rows [ROWS y, ROWS y + ROWS) of bucket e = blockIdx.z; real
//     rows min(C - row0, ROWS), every bucket row counted (an empty row has
//     x = 0 and dy = 0, so its da, db and dx come out exact zeros);
//     flat0 = e C + row0. The maps are 3-d over (E, C, .), so rows at or
//     past C load as zeros, never the next bucket's rows.
template <int ROWS, bool BUCKETS>
__device__ __forceinline__ int row_block(const DgradArgs& a, int& e,
                                         int& row0, int64_t& flat0) {
  row0 = static_cast<int>(blockIdx.y) * ROWS;
  if constexpr (BUCKETS) {
    e = static_cast<int>(blockIdx.z);
    flat0 = static_cast<int64_t>(e) * a.C + row0;
    return min(a.C - row0, ROWS);
  } else {
    flat0 = row0;
    return block_rows(a, row0, ROWS, e);
  }
}

// One activation tile of rows [row0, row0 + box) and depth [k0, k0 + 64):
// from a 2-d map over the flat buffer, or a 3-d map over the buckets.
template <bool BUCKETS>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int k0, int row0,
                                          int e) {
  if constexpr (BUCKETS) {
    tma_load_3d(dst, m, bar, k0, row0, e);
  } else {
    tma_load_2d(dst, m, bar, k0, row0);
  }
}

// Zeros in rows [0, rows) and the first `cols` columns (a multiple of 8)
// of dst (row stride ld), 16 bytes a store, by `threads` threads.
__device__ __forceinline__ void store_zeros(__nv_bfloat16* dst, int64_t ld,
                                            int rows, int cols, int t,
                                            int threads) {
  const int vecs = cols / 8;
  for (int i = t; i < rows * vecs; i += threads) {
    *reinterpret_cast<uint4*>(dst + (i / vecs) * ld + (i % vecs) * 8) =
        make_uint4(0, 0, 0, 0);
  }
}

// A warpgroup's 64 x W accumulator tile v (W / 2 values a thread; element
// i at row 16 (warp % 4) + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (lane % 4) + i % 2), rounded to bf16 and staged in shared memory
// (rows of W + 8 values, so that the 8 rows one store instruction spans
// fall on different banks), then stored with 16-byte stores: rows below
// `rows`, the first `cols` columns (a multiple of 8), to dst (row stride
// ld). t: the thread's index in its warpgroup; bar: a named barrier of
// the warpgroup's 128 threads.
template <int W>
__device__ __forceinline__ void wg_store(const float (&v)[W / 2],
                                         __nv_bfloat16* stage,
                                         __nv_bfloat16* dst, int64_t ld,
                                         int rows, int cols, int t, int bar) {
  constexpr int LD = W + 8;
  const int lane = t % 32;
  const int wq = t / 32;
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int r = 16 * wq + lane / 4 + 8 * ((i / 2) % 2);
    const int c = 8 * (i / 4) + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(stage + r * LD + c) =
        __floats2bfloat162_rn(v[i], v[i + 1]);
  }
  named_bar(bar, 128);
  const int vecs = cols / 8;
  for (int i = t; i < 64 * (W / 8); i += 128) {
    const int r = i / (W / 8);
    const int q = i % (W / 8);
    if (r < rows && q < vecs) {
      *reinterpret_cast<uint4*>(dst + r * ld + q * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + q * 8);
    }
  }
  named_bar(bar, 128);  // the stage may be written again
}

// ---------------------------------------------------------------------------
// K1, launch A: da, db for row block y (row_block) and F columns [64 x,
// 64 x + 64). x, dy: maps over (T, D) (ragged) or (E, C, D) (BUCKETS) with
// a (64, ROWS) box; w1, w3 over (E, D, F), w2 over (E, F, D), (64, 64, 1)
// boxes.
// ---------------------------------------------------------------------------
template <int ROWS, bool BUCKETS>
__global__ void __launch_bounds__(DgradCfg<ROWS>::THREADS)
dgrad_gate_tma_kernel(const __grid_constant__ CUtensorMap x,
                      const __grid_constant__ CUtensorMap dy,
                      const __grid_constant__ CUtensorMap w1,
                      const __grid_constant__ CUtensorMap w3,
                      const __grid_constant__ CUtensorMap w2,
                      const DgradArgs args) {
  using Config = DgradCfg<ROWS>;
  constexpr int NWG = Config::NWG;
  constexpr int STAGE = Config::GATE_STAGE;
  const int col0 = static_cast<int>(blockIdx.x) * BN;
  int e, row0;
  int64_t flat0;
  const int real = row_block<ROWS, BUCKETS>(args, e, row0, flat0);
  if (real == 0) return;  // K2 and launch B read the real rows only

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const Ring<Config::GATE_STAGES, STAGE> ring{smem_u32(smem)};
  if (threadIdx.x == 0) ring.init(4 * NWG);
  __syncthreads();

  const int kt_n = (args.D + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 4 * NWG) {
    if (lane == 0) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = ring.acquire(kt);
        const uint32_t base = ring.slot(s);
        const uint32_t bar = ring.full(s);
        const int k0 = kt * BK;
        tma_load_3d(base, &w1, bar, col0, k0, e);
        tma_load_3d(base + TILE_BYTES, &w3, bar, col0, k0, e);
        tma_load_3d(base + 2 * TILE_BYTES, &w2, bar, k0, col0, e);
        load_rows<BUCKETS>(base + 3 * TILE_BYTES, &x, bar, k0, row0, e);
        load_rows<BUCKETS>(base + 3 * TILE_BYTES + Config::ACT_BYTES, &dy,
                           bar, k0, row0, e);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const bool active = wg * 64 < real;
  float ga[32], gb[32], gh[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    ga[i] = 0.0f;
    gb[i] = 0.0f;
    gh[i] = 0.0f;
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = ring.wait(kt);
    if (active) {
      const uint32_t base = ring.slot(s);
      const uint32_t xs = base + 3 * TILE_BYTES + wg * 64 * 128;
      const uint32_t ys = xs + Config::ACT_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t xd = sw128_desc(xs + kk * 32, 16);
        const uint64_t yd = sw128_desc(ys + kk * 32, 16);
        Wgmma<64, 0, 1>::run(ga, xd, sw128_desc(base + kk * 2048,
                                                TILE_BYTES));
        Wgmma<64, 0, 1>::run(gb, xd, sw128_desc(base + TILE_BYTES +
                                                kk * 2048, TILE_BYTES));
        Wgmma<64, 0, 0>::run(gh, yd, sw128_desc(base + 2 * TILE_BYTES +
                                                kk * 32, 16));
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    ring.release(s, lane);
  }

  // every warpgroup is done with the ring: its memory stages the epilogue
  named_bar(1, 128 * NWG);
  const int rows = min(64, real - wg * 64);
  if (rows <= 0) return;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float av = ga[i];
    const float bv = gb[i];
    const float dh = gh[i];
    const float sg = 1.0f / (1.0f + expf(-av));
    ga[i] = dh * bv * sg * (1.0f + av * (1.0f - sg));
    gb[i] = dh * (av * sg);
  }
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(smem) + wg * 64 * (BN + 8);
  const int64_t off = (flat0 + wg * 64) * args.F + col0;
  const int cols = min(BN, args.F - col0);
  const int t = threadIdx.x % 128;
  wg_store<64>(ga, stage, args.da + off, args.F, rows, cols, t, 2 + wg);
  wg_store<64>(gb, stage, args.db + off, args.F, rows, cols, t, 2 + wg);
}

// ---------------------------------------------------------------------------
// K1, launch B: dx for row block y and D columns [64 x, 64 x + 64). da, db:
// maps over (T, F) (ragged) or (E, C, F) (BUCKETS) with a (64, ROWS) box;
// w1, w3 over (E, D, F). Ragged: every row of the block written, exact
// zeros past the real rows; buckets: rows below C only (the rows past them
// are the next bucket's).
// ---------------------------------------------------------------------------
template <int ROWS, bool BUCKETS>
__global__ void __launch_bounds__(DgradCfg<ROWS>::THREADS)
dgrad_x_tma_kernel(const __grid_constant__ CUtensorMap da,
                   const __grid_constant__ CUtensorMap db,
                   const __grid_constant__ CUtensorMap w1,
                   const __grid_constant__ CUtensorMap w3,
                   const DgradArgs args) {
  using Config = DgradCfg<ROWS>;
  constexpr int NWG = Config::NWG;
  constexpr int STAGE = Config::X_STAGE;
  const int col0 = static_cast<int>(blockIdx.x) * BN;
  const int cols = min(BN, args.D - col0);
  int e, row0;
  int64_t flat0;
  const int real = row_block<ROWS, BUCKETS>(args, e, row0, flat0);
  __nv_bfloat16* out = args.dx + flat0 * args.D + col0;
  if (real == 0) {  // ragged only: a bucket's row block has a real row
    store_zeros(out, args.D, ROWS, cols, threadIdx.x, Config::THREADS);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const Ring<Config::X_STAGES, STAGE> ring{smem_u32(smem)};
  if (threadIdx.x == 0) ring.init(4 * NWG);
  __syncthreads();

  const int kt_n = (args.F + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 4 * NWG) {
    if (lane == 0) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = ring.acquire(kt);
        const uint32_t base = ring.slot(s);
        const uint32_t bar = ring.full(s);
        const int k0 = kt * BK;
        tma_load_3d(base, &w1, bar, k0, col0, e);
        tma_load_3d(base + TILE_BYTES, &w3, bar, k0, col0, e);
        load_rows<BUCKETS>(base + 2 * TILE_BYTES, &da, bar, k0, row0, e);
        load_rows<BUCKETS>(base + 2 * TILE_BYTES + Config::ACT_BYTES, &db,
                           bar, k0, row0, e);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const bool active = wg * 64 < real;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = ring.wait(kt);
    if (active) {
      const uint32_t base = ring.slot(s);
      const uint32_t as = base + 2 * TILE_BYTES + wg * 64 * 128;
      const uint32_t bs = as + Config::ACT_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        Wgmma<64, 0, 0>::run(acc, sw128_desc(as + kk * 32, 16),
                             sw128_desc(base + kk * 32, 16));
        Wgmma<64, 0, 0>::run(acc, sw128_desc(bs + kk * 32, 16),
                             sw128_desc(base + TILE_BYTES + kk * 32, 16));
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    ring.release(s, lane);
  }

  named_bar(1, 128 * NWG);
  // ragged: rows past the real ones (padding, or a warpgroup with none)
  // are exact zeros, whatever da and db hold there; buckets: only the real
  // rows are stored
  const int rows = BUCKETS ? min(64, real - wg * 64) : 64;
  if (rows <= 0) return;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = wg * 64 + 16 * (warp % 4) + lane / 4 + 8 * ((i / 2) % 2);
    acc[i] = r < real ? acc[i] : 0.0f;
  }
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(smem) + wg * 64 * (BN + 8);
  wg_store<64>(acc, stage, out + static_cast<int64_t>(wg * 64) * args.D,
               args.D, rows, cols, threadIdx.x % 128, 2 + wg);
}

// ---------------------------------------------------------------------------
// K2: out1[g][m0 : m0 + 128, n0 : n0 + 64] = A^T B1 (and out3 = A^T B3)
// over expert g's real rows: [row_off[g], row_off[g] + sizes[g]), or with
// args.C > 0 (buckets) [g C, g C + C). a, b1, b3: maps over (T, M) and
// (T, N) with a (64, 64) box. Grid: (N / 64, M / 128, E).
// ---------------------------------------------------------------------------
template <bool TWO>
__global__ void __launch_bounds__(WgradCfg<TWO>::THREADS)
wgrad_tma_kernel(const __grid_constant__ CUtensorMap a,
                 const __grid_constant__ CUtensorMap b1,
                 const __grid_constant__ CUtensorMap b3,
                 const WgradArgs args) {
  using Config = WgradCfg<TWO>;
  constexpr int NWG = Config::NWG;
  constexpr int STAGE = Config::STAGE;
  constexpr int N_TILES = STAGE / TILE_BYTES;
  constexpr int CONSUMERS = 128 * NWG;
  const int n0 = static_cast<int>(blockIdx.x) * BN;
  const int m0 = static_cast<int>(blockIdx.y) * 64 * NWG;
  const int g = static_cast<int>(blockIdx.z);
  const int start = args.C > 0 ? g * args.C : args.row_off[g];
  const int n_rows = args.C > 0 ? args.C : args.sizes[g];
  const int chunks = (n_rows + 63) / 64;
  const int cols = min(BN, args.N - n0);
  const int64_t o = static_cast<int64_t>(g) * args.M * args.N +
                    static_cast<int64_t>(m0) * args.N + n0;
  if (chunks == 0) {
    const int rows = min(64 * NWG, args.M - m0);
    store_zeros(args.out1 + o, args.N, rows, cols, threadIdx.x,
                Config::THREADS);
    if (TWO) {
      store_zeros(args.out3 + o, args.N, rows, cols, threadIdx.x,
                  Config::THREADS);
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const Ring<Config::STAGES, STAGE> ring{smem_u32(smem)};
  if (threadIdx.x == 0) ring.init(4 * NWG);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 4 * NWG) {
    if (lane == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int s = ring.acquire(c);
        const uint32_t base = ring.slot(s);
        const uint32_t bar = ring.full(s);
        const int r0 = start + 64 * c;
        // a 64-wide block wholly past M or N loads the first one again:
        // its products are never stored
#pragma unroll
        for (int j = 0; j < NWG; ++j) {
          const int m = m0 + 64 * j < args.M ? m0 + 64 * j : m0;
          tma_load_2d(base + j * TILE_BYTES, &a, bar, m, r0);
        }
        tma_load_2d(base + Config::A_BYTES, &b1, bar, n0, r0);
        if (TWO) {
          tma_load_2d(base + Config::A_BYTES + TILE_BYTES, &b3, bar, n0, r0);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const bool active = m0 + 64 * wg < args.M;
  float acc1[32], acc3[32];  // acc3 unused (and dropped) if !TWO
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc1[i] = 0.0f;
    acc3[i] = 0.0f;
  }
  for (int c = 0; c < chunks; ++c) {
    const int s = ring.wait(c);
    const uint32_t base = ring.slot(s);
    const int valid = min(64, n_rows - 64 * c);
    if (valid < 64) {
      // rows [valid, 64) of every tile of the slot: zeros
      const int lo = valid * 128;
      const int n16 = (64 - valid) * 8;
      uint8_t* slot = smem + s * STAGE;
      for (int i = threadIdx.x; i < N_TILES * n16; i += CONSUMERS) {
        *reinterpret_cast<uint4*>(slot + (i / n16) * TILE_BYTES + lo +
                                  (i % n16) * 16) = make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();
      named_bar(1, CONSUMERS);
    }
    if (active) {
      const uint32_t as = base + wg * TILE_BYTES;
      const uint32_t bs1 = base + Config::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t ad = sw128_desc(as + kk * 2048, TILE_BYTES);
        Wgmma<64, 1, 1>::run(acc1, ad, sw128_desc(bs1 + kk * 2048,
                                                  TILE_BYTES));
        if constexpr (TWO) {
          Wgmma<64, 1, 1>::run(acc3, ad, sw128_desc(bs1 + TILE_BYTES +
                                                    kk * 2048, TILE_BYTES));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    ring.release(s, lane);
  }

  named_bar(1, CONSUMERS);
  if (!active) return;
  const int rows = min(64, args.M - m0 - 64 * wg);
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(smem) + wg * 64 * (BN + 8);
  const int64_t off = o + static_cast<int64_t>(64 * wg) * args.N;
  const int t = threadIdx.x % 128;
  wg_store<64>(acc1, stage, args.out1 + off, args.N, rows, cols, t, 2 + wg);
  if constexpr (TWO) {
    wg_store<64>(acc3, stage, args.out3 + off, args.N, rows, cols, t,
                 2 + wg);
  }
}

}  // namespace moe_ffn_hopper_bwd
