// The TMA route of the grouped SwiGLU expert FFN kernels for Hopper
// (sm_90a), shared by ragged_moe_ffn.cu and moe_ffn.cu; its PTX wrappers,
// descriptors and tensor maps also serve the backward's TMA route
// (moe_ffn_hopper_bwd.cuh). bf16 in and out,
// f32 accumulation, h rounded to bf16 before the down projection, as the
// Pallas kernels do.
//
// Both kernels are bound by the bytes of the expert weights (118-225 MB a
// call against 0.8-24 GFLOP at the served shapes), so the design keeps
// weight tiles in flight at all times and reads each weight slice once per
// row block:
//
//   * A TMA ring. One producer warp streams BK x BN weight tiles (and the
//     matching activation tile) through STAGES slots of dynamic shared
//     memory with cp.async.bulk.tensor, completion on an mbarrier per slot
//     ("full"); the consumer warpgroups release a slot through a second
//     mbarrier ("empty") once their wgmma has read it. All tiles are
//     128-byte swizzled (an inner box of 64 bf16), the layout wgmma reads.
//     One 3-d tensor map over (E, K, N) serves every expert: the expert is
//     a coordinate. Rows, columns and depth past a tensor's edge load as
//     zeros (TMA's out-of-bounds fill), so D, F and C need no padding.
//   * wgmma.mma_async bf16 -> f32, both operands from shared memory, the
//     accumulators in registers.
//   * A row block sized to the real rows, chosen by the host from static
//     shapes:
//       SWAP (few rows, ROWS = 8 or 16): A and B swap. 64 output columns of
//         the weight take wgmma's M = 64 and the token rows its N = ROWS, so
//         a CTA streams its weight slice once and computes no padding rows.
//         It loops over ROWS-row chunks up to its block's real row count, so
//         a block with more rows than the hint is still computed whole.
//       many rows (ROWS = 64 or 128): one consumer warpgroup per 64 rows,
//         M = 64 rows, N = 64 columns; a warpgroup whose rows are all past
//         the block's real rows skips its products.
//   * Two launches, gate/up into a bf16 h, then down: the Pallas kernel's
//     sequential F axis carries one accumulator that parallel CTAs cannot
//     share, and no split-K with atomics keeps reruns bit-stable.
//
// Operand layouts: the weights (E, K, N) are N-contiguous, so a weight tile
// is always the MN-major operand (transpose flag 1); the activations (rows,
// K) are K-contiguous, the K-major operand (flag 0). (Not so in the
// backward, whose products read both transposed: moe_ffn_hopper_bwd.cuh.)

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe_ffn_hopper {

constexpr int BN = 64;                   // weight columns per CTA
constexpr int BK = 64;                   // depth per stage: one 128 B row
constexpr int TILE_BYTES = BK * BN * 2;  // one weight tile, 8 KB

enum Op { GATE_UP = 0, DOWN = 1 };

constexpr int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Shared-memory plan of one kernel variant. ROWS is the row block: the
// wgmma N of a SWAP variant, 64 rows per consumer warpgroup otherwise.
template <int OP, int ROWS, bool SWAP>
struct Cfg {
  static constexpr int NWG = SWAP ? 1 : ROWS / 64;   // consumer warpgroups
  static constexpr int THREADS = 128 * NWG + 32;     // + one producer warp
  static constexpr int N_W = OP == GATE_UP ? 2 : 1;  // weight tiles a stage
  static constexpr int ACT_BYTES = ROWS * BK * 2;
  static constexpr int STAGE_BYTES = N_W * TILE_BYTES + ACT_BYTES;
  // 3-4 slots, at most ~96 KB a CTA so that two CTAs share an SM
  static constexpr int STAGES = clampi(98304 / STAGE_BYTES, 3, 4);
  static constexpr int EPI_BYTES = SWAP ? ROWS * BN * 2 : 0;
  // + 1 KB so the ring can start on a 1024-byte boundary (the swizzle atom)
  static constexpr int SMEM =
      1024 + STAGES * STAGE_BYTES + EPI_BYTES + 2 * STAGES * 8;
  static_assert(SWAP ? (ROWS == 8 || ROWS == 16)
                     : (ROWS == 64 || ROWS == 128), "row block");
  static_assert(SMEM <= 232448, "more than a block's shared memory");
  // two CTAs an SM (228 KB, of which the runtime keeps 1 KB a CTA), so
  // that one CTA's cold start overlaps the other's stream
  static_assert(2 * (SMEM + 1024) <= 233472, "two CTAs do not fit an SM");
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. A phase that never
// completes is a fault (a byte count or arrival count that does not match):
// after 2^28 tries the kernel traps, so the launch fails instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 28)) asm volatile("trap;");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (layout type
// 1). K-major tiles: rows of 64 values along K, 8-row groups SBO = 1024 B
// apart (LBO unused). MN-major tiles: 64 values along M or N, K rows of
// 128 B, 8-row groups along K SBO = 1024 B apart, LBO the distance to the
// next 64-wide block along M or N (none here: every tile is 64 wide).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// D (64 x N, f32, registers) += A (64 x 16) B (16 x N), both bf16 from
// shared memory; TA / TB = 1 for an MN-major operand.
template <int N, int TA, int TB>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<8, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<16, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

struct Args {
  const int* tile_group;  // ragged: expert per bm tile (sentinel >= E)
  const int* row_off;     // ragged: first buffer row of each expert, and
  const int* sizes;       //   its real rows; null: every tile full
  __nv_bfloat16* out;     // h (gate/up) or y (down), rows of n_lim values
  int n_lim;              // output columns: F (gate/up) or D (down)
  int k_dim;              // reduction: D (gate/up) or F (down)
  int E;
  int bm;                 // ragged: rows per tile
  int C;                  // capacity: rows per expert
};

// One CTA: output columns [64 x, 64 x + 64) of one row block.
//   ragged, SWAP: the block is bm tile y; many rows: rows [ROWS y, ROWS y +
//     ROWS), inside one tile. Rows past the tile's real count are not
//     computed; the down launch writes them as zeros (sentinel tiles
//     whole), the gate/up launch leaves them.
//   capacity (CAP): expert z, all C rows (SWAP) or rows [ROWS y, ...)
//     below C; nothing is stored at or past C.
// act: the activation map (x or h), wa: W1 or W2, wb: W3 (gate/up).
template <int OP, int ROWS, bool SWAP, bool CAP>
__global__ void __launch_bounds__(Cfg<OP, ROWS, SWAP>::THREADS)
ffn_tma_kernel(const __grid_constant__ CUtensorMap act,
               const __grid_constant__ CUtensorMap wa,
               const __grid_constant__ CUtensorMap wb, const Args args) {
  using Config = Cfg<OP, ROWS, SWAP>;
  constexpr int STAGES = Config::STAGES;
  constexpr int NWG = Config::NWG;
  constexpr int MMA_ROWS = SWAP ? ROWS : 64;  // rows one warpgroup computes

  const int col0 = static_cast<int>(blockIdx.x) * BN;
  int e, row0, span, real;
  if constexpr (CAP) {
    e = static_cast<int>(blockIdx.z);
    row0 = SWAP ? 0 : static_cast<int>(blockIdx.y) * ROWS;
    span = SWAP ? args.C : min(ROWS, args.C - row0);
    real = span;
  } else {
    const int by = static_cast<int>(blockIdx.y);
    const int tile = SWAP ? by : by * ROWS / args.bm;
    row0 = SWAP ? tile * args.bm : by * ROWS;
    span = SWAP ? args.bm : ROWS;
    e = args.tile_group[tile];
    // real rows of the tile: those below the end of its expert's rows
    int tr = 0;
    if (e >= 0 && e < args.E) {
      tr = args.sizes ? args.row_off[e] + args.sizes[e] - tile * args.bm
                      : args.bm;
    }
    real = max(0, min(tr - (row0 - tile * args.bm), span));
  }
  // computed rows, rounded up to the row block of one wgmma
  const int chunks = (real + MMA_ROWS - 1) / MMA_ROWS;
  const int store_lim = min(chunks * MMA_ROWS, span);
  const int64_t out_row0 =
      (CAP ? static_cast<int64_t>(e) * args.C : 0) + row0;
  __nv_bfloat16* out = args.out + out_row0 * args.n_lim;

  if constexpr (!CAP && OP == DOWN) {
    // rows past the computed ones: exact zeros, 16 bytes a store
    const int vecs = min(BN, args.n_lim - col0) / 8;
    const int n = (span - store_lim) * vecs;
    for (int i = threadIdx.x; i < n; i += Config::THREADS) {
      const int r = store_lim + i / vecs;
      __nv_bfloat16* dst =
          out + static_cast<int64_t>(r) * args.n_lim + col0 + (i % vecs) * 8;
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  if (real == 0) return;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* epi =
      reinterpret_cast<__nv_bfloat16*>(smem + STAGES * Config::STAGE_BYTES);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full =
      ring + STAGES * Config::STAGE_BYTES + Config::EPI_BYTES;
  const uint32_t empty = full + STAGES * 8;
  auto w_tile = [&](int s, int j) {
    return ring + s * Config::STAGE_BYTES + j * TILE_BYTES;
  };
  auto act_tile = [&](int s) {
    return ring + s * Config::STAGE_BYTES + Config::N_W * TILE_BYTES;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int kt_n = (args.k_dim + BK - 1) / BK;
  const int iters = (SWAP ? chunks : 1) * kt_n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == 4 * NWG) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % STAGES;
        const int round = it / STAGES;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const int k0 = (it % kt_n) * BK;
        const int r0 = row0 + (SWAP ? (it / kt_n) * ROWS : 0);
        mbar_expect_tx(full + 8 * s, Config::STAGE_BYTES);
        tma_load_3d(w_tile(s, 0), &wa, full + 8 * s, col0, k0, e);
        if constexpr (OP == GATE_UP) {
          tma_load_3d(w_tile(s, 1), &wb, full + 8 * s, col0, k0, e);
        }
        if constexpr (CAP) {
          tma_load_3d(act_tile(s), &act, full + 8 * s, k0, r0, e);
        } else {
          tma_load_2d(act_tile(s), &act, full + 8 * s, k0, r0);
        }
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4;
  const bool active = SWAP || wg * 64 < real;
  constexpr int ACC = SWAP ? ROWS / 2 : 32;
  constexpr int NMMA = SWAP ? ROWS : 64;
  float acc1[ACC], acc3[ACC];
  int it = 0;
  for (int c = 0; c < (SWAP ? chunks : 1); ++c) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      acc1[i] = 0.0f;
      acc3[i] = 0.0f;
    }
    for (int kt = 0; kt < kt_n; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      if (active) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // MN-major weight tile: 16 K rows of 128 B a step; K-major
          // activation tile: 32 B a step inside its 128 B rows
          const uint64_t w1d = sw128_desc(w_tile(s, 0) + kk * 2048,
                                          TILE_BYTES);
          const uint64_t ad = sw128_desc(
              act_tile(s) + (SWAP ? 0 : wg * 64 * 128) + kk * 32, 16);
          if constexpr (SWAP) {
            Wgmma<NMMA, 1, 0>::run(acc1, w1d, ad);
          } else {
            Wgmma<NMMA, 0, 1>::run(acc1, ad, w1d);
          }
          if constexpr (OP == GATE_UP) {
            const uint64_t w3d = sw128_desc(w_tile(s, 1) + kk * 2048,
                                            TILE_BYTES);
            if constexpr (SWAP) {
              Wgmma<NMMA, 1, 0>::run(acc3, w3d, ad);
            } else {
              Wgmma<NMMA, 0, 1>::run(acc3, ad, w3d);
            }
          }
        }
        wgmma_commit();
        wgmma_wait_all();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    if (!active) continue;

    // accumulator element i of a thread: 8-column group q = i / 4, row
    // 16 w + lane / 4 + 8 ((i / 2) % 2), column 8 q + 2 (lane % 4) + i % 2
    // (w = warp in the warpgroup); M x N is columns x rows when SWAP
    const int wq = warp % 4;
    float v[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      v[i] = OP == GATE_UP ? silu(acc1[i]) * acc3[i] : acc1[i];
    }
    if constexpr (SWAP) {
      // stage the (ROWS x 64) block in shared memory, then 16-byte stores
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int m = 16 * wq + lane / 4 + 8 * ((i / 2) % 2);
        const int n = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        epi[n * BN + m] = __float2bfloat16(v[i]);
      }
      asm volatile("bar.sync 1, 128;" ::: "memory");
      const int vecs = min(BN, args.n_lim - col0) / 8;
      for (int i = threadIdx.x; i < ROWS * 8; i += 128) {
        const int r = i / 8;
        const int q = i % 8;
        const int row = c * ROWS + r;
        if (row < store_lim && q < vecs) {
          *reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) *
                                              args.n_lim + col0 + q * 8) =
              *reinterpret_cast<const uint4*>(epi + r * BN + q * 8);
        }
      }
      asm volatile("bar.sync 1, 128;" ::: "memory");
    } else {
#pragma unroll
      for (int i = 0; i < ACC; i += 2) {
        const int row = wg * 64 + 16 * wq + lane / 4 + 8 * ((i / 2) % 2);
        const int col = col0 + 8 * (i / 4) + 2 * (lane % 4);
        if (row < store_lim && col < args.n_lim) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<int64_t>(row) * args.n_lim + col) =
              __floats2bfloat162_rn(v[i], v[i + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library needs no -lcuda
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A bf16 map of rank 2 or 3 over a contiguous tensor, dims innermost first,
// box (64, box_rows[, 1]), 128-byte swizzle, zeros out of bounds.
inline bool encode_map(CUtensorMap* m, const void* ptr, int rank,
                       const uint64_t* dims, uint32_t box_rows) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t gdim[3] = {dims[0], dims[1], rank > 2 ? dims[2] : 1};
  cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  cuuint32_t box[3] = {64, box_rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
            gdim, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Weight maps (E, R, N) with a (64, 64, 1) box, cached by (pointer, shape):
// the same layers' weights come back every step. New storage (a placement
// update) simply misses.
inline bool weight_map(CUtensorMap* out, const void* ptr, int E, int R,
                       int N) {
  struct Entry {
    const void* ptr;
    int E, R, N;
    CUtensorMap map;
  };
  static Entry cache[256];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& c = cache[i];
    if (c.ptr == ptr && c.E == E && c.R == R && c.N == N) {
      *out = c.map;
      return true;
    }
  }
  Entry& slot = cache[next];
  const uint64_t dims[3] = {static_cast<uint64_t>(N),
                            static_cast<uint64_t>(R),
                            static_cast<uint64_t>(E)};
  if (!encode_map(out, ptr, 3, dims, BK)) return false;
  slot.map = *out;
  slot.ptr = ptr;
  slot.E = E;
  slot.R = R;
  slot.N = N;
  next = (next + 1) % 256;
  if (used < 256) ++used;
  return true;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising its
// limit before its first launch (`ready`, a flag of the caller's: above
// 48 KB a launch is refused otherwise). Returns cudaGetLastError().
template <typename Kernel, typename... Params>
cudaError_t launch_smem(Kernel kernel, bool& ready, dim3 grid, int threads,
                        int smem, cudaStream_t stream,
                        const Params&... params) {
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  kernel<<<grid, threads, smem, stream>>>(params...);
  return cudaGetLastError();
}

// Launch one variant.
template <int OP, int ROWS, bool SWAP, bool CAP>
cudaError_t launch(dim3 grid, const CUtensorMap& act, const CUtensorMap& wa,
                   const CUtensorMap& wb, const Args& args,
                   cudaStream_t stream) {
  using Config = Cfg<OP, ROWS, SWAP>;
  static bool ready = false;
  return launch_smem(ffn_tma_kernel<OP, ROWS, SWAP, CAP>, ready, grid,
                     Config::THREADS, Config::SMEM, stream, act, wa, wb,
                     args);
}

}  // namespace moe_ffn_hopper
