// Block-level pieces of the general route of the grouped SwiGLU expert FFN
// kernels (sm_90a), shared by ragged_moe_ffn.cu and moe_ffn.cu: the route
// for shapes a TMA descriptor cannot describe (D or F not a multiple of 8,
// an operand not 16-byte aligned); moe_ffn_hopper.cuh holds the TMA route
// that every other shape takes. bf16 in and out,
// f32 accumulation, h rounded to bf16 before the down projection, as the
// Pallas kernels do.
//
// One thread block computes an RB x BN output block of one expert from
// `rows` (<= RB) valid input rows starting at its first row pointer:
//   gate_up_block: h[:, n0:n0+BN] = silu(x W1) * (x W3)
//   down_block:    y[:, n0:n0+BN] = h W2
// with bf16 WMMA 16x16x16 fragments over BK-deep shared-memory tiles.
// Input rows at or past `rows` load as zeros and are never stored; edges in
// D and F are masked the same way (zero-filled tiles, masked stores), so no
// operand is ever padded per call. Shared memory per block: the A tile
// 64x40 bf16 (5 KB), one or two B tiles 32x72 bf16 (4.5 KB each), the f32
// epilogue tile 64x68 (17 KB): at most 31 KB, under the 48 KB static limit,
// so several blocks share an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace moe_ffn_blocks {

using namespace nvcuda;

constexpr int RB = 64;        // rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // reduction depth per shared-memory tile
constexpr int THREADS = 256;  // 8 warps: 4 along rows x 2 along columns
constexpr int A_LD = BK + 8;  // padded leading dims (multiples of 8 for
constexpr int B_LD = BN + 8;  // bf16 WMMA, of 4 for the f32 tile)
constexpr int C_LD = BN + 4;

// Copy a ROWS x COLS bf16 tile of a row-major matrix (row stride ld) from
// (r0, c0) into shared memory, zero-filling everything at or past
// (row_lim, col_lim). Each thread moves chunks of 8 values: one 16-byte
// load where the chunk is in bounds and aligned, single values otherwise.
template <int ROWS, int COLS, int SLD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* __restrict__ s,
                                          const __nv_bfloat16* __restrict__ g,
                                          int64_t ld, int r0, int c0,
                                          int row_lim, int col_lim,
                                          bool vec_ok) {
  constexpr int CHUNKS = ROWS * COLS / 8;
  for (int ch = threadIdx.x; ch < CHUNKS; ch += THREADS) {
    const int r = ch / (COLS / 8);
    const int c = (ch % (COLS / 8)) * 8;
    const int gr = r0 + r;
    const int gc = c0 + c;
    __nv_bfloat16* dst = s + r * SLD + c;
    if (gr < row_lim && vec_ok && gc + 8 <= col_lim) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(g + gr * ld + gc);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dst[j] = (gr < row_lim && gc + j < col_lim)
                     ? g[gr * ld + gc + j]
                     : __float2bfloat16(0.0f);
      }
    }
  }
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Write the block's f32 epilogue tile Cs as bf16 into dst (row stride ld),
// rows < rows and columns n0 + c < n_lim only.
__device__ __forceinline__ void store_block(__nv_bfloat16* __restrict__ dst,
                                            const float* __restrict__ Cs,
                                            int64_t ld, int rows, int n0,
                                            int n_lim) {
  for (int i = threadIdx.x; i < RB * BN; i += THREADS) {
    const int r = i / BN;
    const int c = i % BN;
    if (r < rows && n0 + c < n_lim) {
      dst[r * ld + n0 + c] = __float2bfloat16(Cs[r * C_LD + c]);
    }
  }
}

// h[r, n0:n0+BN] = silu(x[r] W1) * (x[r] W3) for r < rows. x (rows, D) and
// h (rows, F) point at the block's first row; W1/W3 (D, F) are one expert's.
__device__ __forceinline__ void gate_up_block(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ W1,
    const __nv_bfloat16* __restrict__ W3, __nv_bfloat16* __restrict__ h,
    int rows, int n0, int D, int F, bool vec_ok) {
  __shared__ __align__(128) __nv_bfloat16 As[RB * A_LD];
  __shared__ __align__(128) __nv_bfloat16 B1s[BK * B_LD];
  __shared__ __align__(128) __nv_bfloat16 B3s[BK * B_LD];
  __shared__ __align__(128) float Cs[RB * C_LD];

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;  // 0..3: 16-row slice
  const int wn = warp % 2;  // 0..1: 32-column slice
  FragC acc1[2], acc3[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::fill_fragment(acc1[j], 0.0f);
    wmma::fill_fragment(acc3[j], 0.0f);
  }
  for (int k0 = 0; k0 < D; k0 += BK) {
    load_tile<RB, BK, A_LD>(As, x, D, 0, k0, rows, D, vec_ok);
    load_tile<BK, BN, B_LD>(B1s, W1, F, k0, n0, D, F, vec_ok);
    load_tile<BK, BN, B_LD>(B3s, W3, F, k0, n0, D, F, vec_ok);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, As + wm * 16 * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, B1s + kk * B_LD + wn * 32 + j * 16, B_LD);
        wmma::mma_sync(acc1[j], a, b, acc1[j]);
        wmma::load_matrix_sync(b, B3s + kk * B_LD + wn * 32 + j * 16, B_LD);
        wmma::mma_sync(acc3[j], a, b, acc3[j]);
      }
    }
    __syncthreads();
  }
  // fragments of one type share their element layout, so the SwiGLU
  // epilogue is elementwise on the accumulators
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < acc1[j].num_elements; ++e) {
      acc1[j].x[e] = silu(acc1[j].x[e]) * acc3[j].x[e];
    }
    wmma::store_matrix_sync(Cs + wm * 16 * C_LD + wn * 32 + j * 16, acc1[j],
                            C_LD, wmma::mem_row_major);
  }
  __syncthreads();
  store_block(h, Cs, F, rows, n0, F);
}

// y[r, n0:n0+BN] = h[r] W2 for r < rows. h (rows, F) and y (rows, D) point
// at the block's first row; W2 (F, D) is one expert's.
__device__ __forceinline__ void down_block(
    const __nv_bfloat16* __restrict__ hx, const __nv_bfloat16* __restrict__ W2,
    __nv_bfloat16* __restrict__ y, int rows, int n0, int D, int F,
    bool vec_ok) {
  __shared__ __align__(128) __nv_bfloat16 As[RB * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[RB * C_LD];

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  FragC acc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < F; k0 += BK) {
    load_tile<RB, BK, A_LD>(As, hx, F, 0, k0, rows, F, vec_ok);
    load_tile<BK, BN, B_LD>(Bs, W2, D, k0, n0, F, D, vec_ok);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, As + wm * 16 * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(Cs + wm * 16 * C_LD + wn * 32 + j * 16, acc[j],
                            C_LD, wmma::mem_row_major);
  }
  __syncthreads();
  store_block(y, Cs, D, rows, n0, D);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace moe_ffn_blocks
