// Ragged grouped SwiGLU expert FFN for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernel ragged_moe_ffn_pallas
// (src/repro/kernels/ragged_moe_ffn.py:101). Same contract: toks (T, D) is a
// flat expert-sorted buffer, each expert's segment padded to a multiple of
// the row tile bm; tile_group (T / bm) names each tile's expert, or the
// sentinel E for an unoccupied tile, whose output rows are written as exact
// zeros. Per occupied tile with expert g:
//     y = (silu(x W1[g]) * (x W3[g])) W2[g]
// with f32 accumulation and h rounded to bf16 before the down projection,
// as the Pallas kernel does.
//
// What bounds it on an H100: the expert weights. One layer of the granite
// slice (E = 40, D = 1536, F = 512) holds 40 * 3 * 1536 * 512 * 2 B =
// 188.7 MB, about 56 us at 3.35 TB/s if every expert is occupied. A
// 512-token prefill routes 4096 assignments, 19.3 GFLOP of useful work
// (about 20 us at 989 TFLOP/s), so it too sits below the memory bound; a
// decode step reads the weights of up to 40 experts for a few rows each.
//
// Design (a first, simple kernel; wgmma, TMA and a persistent schedule are
// later work):
//   kernel A (gate/up): grid (T / RB, ceil(F / BN)). A block reads its own
//     tile_group entry and returns at once on a sentinel. Otherwise it
//     computes an RB x BN block of x W1 and x W3 with bf16 WMMA 16x16x16
//     fragments through shared-memory tiles (BK deep), applies
//     silu(a) * b in f32 on the accumulator fragments, and writes the block
//     of h (T, F) in bf16. h is a scratch buffer the wrapper allocates.
//   kernel B (down): grid (T / RB, ceil(D / BN)). y = h W2[g] the same way;
//     sentinel blocks write zeros.
// Edges in D and F are masked inside the kernels (zero-filled tiles, masked
// stores), so the weights are never padded per call. Each block of RB rows
// lies inside one bm tile (the wrapper checks bm % RB == 0), so it reads
// one expert's weights. Shared memory per block: A 64x40 bf16 (5 KB), two
// B tiles 32x72 bf16 (9 KB), the f32 epilogue tile 64x68 (17 KB): 31 KB of
// static shared memory, under the 48 KB static limit, several blocks per SM.
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

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

// h[rows, n0:n0+BN] = silu(x W1[g]) * (x W3[g]) for one RB-row block.
__global__ void __launch_bounds__(THREADS)
gate_up_kernel(const __nv_bfloat16* __restrict__ toks,
               const int* __restrict__ tile_group,
               const __nv_bfloat16* __restrict__ w1,
               const __nv_bfloat16* __restrict__ w3,
               __nv_bfloat16* __restrict__ h, int D, int F, int E, int bm,
               bool vec_ok) {
  const int row0 = blockIdx.x * RB;
  const int g = tile_group[row0 / bm];
  if (g >= E || g < 0) return;  // sentinel: kernel B writes the zeros
  const int n0 = blockIdx.y * BN;

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
  const __nv_bfloat16* x = toks + static_cast<int64_t>(row0) * D;
  const __nv_bfloat16* W1 = w1 + static_cast<int64_t>(g) * D * F;
  const __nv_bfloat16* W3 = w3 + static_cast<int64_t>(g) * D * F;

  for (int k0 = 0; k0 < D; k0 += BK) {
    load_tile<RB, BK, A_LD>(As, x, D, 0, k0, RB, D, vec_ok);
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
  for (int i = threadIdx.x; i < RB * BN; i += THREADS) {
    const int r = i / BN;
    const int c = i % BN;
    if (n0 + c < F) {
      h[static_cast<int64_t>(row0 + r) * F + n0 + c] =
          __float2bfloat16(Cs[r * C_LD + c]);
    }
  }
}

// out[rows, n0:n0+BN] = h W2[g]; sentinel blocks write zeros.
__global__ void __launch_bounds__(THREADS)
down_kernel(const __nv_bfloat16* __restrict__ h,
            const int* __restrict__ tile_group,
            const __nv_bfloat16* __restrict__ w2,
            __nv_bfloat16* __restrict__ out, int D, int F, int E, int bm,
            bool vec_ok) {
  const int row0 = blockIdx.x * RB;
  const int g = tile_group[row0 / bm];
  const int n0 = blockIdx.y * BN;
  if (g >= E || g < 0) {
    for (int i = threadIdx.x; i < RB * BN; i += THREADS) {
      const int r = i / BN;
      const int c = i % BN;
      if (n0 + c < D) {
        out[static_cast<int64_t>(row0 + r) * D + n0 + c] =
            __float2bfloat16(0.0f);
      }
    }
    return;
  }

  __shared__ __align__(128) __nv_bfloat16 As[RB * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[RB * C_LD];

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  FragC acc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);
  const __nv_bfloat16* hx = h + static_cast<int64_t>(row0) * F;
  const __nv_bfloat16* W2 = w2 + static_cast<int64_t>(g) * F * D;

  for (int k0 = 0; k0 < F; k0 += BK) {
    load_tile<RB, BK, A_LD>(As, hx, F, 0, k0, RB, F, vec_ok);
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
  for (int i = threadIdx.x; i < RB * BN; i += THREADS) {
    const int r = i / BN;
    const int c = i % BN;
    if (n0 + c < D) {
      out[static_cast<int64_t>(row0 + r) * D + n0 + c] =
          __float2bfloat16(Cs[r * C_LD + c]);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// toks (T, D), tile_group (T / bm), w1/w3 (E, D, F), w2 (E, F, D), scratch
// h (T, F) and out (T, D); all bf16 but tile_group (int32), contiguous, on
// the current device. Returns cudaGetLastError() after the two launches.
int ragged_moe_ffn_bf16(const void* toks, const void* tile_group,
                        const void* w1, const void* w3, const void* w2,
                        void* h, void* out, int T, int D, int F, int E,
                        int bm, void* stream) {
  if (T % RB != 0 || bm % RB != 0 || T <= 0 || D <= 0 || F <= 0 || E <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_ok = D % 8 == 0 && F % 8 == 0 && aligned16(toks) &&
                      aligned16(w1) && aligned16(w3) && aligned16(w2) &&
                      aligned16(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(THREADS);
  const dim3 grid_a(T / RB, (F + BN - 1) / BN);
  gate_up_kernel<<<grid_a, block, 0, s>>>(
      static_cast<const __nv_bfloat16*>(toks),
      static_cast<const int*>(tile_group),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w3),
      static_cast<__nv_bfloat16*>(h), D, F, E, bm, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(T / RB, (D + BN - 1) / BN);
  down_kernel<<<grid_b, block, 0, s>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const int*>(tile_group),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<__nv_bfloat16*>(out), D, F, E, bm, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
