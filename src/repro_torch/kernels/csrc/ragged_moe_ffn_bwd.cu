// Backward of the ragged grouped SwiGLU expert FFN for Hopper (sm_90a).
//
// The TPU kernel ragged_moe_ffn_pallas (src/repro/kernels/ragged_moe_ffn.py:
// 101) has no gradient: the reference trains through its jnp oracle. The
// port trains through its forward kernel (ragged_moe_ffn.cu), so its
// backward is two kernels of its own, over the same layout (a flat
// expert-sorted buffer, each expert's segment padded to the row tile bm,
// tile_group naming each tile's expert or the sentinel E) and only the
// real rows the plan names (row_offsets, sizes):
//
//   K1, dgrad (ragged_moe_ffn_dgrad_*), two launches over row blocks:
//     A: a = x W1[g], b = x W3[g] recomputed in f32, dh = dy W2[g]^T, then
//        da = dh b s(a)(1 + a(1 - s(a))), db = dh silu(a), stored in bf16;
//     B: dx = da W1[g]^T + db W3[g]^T in bf16; padding rows and sentinel
//        tiles come out exact zeros.
//   K2, wgrad (ragged_moe_ffn_wgrad_*), two launches over (column block,
//     row block, expert): dW1[g] = x^T da and dW3[g] = x^T db, then
//     dW2[g] = h^T dy, each summed in f32 over the expert's real rows
//     [row_off[g], row_off[g] + sizes[g]) in a fixed order and written in
//     bf16; an expert with no rows gets exact zeros.
// h is the forward's bf16 scratch, kept as the saved activation.
//
// Two routes, chosen by the wrapper from shapes and pointers:
//   ragged_moe_ffn_{dgrad,wgrad}_tma_bf16 (moe_ffn_hopper_bwd.cuh): the
//     forward's TMA ring and wgmma, for D and F multiples of 8 and 16-byte
//     aligned operands; what bounds each kernel on an H100 and how the
//     design meets it is noted there.
//   ragged_moe_ffn_{dgrad,wgrad}_bf16 (below): the general route, simple
//     WMMA (bf16 16x16x16, f32 accumulate) over synchronous 16-byte loads
//     with masked edges (moe_ffn_blocks.cuh), for every other shape. The
//     weights are read transposed against the forward's layout: W2[g] is
//     (F, D) row-major, so W2^T is (D, F) column-major, and a tile of W2's
//     rows [n0, n0 + 64) and columns [k0, k0 + 32) in shared memory is
//     W2^T's (32 x 64) tile in column-major order, which a WMMA col_major B
//     fragment reads as it stands; likewise W1^T, W3^T for dx and x^T, h^T
//     (the A operands of K2) as col_major A fragments.
// No operand is transposed in memory, and no route uses atomics: every
// output element is one block's alone, so two runs are bit-identical.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <initializer_list>

#include "moe_ffn_blocks.cuh"
#include "moe_ffn_hopper_bwd.cuh"

using namespace moe_ffn_blocks;

namespace {

using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;

// Real rows of the 64-row block starting at row0, and its expert (0 rows
// on a sentinel tile and past the expert's real rows).
__device__ __forceinline__ int block_rows(int row0, int bm,
                                          const int* tile_group,
                                          const int* row_off,
                                          const int* sizes, int E, int& g) {
  g = tile_group[row0 / bm];
  if (g < 0 || g >= E) return 0;
  return max(0, min(RB, row_off[g] + sizes[g] - row0));
}

// Write the block's f32 tile Cs as bf16 into dst (row stride ld): rows
// below `rows` from Cs, the rest of the RB rows as zeros; columns n0 + c
// below n_lim.
__device__ __forceinline__ void store_rows_zero_rest(
    __nv_bfloat16* __restrict__ dst, const float* __restrict__ Cs,
    int64_t ld, int rows, int n0, int n_lim) {
  for (int i = threadIdx.x; i < RB * BN; i += THREADS) {
    const int r = i / BN;
    const int c = i % BN;
    if (n0 + c < n_lim) {
      dst[r * ld + n0 + c] =
          __float2bfloat16(r < rows ? Cs[r * C_LD + c] : 0.0f);
    }
  }
}

// K1 launch A: da, db for the block's rows and columns [n0, n0 + BN) of F.
__global__ void __launch_bounds__(THREADS)
dgrad_gate_kernel(const __nv_bfloat16* __restrict__ toks,
                  const __nv_bfloat16* __restrict__ dy,
                  const int* __restrict__ tile_group,
                  const int* __restrict__ row_off,
                  const int* __restrict__ sizes,
                  const __nv_bfloat16* __restrict__ w1,
                  const __nv_bfloat16* __restrict__ w3,
                  const __nv_bfloat16* __restrict__ w2,
                  __nv_bfloat16* __restrict__ da,
                  __nv_bfloat16* __restrict__ db, int D, int F, int E, int bm,
                  bool vec_ok) {
  __shared__ __align__(128) __nv_bfloat16 Xs[RB * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Ys[RB * A_LD];
  __shared__ __align__(128) __nv_bfloat16 B1s[BK * B_LD];
  __shared__ __align__(128) __nv_bfloat16 B3s[BK * B_LD];
  __shared__ __align__(128) __nv_bfloat16 B2t[BN * A_LD];
  __shared__ __align__(128) float Cs[RB * C_LD];

  const int row0 = blockIdx.x * RB;
  int g;
  const int rows = block_rows(row0, bm, tile_group, row_off, sizes, E, g);
  if (rows == 0) return;  // K2 and launch B read real rows only
  const int n0 = blockIdx.y * BN;
  const int64_t wo = static_cast<int64_t>(g) * D * F;
  const __nv_bfloat16* x = toks + static_cast<int64_t>(row0) * D;
  const __nv_bfloat16* gy = dy + static_cast<int64_t>(row0) * D;
  const __nv_bfloat16* W1 = w1 + wo;
  const __nv_bfloat16* W3 = w3 + wo;
  const __nv_bfloat16* W2 = w2 + wo;   // (F, D)

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;  // 16-row slice
  const int wn = warp % 2;  // 32-column slice
  FragC acc_a[2], acc_b[2], acc_h[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::fill_fragment(acc_a[j], 0.0f);
    wmma::fill_fragment(acc_b[j], 0.0f);
    wmma::fill_fragment(acc_h[j], 0.0f);
  }
  for (int k0 = 0; k0 < D; k0 += BK) {
    load_tile<RB, BK, A_LD>(Xs, x, D, 0, k0, rows, D, vec_ok);
    load_tile<RB, BK, A_LD>(Ys, gy, D, 0, k0, rows, D, vec_ok);
    load_tile<BK, BN, B_LD>(B1s, W1, F, k0, n0, D, F, vec_ok);
    load_tile<BK, BN, B_LD>(B3s, W3, F, k0, n0, D, F, vec_ok);
    // W2's rows [n0, n0 + BN), columns [k0, k0 + BK): W2^T's tile,
    // column-major
    load_tile<BN, BK, A_LD>(B2t, W2, D, n0, k0, F, D, vec_ok);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a, y;
      wmma::load_matrix_sync(a, Xs + wm * 16 * A_LD + kk, A_LD);
      wmma::load_matrix_sync(y, Ys + wm * 16 * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + j * 16;
        FragB b;
        wmma::load_matrix_sync(b, B1s + kk * B_LD + c, B_LD);
        wmma::mma_sync(acc_a[j], a, b, acc_a[j]);
        wmma::load_matrix_sync(b, B3s + kk * B_LD + c, B_LD);
        wmma::mma_sync(acc_b[j], a, b, acc_b[j]);
        FragBc bt;
        wmma::load_matrix_sync(bt, B2t + c * A_LD + kk, A_LD);
        wmma::mma_sync(acc_h[j], y, bt, acc_h[j]);
      }
    }
    __syncthreads();
  }
  // accumulators of one type share their element layout: the epilogue is
  // elementwise. acc_a becomes da, acc_b becomes db.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < acc_a[j].num_elements; ++e) {
      const float av = acc_a[j].x[e];
      const float bv = acc_b[j].x[e];
      const float dh = acc_h[j].x[e];
      const float s = 1.0f / (1.0f + expf(-av));
      acc_a[j].x[e] = dh * bv * s * (1.0f + av * (1.0f - s));
      acc_b[j].x[e] = dh * (av * s);
    }
  }
  __nv_bfloat16* outs[2] = {da + static_cast<int64_t>(row0) * F,
                            db + static_cast<int64_t>(row0) * F};
#pragma unroll
  for (int o = 0; o < 2; ++o) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs + wm * 16 * C_LD + wn * 32 + j * 16,
                              o == 0 ? acc_a[j] : acc_b[j], C_LD,
                              wmma::mem_row_major);
    }
    __syncthreads();
    store_block(outs[o], Cs, F, rows, n0, F);
    __syncthreads();
  }
}

// K1 launch B: dx for the block's rows and columns [n0, n0 + BN) of D.
__global__ void __launch_bounds__(THREADS)
dgrad_x_kernel(const __nv_bfloat16* __restrict__ da,
               const __nv_bfloat16* __restrict__ db,
               const int* __restrict__ tile_group,
               const int* __restrict__ row_off,
               const int* __restrict__ sizes,
               const __nv_bfloat16* __restrict__ w1,
               const __nv_bfloat16* __restrict__ w3,
               __nv_bfloat16* __restrict__ dx, int D, int F, int E, int bm,
               bool vec_ok) {
  __shared__ __align__(128) __nv_bfloat16 As[RB * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[RB * A_LD];
  __shared__ __align__(128) __nv_bfloat16 W1t[BN * A_LD];
  __shared__ __align__(128) __nv_bfloat16 W3t[BN * A_LD];
  __shared__ __align__(128) float Cs[RB * C_LD];

  const int row0 = blockIdx.x * RB;
  const int n0 = blockIdx.y * BN;
  int g;
  const int rows = block_rows(row0, bm, tile_group, row_off, sizes, E, g);
  __nv_bfloat16* out = dx + static_cast<int64_t>(row0) * D;
  if (rows == 0) {
    for (int i = threadIdx.x; i < RB * BN; i += THREADS) {
      const int r = i / BN;
      const int c = i % BN;
      if (n0 + c < D) out[r * static_cast<int64_t>(D) + n0 + c] =
          __float2bfloat16(0.0f);
    }
    return;
  }
  const int64_t wo = static_cast<int64_t>(g) * D * F;
  const __nv_bfloat16* A1 = da + static_cast<int64_t>(row0) * F;
  const __nv_bfloat16* A3 = db + static_cast<int64_t>(row0) * F;
  const __nv_bfloat16* W1 = w1 + wo;   // (D, F)
  const __nv_bfloat16* W3 = w3 + wo;

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  FragC acc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < F; k0 += BK) {
    load_tile<RB, BK, A_LD>(As, A1, F, 0, k0, rows, F, vec_ok);
    load_tile<RB, BK, A_LD>(Bs, A3, F, 0, k0, rows, F, vec_ok);
    // W1's rows [n0, n0 + BN), columns [k0, k0 + BK): W1^T's tile,
    // column-major
    load_tile<BN, BK, A_LD>(W1t, W1, F, n0, k0, D, F, vec_ok);
    load_tile<BN, BK, A_LD>(W3t, W3, F, n0, k0, D, F, vec_ok);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a1, a3;
      wmma::load_matrix_sync(a1, As + wm * 16 * A_LD + kk, A_LD);
      wmma::load_matrix_sync(a3, Bs + wm * 16 * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + j * 16;
        FragBc b;
        wmma::load_matrix_sync(b, W1t + c * A_LD + kk, A_LD);
        wmma::mma_sync(acc[j], a1, b, acc[j]);
        wmma::load_matrix_sync(b, W3t + c * A_LD + kk, A_LD);
        wmma::mma_sync(acc[j], a3, b, acc[j]);
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
  store_rows_zero_rest(out, Cs, D, rows, n0, D);
}

// K2: out[g][m0:m0+RB, n0:n0+BN] = A^T B summed over expert g's real rows,
// for one or two B operands (out1 = A^T B1, out3 = A^T B3). A (rows, M) and
// B (rows, N) row-major with the buffer's row indexing; out (M, N)
// row-major. Grid: (N / BN, M / RB, E).
template <bool TWO>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const __nv_bfloat16* __restrict__ a,
             const __nv_bfloat16* __restrict__ b1,
             const __nv_bfloat16* __restrict__ b3,
             const int* __restrict__ row_off, const int* __restrict__ sizes,
             __nv_bfloat16* __restrict__ out1,
             __nv_bfloat16* __restrict__ out3, int M, int N, bool vec_ok) {
  // A^T's tile: the rows [r0, r0 + BK) and columns [m0, m0 + RB) of A,
  // row-major (BK x RB), which a col_major A fragment reads as (RB x BK)
  __shared__ __align__(128) __nv_bfloat16 At[BK * B_LD];
  __shared__ __align__(128) __nv_bfloat16 B1s[BK * B_LD];
  __shared__ __align__(128) __nv_bfloat16 B3s[TWO ? BK * B_LD : 8];
  __shared__ __align__(128) float Cs[RB * C_LD];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * RB;
  const int g = blockIdx.z;
  const int start = row_off[g];
  const int n_rows = sizes[g];
  const __nv_bfloat16* A = a + static_cast<int64_t>(start) * M;
  const __nv_bfloat16* B1 = b1 + static_cast<int64_t>(start) * N;
  const __nv_bfloat16* B3 = TWO ? b3 + static_cast<int64_t>(start) * N
                                : nullptr;

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  FragC acc1[2], acc3[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::fill_fragment(acc1[j], 0.0f);
    wmma::fill_fragment(acc3[j], 0.0f);
  }
  // A and B are row-major (rows, M) and (rows, N): the A tile is BK rows of
  // RB columns (load_tile's B shape), the B tiles BK rows of BN columns
  static_assert(RB == BN, "the A^T tile reuses the B tile shape");
  for (int r0 = 0; r0 < n_rows; r0 += BK) {
    load_tile<BK, RB, B_LD>(At, A, M, r0, m0, n_rows, M, vec_ok);
    load_tile<BK, BN, B_LD>(B1s, B1, N, r0, n0, n_rows, N, vec_ok);
    if (TWO) load_tile<BK, BN, B_LD>(B3s, B3, N, r0, n0, n_rows, N, vec_ok);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragAc at;
      wmma::load_matrix_sync(at, At + kk * B_LD + wm * 16, B_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + j * 16;
        FragB b;
        wmma::load_matrix_sync(b, B1s + kk * B_LD + c, B_LD);
        wmma::mma_sync(acc1[j], at, b, acc1[j]);
        if (TWO) {
          wmma::load_matrix_sync(b, B3s + kk * B_LD + c, B_LD);
          wmma::mma_sync(acc3[j], at, b, acc3[j]);
        }
      }
    }
    __syncthreads();
  }
  const int64_t oo = static_cast<int64_t>(g) * M * N +
                     static_cast<int64_t>(m0) * N;
  const int rows = min(RB, M - m0);
#pragma unroll
  for (int o = 0; o < (TWO ? 2 : 1); ++o) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs + wm * 16 * C_LD + wn * 32 + j * 16,
                              o == 0 ? acc1[j] : acc3[j], C_LD,
                              wmma::mem_row_major);
    }
    __syncthreads();
    store_block((o == 0 ? out1 : out3) + oo, Cs, N, rows, n0, N);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// K1. toks and dy (T, D), tile_group (T / bm), row_offsets (E + 1) and
// sizes (E) int32, w1/w3 (E, D, F), w2 (E, F, D) -> da and db (T, F) (real
// rows written) and dx (T, D) (every row written; padding and sentinel rows
// zero). bf16 but the int32 plan, contiguous, on the current device; bm a
// multiple of 64. Returns cudaGetLastError() after the two launches.
int ragged_moe_ffn_dgrad_bf16(const void* toks, const void* dy,
                              const void* tile_group, const void* row_offsets,
                              const void* sizes, const void* w1,
                              const void* w3, const void* w2, void* da,
                              void* db, void* dx, int T, int D, int F, int E,
                              int bm, void* stream) {
  if (T <= 0 || D <= 0 || F <= 0 || E <= 0 || bm <= 0 || bm % RB != 0 ||
      T % bm != 0 || row_offsets == nullptr || sizes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_ok = D % 8 == 0 && F % 8 == 0 && aligned16(toks) &&
                      aligned16(dy) && aligned16(w1) && aligned16(w3) &&
                      aligned16(w2) && aligned16(da) && aligned16(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tg = static_cast<const int*>(tile_group);
  const auto* ro = static_cast<const int*>(row_offsets);
  const auto* sz = static_cast<const int*>(sizes);
  auto* dab = static_cast<__nv_bfloat16*>(da);
  auto* dbb = static_cast<__nv_bfloat16*>(db);
  dgrad_gate_kernel<<<dim3(T / RB, (F + BN - 1) / BN), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(toks),
      static_cast<const __nv_bfloat16*>(dy), tg, ro, sz,
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w3),
      static_cast<const __nv_bfloat16*>(w2), dab, dbb, D, F, E, bm, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dgrad_x_kernel<<<dim3(T / RB, (D + BN - 1) / BN), THREADS, 0, s>>>(
      dab, dbb, tg, ro, sz, static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w3),
      static_cast<__nv_bfloat16*>(dx), D, F, E, bm, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// K2. toks and dy (T, D), h, da and db (T, F), row_offsets (E + 1) and sizes
// (E) int32 -> dw1 and dw3 (E, D, F), dw2 (E, F, D), every element written.
// bf16 but the int32 plan, contiguous, on the current device. Returns
// cudaGetLastError() after the two launches.
int ragged_moe_ffn_wgrad_bf16(const void* toks, const void* h, const void* da,
                              const void* db, const void* dy,
                              const void* row_offsets, const void* sizes,
                              void* dw1, void* dw3, void* dw2, int T, int D,
                              int F, int E, void* stream) {
  if (T <= 0 || D <= 0 || F <= 0 || E <= 0 || E > 65535 ||
      row_offsets == nullptr || sizes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_ok = D % 8 == 0 && F % 8 == 0 && aligned16(toks) &&
                      aligned16(h) && aligned16(da) && aligned16(db) &&
                      aligned16(dy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ro = static_cast<const int*>(row_offsets);
  const auto* sz = static_cast<const int*>(sizes);
  // dW1, dW3 (D, F) = x^T da, x^T db: M = D, N = F
  wgrad_kernel<true><<<dim3((F + BN - 1) / BN, (D + RB - 1) / RB, E),
                       THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(toks),
      static_cast<const __nv_bfloat16*>(da),
      static_cast<const __nv_bfloat16*>(db), ro, sz,
      static_cast<__nv_bfloat16*>(dw1), static_cast<__nv_bfloat16*>(dw3), D,
      F, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // dW2 (F, D) = h^T dy: M = F, N = D
  wgrad_kernel<false><<<dim3((D + BN - 1) / BN, (F + RB - 1) / RB, E),
                        THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(dy), nullptr, ro, sz,
      static_cast<__nv_bfloat16*>(dw2), nullptr, F, D, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The TMA route (moe_ffn_hopper_bwd.cuh)
// ---------------------------------------------------------------------------

namespace {

namespace H = moe_ffn_hopper;
namespace B = moe_ffn_hopper_bwd;

template <int ROWS>
cudaError_t dgrad_tma(const void* toks, const void* dy, const B::DgradArgs& a,
                      const void* w1, const void* w3, const void* w2, int T,
                      cudaStream_t s) {
  using Config = B::DgradCfg<ROWS>;
  const uint64_t xd[2] = {static_cast<uint64_t>(a.D),
                          static_cast<uint64_t>(T)};
  const uint64_t fd[2] = {static_cast<uint64_t>(a.F),
                          static_cast<uint64_t>(T)};
  CUtensorMap xm, dym, dam, dbm, w1m, w3m, w2m;
  if (!H::encode_map(&xm, toks, 2, xd, ROWS) ||
      !H::encode_map(&dym, dy, 2, xd, ROWS) ||
      !H::encode_map(&dam, a.da, 2, fd, ROWS) ||
      !H::encode_map(&dbm, a.db, 2, fd, ROWS) ||
      !H::weight_map(&w1m, w1, a.E, a.D, a.F) ||
      !H::weight_map(&w3m, w3, a.E, a.D, a.F) ||
      !H::weight_map(&w2m, w2, a.E, a.F, a.D)) {
    return cudaErrorInvalidValue;
  }
  static bool gate_ready = false, x_ready = false;
  const cudaError_t err = B::launch_smem(
      B::dgrad_gate_tma_kernel<ROWS, false>, gate_ready,
      dim3((a.F + H::BN - 1) / H::BN, T / ROWS), Config::THREADS,
      Config::GATE_SMEM, s, xm, dym, w1m, w3m, w2m, a);
  if (err != cudaSuccess) return err;
  return B::launch_smem(B::dgrad_x_tma_kernel<ROWS, false>, x_ready,
                        dim3((a.D + H::BN - 1) / H::BN, T / ROWS),
                        Config::THREADS, Config::X_SMEM, s, dam, dbm, w1m,
                        w3m, a);
}

// One wgrad launch: out (E, M, N) = A^T B over each expert's real rows,
// A (T, M) and B (T, N) (and out3 = A^T B3 if b3).
template <bool TWO>
cudaError_t wgrad_launch(const CUtensorMap& am, const CUtensorMap& b1m,
                         const CUtensorMap& b3m, const B::WgradArgs& a,
                         int E, cudaStream_t s) {
  using Config = B::WgradCfg<TWO>;
  constexpr int TM = 64 * Config::NWG;
  static bool ready = false;
  return B::launch_smem(B::wgrad_tma_kernel<TWO>, ready,
                        dim3((a.N + H::BN - 1) / H::BN, (a.M + TM - 1) / TM,
                             E),
                        Config::THREADS, Config::SMEM, s, am, b1m, b3m, a);
}

cudaError_t wgrad_tma(const void* toks, const void* h, const void* da,
                      const void* db, const void* dy, const int* ro,
                      const int* sz, void* dw1, void* dw3, void* dw2, int T,
                      int D, int F, int E, cudaStream_t s) {
  const uint64_t xd[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(T)};
  const uint64_t fd[2] = {static_cast<uint64_t>(F), static_cast<uint64_t>(T)};
  CUtensorMap xm, hm, dam, dbm, dym;
  if (!H::encode_map(&xm, toks, 2, xd, 64) ||
      !H::encode_map(&hm, h, 2, fd, 64) ||
      !H::encode_map(&dam, da, 2, fd, 64) ||
      !H::encode_map(&dbm, db, 2, fd, 64) ||
      !H::encode_map(&dym, dy, 2, xd, 64)) {
    return cudaErrorInvalidValue;
  }
  // dW1, dW3 (D, F) = x^T da, x^T db: M = D, N = F
  const B::WgradArgs a13{ro, sz, static_cast<__nv_bfloat16*>(dw1),
                         static_cast<__nv_bfloat16*>(dw3), D, F};
  const cudaError_t err = wgrad_launch<true>(xm, dam, dbm, a13, E, s);
  if (err != cudaSuccess) return err;
  // dW2 (F, D) = h^T dy: M = F, N = D
  const B::WgradArgs a2{ro, sz, static_cast<__nv_bfloat16*>(dw2), nullptr, F,
                        D};
  return wgrad_launch<false>(hm, dym, dym, a2, E, s);
}

bool aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (!aligned16(p)) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// K1 on the TMA route. As ragged_moe_ffn_dgrad_bf16, plus the row block
// `rows`: 128 (bm a multiple of 128; two consumer warpgroups, one CTA an
// SM) or 64 (one warpgroup, two CTAs an SM). D and F multiples of 8, every
// pointer 16-byte aligned. Returns cudaGetLastError() after the two
// launches.
int ragged_moe_ffn_dgrad_tma_bf16(const void* toks, const void* dy,
                                  const void* tile_group,
                                  const void* row_offsets, const void* sizes,
                                  const void* w1, const void* w3,
                                  const void* w2, void* da, void* db,
                                  void* dx, int T, int D, int F, int E,
                                  int bm, int rows, void* stream) {
  if (T <= 0 || D <= 0 || F <= 0 || E <= 0 || bm <= 0 || bm % 64 != 0 ||
      T % bm != 0 || D % 8 != 0 || F % 8 != 0 || T / 64 > 65535 ||
      tile_group == nullptr || row_offsets == nullptr || sizes == nullptr ||
      !aligned({toks, dy, w1, w3, w2, da, db, dx}) ||
      !(rows == 64 || (rows == 128 && bm % 128 == 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const B::DgradArgs a{static_cast<const int*>(tile_group),
                       static_cast<const int*>(row_offsets),
                       static_cast<const int*>(sizes),
                       static_cast<__nv_bfloat16*>(da),
                       static_cast<__nv_bfloat16*>(db),
                       static_cast<__nv_bfloat16*>(dx), D, F, E, bm};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rows == 128 ? dgrad_tma<128>(toks, dy, a, w1, w3, w2, T, s)
                  : dgrad_tma<64>(toks, dy, a, w1, w3, w2, T, s);
  return static_cast<int>(err);
}

// K2 on the TMA route. As ragged_moe_ffn_wgrad_bf16, with D and F
// multiples of 8 and every pointer 16-byte aligned. Returns
// cudaGetLastError() after the two launches.
int ragged_moe_ffn_wgrad_tma_bf16(const void* toks, const void* h,
                                  const void* da, const void* db,
                                  const void* dy, const void* row_offsets,
                                  const void* sizes, void* dw1, void* dw3,
                                  void* dw2, int T, int D, int F, int E,
                                  void* stream) {
  if (T <= 0 || D <= 0 || F <= 0 || E <= 0 || E > 65535 || D % 8 != 0 ||
      F % 8 != 0 || row_offsets == nullptr || sizes == nullptr ||
      !aligned({toks, h, da, db, dy, dw1, dw3, dw2})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* ro = static_cast<const int*>(row_offsets);
  const auto* sz = static_cast<const int*>(sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(wgrad_tma(toks, h, da, db, dy, ro, sz, dw1, dw3,
                                    dw2, T, D, F, E, s));
}

}  // extern "C"
