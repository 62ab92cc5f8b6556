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
// later work). The block bodies live in moe_ffn_blocks.cuh, shared with the
// capacity kernel (moe_ffn.cu):
//   kernel A (gate/up): grid (T / RB, ceil(F / BN)). A block reads its own
//     tile_group entry and returns at once on a sentinel. Otherwise it
//     computes an RB x BN block of h = silu(x W1[g]) * (x W3[g]) into the
//     scratch buffer h (T, F) the wrapper allocates.
//   kernel B (down): grid (T / RB, ceil(D / BN)). y = h W2[g] the same way;
//     sentinel blocks write zeros.
// Each block of RB rows lies inside one bm tile (the wrapper checks
// bm % RB == 0), so it reads one expert's weights, and every one of its
// rows is a buffer row (padding rows are zero, and SwiGLU(0) = 0).
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include "moe_ffn_blocks.cuh"

using namespace moe_ffn_blocks;

namespace {

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
  const int64_t wo = static_cast<int64_t>(g) * D * F;
  gate_up_block(toks + static_cast<int64_t>(row0) * D, w1 + wo, w3 + wo,
                h + static_cast<int64_t>(row0) * F, RB, blockIdx.y * BN, D,
                F, vec_ok);
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
  down_block(h + static_cast<int64_t>(row0) * F,
             w2 + static_cast<int64_t>(g) * F * D,
             out + static_cast<int64_t>(row0) * D, RB, n0, D, F, vec_ok);
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
