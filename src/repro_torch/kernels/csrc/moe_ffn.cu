// Capacity-bucket grouped SwiGLU expert FFN for Hopper (sm_90a), bf16 in
// and out.
//
// Replaces the TPU kernel fused_moe_ffn_pallas
// (src/repro/kernels/moe_ffn.py:57). Same contract: toks (E, C, D) holds C
// bucket rows per expert (unused rows are zero), w1/w3 (E, D, F), w2
// (E, F, D); per expert e
//     y[e] = (silu(toks[e] W1[e]) * (toks[e] W3[e])) W2[e]
// with f32 accumulation and h rounded to bf16 before the down projection
// (moe_ffn.py:41).
//
// What bounds it on an H100: the expert weights. The kernel computes every
// bucket, occupied or not, so it reads all E experts' weights: for the
// granite slice (E = 40, D = 1536, F = 512) 188.7 MB a layer, 56.3 us at
// 3.35 TB/s, against 0.76 GFLOP at an 8-lane decode (C = 4) and 24.2 GFLOP
// at a 512-token prefill (C = 128): below the memory bound in both.
//
// Design (a first, simple kernel; wgmma, TMA and a row block sized for
// C <= 16 are later work). The TPU kernel carries an f32 (bm, D)
// accumulator across its sequential F grid axis; Hopper's blocks run in
// parallel, so the F reduction is split into two launches, as the ragged
// kernel does, with the block bodies of moe_ffn_blocks.cuh:
//   kernel A (gate/up): grid (ceil(C / RB), ceil(F / BN), E): an RB x BN
//     block of h = silu(x W1[e]) * (x W3[e]) into the scratch buffer
//     h (E, C, F) the wrapper allocates;
//   kernel B (down): grid (ceil(C / RB), ceil(D / BN), E): y = h W2[e].
// The Pallas kernel rounds h to bf16 at the same point, so the numerics do
// not change. C is 4 at an 8-lane decode and rarely a multiple of RB, so
// the edges are masked inside the kernel instead of padding: rows at or
// past C load as zeros and are never stored (the reference wrapper's pad of
// C and F would copy the weights, 188.7 MB per layer per call). Launches on
// the caller's stream, allocates nothing, returns cudaGetLastError().

#include "moe_ffn_blocks.cuh"

using namespace moe_ffn_blocks;

namespace {

// h[e, rows, n0:n0+BN] = silu(x W1[e]) * (x W3[e]) for one RB-row block.
__global__ void __launch_bounds__(THREADS)
capacity_gate_up_kernel(const __nv_bfloat16* __restrict__ toks,
                        const __nv_bfloat16* __restrict__ w1,
                        const __nv_bfloat16* __restrict__ w3,
                        __nv_bfloat16* __restrict__ h, int C, int D, int F,
                        bool vec_ok) {
  const int e = blockIdx.z;
  const int row0 = blockIdx.x * RB;
  const int64_t row = static_cast<int64_t>(e) * C + row0;
  const int64_t wo = static_cast<int64_t>(e) * D * F;
  gate_up_block(toks + row * D, w1 + wo, w3 + wo, h + row * F,
                min(RB, C - row0), blockIdx.y * BN, D, F, vec_ok);
}

// out[e, rows, n0:n0+BN] = h[e] W2[e] for one RB-row block.
__global__ void __launch_bounds__(THREADS)
capacity_down_kernel(const __nv_bfloat16* __restrict__ h,
                     const __nv_bfloat16* __restrict__ w2,
                     __nv_bfloat16* __restrict__ out, int C, int D, int F,
                     bool vec_ok) {
  const int e = blockIdx.z;
  const int row0 = blockIdx.x * RB;
  const int64_t row = static_cast<int64_t>(e) * C + row0;
  down_block(h + row * F, w2 + static_cast<int64_t>(e) * F * D, out + row * D,
             min(RB, C - row0), blockIdx.y * BN, D, F, vec_ok);
}

}  // namespace

extern "C" {

// toks (E, C, D), w1/w3 (E, D, F), w2 (E, F, D), scratch h (E, C, F) and
// out (E, C, D); all bf16, contiguous, on the current device. Returns
// cudaGetLastError() after the two launches.
int moe_ffn_bf16(const void* toks, const void* w1, const void* w3,
                 const void* w2, void* h, void* out, int E, int C, int D,
                 int F, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_ok = D % 8 == 0 && F % 8 == 0 && aligned16(toks) &&
                      aligned16(w1) && aligned16(w3) && aligned16(w2) &&
                      aligned16(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(THREADS);
  const int row_blocks = (C + RB - 1) / RB;
  const dim3 grid_a(row_blocks, (F + BN - 1) / BN, E);
  capacity_gate_up_kernel<<<grid_a, block, 0, s>>>(
      static_cast<const __nv_bfloat16*>(toks),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w3),
      static_cast<__nv_bfloat16*>(h), C, D, F, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(row_blocks, (D + BN - 1) / BN, E);
  capacity_down_kernel<<<grid_b, block, 0, s>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<__nv_bfloat16*>(out), C, D, F, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
