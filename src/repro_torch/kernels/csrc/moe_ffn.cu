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
// Two routes, both split into two launches, as the ragged kernel is: the
// TPU kernel carries an f32 (bm, D) accumulator across its sequential F
// grid axis, and Hopper's blocks run in parallel, so gate/up writes a bf16
// scratch h (E, C, F) the wrapper allocates (the Pallas kernel rounds h to
// bf16 at the same point, so the numerics do not change) and down reads it.
// The wrapper picks the route from shapes and pointers:
//   moe_ffn_tma_bf16 (moe_ffn_hopper.cuh): a TMA ring and wgmma, for D and F
//     multiples of 8 and 16-byte aligned pointers. The buckets are a 3-d
//     tensor map (E, C, D), so rows past C load as zeros and never reach
//     the next expert. Row block: rows = 8 or 16 for C <= 16 (A and B
//     swapped: one CTA per expert and 64 columns reads its weight slice
//     once and computes no padding rows; an 8-lane decode has C = 4), else
//     64 or 128 rows a CTA.
//   moe_ffn_bf16 (moe_ffn_blocks.cuh): the general route, WMMA over 64-row
//     blocks, grid (ceil(C / RB), ceil(F / BN), E) then (ceil(C / RB),
//     ceil(D / BN), E).
// Both mask the edges of C, D and F inside the kernel instead of padding:
// rows at or past C are never stored (the reference wrapper's pad of C and
// F would copy the weights, 188.7 MB per layer per call). Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include "moe_ffn_blocks.cuh"
#include "moe_ffn_hopper.cuh"

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

namespace {

namespace H = moe_ffn_hopper;

template <int ROWS, bool SWAP>
cudaError_t capacity_tma(const void* toks, const void* w1, const void* w3,
                         const void* w2, __nv_bfloat16* h,
                         __nv_bfloat16* out, int E, int C, int D, int F,
                         cudaStream_t s) {
  CUtensorMap xm, hm, w1m, w3m, w2m;
  const uint64_t xd[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(C),
                          static_cast<uint64_t>(E)};
  const uint64_t hd[3] = {static_cast<uint64_t>(F), static_cast<uint64_t>(C),
                          static_cast<uint64_t>(E)};
  if (!H::encode_map(&xm, toks, 3, xd, ROWS) ||
      !H::encode_map(&hm, h, 3, hd, ROWS) ||
      !H::weight_map(&w1m, w1, E, D, F) || !H::weight_map(&w3m, w3, E, D, F) ||
      !H::weight_map(&w2m, w2, E, F, D)) {
    return cudaErrorInvalidValue;
  }
  const int row_blocks = SWAP ? 1 : (C + ROWS - 1) / ROWS;
  const H::Args a{nullptr, nullptr, nullptr, h, F, D, E, 0, C};
  cudaError_t err = H::launch<H::GATE_UP, ROWS, SWAP, true>(
      dim3((F + H::BN - 1) / H::BN, row_blocks, E), xm, w1m, w3m, a, s);
  if (err != cudaSuccess) return err;
  const H::Args b{nullptr, nullptr, nullptr, out, D, F, E, 0, C};
  return H::launch<H::DOWN, ROWS, SWAP, true>(
      dim3((D + H::BN - 1) / H::BN, row_blocks, E), hm, w2m, w2m, b, s);
}

}  // namespace

extern "C" {

// The TMA route. As moe_ffn_bf16, plus the row block `rows`: 8 or 16 (few
// rows; C above it is computed in further chunks) or 64 or 128. D and F
// must be multiples of 8 and every pointer 16-byte aligned.
int moe_ffn_tma_bf16(const void* toks, const void* w1, const void* w3,
                     const void* w2, void* h, void* out, int E, int C, int D,
                     int F, int rows, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || D % 8 != 0 ||
      F % 8 != 0 || !aligned16(toks) || !aligned16(w1) || !aligned16(w3) ||
      !aligned16(w2) || !aligned16(h) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rows) {
    case 8:
      err = capacity_tma<8, true>(toks, w1, w3, w2, hb, ob, E, C, D, F, s);
      break;
    case 16:
      err = capacity_tma<16, true>(toks, w1, w3, w2, hb, ob, E, C, D, F, s);
      break;
    case 64:
      err = capacity_tma<64, false>(toks, w1, w3, w2, hb, ob, E, C, D, F, s);
      break;
    case 128:
      err = capacity_tma<128, false>(toks, w1, w3, w2, hb, ob, E, C, D, F,
                                     s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
