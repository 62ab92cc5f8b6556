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
// Two routes, both two launches (gate/up into a bf16 scratch h (T, F), then
// down), chosen by the wrapper from shapes and pointers:
//   ragged_moe_ffn_tma_bf16 (moe_ffn_hopper.cuh): a TMA ring and wgmma, for
//     D and F multiples of 8 and 16-byte aligned pointers. It also takes
//     the plan's row_offsets and sizes (null: every tile full), from which
//     each CTA works out its tile's real rows, and computes only those
//     rows, rounded up to its row block: rows = 8 or 16
//     (few rows, A and B swapped, one CTA per tile and 64 columns) or 64 or
//     128 (one CTA per row block of a tile). The down launch writes the
//     uncomputed rows of a tile, and whole sentinel tiles, as exact zeros
//     with 16-byte stores, so the combine's clamp of inactive assignments to
//     the buffer's last row still reads a zero.
//   ragged_moe_ffn_bf16 (moe_ffn_blocks.cuh): the general route, WMMA over
//     64-row blocks with masked edges, for every other shape.
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include "moe_ffn_blocks.cuh"
#include "moe_ffn_hopper.cuh"

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

namespace {

namespace H = moe_ffn_hopper;

template <int ROWS, bool SWAP>
cudaError_t ragged_tma(const void* toks, const int* tile_group,
                       const int* row_off, const int* sizes, const void* w1,
                       const void* w3, const void* w2, __nv_bfloat16* h,
                       __nv_bfloat16* out,
                       int T, int D, int F, int E, int bm, cudaStream_t s) {
  CUtensorMap xm, hm, w1m, w3m, w2m;
  const uint64_t xd[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(T)};
  const uint64_t hd[2] = {static_cast<uint64_t>(F), static_cast<uint64_t>(T)};
  if (!H::encode_map(&xm, toks, 2, xd, ROWS) ||
      !H::encode_map(&hm, h, 2, hd, ROWS) ||
      !H::weight_map(&w1m, w1, E, D, F) || !H::weight_map(&w3m, w3, E, D, F) ||
      !H::weight_map(&w2m, w2, E, F, D)) {
    return cudaErrorInvalidValue;
  }
  const int row_blocks = SWAP ? T / bm : T / ROWS;
  const H::Args a{tile_group, row_off, sizes, h, F, D, E, bm, 0};
  cudaError_t err = H::launch<H::GATE_UP, ROWS, SWAP, false>(
      dim3((F + H::BN - 1) / H::BN, row_blocks), xm, w1m, w3m, a, s);
  if (err != cudaSuccess) return err;
  const H::Args b{tile_group, row_off, sizes, out, D, F, E, bm, 0};
  return H::launch<H::DOWN, ROWS, SWAP, false>(
      dim3((D + H::BN - 1) / H::BN, row_blocks), hm, w2m, w2m, b, s);
}

}  // namespace

extern "C" {

// The TMA route. As ragged_moe_ffn_bf16, plus row_offsets (E + 1) and
// sizes (E) int32, where each expert's segment starts in toks and how many
// of its rows are real (both null: every tile full), and the row block
// `rows`: 8 or 16 (few rows: at most that many real rows a tile is the
// common case, more are computed in further chunks) or 64 or 128 (bm a
// multiple of it). D and F must be multiples of 8 and every pointer 16-byte
// aligned.
int ragged_moe_ffn_tma_bf16(const void* toks, const void* tile_group,
                            const void* row_offsets, const void* sizes,
                            const void* w1, const void* w3, const void* w2,
                            void* h, void* out, int T, int D, int F, int E,
                            int bm, int rows, void* stream) {
  if (T <= 0 || D <= 0 || F <= 0 || E <= 0 || bm <= 0 || bm % 64 != 0 ||
      T % bm != 0 || D % 8 != 0 || F % 8 != 0 || !aligned16(toks) ||
      !aligned16(w1) || !aligned16(w3) || !aligned16(w2) || !aligned16(h) ||
      !aligned16(out) || (rows == 128 && bm % 128 != 0) ||
      (row_offsets == nullptr) != (sizes == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* tg = static_cast<const int*>(tile_group);
  const int* ro = static_cast<const int*>(row_offsets);
  const int* sz = static_cast<const int*>(sizes);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rows) {
    case 8:
      err = ragged_tma<8, true>(toks, tg, ro, sz, w1, w3, w2, hb, ob, T, D, F,
                                E, bm, s);
      break;
    case 16:
      err = ragged_tma<16, true>(toks, tg, ro, sz, w1, w3, w2, hb, ob, T, D,
                                 F, E, bm, s);
      break;
    case 64:
      err = ragged_tma<64, false>(toks, tg, ro, sz, w1, w3, w2, hb, ob, T, D,
                                  F, E, bm, s);
      break;
    case 128:
      err = ragged_tma<128, false>(toks, tg, ro, sz, w1, w3, w2, hb, ob, T,
                                   D, F, E, bm, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
