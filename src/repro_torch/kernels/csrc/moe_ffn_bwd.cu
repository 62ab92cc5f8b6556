// Backward of the capacity-bucket grouped SwiGLU expert FFN for Hopper
// (sm_90a), bf16 in and out, f32 accumulation.
//
// The forward replaces the TPU kernel fused_moe_ffn_pallas
// (src/repro/kernels/moe_ffn.py:57), which has no gradient: the reference
// trains its capacity bodies through the jnp oracle expert_ffn_ref
// (src/repro/models/moe.py:130). The port trains through its forward
// kernel (moe_ffn.cu), so this is its gradient, on the ragged backward's
// machinery (moe_ffn_hopper_bwd.cuh) over the bucket layout: toks (E, C, D)
// holds C rows an expert, w1/w3 (E, D, F), w2 (E, F, D), and the forward's
// bf16 scratch h (E, C, F) is the saved activation.
//
//   K1, dgrad (moe_ffn_dgrad_tma_bf16), two launches over (column block,
//     row block, expert):
//     A: a = x W1[e], b = x W3[e] recomputed in f32, dh = dy W2[e]^T, then
//        da = dh b s(a)(1 + a(1 - s(a))), db = dh silu(a), stored in bf16;
//     B: dx = da W1[e]^T + db W3[e]^T in bf16.
//     The kernels are the ragged K1's (dgrad_gate_tma_kernel,
//     dgrad_x_tma_kernel) with BUCKETS set: the expert is blockIdx.z, row
//     block y covers bucket rows [ROWS y, ROWS y + ROWS), of which
//     min(C - ROWS y, ROWS) are real. x, dy, da and db are read through
//     3-d tensor maps over (E, C, .), so TMA fills rows at or past C with
//     zeros: a row block never reads the next bucket's rows, which here
//     are real data (not padding, as on the ragged layout). da, db and dx
//     are stored on rows below C only. Every bucket row is computed, as
//     the forward does: an empty row has x = 0, and its dy is 0 (the
//     combine gathers no kept assignment from it), so its da, db and dx
//     come out exact zeros. (Skipping them would need the receiver's fill
//     counts, which the a2a frames do not carry.) Row block 128 where
//     C >= 128 (two consumer warpgroups, one CTA an SM), else 64.
//   K2, wgrad (moe_ffn_wgrad_tma_bf16), two launches over (column block,
//     row block, expert): dW1 = x^T da and dW3 = x^T db, then
//     dW2 = h^T dy, each summed in f32 over the bucket's C rows in 64-row
//     chunks, in order, and written in bf16. The ragged K2 kernel
//     (wgrad_tma_kernel) on the flat (E C, .) views, with expert g's rows
//     [g C, g C + C) (WgradArgs::C; no row tables). Where C is not a
//     multiple of 64 a bucket's last chunk runs into the next bucket's
//     rows: the kernel zeroes rows [valid, 64) of every tile of that chunk
//     in shared memory before wgmma reads it (moe_ffn_hopper_bwd.cuh,
//     "Ragged depth"), so they add nothing, whatever they hold; the last
//     bucket's last chunk runs past the tensor, and TMA fills it with
//     zeros (and the kernel zeroes it too).
// No atomics and no split over rows: every output element is one CTA's,
// so two runs are bit-identical.
//
// What bounds it on an H100 (granite-moe-3b-a800m's training buckets: E 40,
// C 1024, D 1536, F 512; 989 TFLOP/s bf16, 3.35 TB/s): K1's five products
// are 10 E C D F = 322.1 GFLOP (0.326 ms) against ~650 MB (0.194 ms), K2's
// three 6 E C D F = 193.3 GFLOP (0.195 ms) against ~567 MB (0.169 ms):
// both by the tensor cores. The design is the ragged backward's: a TMA ring
// of 128-byte-swizzled tiles kept full by a producer warp, wgmma from
// shared memory, each output tile stored once with 16-byte stores.
//
// The TMA route only: D and F multiples of 8 and every pointer 16-byte
// aligned (the wrapper raises a ValueError on any other shape; every
// configuration of the repo has such widths). Launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <initializer_list>

#include "moe_ffn_hopper_bwd.cuh"

namespace {

namespace H = moe_ffn_hopper;
namespace B = moe_ffn_hopper_bwd;

bool aligned_all(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

template <int ROWS>
cudaError_t dgrad_buckets(const void* toks, const void* dy,
                          const B::DgradArgs& a, const void* w1,
                          const void* w3, const void* w2, cudaStream_t s) {
  using Config = B::DgradCfg<ROWS>;
  const uint64_t xd[3] = {static_cast<uint64_t>(a.D),
                          static_cast<uint64_t>(a.C),
                          static_cast<uint64_t>(a.E)};
  const uint64_t fd[3] = {static_cast<uint64_t>(a.F),
                          static_cast<uint64_t>(a.C),
                          static_cast<uint64_t>(a.E)};
  CUtensorMap xm, dym, dam, dbm, w1m, w3m, w2m;
  if (!H::encode_map(&xm, toks, 3, xd, ROWS) ||
      !H::encode_map(&dym, dy, 3, xd, ROWS) ||
      !H::encode_map(&dam, a.da, 3, fd, ROWS) ||
      !H::encode_map(&dbm, a.db, 3, fd, ROWS) ||
      !H::weight_map(&w1m, w1, a.E, a.D, a.F) ||
      !H::weight_map(&w3m, w3, a.E, a.D, a.F) ||
      !H::weight_map(&w2m, w2, a.E, a.F, a.D)) {
    return cudaErrorInvalidValue;
  }
  const int row_blocks = (a.C + ROWS - 1) / ROWS;
  static bool gate_ready = false, x_ready = false;
  const cudaError_t err = B::launch_smem(
      B::dgrad_gate_tma_kernel<ROWS, true>, gate_ready,
      dim3((a.F + H::BN - 1) / H::BN, row_blocks, a.E), Config::THREADS,
      Config::GATE_SMEM, s, xm, dym, w1m, w3m, w2m, a);
  if (err != cudaSuccess) return err;
  return B::launch_smem(B::dgrad_x_tma_kernel<ROWS, true>, x_ready,
                        dim3((a.D + H::BN - 1) / H::BN, row_blocks, a.E),
                        Config::THREADS, Config::X_SMEM, s, dam, dbm, w1m,
                        w3m, a);
}

// One wgrad launch: out (E, M, N) = A^T B over each bucket's C rows, A
// (E C, M) and B (E C, N) (and out3 = A^T B3 if TWO).
template <bool TWO>
cudaError_t wgrad_buckets(const CUtensorMap& am, const CUtensorMap& b1m,
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

}  // namespace

extern "C" {

// K1 over buckets. toks and dy (E, C, D), w1/w3 (E, D, F), w2 (E, F, D) ->
// da and db (E, C, F) and dx (E, C, D), every element written; bf16,
// contiguous, on the current device; D and F multiples of 8, every pointer
// 16-byte aligned; rows 64 or 128 (the row block). Returns
// cudaGetLastError() after the two launches.
int moe_ffn_dgrad_tma_bf16(const void* toks, const void* dy, const void* w1,
                           const void* w3, const void* w2, void* da,
                           void* db, void* dx, int E, int C, int D, int F,
                           int rows, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || D % 8 != 0 ||
      F % 8 != 0 || !(rows == 64 || rows == 128) ||
      (C + rows - 1) / rows > 65535 ||
      !aligned_all({toks, dy, w1, w3, w2, da, db, dx})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const B::DgradArgs a{nullptr, nullptr, nullptr,
                       static_cast<__nv_bfloat16*>(da),
                       static_cast<__nv_bfloat16*>(db),
                       static_cast<__nv_bfloat16*>(dx), D, F, E, 0, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rows == 128 ? dgrad_buckets<128>(toks, dy, a, w1, w3, w2, s)
                  : dgrad_buckets<64>(toks, dy, a, w1, w3, w2, s);
  return static_cast<int>(err);
}

// K2 over buckets. toks and dy (E, C, D), h, da and db (E, C, F) -> dw1
// and dw3 (E, D, F), dw2 (E, F, D), every element written; bf16,
// contiguous, on the current device; D and F multiples of 8, every pointer
// 16-byte aligned. Returns cudaGetLastError() after the two launches.
int moe_ffn_wgrad_tma_bf16(const void* toks, const void* h, const void* da,
                           const void* db, const void* dy, void* dw1,
                           void* dw3, void* dw2, int E, int C, int D, int F,
                           void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 || D % 8 != 0 ||
      F % 8 != 0 || static_cast<int64_t>(E) * C > 2147483647 ||
      !aligned_all({toks, h, da, db, dy, dw1, dw3, dw2})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint64_t T = static_cast<uint64_t>(E) * C;
  const uint64_t xd[2] = {static_cast<uint64_t>(D), T};
  const uint64_t fd[2] = {static_cast<uint64_t>(F), T};
  CUtensorMap xm, hm, dam, dbm, dym;
  if (!H::encode_map(&xm, toks, 2, xd, 64) ||
      !H::encode_map(&hm, h, 2, fd, 64) ||
      !H::encode_map(&dam, da, 2, fd, 64) ||
      !H::encode_map(&dbm, db, 2, fd, 64) ||
      !H::encode_map(&dym, dy, 2, xd, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dW1, dW3 (D, F) = x^T da, x^T db: M = D, N = F
  const B::WgradArgs a13{nullptr, nullptr, static_cast<__nv_bfloat16*>(dw1),
                         static_cast<__nv_bfloat16*>(dw3), D, F, C};
  const cudaError_t err = wgrad_buckets<true>(xm, dam, dbm, a13, E, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dW2 (F, D) = h^T dy: M = F, N = D
  const B::WgradArgs a2{nullptr, nullptr, static_cast<__nv_bfloat16*>(dw2),
                        nullptr, F, D, C};
  return static_cast<int>(wgrad_buckets<false>(hm, dym, dym, a2, E, s));
}

}  // extern "C"
