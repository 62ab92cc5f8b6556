// Chunked attention on Hopper: the prefill forward (flash_attn_fwd) and the
// decode step against the cache (flash_decode), with a plain C interface
// for ctypes (kernels/flash.py).
//
// Replaces no Pallas kernel: the reference's attention is plain jnp,
// src/repro/models/flash.py:45 (flash_attention) and :133 (flash_decode);
// the plain PyTorch versions are src/repro_torch/models/flash.py. The
// arithmetic is the reference's: f32 scores (q.k times 1/sqrt(hd), masked
// to _NEG), the online softmax's running max m, sum l and accumulator in
// f32, p cast to v's dtype before the PV product, the output acc / max(l,
// 1e-30) cast to q's dtype.
//
// Prefill (flash_attn_fwd): a block holds rows of one (lane, KV head) --
// query position s and query head g flattened as s * G + g, so the G heads
// of a KV head share each K/V tile -- and walks key tiles of a fixed length
// BN from key row 0, so a row's result depends only on its q row, its
// lane's k/v and the masks (never on B, KV, Sq, its neighbours or the SM
// count). A tile whose mask is false for every row of the block (no valid
// key; or, from the position bounds, causal or window excludes all) is
// skipped: for a row that has a valid key that is what computing it would
// give bit for bit (p = exp(_NEG - m) = 0, correction 1; or, before its
// first valid key, a state the first valid tile multiplies by exp(_NEG -
// m) = 0). A row with no valid key at all gets the plain version's value,
// sum(v) / (the padded key count), in a pass of its own. Given m and l, it
// also writes each row's softmax stats, which a call that needs a gradient
// keeps for the backward. Two routes, chosen by the dtype alone
// (kernels/flash.py::route_of), so a chunk and the whole prompt, a rank
// and one device, take the same one, each with a kernel for every head size
// (32, 64, 80, 128, 256):
//   * the Hopper route, bf16: TMA and wgmma, 128-row blocks; attn_fwd_tma
//     at hd 32, 64, 80 and 128 (a producer and two consumer warpgroups,
//     128-key tiles, hd 32 and 80 in a partial 64-value panel), and
//     attn_fwd_hd256 at 256 (two warpgroups and no producer, 64-key tiles).
//     Bound at long context: the exponentials at hd 32 (an ex2 a (row, key)
//     pair takes longer than its products), both at hd 64, the tensor cores
//     above (notes below);
//   * the tf32x3 route, f32: each product as three TF32 products on the
//     tensor cores, 128-row blocks; attn_fwd_tf32x3 at hd 32, 64 and 80
//     (wgmma for S from Q's and K's split parts in shared memory, 64-key
//     tiles), attn_fwd_tf32x3_wide at 128 and 256 (every product on
//     mma.sync, each operand split in registers as it is read, 64- and
//     32-key tiles: the split parts would not fit in shared memory). Bound:
//     the tensor cores' TF32 rate over the three products (notes below).
// A (dtype, hd) outside these raises in the wrapper; a refused launch
// returns its error.
//
// Decode (flash_decode): one launch a call (decode_attn). A block reads one
// split of split_rows cache rows of one (lane, KV head) once for up to 8 of
// its query heads, and only the rows that can be valid (<= pos -
// kpos_offset, inside the window), through a per-thread cp.async ring; the
// last block of a (lane, KV head) merges the splits' (acc, m, l) in split
// order, found by a ticket (its note below). Splits and tiles depend on
// S_max alone. Bound: the bytes of the valid rows.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "moe_ffn_hopper.cuh"

namespace {

using namespace flash_common;

constexpr int NT = 128;          // threads a block of the decode kernel

// p cast to v's dtype, as a float
__device__ __forceinline__ float round_as(float x, bf16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_as(float x, float) { return x; }

// Rows of the block with no valid key (rowflag set): sum(v) / den over
// every key of the (lane, KV head), as the plain version gives them.
// Threads tid of nthr share the columns.
template <typename T>
__device__ void fill_unseen(const T* v, T* out, const int* rowflag, int row0,
                            int rows, int M, int G, int Sq, int Skv, int KV,
                            int HD, int b, int kvh, long long vs0,
                            long long vs1, long long vs2, float den, int tid,
                            int nthr) {
  for (int d = tid; d < HD; d += nthr) {
    float sum = 0.f;
    const T* col = v + b * vs0 + kvh * vs2 + d;
    for (int key = 0; key < Skv; ++key) sum += to_f(col[key * vs1]);
    const T val = from_f<T>(sum / den);
    for (int r = 0; r < rows; ++r) {
      const int gr = row0 + r;
      if (gr < M && rowflag[r]) {
        const int s = gr / G, g = gr % G;
        out[(((long long)b * Sq + s) * KV + kvh) * G * HD + (long long)g * HD +
            d] = val;
      }
    }
  }
}

// Row gr's softmax stats, as the plain version's return_stats gives them:
// the running max m and sum l over the keys; a row with no valid key m =
// _NEG and l = den (every key, padding included, took exp(_NEG - _NEG) =
// 1).
__device__ __forceinline__ void write_stats(float* ms, float* ls, int gr,
                                            int G, int Sq, int KV, int b,
                                            int kvh, float m, float l,
                                            float den) {
  const int s = gr / G, g = gr % G;
  const long long i = (((long long)b * KV + kvh) * G + g) * Sq + s;
  ms[i] = m;
  ls[i] = m == neg_big() ? den : l;
}

struct FwdArgs {
  const void *q, *k, *v;
  void* out;
  float *m, *l;           // the rows' softmax stats (B, KV, G, Sq), or null
  Pos qpos, kpos;
  const unsigned char* kval;
  int Sq, Skv, KV, G;
  long long qs0, qs1, qs2, qs3, ks0, ks1, ks2, vs0, vs1, vs2;
  int causal, window;
  float scale, den;
};

// ------------------------------------------------------ bf16, Hopper route
// The prefill route for bf16 at hd 32, 64, 80 and 128
// (kernels/flash.py::route_of; at hd 256 attn_fwd_hd256, its note below): a
// block of 384 threads, 128 rows of one (lane, KV head), 128-key tiles.
//   * Panels. A row of Q, K or V is ceil(hd / 64) panels of 64 values, 128
//     bytes a row in the 128-byte swizzle wgmma reads; at hd 32 and 80 the
//     last panel is partial. TMA reads K's and V's columns past hd as zeros
//     (the maps' first dimension is hd, the box 64 wide), and no product
//     reads them: S takes hd / 16 k-steps (2 at hd 32, 5 at hd 80, the last
//     from the partial panel's first 32 bytes a row), P V takes N = hd (one
//     wgmma m64n32 or m64n80 over the panels, LBO a panel), so S and O are
//     what hd columns give bit for bit.
//   * Prologue, every thread: Q's 128 rows into that layout (a block's rows
//     are s * G + g, not a TMA box, so plain 16-byte loads), the block's
//     query-position bounds, and the states of the first 1024 key tiles
//     (fill_states: two tiles a warp a round trip, twelve warps). The scan
//     over every key tile is a block's fixed cost, whatever its causal
//     extent; done by the producer's four warps one tile a round trip, it
//     held each block's first tile back.
//   * Warpgroup 0, the producer (setmaxnreg down to 56): lane 0 of warp 0
//     walks the live tiles in order and keeps them in flight through a ring
//     of STAGES slots (4 with one panel, 2 with two: at hd 80 a third slot
//     of 64 KB does not fit beside Q), K and V each as its panels of 128
//     keys x 128 bytes copied by TMA (cp.async.bulk.tensor over the (hd,
//     KV, Skv, B) view with the caller's strides, keys past Skv read as
//     zeros), completion on the slot's full mbarrier. Beside the slot it
//     writes the tile's index and state and, for a tile with some masked
//     pairs, its keys' positions and validity; after the last live tile a
//     slot with index -1 ends the walk. Its four warps judge the later
//     windows of 1024 tiles.
//   * Warpgroups 1 and 2, the consumers (setmaxnreg up to 224), 64 rows
//     each: S = Q K^T by wgmma m64n128k16 from shared memory, the masks
//     and the online softmax in registers, P rounded to bf16 in registers
//     as wgmma's A operand, O += P V by wgmma m64n{hd}k16 with V MN-major
//     (the transpose bit); lane 0 of each warp frees a slot on its empty
//     mbarrier. At hd 32, 64 and 80 the two take turns at the tensor cores
//     (named barriers 4 and 5, ping-pong), a turn issuing this tile's S with
//     the last tile's P V, so that one's softmax runs under the other's
//     products. At hd 128 S, P and O do not fit together in the 168
//     registers a thread that ptxas (CUDA 12.9) gives the consumer path
//     here (it spills and serialises wgmma; it does raise a plain kernel's
//     budget to setmaxnreg's), so each warpgroup runs S, softmax, P V in
//     turn.
// The softmax is in base 2: m2 the running max of q.k scale log2 e, p =
// 2^(q.k c2 - m2) by one FFMA and ex2, a masked pair -inf (p = 0); the
// stats come back as m2 ln 2 (a row with no valid key keeps _NEG and takes
// l = the padded key count, as the plain version). Computing a tile whose
// every pair is masked leaves m, l and O as they were (the correction
// exp2(0) = 1, p = 0), so a skipped tile is still bitwise what computing it
// gives. Which route runs depends on (dtype, hd) alone. The row blocks go
// longest first (causal rows at the end of the prompt have the most
// tiles). Host cost: two tensor maps encoded a call (cuTensorMapEncodeTiled,
// on the host). Bound at long context: at hd 80 and 128 the tensor cores;
// at hd 64 the exponentials as much (the 16 a clock of an SM's ex2 units
// take as long as a tile's products), and at hd 32 the exponentials alone
// (a (row, key) pair's ex2 takes 1.9x its 4 hd FLOPs at the tensor cores'
// rate): there the ping-pong keeps the ex2 units of one warpgroup busy
// while the other's products run, and 128-key tiles spread each tile's
// fixed cost (the row maxima, the barriers) and the tile-state scan over
// more keys. Each block's tile-state scan is a fixed cost besides.
namespace hop = moe_ffn_hopper;

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// S (64 x 128, f32) = or += Q (64 x 16) K (16 x 128): both bf16,
// K-major, from shared memory; scale_d 0 overwrites S
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// O (64 x N, f32) += P (64 x 16, bf16 in registers: a warp's 16 rows as
// mma.sync m16n8k16's A fragment) V (16 x N, bf16, MN-major in shared
// memory: the transpose bit), wgmma_rs by O's size: N = 32 and 80 (hd 32
// and 80: the first 32 columns of one panel, or one panel and the next's
// first 16 columns LBO on), 64, 128 and 256 below
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %45, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 64, f32) += P (64 x 16, bf16 in registers: a warp's 16
// rows as mma.sync m16n8k16's A fragment) V (16 x 64, bf16,
// MN-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 128, f32) += P (64 x 16, bf16 in registers: a warp's 16
// rows as mma.sync m16n8k16's A fragment) V (16 x 128, bf16,
// MN-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S (64 x 64, f32) = or += Q (64 x 16) K (16 x 64): both bf16, K-major,
// from shared memory; scale_d 0 overwrites S (hd 256's 64-key tiles)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// O (64 x 256, f32) += P (64 x 16, bf16 in registers: a warp's 16
// rows as mma.sync m16n8k16's A fragment) V (16 x 256, bf16,
// MN-major in shared memory: the transpose bit; four 64-wide panels LBO
// apart)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// A consumer warpgroup's tile after S (the wgmma accumulators s, 64 rows x
// BN keys: accumulator i is row rA + 8 ((i / 2) % 2), key 8 (i / 4) + 2
// (lane % 4) + i % 2): the masks (a masked pair and a key past Skv: -inf,
// p = 0; none where st == 2) and the online softmax in base 2 (m2 the
// running max of q.k scale log2 e, p = 2^(q.k c2 - m2) by one FFMA and
// ex2); P rounded to bf16 pairs as wgmma's A fragments, lsum updated, O
// (the tiles before this one) rescaled to this tile's maxima.
template <int BN, int NO>
__device__ __forceinline__ void tile_softmax(
    float (&s)[BN / 2], uint32_t (&pf)[BN / 16][4], float (&o)[NO],
    float (&m2)[2], float (&lsum)[2], int st, const signed char* kval,
    const long long* kpos, long long qpA, long long qpB, int causal,
    int window, float c2) {
  const int lane = threadIdx.x & 31;
  float tmax[2] = {-INFINITY, -INFINITY};
  if (st == 2) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
  } else {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int h = (i >> 1) & 1;
      if (kval[col] <= 0 || !allowed(h ? qpB : qpA, kpos[col], causal, window))
        s[i] = -INFINITY;
      tmax[h] = fmaxf(tmax[h], s[i]);
    }
  }
  float corr[2], nm[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
    tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
    const float m_new = fmaxf(m2[h], tmax[h] * c2);
    corr[h] = ex2(m2[h] - m_new);
    m2[h] = m_new;
    nm[h] = -m_new;
  }
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int h = (e >> 1) & 1;
      p[e] = ex2(fmaf(s[8 * kk + e], c2, nm[h]));
      rsum[h] += p[e];
    }
    pf[kk][0] = pack_bf16(p[0], p[1]);
    pf[kk][1] = pack_bf16(p[2], p[3]);
    pf[kk][2] = pack_bf16(p[4], p[5]);
    pf[kk][3] = pack_bf16(p[6], p[7]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
    rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
    lsum[h] = lsum[h] * corr[h] + rsum[h];
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
}

// The query-position bounds of a block's rows row0 .. row0 + 127 below M
// (threads 0-127 a row each), by every thread; lo_s and hi_s four
// entries of shared memory. Ends in a __syncthreads.
__device__ __forceinline__ void block_bounds(const Pos& qpos, int row0,
                                             int M, int G, long long* lo_s,
                                             long long* hi_s,
                                             long long* qmin,
                                             long long* qmax) {
  const int warp = threadIdx.x >> 5;
  long long lo = 0x7fffffffffffffffLL, hi = -0x7fffffffffffffffLL;
  if (threadIdx.x < 128 && row0 + threadIdx.x < M) {
    const int s = (row0 + threadIdx.x) / G;
    lo = hi = qpos.at(s, s);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const long long x = __shfl_xor_sync(0xffffffffu, lo, o);
    const long long y = __shfl_xor_sync(0xffffffffu, hi, o);
    lo = x < lo ? x : lo;
    hi = y > hi ? y : hi;
  }
  if ((threadIdx.x & 31) == 0 && warp < 4) {
    lo_s[warp] = lo;
    hi_s[warp] = hi;
  }
  __syncthreads();
  *qmin = lo_s[0];
  *qmax = hi_s[0];
  for (int w = 1; w < 4; ++w) {
    *qmin = lo_s[w] < *qmin ? lo_s[w] : *qmin;
    *qmax = hi_s[w] > *qmax ? hi_s[w] : *qmax;
  }
}

// Rows rA and rA + 8 of a consumer warpgroup (m64 accumulators: this
// lane's columns 8 n + 2 (lane % 4) and + 1 of O): the stats, rowflag
// (no valid key), and the output in bf16, acc / max(l, 1e-30), of those
// below M with a valid key. True if one of its rows has none.
template <int HD>
__device__ __forceinline__ bool write_rows_bf16(const FwdArgs& a,
                                                const float (&o)[HD / 2],
                                                const float (&m2)[2],
                                                const float (&lsum)[2],
                                                int grA, int* rowflag, int b,
                                                int kvh) {
  const int lane = threadIdx.x & 31, M = a.Sq * a.G;
  bf16* out = static_cast<bf16*>(a.out);
  bool mine = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = grA + 8 * h;
    const bool none = m2[h] == neg_big();
    if ((lane & 3) == 0) {
      rowflag[8 * h] = gr < M && none;
      if (a.m && gr < M)
        write_stats(a.m, a.l, gr, a.G, a.Sq, a.KV, b, kvh,
                    none ? neg_big() : m2[h] * 0.6931471805599453f, lsum[h],
                    a.den);
    }
    if (gr >= M) continue;
    if (none) {
      mine = true;
      continue;
    }
    const int s_ = gr / a.G, g = gr % a.G;
    bf16* dst = out + (((long long)b * a.Sq + s_) * a.KV + kvh) * a.G * HD +
                (long long)g * HD + 2 * (lane & 3);
    const float den = fmaxf(lsum[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[4 * n + 2 * h] / den,
                                o[4 * n + 2 * h + 1] / den);
    }
  }
  return mine;
}

template <int HD>
struct TmaCfg {
  static constexpr int BM = 128;          // rows a block
  static constexpr int BN = 128;          // keys a tile
  // 64-value panels of a row, the last partial at hd 32 and 80
  static constexpr int PANELS = (HD + 63) / 64;
  static constexpr int PANEL = BN * 128;  // bytes of a K or V panel
  static constexpr int Q_PANEL = BM * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int TILE_BYTES = 2 * PANELS * PANEL;  // K and V
  static constexpr int STAGES = PANELS == 1 ? 4 : 2;
  // + 1 KB so that the panels start on the swizzle atom (1024 bytes)
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * TILE_BYTES;
  static constexpr int THREADS = 384;
  // ping-pong, a turn issuing this tile's S with the last tile's P V (hd
  // 32, 64, 80); at hd 128 S, P and O would not fit together in the 168
  // registers a thread that ptxas allocates (it spills and serialises
  // wgmma), so each warpgroup runs S, softmax, P V in turn
  static constexpr bool PAIR = HD <= 80;
  static_assert(HD == 32 || HD == 64 || HD == 80 || HD == 128,
                "the Hopper route's head sizes");
  static_assert(SMEM + 8192 <= 227 * 1024, "shared memory");
};

template <int HD>
__global__ void __launch_bounds__(384, 1)
    attn_fwd_tma(const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, FwdArgs a) {
  using C = TmaCfg<HD>;
  constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES, MAXT = 1024;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = hop::smem_u32(smem);
  const uint32_t ring = q_s + C::Q_BYTES;
  __shared__ __align__(8) uint64_t bars[2 * ST];   // full, then empty
  __shared__ long long kpos_s[ST][BN];
  __shared__ signed char kval_s[ST][BN];
  __shared__ int tile_s[ST], stt_s[ST], rowflag[BM], unseen[2];
  __shared__ unsigned char state_s[MAXT];
  __shared__ long long qlo_s[4], qhi_s[4];

  const int b = blockIdx.z, kvh = blockIdx.y, M = a.Sq * a.G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t full0 = hop::smem_u32(bars), empty0 = full0 + 8 * ST;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hop::mbar_init(full0 + 8 * s, 1);
      hop::mbar_init(empty0 + 8 * s, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < 2) unseen[threadIdx.x] = 0;
  // Q, the block's 128 rows, by every thread (its loads in flight with
  // the tile states' below): 16-byte chunk j of a 128-byte row r at chunk
  // j ^ (r % 8), the 128-byte swizzle wgmma reads
  {
    const bf16* q = static_cast<const bf16*>(a.q);
    constexpr int CH = HD / 8;
    for (int i = threadIdx.x; i < BM * CH; i += C::THREADS) {
      const int r = i / CH, c = i % CH, gr = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < M) {
        const int s = gr / a.G, g = gr % a.G;
        val = *reinterpret_cast<const uint4*>(q + b * a.qs0 + s * a.qs1 +
                                              kvh * a.qs2 + g * a.qs3 + c * 8);
      }
      *reinterpret_cast<uint4*>(smem + (c / 8) * C::Q_PANEL + r * 128 +
                                ((c % 8) ^ (r & 7)) * 16) = val;
    }
    hop::fence_proxy_async();
  }
  long long qmin, qmax;
  block_bounds(a.qpos, row0, M, a.G, qlo_s, qhi_s, &qmin, &qmax);
  const int ntiles = (a.Skv + BN - 1) / BN;
  // the tiles' states, a window of MAXT tiles at a time; the first by all
  // twelve warps, two tiles a warp a round trip, while the consumers would
  // wait for their first tile anyway; later windows by the producer
  fill_states<BN, MAXT>(state_s, 0, warp, 12, a.kpos, a.kval, ntiles, a.Skv,
                        qmin, qmax, a.causal, a.window);
  __syncthreads();
  // the warpgroup, as a value the compiler knows to be warp-uniform (a
  // divergent branch around wgmma serialises it)
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wgi == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int ptid = threadIdx.x;
    int base = 0, t = 0;
    for (int it = 0;; ++it) {
      int st = 0;
      for (; t < ntiles; ++t) {
        if (t >= base + MAXT) {
          base = t;
          named_bar(1, 128);              // the last window's readers
          fill_states<BN, MAXT>(state_s, base, warp, 4, a.kpos, a.kval,
                                ntiles, a.Skv, qmin, qmax, a.causal,
                                a.window);
          named_bar(1, 128);
        }
        st = state_s[t - base];
        if (st) break;
      }
      const int stage = it % ST;
      if (it >= ST) hop::mbar_wait(empty0 + 8 * stage, (it / ST - 1) & 1);
      const bool live = t < ntiles;
      if (live && st == 1) {
        for (int j = ptid; j < BN; j += 128) {
          const int key = t * BN + j;
          kpos_s[stage][j] = key < a.Skv ? a.kpos.at(key, key) : 0;
          kval_s[stage][j] = static_cast<signed char>(
              key >= a.Skv ? -1 : (a.kval && !a.kval[key] ? 0 : 1));
        }
      }
      if (ptid == 0) {
        tile_s[stage] = live ? t : -1;
        stt_s[stage] = st;
      }
      named_bar(1, 128);                  // the slot's notes are written
      if (ptid == 0) {
        const uint32_t bar = full0 + 8 * stage;
        if (live) {
          const uint32_t kdst = ring + stage * C::TILE_BYTES;
          const uint32_t vdst = kdst + C::PANELS * C::PANEL;
          hop::mbar_expect_tx(bar, C::TILE_BYTES);
#pragma unroll
          for (int p = 0; p < C::PANELS; ++p) {
            tma_load_4d(kdst + p * C::PANEL, &kmap, bar, p * 64, kvh, t * BN,
                        b);
            tma_load_4d(vdst + p * C::PANEL, &vmap, bar, p * 64, kvh, t * BN,
                        b);
          }
        } else {
          hop::mbar_arrive(bar);
        }
      }
      if (!live) break;
      ++t;
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int wg = wgi - 1, ctid = threadIdx.x - 128 * wgi;
    const int w = warp & 3, wrow0 = row0 + wg * 64;
    const bool active = wrow0 < M;
    const int rA = 16 * w + (lane >> 2);   // rows rA and rA + 8 of the 64
    const int grA = wrow0 + rA, grB = grA + 8;
    const long long qpA = grA < M ? a.qpos.at(grA / a.G, grA / a.G) : 0;
    const long long qpB = grB < M ? a.qpos.at(grB / a.G, grB / a.G) : 0;
    const float c2 = a.scale * 1.4426950408889634f;
    float m2[2] = {neg_big(), neg_big()}, lsum[2] = {0.f, 0.f};
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

    // hd 32, 64, 80 (PAIR): the warpgroups take turns at the tensor cores
    // (named barriers 4 and 5, ping-pong), so that one's softmax runs under
    // the other's products; a turn issues this tile's S with the last
    // tile's P V, and the last tile's slot is freed once both are done. hd
    // 128: S, softmax, then P V of the same tile, and the slot is freed.
    uint32_t pf_last[C::PAIR ? BN / 16 : 1][4];   // PAIR: the last P
    int prev = -1;                        // the last tile's slot (PAIR)
    if (C::PAIR && wg == 1) named_arrive(4, 256);   // warpgroup 0 first
    for (int it = 0;; ++it) {
      const int stage = it % ST;
      hop::mbar_wait(full0 + 8 * stage, (it / ST) & 1);
      const bool live = __shfl_sync(0xffffffffu, tile_s[stage], 0) >= 0;
      const int st = __shfl_sync(0xffffffffu, stt_s[stage], 0);
      if constexpr (C::PAIR) named_bar(4 + wg, 256);
      float s[BN / 2];
      uint32_t pf[BN / 16][4];            // P, bf16 pairs
      if (active) {
        hop::wgmma_fence();
        if (live) {
          // S = Q K^T: accumulator i is row rA + 8 ((i / 2) % 2), key
          // 8 (i / 4) + 2 (lane % 4) + i % 2
          const uint32_t kst = ring + stage * C::TILE_BYTES;
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const uint64_t ad = hop::sw128_desc(
                q_s + (kk / 4) * C::Q_PANEL + wg * 64 * 128 + (kk % 4) * 32,
                16);
            const uint64_t bd =
                hop::sw128_desc(kst + (kk / 4) * C::PANEL + (kk % 4) * 32, 16);
            wgmma_ss_n128(s, ad, bd, kk);
          }
        }
        if constexpr (C::PAIR) {
          if (prev >= 0) {
            // O += P V of the last tile, beside this tile's S
            const uint32_t vst =
                ring + prev * C::TILE_BYTES + C::PANELS * C::PANEL;
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk)
              wgmma_rs(o, pf_last[kk],
                       hop::sw128_desc(vst + kk * 2048, C::PANEL));
          }
        }
        hop::wgmma_commit();
      }
      if constexpr (C::PAIR) {
        // the other warpgroup's turn (warpgroup 1 hands back none after
        // its last, so that every turn taken was handed over once)
        if (live || wg == 0) named_arrive(4 + (wg ^ 1), 256);
      }
      if (active) hop::wgmma_wait_all();
      if (C::PAIR && prev >= 0) {
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(empty0 + 8 * prev);
      }
      if (!live) break;
      prev = stage;
      if (active) {
        tile_softmax<BN>(s, pf, o, m2, lsum, st, kval_s[stage],
                         kpos_s[stage], qpA, qpB, a.causal, a.window, c2);
      }
      if constexpr (!C::PAIR) {
        if (active) {
          // O += P V of this tile
          const uint32_t vst =
              ring + stage * C::TILE_BYTES + C::PANELS * C::PANEL;
          hop::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            wgmma_rs(o, pf[kk], hop::sw128_desc(vst + kk * 2048, C::PANEL));
          hop::wgmma_commit();
          hop::wgmma_wait_all();
        }
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(empty0 + 8 * stage);
      } else {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pf_last[kk][e] = pf[kk][e];
      }
    }
    if (!active) return;

    if (write_rows_bf16<HD>(a, o, m2, lsum, grA, rowflag + wg * 64 + rA, b,
                            kvh))
      unseen[wg] = 1;
    named_bar(2 + wg, 128);
    if (unseen[wg])
      fill_unseen<bf16>(static_cast<const bf16*>(a.v),
                        static_cast<bf16*>(a.out), rowflag + wg * 64,
                        wrow0, 64, M, a.G, a.Sq, a.Skv, a.KV, HD, b, kvh,
                        a.vs0, a.vs1, a.vs2, a.den, ctid, 128);
  }
}

// ------------------------------------------- bf16 at hd 256, Hopper route
// The Hopper route at hd 256 (attn_fwd_hd256): a block of 256 threads, two
// warpgroups of 64 rows each, 128 rows of one (lane, KV head), 64-key
// tiles, both warpgroups on every tile.
//   * Registers. O is m64n256, 128 registers a thread. The register file
//     is four sub-partitions of 16384 registers, warp w on sub-partition
//     w % 4: a block of 9 to 12 warps (attn_fwd_tma's producer warpgroup
//     and two consumers, or a producer warp and two consumers) puts three
//     warps on one of them and ptxas caps every thread at 168 (16384 / 96
//     rounded down to 8), where O, S and P spilled 420 bytes (288
//     threads). Eight warps leave two on each: 255.
//   * No producer warp, so: the block stages its next live tile (the
//     notes by warp 0, K's and V's four 64-value panels by TMA from thread
//     0, as attn_fwd_tma's producer does) before it computes the current
//     one, into the other of two stages, which the last tile's products
//     have left (a __syncthreads a tile orders that reuse). The tile
//     states are judged a window of 1024 tiles ahead by the eight warps.
//   * Shared memory: Q (128 rows, four panels) 64 KB and two stages of K
//     and V 64 KB each, 193 KB with the alignment. 128 rows share each K
//     and V tile: 64-row blocks (one consumer warpgroup beside a producer
//     warp, 160 threads; or one warpgroup staging its own 32-key tiles,
//     two blocks an SM) stream twice the keys from L2 a row and were
//     slower (PERF.md).
//   * A tile, each warpgroup: S by wgmma m64n64k16 from shared memory (16
//     steps over hd), the masks and the base-2 softmax in registers
//     (tile_softmax), P V by four m64n256k16 with V MN-major over its four
//     panels (LBO a panel). The two warpgroups' products share the tensor
//     cores, so one's softmax runs under the other's. Every wgmma is
//     issued and waited on one path: a wgmma behind a branch (an
//     inactive warpgroup, a live flag) made ptxas serialise them (C7515),
//     and S of the next tile issued before this one's softmax spilled at
//     255 registers and was slower. Rows past M compute on zeros and are
//     not written.
struct Hd256Cfg {
  static constexpr int HD = 256, BM = 128, BN = 64, PANELS = 4;
  static constexpr int PANEL = BN * 128;           // bytes of a K or V panel
  static constexpr int Q_PANEL = BM * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int TILE_BYTES = 2 * PANELS * PANEL;   // K and V
  static constexpr int STAGES = 2;
  // + 1 KB so that the panels start on the swizzle atom (1024 bytes)
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * TILE_BYTES;
  static constexpr int THREADS = 256;
  static_assert(SMEM + 4096 <= 228 * 1024, "shared memory");
};

__global__ void __launch_bounds__(256, 1)
    attn_fwd_hd256(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, FwdArgs a) {
  using C = Hd256Cfg;
  constexpr int HD = C::HD, BM = C::BM, BN = C::BN, MAXT = 1024;
  extern __shared__ uint8_t hd256_raw[];
  uint8_t* smem =
      hd256_raw + ((1024 - (hop::smem_u32(hd256_raw) & 1023)) & 1023);
  const uint32_t q_s = hop::smem_u32(smem);
  const uint32_t ring = q_s + C::Q_BYTES;
  __shared__ __align__(8) uint64_t bars[C::STAGES];     // full
  __shared__ long long kpos_s[C::STAGES][BN];
  __shared__ signed char kval_s[C::STAGES][BN];
  __shared__ int rowflag[BM];
  __shared__ unsigned char state_s[MAXT];
  __shared__ long long qlo_s[4], qhi_s[4];

  const int b = blockIdx.z, kvh = blockIdx.y, M = a.Sq * a.G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const uint32_t full0 = hop::smem_u32(bars);
  // the maps' addresses in the kernel's parameter space, for TMA
  const CUtensorMap* kmp = &kmap;
  const CUtensorMap* vmp = &vmap;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) hop::mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Q, the block's 64 rows, into the 128-byte swizzled layout wgmma reads
  {
    const bf16* q = static_cast<const bf16*>(a.q);
    constexpr int CH = HD / 8;
    for (int i = threadIdx.x; i < BM * CH; i += C::THREADS) {
      const int r = i / CH, c = i % CH, gr = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < M) {
        const int s = gr / a.G, g = gr % a.G;
        val = *reinterpret_cast<const uint4*>(q + b * a.qs0 + s * a.qs1 +
                                              kvh * a.qs2 + g * a.qs3 + c * 8);
      }
      *reinterpret_cast<uint4*>(smem + (c / 8) * C::Q_PANEL + r * 128 +
                                ((c % 8) ^ (r & 7)) * 16) = val;
    }
    hop::fence_proxy_async();
  }
  long long qmin, qmax;
  block_bounds(a.qpos, row0, M, a.G, qlo_s, qhi_s, &qmin, &qmax);
  const int ntiles = (a.Skv + BN - 1) / BN;
  int base = -MAXT;
  // the next live tile from t (every thread the same), its state in *st;
  // the states a window of MAXT tiles at a time, by the four warps
  auto next_live = [&](int t, int* st) {
    for (; t < ntiles; ++t) {
      if (t >= base + MAXT) {
        base = t;
        __syncthreads();                  // the last window's readers
        fill_states<BN, MAXT>(state_s, base, warp, 8, a.kpos, a.kval,
                              ntiles, a.Skv, qmin, qmax, a.causal, a.window);
        __syncthreads();
      }
      *st = state_s[t - base];
      if (*st) return t;
    }
    return ntiles;
  };
  // stage tile t (state st): where some pair is masked its keys' positions
  // and validity (warp 0), then K's and V's panels by TMA (thread 0)
  auto stage_tile = [&](int t, int st, int stage) {
    if (warp == 0) {
      for (int j = lane; j < BN && st == 1; j += 32) {
        const int key = t * BN + j;
        kpos_s[stage][j] = key < a.Skv ? a.kpos.at(key, key) : 0;
        kval_s[stage][j] = static_cast<signed char>(
            key >= a.Skv ? -1 : (a.kval && !a.kval[key] ? 0 : 1));
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t bar = full0 + 8 * stage;
        const uint32_t kdst = ring + stage * C::TILE_BYTES;
        const uint32_t vdst = kdst + C::PANELS * C::PANEL;
        hop::mbar_expect_tx(bar, C::TILE_BYTES);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load_4d(kdst + p * C::PANEL, kmp, bar, p * 64, kvh, t * BN, b);
          tma_load_4d(vdst + p * C::PANEL, vmp, bar, p * 64, kvh, t * BN, b);
        }
      }
    }
  };

  // rows rA and rA + 8 of the warpgroup's 64
  const int rA = 16 * (warp & 3) + (lane >> 2);
  const int grA = row0 + 64 * wg + rA, grB = grA + 8;
  const long long qpA = grA < M ? a.qpos.at(grA / a.G, grA / a.G) : 0;
  const long long qpB = grB < M ? a.qpos.at(grB / a.G, grB / a.G) : 0;
  const float c2 = a.scale * 1.4426950408889634f;
  float m2[2] = {neg_big(), neg_big()}, lsum[2] = {0.f, 0.f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  int st = 0;
  int t = next_live(0, &st);
  if (t < ntiles) stage_tile(t, st, 0);
  for (int it = 0; t < ntiles; ++it) {
    const int stage = it & 1;
    int nst = 0;
    const int tn = next_live(t + 1, &nst);
    __syncthreads();                      // the other stage's readers are done
    if (tn < ntiles) stage_tile(tn, nst, stage ^ 1);
    hop::mbar_wait(full0 + 8 * stage, (it >> 1) & 1);
    // S = Q K^T: accumulator i is row rA + 8 ((i / 2) % 2), key 8 (i / 4)
    // + 2 (lane % 4) + i % 2
    float s[BN / 2];
    uint32_t pf[BN / 16][4];              // P, bf16 pairs
    const uint32_t kst = ring + stage * C::TILE_BYTES;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s,
                   hop::sw128_desc(q_s + (kk / 4) * C::Q_PANEL + wg * 8192 +
                                       (kk % 4) * 32, 16),
                   hop::sw128_desc(kst + (kk / 4) * C::PANEL + (kk % 4) * 32,
                                   16),
                   kk);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    tile_softmax<BN>(s, pf, o, m2, lsum, st, kval_s[stage], kpos_s[stage],
                     qpA, qpB, a.causal, a.window, c2);
    // O += P V: one m64n256k16 a 16 keys
    const uint32_t vst = kst + C::PANELS * C::PANEL;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(o, pf[kk], hop::sw128_desc(vst + kk * 2048, C::PANEL));
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    t = tn;
    st = nst;
  }

  const bool mine = write_rows_bf16<HD>(a, o, m2, lsum, grA,
                                        rowflag + 64 * wg + rA, b, kvh);
  if (__syncthreads_or(mine))
    fill_unseen<bf16>(static_cast<const bf16*>(a.v),
                      static_cast<bf16*>(a.out), rowflag, row0, BM,
                      M, a.G, a.Sq, a.Skv, a.KV, HD, b, kvh, a.vs0, a.vs1,
                      a.vs2, a.den, threadIdx.x, C::THREADS);
}

// ------------------------------------------- f32, three TF32 products
// The prefill route for f32 at hd 32, 64 and 80 (kernels/flash.py::route_of;
// hubert-xlarge's encoder is f32 at hd 80): a block of 384 threads, 128
// rows of one (lane, KV head), 64-key tiles.
//   * Arithmetic. Each f32 operand x is split into big = x with the low 13
//     mantissa bits masked and small = x - big (exact) masked the same way,
//     both TF32 values; a product of two f32 matrices is taken as three TF32
//     products accumulated in f32, small.big, then big.small, then big.big
//     (the small.small term is below f32's rounding). The masks are
//     explicit: nothing rests on how the tensor cores drop the bits. At
//     hd 80 one TF32 product puts a row ~3e-3 from the f32 result, 30x
//     the f32 route's 1e-4 bound; three ~2e-6 (the CPU emulation in
//     tests/test_torch_flash.py).
//   * Prologue, every thread: Q's 128 rows, split, into shared memory as
//     big and small parts, each K-major without swizzle (core matrices of
//     8 rows x 16 bytes, 128 contiguous bytes; the next along hd 128 bytes
//     on, the next 8 rows hd * 32 bytes on), so that hd 80 (2.5 of the
//     128-byte swizzle's rows) needs no padding; the block's query-position
//     bounds and the first 1024 key tiles' states (fill_states, twelve
//     warps).
//   * Warpgroup 0, the producer and converter: for each live tile in order,
//     into a ring of two stages, K's big and small parts in Q's layout, and
//     V as it is, its rows in pairs (v[2p][d], v[2p + 1][d]) as a float2,
//     each thread's loads all in flight before its stores; the tile's notes
//     (index, state, positions and validity where some pair is masked);
//     then every thread arrives on the stage's full mbarrier. A slot with
//     index -1 ends the walk. It judges the later windows of 1024 tiles.
//   * Warpgroups 1 and 2, the consumers, 64 rows each: S = Q K^T by wgmma
//     m64n64k8 .tf32 from shared memory (three products of hd / 8 steps);
//     the masks and the online softmax in registers; O += P V by mma.sync
//     m16n8k8 .tf32, a warp's 16 rows, P straight from S's accumulators
//     and split in registers (its k index k' = t takes the tile's key 2t
//     of each 8, k' = t + 4 key 2t + 1, so V's fragment is one float2 of a
//     row pair), V split in registers as it is read; lane 0 of each warp
//     frees the stage on its empty mbarrier. P V takes mma.sync, not
//     wgmma: wgmma reads 32-bit operands K-major only (the transpose bit
//     is for 16-bit types), so it would need V^T's big and small parts in
//     shared memory, 40 KB more a stage at hd 80 beside Q's 80 KB and two
//     stages of K's parts (40 KB each): past the 227 KB a block may have.
//     f32 at hd 128 and 256 takes attn_fwd_tf32x3_wide (its note below)
//     for the same reason: Q's two parts alone would take 128 and 256 KB.
//     Each 8 keys' and 8 columns' three products go into a zeroed fragment
//     that the FMA units then add to O: the tensor cores' f32 accumulation
//     drops an addend's bits below the sum's, toward zero, a drift that
//     grows with a row's key count (O carried in the tensor cores read
//     5.5e-4 a row against the 1e-4 bound at 67000 keys on an H100).
//     The fragments cost registers: at hd 64 and 80 ptxas takes the 168
//     that 384 threads leave and spills 100 and 112 bytes (none at hd 32;
//     with the column blocks outermost 32 and 20, no faster). Both stay
//     here: at hubert's shape an FMA kernel took 4.5x as long.
// The softmax keeps f32's accuracy in base 2 with the difference first: m
// the running max of q.k (unscaled), p = 2^((q.k - m) scale log2 e) by
// ex2.approx (2 ulp), the correction 2^((m_old - m_new) scale log2 e); a
// masked pair is -inf (p = 0), so a fully masked tile leaves m, l and O as
// they were (p = 0, correction 2^0 = 1) and skipping it is bitwise what
// computing it gives. The stats come back as m scale, in natural log (a
// row with no valid key keeps _NEG and takes l = the padded key count). No
// atomics: a row's result depends on its q row, its lane's k/v and the
// masks alone. Bound: the tensor cores' TF32 rate over the three products
// (495 TFLOP/s dense), and the conversions' shared-memory traffic.

// four values' big parts at dst, their small parts `part` bytes on
__device__ __forceinline__ void store_split(uint8_t* dst, int part,
                                            float4 x) {
  uint4 hi, lo;
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(dst) = hi;
  *reinterpret_cast<uint4*>(dst + part) = lo;
}

// Shared-memory matrix descriptor of a K-major tile without swizzle (layout
// type 0): core matrices of 8 rows x 16 bytes, 128 contiguous bytes each;
// the next along K lbo bytes on, the next 8 rows sbo bytes on
__device__ __forceinline__ uint64_t plain_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// S (64 x 64, f32) = or += A (64 x 8) B (8 x 64): both tf32, K-major, from
// shared memory; scale_d 0 overwrites S
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int HD>
struct Tf32Cfg {
  static constexpr int BM = 128;              // rows a block
  static constexpr int BN = 64;               // keys a tile
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 384;
  static constexpr int C4 = HD / 4;           // 16-byte chunks of a row
  static constexpr int SBO = C4 * 128;        // bytes of 8 rows
  static constexpr int Q_PART = BM * HD * 4;  // Q's big or small part
  static constexpr int K_PART = BN * HD * 4;  // a tile's K, big or small
  // float2s of a row pair: hd + 4 (= 4 mod 16), so that a warp's V
  // fragments (4 row pairs x 8 columns) hit 32 distinct banks
  static constexpr int VP = HD + 4;
  static constexpr int V_BYTES = BN / 2 * VP * 8;
  static constexpr int STAGE = 2 * K_PART + V_BYTES;
  // hd 80: 80 KB of Q, two stages of 61 KB
  static constexpr int SMEM = 2 * Q_PART + STAGES * STAGE;
  // the producer's float4s a tile: K, and V's pairs of rows
  static constexpr int KN = BN * C4 / 128, VN = BN / 2 * C4 / 128;
  static_assert(HD == 32 || HD == 64 || HD == 80,
                "the tf32x3 route's head sizes");
  static_assert(KN * 128 == BN * C4 && VN * 128 == BN / 2 * C4, "tiles");
  static_assert(SMEM <= 227 * 1024 - 4096, "shared memory");
};

template <int HD>
__global__ void __launch_bounds__(384, 1) attn_fwd_tf32x3(FwdArgs a) {
  using C = Tf32Cfg<HD>;
  constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES, C4 = C::C4;
  constexpr int MAXT = 1024;
  extern __shared__ __align__(16) uint8_t fsmem[];
  uint8_t* ring_p = fsmem + 2 * C::Q_PART;
  const uint32_t q_s = hop::smem_u32(fsmem);
  const uint32_t ring = q_s + 2 * C::Q_PART;
  __shared__ __align__(8) uint64_t bars[2 * ST];   // full, then empty
  __shared__ long long kpos_s[ST][BN];
  __shared__ signed char kval_s[ST][BN];
  __shared__ int tile_s[ST], stt_s[ST], rowflag[BM], unseen[2];
  __shared__ unsigned char state_s[MAXT];
  __shared__ long long qlo_s[4], qhi_s[4];

  const int b = blockIdx.z, kvh = blockIdx.y, M = a.Sq * a.G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t full0 = hop::smem_u32(bars), empty0 = full0 + 8 * ST;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hop::mbar_init(full0 + 8 * s, 128);  // every producer thread
      hop::mbar_init(empty0 + 8 * s, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < 2) unseen[threadIdx.x] = 0;
  // Q's parts, by every thread: chunk c of row r in core matrix (r / 8, c),
  // eight neighbouring threads a core matrix
  {
    const float* q = static_cast<const float*>(a.q);
    for (int i = threadIdx.x; i < BM * C4; i += C::THREADS) {
      const int r = (i >> 3) / C4 * 8 + (i & 7), c = (i >> 3) % C4;
      const int gr = row0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < M) {
        const int s = gr / a.G, g = gr % a.G;
        x = *reinterpret_cast<const float4*>(q + b * a.qs0 + s * a.qs1 +
                                             kvh * a.qs2 + g * a.qs3 + c * 4);
      }
      store_split(fsmem + (r >> 3) * C::SBO + c * 128 + (r & 7) * 16,
                  C::Q_PART, x);
    }
    hop::fence_proxy_async();
  }
  long long qmin, qmax;
  block_bounds(a.qpos, row0, M, a.G, qlo_s, qhi_s, &qmin, &qmax);
  const int ntiles = (a.Skv + BN - 1) / BN;
  fill_states<BN, MAXT>(state_s, 0, warp, 12, a.kpos, a.kval, ntiles, a.Skv,
                        qmin, qmax, a.causal, a.window);
  __syncthreads();
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wgi == 0) {
    // ------------------------------------------------- producer, converter
    const int ptid = threadIdx.x;
    const float* kb = static_cast<const float*>(a.k) + b * a.ks0 +
                      kvh * a.ks2;
    const float* vb = static_cast<const float*>(a.v) + b * a.vs0 +
                      kvh * a.vs2;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    int base = 0, t = 0;
    for (int it = 0;; ++it) {
      int st = 0;
      for (; t < ntiles; ++t) {
        if (t >= base + MAXT) {
          base = t;
          named_bar(1, 128);              // the last window's readers
          fill_states<BN, MAXT>(state_s, base, warp, 4, a.kpos, a.kval,
                                ntiles, a.Skv, qmin, qmax, a.causal,
                                a.window);
          named_bar(1, 128);
        }
        st = state_s[t - base];
        if (st) break;
      }
      const int stage = it % ST;
      const bool live = t < ntiles;
      // the tile's loads go out before the wait for its slot
      float4 kx[C::KN], vx[C::VN][2];
      if (live) {
        const int key0 = t * BN;
#pragma unroll
        for (int u = 0; u < C::KN; ++u) {
          const int i = ptid + 128 * u;
          const int key = key0 + (i >> 3) / C4 * 8 + (i & 7);
          kx[u] = key < a.Skv ? *reinterpret_cast<const float4*>(
                                    kb + key * a.ks1 + (i >> 3) % C4 * 4)
                              : zero;
        }
#pragma unroll
        for (int u = 0; u < C::VN; ++u) {
          const int i = ptid + 128 * u;
          const int key = key0 + 2 * (i / C4), c = i % C4;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            vx[u][h] = key + h < a.Skv
                           ? *reinterpret_cast<const float4*>(
                                 vb + (key + h) * a.vs1 + c * 4)
                           : zero;
        }
      }
      if (it >= ST) hop::mbar_wait(empty0 + 8 * stage, (it / ST - 1) & 1);
      if (live) {
        if (st == 1) {
          for (int j = ptid; j < BN; j += 128) {
            const int key = t * BN + j;
            kpos_s[stage][j] = key < a.Skv ? a.kpos.at(key, key) : 0;
            kval_s[stage][j] = static_cast<signed char>(
                key >= a.Skv ? -1 : (a.kval && !a.kval[key] ? 0 : 1));
          }
        }
        uint8_t* kst = ring_p + stage * C::STAGE;
#pragma unroll
        for (int u = 0; u < C::KN; ++u) {
          const int i = ptid + 128 * u;
          const int r = (i >> 3) / C4 * 8 + (i & 7), c = (i >> 3) % C4;
          store_split(kst + (r >> 3) * C::SBO + c * 128 + (r & 7) * 16,
                      C::K_PART, kx[u]);
        }
        uint8_t* vst = kst + 2 * C::K_PART;
#pragma unroll
        for (int u = 0; u < C::VN; ++u) {
          const int i = ptid + 128 * u;
          float4* d = reinterpret_cast<float4*>(
              vst + ((i / C4) * C::VP + 4 * (i % C4)) * 8);
          d[0] = make_float4(vx[u][0].x, vx[u][1].x, vx[u][0].y, vx[u][1].y);
          d[1] = make_float4(vx[u][0].z, vx[u][1].z, vx[u][0].w, vx[u][1].w);
        }
        hop::fence_proxy_async();         // K's parts are read by wgmma
      }
      if (ptid == 0) {
        tile_s[stage] = live ? t : -1;
        stt_s[stage] = st;
      }
      hop::mbar_arrive(full0 + 8 * stage);
      if (!live) break;
      ++t;
    }
  } else {
    // --------------------------------------------------------- consumers
    const int wg = wgi - 1, ctid = threadIdx.x - 128 * wgi;
    const int w = warp & 3, wrow0 = row0 + wg * 64;
    const bool active = wrow0 < M;
    const int gq = lane >> 2, tq = lane & 3;
    const int rA = 16 * w + gq;            // rows rA and rA + 8 of the 64
    const int grA = wrow0 + rA, grB = grA + 8;
    const long long qpA = grA < M ? a.qpos.at(grA / a.G, grA / a.G) : 0;
    const long long qpB = grB < M ? a.qpos.at(grB / a.G, grB / a.G) : 0;
    const float c2 = a.scale * 1.4426950408889634f;
    float m[2] = {neg_big(), neg_big()}, lsum[2] = {0.f, 0.f};
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    const uint32_t qa = q_s + wg * 8 * C::SBO;    // the warpgroup's rows

    for (int it = 0;; ++it) {
      const int stage = it % ST;
      hop::mbar_wait(full0 + 8 * stage, (it / ST) & 1);
      const bool live = __shfl_sync(0xffffffffu, tile_s[stage], 0) >= 0;
      const int st = __shfl_sync(0xffffffffu, stt_s[stage], 0);
      if (!live) break;
      if (active) {
        // S = Q K^T: small.big, big.small, big.big; accumulator i is row
        // rA + 8 ((i / 2) % 2), key 8 (i / 4) + 2 tq + i % 2
        const uint32_t kst = ring + stage * C::STAGE;
        float s[BN / 2];
        hop::wgmma_fence();
#pragma unroll
        for (int pr = 0; pr < 3; ++pr) {
          const uint32_t qp = qa + (pr == 0 ? C::Q_PART : 0);
          const uint32_t kp = kst + (pr == 1 ? C::K_PART : 0);
#pragma unroll
          for (int kk = 0; kk < HD / 8; ++kk)
            wgmma_tf32_n64(s, plain_desc(qp + kk * 256, 128, C::SBO),
                           plain_desc(kp + kk * 256, 128, C::SBO), pr + kk);
        }
        hop::wgmma_commit();
        hop::wgmma_wait_all();
        // mask (a masked pair and a key past Skv: -inf, p = 0); the tile's
        // row maxima of q.k
        float tmax[2] = {-INFINITY, -INFINITY};
        if (st == 2) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
        } else {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
            const int h = (i >> 1) & 1;
            if (kval_s[stage][col] <= 0 ||
                !allowed(h ? qpB : qpA, kpos_s[stage][col], a.causal,
                         a.window))
              s[i] = -INFINITY;
            tmax[h] = fmaxf(tmax[h], s[i]);
          }
        }
        float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
          tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
          const float m_new = fmaxf(m[h], tmax[h]);
          corr[h] = ex2((m[h] - m_new) * c2);
          m[h] = m_new;
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int h = (i >> 1) & 1;
          s[i] = ex2((s[i] - m[h]) * c2);
          rsum[h] += s[i];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
          rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
          lsum[h] = lsum[h] * corr[h] + rsum[h];
        }
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[n][0] *= corr[0]; o[n][1] *= corr[0];
          o[n][2] *= corr[1]; o[n][3] *= corr[1];
        }
        // O += P V: small.big, big.small, big.big for each 8 keys and 8
        // columns into a zeroed fragment, added to O in f32; V's fragment,
        // keys 8 kb + 2 tq and + 1 of column 8 n + gq, is one float2 of row
        // pair 4 kb + tq
        const float2* vt =
            reinterpret_cast<const float2*>(ring_p + stage * C::STAGE +
                                            2 * C::K_PART) +
            tq * C::VP + gq;
#pragma unroll
        for (int kb = 0; kb < BN / 8; ++kb) {
          uint32_t pb[4], ps[4];
          split_tf32(s[4 * kb], pb[0], ps[0]);
          split_tf32(s[4 * kb + 2], pb[1], ps[1]);
          split_tf32(s[4 * kb + 1], pb[2], ps[2]);
          split_tf32(s[4 * kb + 3], pb[3], ps[3]);
#pragma unroll
          for (int n = 0; n < HD / 8; ++n) {
            const float2 x = vt[kb * 4 * C::VP + 8 * n];
            uint32_t vb0, vs0, vb1, vs1;
            split_tf32(x.x, vb0, vs0);
            split_tf32(x.y, vb1, vs1);
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, ps, vb0, vb1);
            mma_tf32(d, pb, vs0, vs1);
            mma_tf32(d, pb, vb0, vb1);
#pragma unroll
            for (int j = 0; j < 4; ++j) o[n][j] += d[j];
          }
        }
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(empty0 + 8 * stage);
    }
    if (!active) return;

    float* out = static_cast<float*>(a.out);
    bool mine = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = h ? grB : grA;
      const bool none = m[h] == neg_big();
      if (tq == 0) {
        rowflag[wg * 64 + rA + 8 * h] = gr < M && none;
        if (a.m && gr < M)
          write_stats(a.m, a.l, gr, a.G, a.Sq, a.KV, b, kvh,
                      none ? neg_big() : m[h] * a.scale, lsum[h], a.den);
      }
      if (gr >= M) continue;
      if (none) {
        mine = true;
        continue;
      }
      const int s_ = gr / a.G, g = gr % a.G;
      float* dst = out + (((long long)b * a.Sq + s_) * a.KV + kvh) * a.G * HD +
                   (long long)g * HD + 2 * tq;
      const float den = fmaxf(lsum[h], 1e-30f);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(o[n][2 * h] / den, o[n][2 * h + 1] / den);
    }
    if (mine) unseen[wg] = 1;
    named_bar(2 + wg, 128);
    if (unseen[wg])
      fill_unseen<float>(static_cast<const float*>(a.v), out,
                         rowflag + wg * 64, wrow0, 64, M, a.G, a.Sq, a.Skv,
                         a.KV, HD, b, kvh, a.vs0, a.vs1, a.vs2, a.den, ctid,
                         128);
  }
}

// ---------------------------- f32 at hd 128 and 256, three TF32 products
// The tf32x3 route at hd 128 and 256 (attn_fwd_tf32x3_wide): the
// arithmetic of attn_fwd_tf32x3 (each f32 product as three TF32 products,
// the splits masked explicitly; each 8 keys' P V products added to O by the
// FMA units) in another layout, since its parts do not fit here: Q's big
// and small parts alone would take 128 and 256 KB of 128 rows, K's two
// more a tile.
//   * Shared memory holds each operand once, raw f32: Q's 128 rows, one
//     tile of K and one of V, each row hd + 4 floats apart, so that a
//     warp's fragment loads hit 32 distinct banks: 132 KB at hd 128
//     (64-key tiles), 195 KB at hd 256 (32-key tiles).
//   * Every product is mma.sync m16n8k8 .tf32 on a warp's 16 rows, both
//     operands split into big and small parts in registers as they are
//     read from shared memory. S: small.big and big.small into one
//     accumulator, big.big into another, the two added once the hd steps
//     are done, so that the small terms keep their bits; P V as in
//     attn_fwd_tf32x3 (P from S's accumulators, V's fragment keys 2t and
//     2t + 1 of each 8, each 8 keys' and 8 columns' three products into a
//     zeroed fragment that the FMA units add to O). wgmma would read K's
//     parts from shared memory, two more copies of a tile, which do not
//     fit at hd 256 beside Q and V with 128 rows a block.
//   * 256 threads, eight warps of 16 rows, no producer: O at hd 256 is 128
//     registers a thread, and eight warps leave ptxas 255 (attn_fwd_hd256's
//     note). The block stages its own tiles by cp.async in two phases a
//     tile: K of the next live tile is copied while this tile's softmax
//     and P V run (K's buffer is free once S is taken), V of the next while
//     its S runs; the tile's notes (where some pair is masked, its keys'
//     positions and validity) go with K. Tile states a window of 1024
//     ahead, by the eight warps.
// Softmax, masks, stats, skipped tiles and rows with no valid key as in
// attn_fwd_tf32x3. Bound: the tensor cores' TF32 rate over the three
// products (495 TFLOP/s dense); mma.sync takes every operand through the
// warp's registers, so the shared-memory reads (each warp reads the whole
// K and V tile) and the splits' instructions come close behind.
template <int HD>
struct Tf32WideCfg {
  static constexpr int BM = 128;                  // rows a block
  static constexpr int BN = HD == 128 ? 64 : 32;  // keys a tile
  static constexpr int THREADS = 256;
  static constexpr int LD = HD + 4;               // floats a row
  static constexpr int Q_FLOATS = BM * LD;
  static constexpr int KV_FLOATS = BN * LD;
  static constexpr int SMEM = 4 * (Q_FLOATS + 2 * KV_FLOATS);
  static_assert(HD == 128 || HD == 256, "the wide tf32x3 head sizes");
  static_assert(SMEM + 4096 <= 227 * 1024, "shared memory");
};

template <int HD>
__global__ void __launch_bounds__(256, 1) attn_fwd_tf32x3_wide(FwdArgs a) {
  using C = Tf32WideCfg<HD>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, CH = HD / 4;
  constexpr int MAXT = 1024;
  extern __shared__ __align__(16) float wide_smem[];
  float* Qs = wide_smem;
  float* Ks = Qs + C::Q_FLOATS;
  float* Vs = Ks + C::KV_FLOATS;
  __shared__ long long kpos_s[BN];
  __shared__ signed char kval_s[BN];
  __shared__ int rowflag[BM];
  __shared__ unsigned char state_s[MAXT];
  __shared__ long long qlo_s[4], qhi_s[4];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y, M = a.Sq * a.G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const float* kg = static_cast<const float*>(a.k) + b * a.ks0 + kvh * a.ks2;
  const float* vg = static_cast<const float*>(a.v) + b * a.vs0 + kvh * a.vs2;
  // Q's 128 rows, 16 bytes a copy (rows past M zeros)
  {
    const float* q = static_cast<const float*>(a.q);
    for (int i = tid; i < BM * CH; i += C::THREADS) {
      const int r = i / CH, c = i % CH, gr = row0 + r;
      const bool in = gr < M;
      const int s = in ? gr / a.G : 0, g = in ? gr % a.G : 0;
      cp_async16(Qs + r * LD + c * 4,
                 q + b * a.qs0 + s * a.qs1 + kvh * a.qs2 + g * a.qs3 + c * 4,
                 in);
    }
    cp_async_commit();
  }
  long long qmin, qmax;
  block_bounds(a.qpos, row0, M, a.G, qlo_s, qhi_s, &qmin, &qmax);
  const int ntiles = (a.Skv + BN - 1) / BN;
  int base = -MAXT;
  // the next live tile from t (every thread the same), its state in *st;
  // the states a window of MAXT tiles at a time, by the eight warps
  auto next_live = [&](int t, int* st) {
    for (; t < ntiles; ++t) {
      if (t >= base + MAXT) {
        base = t;
        __syncthreads();                  // the last window's readers
        fill_states<BN, MAXT>(state_s, base, warp, 8, a.kpos, a.kval,
                              ntiles, a.Skv, qmin, qmax, a.causal, a.window);
        __syncthreads();
      }
      *st = state_s[t - base];
      if (*st) return t;
    }
    return ntiles;
  };
  // tile t's rows of src (K or V of the lane and head, rs floats a row)
  // into dst, 16 bytes a copy, keys past Skv zeros; one cp.async group
  auto copy_tile = [&](float* dst, const float* src, long long rs, int t) {
    for (int i = tid; i < BN * CH; i += C::THREADS) {
      const int j = i / CH, c = i % CH, key = t * BN + j;
      const bool in = key < a.Skv;
      cp_async16(dst + j * LD + c * 4, src + (in ? key : 0) * rs + c * 4, in);
    }
    cp_async_commit();
  };
  // K of tile t (state st) with its notes
  auto stage_k = [&](int t, int st) {
    for (int j = tid; j < BN && st == 1; j += C::THREADS) {
      const int key = t * BN + j;
      kpos_s[j] = key < a.Skv ? a.kpos.at(key, key) : 0;
      kval_s[j] = static_cast<signed char>(
          key >= a.Skv ? -1 : (a.kval && !a.kval[key] ? 0 : 1));
    }
    copy_tile(Ks, kg, a.ks1, t);
  };

  const int rA = 16 * warp + gq;          // rows rA and rA + 8 of the block
  const int grA = row0 + rA, grB = grA + 8;
  const long long qpA = grA < M ? a.qpos.at(grA / a.G, grA / a.G) : 0;
  const long long qpB = grB < M ? a.qpos.at(grB / a.G, grB / a.G) : 0;
  const float c2 = a.scale * 1.4426950408889634f;
  float m[2] = {neg_big(), neg_big()}, lsum[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // A's fragment, (row, k): (rA, tq), (rA + 8, tq), (rA, tq + 4), (rA + 8,
  // tq + 4) of each 8 columns
  const float* qw = Qs + rA * LD + tq;

  int st = 0;
  int t = next_live(0, &st);
  if (t < ntiles) {
    stage_k(t, st);
    copy_tile(Vs, vg, a.vs1, t);
    cp_async_wait<1>();                   // Q and the first K
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  while (t < ntiles) {
    // S = Q K^T: s[j] the keys 8 j + 2 tq and + 1 of rows rA ([0], [1])
    // and rA + 8 ([2], [3]); sl the small terms
    float s[BN / 8][4], sl[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t qb[4], qs[4];
      split_tf32(qw[8 * kk], qb[0], qs[0]);
      split_tf32(qw[8 * LD + 8 * kk], qb[1], qs[1]);
      split_tf32(qw[8 * kk + 4], qb[2], qs[2]);
      split_tf32(qw[8 * LD + 8 * kk + 4], qb[3], qs[3]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        // B's fragment (k, key): (tq, gq), (tq + 4, gq) of key block j
        const float* kr = Ks + (8 * j + gq) * LD + 8 * kk + tq;
        uint32_t kb0, ks0, kb1, ks1;
        split_tf32(kr[0], kb0, ks0);
        split_tf32(kr[4], kb1, ks1);
        mma_tf32(sl[j], qs, kb0, kb1);
        mma_tf32(sl[j], qb, ks0, ks1);
        mma_tf32(s[j], qb, kb0, kb1);
      }
    }
    // mask (a masked pair and a key past Skv: -inf, p = 0); the tile's
    // row maxima of q.k
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tq + (e & 1), h = e >> 1;
        float x = s[j][e] + sl[j][e];
        if (st == 1 && (kval_s[col] <= 0 ||
                        !allowed(h ? qpB : qpA, kpos_s[col], a.causal,
                                 a.window)))
          x = -INFINITY;
        s[j][e] = x;
        tmax[h] = fmaxf(tmax[h], x);
      }
    }
    __syncthreads();                      // K's and the notes' readers
    int nst = 0;
    const int tn = next_live(t + 1, &nst);
    if (tn < ntiles) {
      stage_k(tn, nst);
      cp_async_wait<1>();                 // this tile's V
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);
      corr[h] = ex2((m[h] - m_new) * c2);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[j][e] = ex2((s[j][e] - m[h]) * c2);
        rsum[h] += s[j][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
      lsum[h] = lsum[h] * corr[h] + rsum[h];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }
    // O += P V: small.big, big.small, big.big for each 8 keys and 8
    // columns into a zeroed fragment, added to O in f32; V's fragment,
    // keys 8 kb + 2 tq and + 1 of column 8 n + gq
#pragma unroll
    for (int kb = 0; kb < BN / 8; ++kb) {
      uint32_t pb[4], ps[4];
      split_tf32(s[kb][0], pb[0], ps[0]);
      split_tf32(s[kb][2], pb[1], ps[1]);
      split_tf32(s[kb][1], pb[2], ps[2]);
      split_tf32(s[kb][3], pb[3], ps[3]);
      const float* vr = Vs + (8 * kb + 2 * tq) * LD + gq;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t vb0, vs0, vb1, vs1;
        split_tf32(vr[8 * n], vb0, vs0);
        split_tf32(vr[LD + 8 * n], vb1, vs1);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(d, ps, vb0, vb1);
        mma_tf32(d, pb, vs0, vs1);
        mma_tf32(d, pb, vb0, vb1);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += d[e];
      }
    }
    __syncthreads();                      // V's readers
    if (tn < ntiles) {
      copy_tile(Vs, vg, a.vs1, tn);
      cp_async_wait<1>();                 // the next tile's K
    }
    __syncthreads();
    t = tn;
    st = nst;
  }

  float* out = static_cast<float*>(a.out);
  bool mine = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = h ? grB : grA;
    const bool none = m[h] == neg_big();
    if (tq == 0) {
      rowflag[rA + 8 * h] = gr < M && none;
      if (a.m && gr < M)
        write_stats(a.m, a.l, gr, a.G, a.Sq, a.KV, b, kvh,
                    none ? neg_big() : m[h] * a.scale, lsum[h], a.den);
    }
    if (gr >= M) continue;
    if (none) {
      mine = true;
      continue;
    }
    const int s_ = gr / a.G, g = gr % a.G;
    float* dst = out + (((long long)b * a.Sq + s_) * a.KV + kvh) * a.G * HD +
                 (long long)g * HD + 2 * tq;
    const float den = fmaxf(lsum[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][2 * h] / den, o[n][2 * h + 1] / den);
  }
  if (__syncthreads_or(mine))
    fill_unseen<float>(static_cast<const float*>(a.v), out, rowflag, row0,
                       BM, M, a.G, a.Sq, a.Skv, a.KV, HD, b, kvh, a.vs0,
                       a.vs1, a.vs2, a.den, tid, C::THREADS);
}

// -------------------------------------------------------------- decode
struct DecArgs {
  const void *q, *k, *v;
  Pos pos;
  void* out;
  float *acc, *m, *l;     // the stats (return_stats), else null
  float *pacc, *pml;      // the splits' partials (nsplit > 1), else null
  int* tickets;           // a (lane, KV head, head group)'s splits done
  int S_max, KV, G, nsplit, split_rows;   // cache rows a split
  long long qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2;
  int window;
  long long koff;
  float scale;
  int stats;
};

// 16 bytes from global to shared, asynchronously (cache in L2 only)
__device__ __forceinline__ void cp_async16_cg(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

template <typename T, int HD, int GB>
struct DecCfg {
  static constexpr int CPR = HD / 8;     // 8-value chunks a row
  static constexpr int LPR = CPR <= 4 ? 4 : CPR <= 8 ? 8 : CPR <= 16 ? 16 : 32;
  static constexpr int RP = NT / LPR;    // row slots
  static constexpr int R = 4;            // rows a slot a stage
  static constexpr int STAGES = 3;
  static constexpr int CB = 8 * sizeof(T);             // bytes a chunk
  static constexpr int ROWS = RP * R;                  // rows a stage
  static constexpr int STAGE_BYTES = R * 2 * NT * CB;  // K and V
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int RED = 4 * GB * (HD + 2) * 4;    // a warp's merge
  static constexpr int SMEM = RING > RED ? RING : RED;
};

// One split of split_rows cache rows of one (lane, KV head), for GB of its
// query heads (GB from {1, 2, 4, 8}, >= min(G, 8)), in one launch with the
// merge of the splits.
//   * Rows: LPR lanes a row slot, 8 values (16 bytes of bf16) a lane; the
//     split's rows that can be valid go by in stages of RP x R rows
//     (aligned to the split's start), row i * RP + slot of a stage to its
//     slot. Each thread copies its own chunks of K and V into a ring of
//     STAGES stages (cp.async, 16 bytes, waited per thread: no barrier in
//     the loop), so two stages are in flight while one is computed.
//   * A slot keeps its own online softmax (base 2, as the prefill's Hopper
//     route) over its rows: the scores' partial dots summed across the
//     slot's lanes by an xor butterfly (every lane ends with the same
//     bits), one correction a stage, p rounded to the cache's dtype before
//     p v. The slots merge by a butterfly within a warp, then the four
//     warps in order through shared memory (the ring's bytes).
//   * One split writes the output (or the stats) itself. More: each block
//     writes its split's f32 partials (acc, m, l), then takes a ticket;
//     the last block of the (lane, KV head, head group) resets its ticket
//     to 0 and merges the partials in split order. Tickets are zero
//     between launches; no sum takes an atomic.
// Bound: the bytes of the valid rows.
template <typename T, int HD, int GB>
__global__ void __launch_bounds__(NT) decode_attn(DecArgs a) {
  using C = DecCfg<T, HD, GB>;
  constexpr int LPR = C::LPR, RP = C::RP, R = C::R, ST = C::STAGES;
  constexpr int CB = C::CB;
  extern __shared__ __align__(16) unsigned char dsmem[];
  __shared__ int last;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rl = tid / LPR, c = tid % LPR;
  const bool col = c < C::CPR;
  // x the (KV head, head group), fastest: the blocks in flight together
  // read the same cache rows of neighbouring heads
  const int split = blockIdx.y, b = blockIdx.z;
  const int ngroups = (a.G + GB - 1) / GB;
  const int kvh = blockIdx.x / ngroups, g0 = (blockIdx.x % ngroups) * GB;
  const int gn = a.G - g0 < GB ? a.G - g0 : GB;
  const float c2 = a.scale * 1.4426950408889634f;

  float qv[GB][8], acc[GB][8], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[g][e] = acc[g][e] = 0.f;
    m[g] = neg_big();
    l[g] = 0.f;
    if (g < gn && col)
      load8(q + b * a.qs0 + kvh * a.qs1 + (g0 + g) * a.qs2 + c * 8, qv[g]);
  }
  // the rows that can be valid: [lo, hi]; none -> with stats nothing is
  // read (m = _NEG, l = 0, acc = 0), else every row masked (the plain
  // version's mean of v)
  const long long p = a.pos.at(b, 0);
  long long hi = p - a.koff;
  long long lo = a.window > 0 ? hi - a.window + 1 : 0;
  lo = lo < 0 ? 0 : lo;
  hi = hi > a.S_max - 1 ? a.S_max - 1 : hi;
  bool masked = false;
  if (lo > hi && !a.stats) {
    lo = 0;
    hi = a.S_max - 1;
    masked = true;
  }
  const long long s0 = (long long)split * a.split_rows;
  const long long r0 = lo > s0 ? lo : s0;
  const long long r1 =
      hi < s0 + a.split_rows - 1 ? hi : s0 + a.split_rows - 1;
  const long long t_first = s0 + (r0 - s0) / C::ROWS * C::ROWS;
  const int nst = r0 <= r1 ? static_cast<int>((r1 - t_first) / C::ROWS) + 1
                           : 0;
  const T* kb = k + b * a.ks0 + kvh * a.ks2 + c * 8;
  const T* vb = v + b * a.vs0 + kvh * a.vs2 + c * 8;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(dsmem));
  // this thread's chunk of row i of a stage: K, then V
  auto slot = [&](int stage, int i, int kv) {
    return ring + stage * C::STAGE_BYTES + ((i * 2 + kv) * NT + tid) * CB;
  };
  auto issue = [&](int j) {
    if (j < nst) {
      const long long t0 = t_first + (long long)j * C::ROWS;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long row = t0 + i * RP + rl;
        if (col && row >= r0 && row <= r1) {
#pragma unroll
          for (int h = 0; h < CB / 16; ++h) {
            cp_async16_cg(slot(j % ST, i, 0) + 16 * h, kb + row * a.ks1 +
                                                       h * (16 / sizeof(T)));
            cp_async16_cg(slot(j % ST, i, 1) + 16 * h, vb + row * a.vs1 +
                                                       h * (16 / sizeof(T)));
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) issue(j);

  for (int j = 0; j < nst; ++j) {
    issue(j + ST - 1);
    cp_async_wait<ST - 1>();
    const long long t0 = t_first + (long long)j * C::ROWS;
    const unsigned char* stage =
        dsmem + (j % ST) * C::STAGE_BYTES + tid * CB;
    float s[R][GB];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long row = t0 + i * RP + rl;
      const bool in = row >= r0 && row <= r1;
      float dot[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) dot[g] = 0.f;
      if (in && col) {
        float f[8];
        load8(reinterpret_cast<const T*>(stage + (i * 2) * NT * CB), f);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) dot[g] += qv[g][e] * f[e];
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int o = LPR / 2; o; o >>= 1)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
        s[i][g] = !in ? -INFINITY : (masked ? neg_big() : dot[g] * c2);
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float tmax = s[0][g];
#pragma unroll
      for (int i = 1; i < R; ++i) tmax = fmaxf(tmax, s[i][g]);
      const float m_new = fmaxf(m[g], tmax);
      const float corr = ex2(m[g] - m_new);
      m[g] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s[i][g] = ex2(s[i][g] - m_new);
        sum += s[i][g];
        s[i][g] = round_as(s[i][g], T());
      }
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long row = t0 + i * RP + rl;
      if (!col || row < r0 || row > r1) continue;
      float f[8];
      load8(reinterpret_cast<const T*>(stage + (i * 2 + 1) * NT * CB), f);
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] += s[i][g] * f[e];
    }
  }
  cp_async_wait<0>();

  // the slots of a warp, by an xor butterfly; then the warps in order
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float wa = ex2(m[g] - mn), wb = ex2(mo - mn);
      l[g] = l[g] * wa + lo_ * wb;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * wa + ao * wb;
      }
      m[g] = mn;
    }
  }
  __syncthreads();                        // the ring's bytes are free
  float* red = reinterpret_cast<float*>(dsmem);   // [4][GB][HD + 2]
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float* r = red + (warp * GB + g) * (HD + 2);
      if (col)
#pragma unroll
        for (int e = 0; e < 8; ++e) r[c * 8 + e] = acc[g][e];
      if (lane == 0) {
        r[HD] = m[g];
        r[HD + 1] = l[g];
      }
    }
  }
  __syncthreads();
  const long long head = (long long)b * a.KV + kvh;
  for (int i = tid; i < gn * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float mm = neg_big();
#pragma unroll
    for (int w = 0; w < 4; ++w)
      mm = fmaxf(mm, red[(w * GB + g) * (HD + 2) + HD]);
    float av = 0.f, lv = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* r = red + (w * GB + g) * (HD + 2);
      const float wt = ex2(r[HD] - mm);
      av += r[d] * wt;
      lv += r[HD + 1] * wt;
    }
    const long long hg = head * a.G + g0 + g;
    if (a.nsplit > 1) {
      const long long pi = (head * a.nsplit + split) * a.G + g0 + g;
      a.pacc[pi * HD + d] = av;
      if (d == 0) {
        a.pml[pi * 2] = mm;
        a.pml[pi * 2 + 1] = lv;
      }
    } else if (a.stats) {
      a.acc[hg * HD + d] = av;
      if (d == 0) {
        a.m[hg] = mm == neg_big() ? mm : mm * 0.6931471805599453f;
        a.l[hg] = lv;
      }
    } else {
      static_cast<T*>(a.out)[hg * HD + d] = from_f<T>(av / fmaxf(lv, 1e-30f));
    }
  }
  if (a.nsplit == 1) return;

  // the last split block of this (lane, KV head, head group) merges
  __threadfence();
  __syncthreads();
  const int tix = b * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(a.tickets + tix, 1) == a.nsplit - 1;
  __syncthreads();
  if (!last) return;
  if (tid == 0) a.tickets[tix] = 0;      // consumed: zero for the next launch
  __threadfence();
  for (int i = tid; i < gn * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    const long long p0 = head * a.nsplit * a.G + g0 + g;   // split 0
    float mg = neg_big();
    for (int j = 0; j < a.nsplit; ++j)
      mg = fmaxf(mg, __ldcg(a.pml + (p0 + (long long)j * a.G) * 2));
    float av = 0.f, lv = 0.f;
    for (int j = 0; j < a.nsplit; ++j) {
      const long long pj = p0 + (long long)j * a.G;
      const float wt = ex2(__ldcg(a.pml + pj * 2) - mg);
      av += __ldcg(a.pacc + pj * HD + d) * wt;
      lv += __ldcg(a.pml + pj * 2 + 1) * wt;
    }
    const long long hg = head * a.G + g0 + g;
    if (a.stats) {
      a.acc[hg * HD + d] = av;
      if (d == 0) {
        a.m[hg] = mg == neg_big() ? mg : mg * 0.6931471805599453f;
        a.l[hg] = lv;
      }
    } else {
      static_cast<T*>(a.out)[hg * HD + d] = from_f<T>(av / fmaxf(lv, 1e-30f));
    }
  }
}

// the dynamic shared memory a kernel may take, set once per kernel: with
// its static arrays a block may pass 48 KB below 48 KB of dynamic memory
template <typename K>
cudaError_t smem_limit(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// A bf16 map over k or v as (hd, KV, Skv, B) with the caller's strides
// (elements), box (64, 1, BN, 1), 128-byte swizzle, keys past Skv and, at
// hd 32 and 80, columns past hd read as zeros. A dimension of size 1 is never stepped: its stride is set to one
// the encoder takes.
bool kv_map(CUtensorMap* m, const void* ptr, int hd, int KV, int Skv, int B,
            long long s_head, long long s_row, long long s_lane, int BN) {
  const hop::EncodeTiledFn fn = hop::encode_fn();
  if (fn == nullptr) return false;
  auto stride = [&](long long s, int n) {
    return static_cast<cuuint64_t>(n > 1 ? s * 2 : hd * 2);
  };
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                        static_cast<cuuint64_t>(KV),
                        static_cast<cuuint64_t>(Skv),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {stride(s_head, KV), stride(s_row, Skv),
                           stride(s_lane, B)};
  cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(BN), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The Hopper route: bf16 at hd 32, 64, 80 and 128 (attn_fwd_tma), and 256
// (attn_fwd_hd256, launch_fwd_hd256).
template <int HD>
cudaError_t launch_fwd_tma(const FwdArgs& a, int B, cudaStream_t stream) {
  using C = TmaCfg<HD>;
  CUtensorMap km, vm;
  if (!kv_map(&km, a.k, HD, a.KV, a.Skv, B, a.ks2, a.ks1, a.ks0, C::BN) ||
      !kv_map(&vm, a.v, HD, a.KV, a.Skv, B, a.vs2, a.vs1, a.vs0, C::BN))
    return cudaErrorInvalidValue;
  const int M = a.Sq * a.G;
  static bool ready = false;
  return hop::launch_smem(attn_fwd_tma<HD>, ready,
                          dim3((M + C::BM - 1) / C::BM, a.KV, B), C::THREADS,
                          C::SMEM, stream, km, vm, a);
}

cudaError_t launch_fwd_hd256(const FwdArgs& a, int B, cudaStream_t stream) {
  using C = Hd256Cfg;
  CUtensorMap km, vm;
  if (!kv_map(&km, a.k, C::HD, a.KV, a.Skv, B, a.ks2, a.ks1, a.ks0, C::BN) ||
      !kv_map(&vm, a.v, C::HD, a.KV, a.Skv, B, a.vs2, a.vs1, a.vs0, C::BN))
    return cudaErrorInvalidValue;
  const int M = a.Sq * a.G;
  static bool ready = false;
  return hop::launch_smem(attn_fwd_hd256, ready,
                          dim3((M + C::BM - 1) / C::BM, a.KV, B), C::THREADS,
                          C::SMEM, stream, km, vm, a);
}

// The tf32x3 route: f32 at hd 32, 64 and 80 (attn_fwd_tf32x3), 128 and 256
// (attn_fwd_tf32x3_wide).
template <int HD>
cudaError_t launch_fwd_tf32x3(const FwdArgs& a, int B, cudaStream_t stream) {
  const int M = a.Sq * a.G;
  static bool ready = false;
  if constexpr (HD >= 128) {
    using C = Tf32WideCfg<HD>;
    return hop::launch_smem(attn_fwd_tf32x3_wide<HD>, ready,
                            dim3((M + C::BM - 1) / C::BM, a.KV, B),
                            C::THREADS, C::SMEM, stream, a);
  } else {
    using C = Tf32Cfg<HD>;
    return hop::launch_smem(attn_fwd_tf32x3<HD>, ready,
                            dim3((M + C::BM - 1) / C::BM, a.KV, B),
                            C::THREADS, C::SMEM, stream, a);
  }
}

template <typename T, int HD, int GB>
cudaError_t launch_decode(const DecArgs& a, int B, cudaStream_t stream) {
  constexpr int bytes = DecCfg<T, HD, GB>::SMEM;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = smem_limit(decode_attn<T, HD, GB>, bytes);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const int ngroups = (a.G + GB - 1) / GB;
  decode_attn<T, HD, GB>
      <<<dim3(a.KV * ngroups, a.nsplit, B), NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

// query heads a block: the least of {1, 2, 4, 8} >= min(G, 8) for the
// served caches (bf16 at hd 64 and 128); the others take 8 (fewer
// instances to build)
template <typename T, int HD>
cudaError_t decode_gb(const DecArgs& a, int B, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2 && (HD == 64 || HD == 128)) {
    if (a.G == 1) return launch_decode<T, HD, 1>(a, B, stream);
    if (a.G == 2) return launch_decode<T, HD, 2>(a, B, stream);
    if (a.G <= 4) return launch_decode<T, HD, 4>(a, B, stream);
  }
  return launch_decode<T, HD, 8>(a, B, stream);
}

template <typename T>
cudaError_t decode_hd(const DecArgs& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return decode_gb<T, 32>(a, B, stream);
    case 64: return decode_gb<T, 64>(a, B, stream);
    case 80: return decode_gb<T, 80>(a, B, stream);
    case 128: return decode_gb<T, 128>(a, B, stream);
    case 256: return decode_gb<T, 256>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype 0: bf16 on the Hopper route, 1: f32 on the tf32x3 route (each at
// hd 32, 64, 80, 128 or 256)
extern "C" int flash_attn_fwd(
    const void* q, const void* k, const void* v, void* out, void* m,
    void* l, const void* qpos, int qpos64, const void* kpos, int kpos64,
    const void* kval, int B, int Sq, int Skv, int KV, int G, int hd,
    long long qs0, long long qs1, long long qs2, long long qs3,
    long long ks0, long long ks1, long long ks2, long long vs0,
    long long vs1, long long vs2, int causal, int window, float scale,
    float den, int dtype, void* stream) {
  FwdArgs a{q, k, v, out, static_cast<float*>(m), static_cast<float*>(l),
            {qpos, qpos64}, {kpos, kpos64},
            static_cast<const unsigned char*>(kval), Sq, Skv, KV, G,
            qs0, qs1, qs2, qs3, ks0, ks1, ks2, vs0, vs1, vs2, causal, window,
            scale, den};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (hd) {
      case 32: return launch_fwd_tma<32>(a, B, s);
      case 64: return launch_fwd_tma<64>(a, B, s);
      case 80: return launch_fwd_tma<80>(a, B, s);
      case 128: return launch_fwd_tma<128>(a, B, s);
      case 256: return launch_fwd_hd256(a, B, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: return launch_fwd_tf32x3<32>(a, B, s);
      case 64: return launch_fwd_tf32x3<64>(a, B, s);
      case 80: return launch_fwd_tf32x3<80>(a, B, s);
      case 128: return launch_fwd_tf32x3<128>(a, B, s);
      case 256: return launch_fwd_tf32x3<256>(a, B, s);
    }
  }
  return cudaErrorInvalidValue;
}

extern "C" int flash_decode(
    const void* q, const void* k, const void* v, const void* pos, int pos64,
    void* out, void* acc, void* m, void* l, void* pacc, void* pml,
    void* tickets, int B, int S_max, int KV, int G, int hd, int nsplit,
    int split_rows, long long qs0, long long qs1, long long qs2,
    long long ks0, long long ks1, long long ks2, long long vs0,
    long long vs1, long long vs2, int window, long long koff, float scale,
    int stats, int dtype, void* stream) {
  DecArgs a{q, k, v, {pos, pos64}, out, static_cast<float*>(acc),
            static_cast<float*>(m), static_cast<float*>(l),
            static_cast<float*>(pacc), static_cast<float*>(pml),
            static_cast<int*>(tickets), S_max, KV, G, nsplit, split_rows,
            qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2, window, koff, scale,
            stats};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? decode_hd<bf16>(a, B, hd, s)
                    : decode_hd<float>(a, B, hd, s);
}
