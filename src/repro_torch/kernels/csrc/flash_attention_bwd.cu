// The prefill attention's backward on Hopper: dQ (flash_attn_bwd_dq) and
// dK, dV (flash_attn_bwd_dkdv), two launches a call, with a plain C
// interface for ctypes (kernels/flash.py::flash_attn_bwd).
//
// Replaces no Pallas kernel: the reference takes this gradient by autodiff
// through its jnp online softmax, a jax.checkpoint on each chunk pair
// (src/repro/models/flash.py:94). The function is the plain version's,
// src/repro_torch/models/flash.py::flash_attention_bwd, from what the
// forward kept (q, k, v, out and the rows' softmax stats m, l): a pair's
// scores S = q.k scale again, P = exp(S - m) / l, dP = dout.v, dS = P (dP
// - D) scale on the pairs the masks keep (D = dout.out a row), then dQ =
// dS k, dK = dS^T q, dV = P^T dout. Each gradient comes out in its input's
// dtype.
//
// Layout as the forward's: a row is a query position s and one of the G
// query heads of a KV head, flattened as s * G + g, so the G heads of a KV
// head share each K and V tile; a row block is BM such rows of one (lane,
// KV head), the same blocks in both kernels.
//   * attn_bwd_dq: a block takes one row block and walks the key tiles
//     that the masks leave, in key order, judged per tile from position
//     bounds (tile_states, never an assumption that positions are sorted):
//     S, P, dP, dS, then dQ += dS k. It also writes each row's D, the row
//     block's query-position bounds over its rows with a valid key, and,
//     where the block has rows with no valid key, their sum of dout / l.
//   * attn_bwd_dkdv: a block takes one key tile and walks the row blocks
//     that the masks leave, in row order, judged from those bounds: S^T and
//     dP^T again, then dV += P^T dout and dK += dS^T q, each row block's
//     products added into f32 accumulators in shared memory. dV then gains
//     the sum over the (lane, KV head)'s rows with no valid key of dout / l,
//     the row blocks' partial sums added in block order: the plain version
//     passes such a row's dout / l to every key's v (p = exp(_NEG - _NEG) /
//     l) and nothing to q or k, and the tile loops leave those rows out
//     (their P is 0).
// No atomics: every output element is summed by one thread in a fixed
// order, so two calls give the same bits; the price is S and dP computed
// in both kernels.
//
// The products are mma.sync on the tensor cores, a warp 16 rows (or keys)
// of a block, operands read from shared memory (K-major 32-bit loads, or
// two 16-bit loads where a product runs down the rows of a tile), P and dS
// taken from the score fragments in registers. Two routes by the dtype, as
// the forward's (kernels/flash.py::route_of), each at hd 32, 64, 80, 128
// and 256:
//   * bf16: m16n8k16, bf16 in, f32 accumulation; P and dS rounded to bf16
//     for their products, as the reference rounds p to v's dtype;
//   * f32: m16n8k8 in TF32, each product as three (big.big, big.small,
//     small.big, the split of flash_common.cuh::split_tf32 made in
//     registers as the operand is read), the small terms in an accumulator
//     of their own. Every product that sums over a tile's keys or rows into
//     a gradient starts from zero and is added to the f32 accumulator by
//     the FMA units, so that no long sum runs in the tensor cores'
//     accumulator (where the forward's O drifted at 70000 keys).
// Accumulators: dQ in registers (16 x hd a warp), in shared memory at f32
// hd 256; dK and dV in shared memory (2 x 16 x hd f32 a warp would not fit
// the registers beside the scores at hd 128 and 256). Tiles (BwdCfg): row
// blocks of 64 (32 at f32 hd 128 and 256), key tiles of 64 (32 at hd 256,
// and in the dQ kernel at f32 hd 128), the streamed operand double-buffered
// through cp.async where two stages fit in shared memory.
//
// Bound: the tensor cores, 5 products over the valid pairs (10 hd FLOPs a
// pair; 7 products computed), three TF32 products each on the f32 route.
// This first version is a simple one: mma.sync rather than wgmma, no TMA,
// no warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash_common;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAXT = 1024;       // key tiles whose states a window holds

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The operands of a warp's products (g = lane / 4, t = lane % 4). A is 16
// rows x KS of depth, B KS x 8 columns, C (16 x 8, f32) c[0] (g, 2t), c[1]
// (g, 2t + 1), c[2] (g + 8, 2t), c[3] (g + 8, 2t + 1). Three ways to read an
// operand: a_rows (A, rows of a tile with the depth along them), b_rows (B
// whose column n is row n of a tile, the depth along it), b_cols (B whose
// depth runs down a tile's rows and whose columns are 8 of its columns),
// and a_frag (A from C fragments: 16 rows of scores whose columns become
// the depth).
struct Bf16Mma {
  using T = bf16;
  static constexpr int KS = 16;
  static constexpr bool SPLIT = false;
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };
  // the depth k0 + 2t, + 1 in x[0] (row g) and x[1] (row g + 8), k0 + 8 +
  // 2t, + 1 in x[2] and x[3], as m16n8k16 reads them
  static __device__ __forceinline__ A a_rows(const T* s, int ld, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const T* p = s + g * ld + k0 + 2 * t;
    return A{{ld32(p), ld32(p + 8 * ld), ld32(p + 8), ld32(p + 8 * ld + 8)}};
  }
  static __device__ __forceinline__ B b_rows(const T* s, int ld, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const T* p = s + g * ld + k0 + 2 * t;
    return B{{ld32(p), ld32(p + 8)}};
  }
  // s at the tile's row k0 and column n0
  static __device__ __forceinline__ B b_cols(const T* s, int ld) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const T* p = s + 2 * t * ld + g;
    return B{{pack2(p[0], p[ld]), pack2(p[8 * ld], p[9 * ld])}};
  }
  // depth step kk: the C tiles 2 kk and 2 kk + 1, rounded to bf16
  template <int N>
  static __device__ __forceinline__ A a_frag(const float (&c)[N][4], int kk) {
    return A{{pack_bf16(c[2 * kk][0], c[2 * kk][1]),
              pack_bf16(c[2 * kk][2], c[2 * kk][3]),
              pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
              pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])}};
  }
  static __device__ __forceinline__ void mma(float (&d)[4], float (&)[4],
                                             const A& a, const B& b) {
    mma_bf16(d, a.x, b.x[0], b.x[1]);
  }
};

// The f32 route: m16n8k8 in TF32, three products a product. The depth
// slot t of the fragment holds depth k0 + 2t and slot t + 4 holds k0 + 2t +
// 1, in every operand alike (a permutation of the sum), so that a C
// fragment is an A fragment as it stands and the rows' operands load as
// float2.
struct Tf32x3Mma {
  using T = float;
  static constexpr int KS = 8;
  static constexpr bool SPLIT = true;
  struct A { uint32_t big[4], small[4]; };
  struct B { uint32_t big[2], small[2]; };
  static __device__ __forceinline__ A a_split(float r0, float r1, float r2,
                                              float r3) {
    A a;
    split_tf32(r0, a.big[0], a.small[0]);
    split_tf32(r1, a.big[1], a.small[1]);
    split_tf32(r2, a.big[2], a.small[2]);
    split_tf32(r3, a.big[3], a.small[3]);
    return a;
  }
  static __device__ __forceinline__ B b_split(float r0, float r1) {
    B b;
    split_tf32(r0, b.big[0], b.small[0]);
    split_tf32(r1, b.big[1], b.small[1]);
    return b;
  }
  static __device__ __forceinline__ A a_rows(const T* s, int ld, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float2 x = *reinterpret_cast<const float2*>(s + g * ld + k0 + 2 * t);
    const float2 y =
        *reinterpret_cast<const float2*>(s + (g + 8) * ld + k0 + 2 * t);
    return a_split(x.x, y.x, x.y, y.y);
  }
  static __device__ __forceinline__ B b_rows(const T* s, int ld, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float2 x = *reinterpret_cast<const float2*>(s + g * ld + k0 + 2 * t);
    return b_split(x.x, x.y);
  }
  static __device__ __forceinline__ B b_cols(const T* s, int ld) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const T* p = s + 2 * t * ld + g;
    return b_split(p[0], p[ld]);
  }
  template <int N>
  static __device__ __forceinline__ A a_frag(const float (&c)[N][4], int kk) {
    return a_split(c[kk][0], c[kk][2], c[kk][1], c[kk][3]);
  }
  // the small terms into dl, big.big into d
  static __device__ __forceinline__ void mma(float (&d)[4], float (&dl)[4],
                                             const A& a, const B& b) {
    mma_tf32(dl, a.small, b.big[0], b.big[1]);
    mma_tf32(dl, a.big, b.small[0], b.small[1]);
    mma_tf32(d, a.big, b.big[0], b.big[1]);
  }
};

template <typename M>
__device__ __forceinline__ float sum_of(const float (&d)[4],
                                        const float (&dl)[4], int e) {
  if constexpr (M::SPLIT) return d[e] + dl[e];
  return d[e];
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// C (16 x 8) of a warp's rows into rows r0, r0 + 8 of an f32 accumulator
// in shared memory (lda floats a row), columns n0 ..: one thread an element
__device__ __forceinline__ void acc_add(float* acc, int lda, int n0,
                                        float x0, float x1, float x2,
                                        float x3) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float2* p = reinterpret_cast<float2*>(acc + g * lda + n0 + 2 * t);
  float2* q = reinterpret_cast<float2*>(acc + (g + 8) * lda + n0 + 2 * t);
  float2 a = *p, b = *q;
  a.x += x0; a.y += x1; b.x += x2; b.y += x3;
  *p = a;
  *q = b;
}

// Tiles and shared memory of both kernels at (route M, hd)
template <typename M, int HD>
struct BwdCfg {
  using T = typename M::T;
  static constexpr bool F32 = M::SPLIT;
  static constexpr int BM = F32 && HD >= 128 ? 32 : 64;  // rows a row block
  static constexpr int BN =                              // keys a dQ tile
      HD == 256 || (F32 && HD == 128) ? 32 : 64;
  static constexpr int BK = HD == 256 ? 32 : 64;  // keys a dK/dV block
  // elements a row of an operand in shared memory: 16 (bf16) or 32 (f32)
  // bytes past hd, so that a warp's fragment loads hit distinct banks
  static constexpr int LD = HD + 8;
  static constexpr int LDA = HD + 8;              // floats an accumulator row
  static constexpr int EPC = 16 / sizeof(T);      // elements a 16-byte copy
  static constexpr int CH = HD / EPC;             // copies a row
  static constexpr int LIMIT = 227 * 1024 - 8192; // beside the static arrays
  static constexpr bool DQ_SHARED = F32 && HD == 256;
  static constexpr int DQ_THREADS = BM / 16 * 32;
  static constexpr int DQ_FIXED =
      2 * BM * LD * sizeof(T) + (DQ_SHARED ? BM * LDA * 4 : 0);
  static constexpr int DQ_STAGE = 2 * BN * LD * sizeof(T);   // K and V
  static constexpr int DQ_STAGES = DQ_FIXED + 2 * DQ_STAGE <= LIMIT ? 2 : 1;
  static constexpr int DQ_SMEM = DQ_FIXED + DQ_STAGES * DQ_STAGE;
  static constexpr int KV_THREADS = BK / 16 * 32;
  static constexpr int KV_FIXED = 2 * BK * LD * sizeof(T) + 2 * BK * LDA * 4;
  static constexpr int KV_STAGE = 2 * BM * LD * sizeof(T);   // q and dout
  static constexpr int KV_STAGES = KV_FIXED + 2 * KV_STAGE <= LIMIT ? 2 : 1;
  static constexpr int KV_SMEM = KV_FIXED + KV_STAGES * KV_STAGE;
  static_assert(HD % 16 == 0 && HD % M::KS == 0, "head size");
  static_assert(DQ_SMEM <= LIMIT && KV_SMEM <= LIMIT, "shared memory");
};

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float *m, *l;        // the forward's stats (B, KV, G, Sq)
  Pos qpos, kpos;
  const unsigned char* kval;
  void *dq, *dk, *dv;        // contiguous, the shapes of q, k and v
  float* dsum;               // D (B, KV, Sq G): written by the dQ kernel
  float* unseen;             // (B, KV, nblk, hd): a row block's sum of
                             // dout / l over its rows with no valid key
  long long* bounds;         // (B, KV, nblk, 3): a row block's query-position
                             // bounds over its rows with a valid key (min >
                             // max: none), and whether it has a row without
  int Sq, Skv, KV, G, nblk;
  long long qs0, qs1, qs2, qs3, ks0, ks1, ks2, vs0, vs1, vs2;
  long long os0, os1, os2, os3, ds0, ds1, ds2, ds3;
  int causal, window;
  float scale;
};

// Q's (or any row-layout tensor's) row gr of the (lane, KV head)
template <typename T>
__device__ __forceinline__ const T* row_of(const void* base, int b, int s,
                                           int kvh, int g, long long s0,
                                           long long s1, long long s2,
                                           long long s3) {
  return static_cast<const T*>(base) + b * s0 + s * s1 + kvh * s2 + g * s3;
}

// ------------------------------------------------------------------- dQ
template <typename M, int HD>
__global__ void __launch_bounds__(BwdCfg<M, HD>::DQ_THREADS)
    attn_bwd_dq(BwdArgs a) {
  using C = BwdCfg<M, HD>;
  using T = typename M::T;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, LDA = C::LDA;
  constexpr int ST = C::DQ_STAGES, NTH = C::DQ_THREADS, NW = NTH / 32;
  constexpr int KS = M::KS, CH = C::CH, EPC = C::EPC;
  extern __shared__ __align__(16) uint8_t dq_smem[];
  T* Qs = reinterpret_cast<T*>(dq_smem);
  T* dOs = Qs + BM * LD;
  T* ring = dOs + BM * LD;                        // a stage: K, then V
  float* accs = reinterpret_cast<float*>(ring + ST * 2 * BN * LD);
  __shared__ long long kpos_s[ST][BN];
  __shared__ signed char kval_s[ST][BN];
  __shared__ unsigned char state_s[MAXT];
  __shared__ long long qlo_s[NW], qhi_s[NW];
  __shared__ int none_s[NW];
  __shared__ float unseen_il[BM];   // 1 / l of a row with no valid key, or 0

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y, rb = blockIdx.x;
  const int M_ = a.Sq * a.G, row0 = rb * BM;
  const long long bh = static_cast<long long>(b) * a.KV + kvh;
  const T* kg = static_cast<const T*>(a.k) + b * a.ks0 + kvh * a.ks2;
  const T* vg = static_cast<const T*>(a.v) + b * a.vs0 + kvh * a.vs2;
  // Q's and dout's rows, 16 bytes a copy (rows past M zeros)
  for (int i = tid; i < BM * CH; i += NTH) {
    const int r = i / CH, c = i % CH, gr = row0 + r;
    const bool in = gr < M_;
    const int s = in ? gr / a.G : 0, gg = in ? gr % a.G : 0;
    cp_async16(Qs + r * LD + c * EPC,
               row_of<T>(a.q, b, s, kvh, gg, a.qs0, a.qs1, a.qs2, a.qs3) +
                   c * EPC,
               in);
    cp_async16(dOs + r * LD + c * EPC,
               row_of<T>(a.dout, b, s, kvh, gg, a.ds0, a.ds1, a.ds2, a.ds3) +
                   c * EPC,
               in);
  }
  cp_async_commit();

  // this thread's rows 16 warp + g and + 8: stats, D, position
  float m2[2], il[2], dd[2];
  long long qp[2];
  bool live[2], none[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h, gr = row0 + r;
    const bool in = gr < M_;
    const int s = in ? gr / a.G : 0, gg = in ? gr % a.G : 0;
    const long long si = (bh * a.G + gg) * a.Sq + s;
    const float mv = in ? a.m[si] : 0.f, lv = in ? a.l[si] : 1.f;
    none[h] = in && mv == neg_big();
    live[h] = in && !none[h];
    m2[h] = live[h] ? mv * LOG2E : INFINITY;     // P = 0 for the others
    il[h] = live[h] ? 1.f / lv : 0.f;
    qp[h] = in ? a.qpos.at(s, s) : 0;
    // D: the row's four lanes 8 values at a time, then across them
    float part = 0.f;
    if (in) {
      const T* orow = row_of<T>(a.o, b, s, kvh, gg, a.os0, a.os1, a.os2,
                                a.os3);
      const T* drow = row_of<T>(a.dout, b, s, kvh, gg, a.ds0, a.ds1, a.ds2,
                                a.ds3);
      for (int c = t4; c < HD / 8; c += 4) {
        float x[8], y[8];
        load8(orow + 8 * c, x);
        load8(drow + 8 * c, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) part += y[e] * x[e];
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dd[h] = part;
    if (t4 == 0) {
      if (in) a.dsum[bh * M_ + gr] = part;
      unseen_il[r] = none[h] ? 1.f / lv : 0.f;
    }
  }
  // the block's query-position bounds over its rows with a valid key
  {
    long long lo = 0x7fffffffffffffffLL, hi = -0x7fffffffffffffffLL;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (live[h]) {
        lo = qp[h] < lo ? qp[h] : lo;
        hi = qp[h] > hi ? qp[h] : hi;
      }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const long long x = __shfl_xor_sync(0xffffffffu, lo, o);
      const long long y = __shfl_xor_sync(0xffffffffu, hi, o);
      lo = x < lo ? x : lo;
      hi = y > hi ? y : hi;
    }
    const bool any_none = __any_sync(0xffffffffu, none[0] || none[1]);
    if (lane == 0) {
      qlo_s[warp] = lo;
      qhi_s[warp] = hi;
      none_s[warp] = any_none;
    }
  }
  __syncthreads();
  long long qmin = qlo_s[0], qmax = qhi_s[0];
  int has_none = none_s[0];
  for (int w = 1; w < NW; ++w) {
    qmin = qlo_s[w] < qmin ? qlo_s[w] : qmin;
    qmax = qhi_s[w] > qmax ? qhi_s[w] : qmax;
    has_none |= none_s[w];
  }
  if (tid == 0) {
    long long* bd = a.bounds + (bh * a.nblk + rb) * 3;
    bd[0] = qmin;
    bd[1] = qmax;
    bd[2] = has_none;
  }
  // the rows with no valid key: their dout / l, column by column, rows in
  // order (read back by the dK/dV kernel)
  if (has_none) {
    cp_async_wait<0>();
    __syncthreads();
    for (int d = tid; d < HD; d += NTH) {
      float sum = 0.f;
      for (int r = 0; r < BM; ++r)
        if (unseen_il[r] != 0.f) sum += to_f(dOs[r * LD + d]) * unseen_il[r];
      a.unseen[(bh * a.nblk + rb) * HD + d] = sum;
    }
  }

  float dqr[C::DQ_SHARED ? 1 : HD / 8][4];
#pragma unroll
  for (int n = 0; n < (C::DQ_SHARED ? 1 : HD / 8); ++n)
    dqr[n][0] = dqr[n][1] = dqr[n][2] = dqr[n][3] = 0.f;
  if constexpr (C::DQ_SHARED)
    for (int i = tid; i < BM * LDA; i += NTH) accs[i] = 0.f;

  const int ntiles = qmin > qmax ? 0 : (a.Skv + BN - 1) / BN;
  int base = -MAXT;
  // the next live key tile from t (every thread the same), its state in
  // *st; the states a window of MAXT tiles at a time, by every warp
  auto next_live = [&](int t, int* st) {
    for (; t < ntiles; ++t) {
      if (t >= base + MAXT) {
        base = t;
        __syncthreads();                  // the last window's readers
        fill_states<BN, MAXT>(state_s, base, warp, NW, a.kpos, a.kval,
                              ntiles, a.Skv, qmin, qmax, a.causal, a.window);
        __syncthreads();
      }
      *st = state_s[t - base];
      if (*st) return t;
    }
    return ntiles;
  };
  // K and V of tile t (state st) into stage slot, with the keys' notes
  // where some pairs are masked; one cp.async group
  auto issue = [&](int slot, int t, int st) {
    T* Kd = ring + slot * 2 * BN * LD;
    T* Vd = Kd + BN * LD;
    for (int j = tid; j < BN && st == 1; j += NTH) {
      const int key = t * BN + j;
      kpos_s[slot][j] = key < a.Skv ? a.kpos.at(key, key) : 0;
      kval_s[slot][j] = static_cast<signed char>(
          key >= a.Skv ? -1 : (a.kval && !a.kval[key] ? 0 : 1));
    }
    for (int i = tid; i < BN * CH; i += NTH) {
      const int j = i / CH, c = i % CH, key = t * BN + j;
      const bool in = key < a.Skv;
      const long long kr = in ? key : 0;
      cp_async16(Kd + j * LD + c * EPC, kg + kr * a.ks1 + c * EPC, in);
      cp_async16(Vd + j * LD + c * EPC, vg + kr * a.vs1 + c * EPC, in);
    }
    cp_async_commit();
  };

  const float c2 = a.scale * LOG2E;
  const T* qw = Qs + 16 * warp * LD;
  const T* dow = dOs + 16 * warp * LD;
  int st = 0, slot = 0;
  int t = next_live(0, &st);
  if (t < ntiles) issue(0, t, st);
  while (t < ntiles) {
    int nst = 0;
    const int tn = next_live(t + 1, &nst);
    if (ST == 2 && tn < ntiles) {
      issue(slot ^ 1, tn, nst);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = ring + slot * 2 * BN * LD;
    const T* Vt = Kt + BN * LD;
    // S = Q K^T and dP = dout V^T, 16 rows x BN keys a warp
    float s[BN / 8][4], sl[BN / 8][4], dp[BN / 8][4], dpl[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = sl[j][e] = dp[j][e] = dpl[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / KS; ++kk) {
      const typename M::A qa = M::a_rows(qw, LD, kk * KS);
      const typename M::A da = M::a_rows(dow, LD, kk * KS);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        M::mma(s[j], sl[j], qa, M::b_rows(Kt + 8 * j * LD, LD, kk * KS));
        M::mma(dp[j], dpl[j], da, M::b_rows(Vt + 8 * j * LD, LD, kk * KS));
      }
    }
    // P on the kept pairs (0 elsewhere), then dS = P (dP - D) scale
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1), h = e >> 1;
        const bool keep =
            st == 2 || (kval_s[slot][col] > 0 &&
                        allowed(qp[h], kpos_s[slot][col], a.causal, a.window));
        const float p = keep ? ex2(fmaf(sum_of<M>(s[j], sl[j], e), c2,
                                        -m2[h])) * il[h]
                             : 0.f;
        dp[j][e] = p * (sum_of<M>(dp[j], dpl[j], e) - dd[h]) * a.scale;
      }
    // dQ += dS K: each 8 columns from zero over the tile's keys, then added
    typename M::A dsa[BN / KS];
#pragma unroll
    for (int kk = 0; kk < BN / KS; ++kk) dsa[kk] = M::a_frag(dp, kk);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      float d[4] = {0.f, 0.f, 0.f, 0.f}, dl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BN / KS; ++kk)
        M::mma(d, dl, dsa[kk], M::b_cols(Kt + kk * KS * LD + 8 * n, LD));
      if constexpr (C::DQ_SHARED) {
        acc_add(accs + 16 * warp * LDA, LDA, 8 * n, sum_of<M>(d, dl, 0),
                sum_of<M>(d, dl, 1), sum_of<M>(d, dl, 2),
                sum_of<M>(d, dl, 3));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dqr[n][e] += sum_of<M>(d, dl, e);
      }
    }
    __syncthreads();                      // the stage's readers
    if (ST == 1 && tn < ntiles) issue(0, tn, nst);
    t = tn;
    st = nst;
    if (ST == 2) slot ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // dQ's rows below M (a row without a valid key: 0)
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h, gr = row0 + r;
    if (gr >= M_) continue;
    const int s = gr / a.G, gg = gr % a.G;
    T* dst = dq + (((static_cast<long long>(b) * a.Sq + s) * a.KV + kvh) *
                       a.G + gg) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if constexpr (C::DQ_SHARED) {
        const float* src = accs + r * LDA + 8 * n + 2 * t4;
        store2(dst + 8 * n, src[0], src[1]);
      } else {
        store2(dst + 8 * n, dqr[n][2 * h], dqr[n][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- dK, dV
template <typename M, int HD>
__global__ void __launch_bounds__(BwdCfg<M, HD>::KV_THREADS)
    attn_bwd_dkdv(BwdArgs a) {
  using C = BwdCfg<M, HD>;
  using T = typename M::T;
  constexpr int BM = C::BM, BK = C::BK, LD = C::LD, LDA = C::LDA;
  constexpr int ST = C::KV_STAGES, NTH = C::KV_THREADS;
  constexpr int KS = M::KS, CH = C::CH, EPC = C::EPC;
  extern __shared__ __align__(16) uint8_t kv_smem[];
  T* Ks = reinterpret_cast<T*>(kv_smem);
  T* Vs = Ks + BK * LD;
  float* dKa = reinterpret_cast<float*>(Vs + BK * LD);
  float* dVa = dKa + BK * LDA;
  T* ring = reinterpret_cast<T*>(dVa + BK * LDA);   // a stage: q, then dout
  __shared__ float m2_s[ST][BM], il_s[ST][BM], dd_s[ST][BM];
  __shared__ long long qp_s[ST][BM];
  __shared__ float unseen_s[HD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y, key0 = blockIdx.x * BK;
  const int M_ = a.Sq * a.G;
  const long long bh = static_cast<long long>(b) * a.KV + kvh;
  {
    const T* kg = static_cast<const T*>(a.k) + b * a.ks0 + kvh * a.ks2;
    const T* vg = static_cast<const T*>(a.v) + b * a.vs0 + kvh * a.vs2;
    for (int i = tid; i < BK * CH; i += NTH) {
      const int j = i / CH, c = i % CH, key = key0 + j;
      const bool in = key < a.Skv;
      const long long kr = in ? key : 0;
      cp_async16(Ks + j * LD + c * EPC, kg + kr * a.ks1 + c * EPC, in);
      cp_async16(Vs + j * LD + c * EPC, vg + kr * a.vs1 + c * EPC, in);
    }
    cp_async_commit();
  }
  for (int i = tid; i < BK * LDA; i += NTH) dKa[i] = dVa[i] = 0.f;
  // the tile's key-position bounds over its valid keys, by every warp alone
  const KeyBounds kb =
      warp_bounds(scan_keys<BK>(a.kpos, a.kval, key0, true, a.Skv));
  // this thread's keys 16 warp + g and + 8
  long long kp[2];
  bool kok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 16 * warp + g + 8 * h;
    kok[h] = key < a.Skv && (!a.kval || a.kval[key]);
    kp[h] = key < a.Skv ? a.kpos.at(key, key) : 0;
  }
  // the rows with no valid key: the row blocks' sums of dout / l, in
  // block order, for every key's dV
  for (int d = tid; d < HD; d += NTH) {
    float sum = 0.f;
    for (int r = 0; r < a.nblk; ++r)
      if (a.bounds[(bh * a.nblk + r) * 3 + 2])
        sum += a.unseen[(bh * a.nblk + r) * HD + d];
    unseen_s[d] = sum;
  }

  // what the masks leave of row block r for this tile (state_from_bounds,
  // as tile_states judges a key tile): 0 nothing, 2 every pair, 1 some; a
  // block with no row of a valid key (qmin > qmax) is nothing
  auto state_of = [&](int r) {
    const long long* bd = a.bounds + (bh * a.nblk + r) * 3;
    if (bd[0] > bd[1]) return 0;
    return state_from_bounds(bd[0], bd[1], kb, a.causal, a.window);
  };
  auto next_live = [&](int r, int* st) {
    for (; r < a.nblk; ++r) {
      *st = state_of(r);
      if (*st) return r;
    }
    return a.nblk;
  };
  // q and dout of row block r into stage slot (one cp.async group), and
  // the rows' stats, D and positions
  auto issue = [&](int slot, int r) {
    T* Qd = ring + slot * 2 * BM * LD;
    T* Dd = Qd + BM * LD;
    const int row0 = r * BM;
    for (int i = tid; i < BM * CH; i += NTH) {
      const int rr = i / CH, c = i % CH, gr = row0 + rr;
      const bool in = gr < M_;
      const int s = in ? gr / a.G : 0, gg = in ? gr % a.G : 0;
      cp_async16(Qd + rr * LD + c * EPC,
                 row_of<T>(a.q, b, s, kvh, gg, a.qs0, a.qs1, a.qs2, a.qs3) +
                     c * EPC,
                 in);
      cp_async16(Dd + rr * LD + c * EPC,
                 row_of<T>(a.dout, b, s, kvh, gg, a.ds0, a.ds1, a.ds2,
                           a.ds3) + c * EPC,
                 in);
    }
    cp_async_commit();
    for (int rr = tid; rr < BM; rr += NTH) {
      const int gr = row0 + rr;
      const bool in = gr < M_;
      const int s = in ? gr / a.G : 0, gg = in ? gr % a.G : 0;
      const long long si = (bh * a.G + gg) * a.Sq + s;
      const float mv = in ? a.m[si] : 0.f;
      const bool live = in && mv != neg_big();
      m2_s[slot][rr] = live ? mv * LOG2E : INFINITY;
      il_s[slot][rr] = live ? 1.f / a.l[si] : 0.f;
      dd_s[slot][rr] = in ? a.dsum[bh * M_ + gr] : 0.f;
      qp_s[slot][rr] = in ? a.qpos.at(s, s) : 0;
    }
  };

  const float c2 = a.scale * LOG2E;
  const T* kw = Ks + 16 * warp * LD;
  const T* vw = Vs + 16 * warp * LD;
  float* dKw = dKa + 16 * warp * LDA;
  float* dVw = dVa + 16 * warp * LDA;
  int st = 0, slot = 0;
  int r = next_live(0, &st);
  if (r < a.nblk) issue(0, r);
  while (r < a.nblk) {
    int nst = 0;
    const int rn = next_live(r + 1, &nst);
    if (ST == 2 && rn < a.nblk) {
      issue(slot ^ 1, rn);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = ring + slot * 2 * BM * LD;
    const T* dOt = Qt + BM * LD;
    // S^T = K Q^T and dP^T = V dout^T, 16 keys x BM rows a warp
    float s[BM / 8][4], sl[BM / 8][4], dp[BM / 8][4], dpl[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = sl[j][e] = dp[j][e] = dpl[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / KS; ++kk) {
      const typename M::A ka = M::a_rows(kw, LD, kk * KS);
      const typename M::A va = M::a_rows(vw, LD, kk * KS);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        M::mma(s[j], sl[j], ka, M::b_rows(Qt + 8 * j * LD, LD, kk * KS));
        M::mma(dp[j], dpl[j], va, M::b_rows(dOt + 8 * j * LD, LD, kk * KS));
      }
    }
    // P^T on the kept pairs (0 elsewhere), dS^T = P^T (dP^T - D) scale
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1), h = e >> 1;
        const bool keep =
            st == 2 || (kok[h] && allowed(qp_s[slot][col], kp[h], a.causal,
                                          a.window));
        const float p = keep ? ex2(fmaf(sum_of<M>(s[j], sl[j], e), c2,
                                        -m2_s[slot][col])) *
                                   il_s[slot][col]
                             : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (sum_of<M>(dp[j], dpl[j], e) - dd_s[slot][col]) *
                   a.scale;
      }
    // dV += P^T dout, dK += dS^T q: each 8 columns from zero over the row
    // block, then added to the accumulators
    {
      typename M::A pa[BM / KS];
#pragma unroll
      for (int kk = 0; kk < BM / KS; ++kk) pa[kk] = M::a_frag(s, kk);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        float d[4] = {0.f, 0.f, 0.f, 0.f}, dl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < BM / KS; ++kk)
          M::mma(d, dl, pa[kk], M::b_cols(dOt + kk * KS * LD + 8 * n, LD));
        acc_add(dVw, LDA, 8 * n, sum_of<M>(d, dl, 0), sum_of<M>(d, dl, 1),
                sum_of<M>(d, dl, 2), sum_of<M>(d, dl, 3));
      }
    }
    {
      typename M::A da[BM / KS];
#pragma unroll
      for (int kk = 0; kk < BM / KS; ++kk) da[kk] = M::a_frag(dp, kk);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        float d[4] = {0.f, 0.f, 0.f, 0.f}, dl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < BM / KS; ++kk)
          M::mma(d, dl, da[kk], M::b_cols(Qt + kk * KS * LD + 8 * n, LD));
        acc_add(dKw, LDA, 8 * n, sum_of<M>(d, dl, 0), sum_of<M>(d, dl, 1),
                sum_of<M>(d, dl, 2), sum_of<M>(d, dl, 3));
      }
    }
    __syncthreads();                      // the stage's readers
    if (ST == 1 && rn < a.nblk) issue(0, rn);
    r = rn;
    st = nst;
    if (ST == 2) slot ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the tile's keys below Skv: dK, and dV with the rows without a valid key
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  for (int i = tid; i < BK * HD / 2; i += NTH) {
    const int j = i / (HD / 2), c = 2 * (i % (HD / 2)), key = key0 + j;
    if (key >= a.Skv) continue;
    const long long off =
        ((static_cast<long long>(b) * a.Skv + key) * a.KV + kvh) * HD + c;
    const float* ka = dKa + j * LDA + c;
    const float* va = dVa + j * LDA + c;
    store2(dk + off, ka[0], ka[1]);
    store2(dv + off, va[0] + unseen_s[c], va[1] + unseen_s[c + 1]);
  }
}

template <typename K>
cudaError_t launch_smem(K kernel, bool& ready, dim3 grid, int threads,
                        int smem, cudaStream_t stream, const BwdArgs& a) {
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int N> struct Hd { static constexpr int value = N; };

// f(route, Hd<hd>) at a (dtype, hd) of the table: dtype 0 bf16, 1 f32
template <typename F>
cudaError_t by_route(int dtype, int hd, F&& f) {
  if (dtype == 0) {
    switch (hd) {
      case 32: return f(Bf16Mma(), Hd<32>());
      case 64: return f(Bf16Mma(), Hd<64>());
      case 80: return f(Bf16Mma(), Hd<80>());
      case 128: return f(Bf16Mma(), Hd<128>());
      case 256: return f(Bf16Mma(), Hd<256>());
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: return f(Tf32x3Mma(), Hd<32>());
      case 64: return f(Tf32x3Mma(), Hd<64>());
      case 80: return f(Tf32x3Mma(), Hd<80>());
      case 128: return f(Tf32x3Mma(), Hd<128>());
      case 256: return f(Tf32x3Mma(), Hd<256>());
    }
  }
  return cudaErrorInvalidValue;
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const void* m,
                  const void* l, const void* qpos, int qpos64,
                  const void* kpos, int kpos64, const void* kval, void* dq,
                  void* dk, void* dv, void* dsum, void* unseen,
                  void* bounds, int Sq, int Skv, int KV, int G, int nblk,
                  const long long* st, int causal, int window, float scale) {
  return BwdArgs{q, k, v, o, dout,
                 static_cast<const float*>(m), static_cast<const float*>(l),
                 {qpos, qpos64}, {kpos, kpos64},
                 static_cast<const unsigned char*>(kval), dq, dk, dv,
                 static_cast<float*>(dsum), static_cast<float*>(unseen),
                 static_cast<long long*>(bounds), Sq, Skv, KV, G, nblk,
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                 st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                 st[15], st[16], st[17], causal, window, scale};
}

}  // namespace

// Both entry points take the same arguments. strides: q's four, k's three,
// v's three, out's four, dout's four (elements); bm the row block the
// wrapper sized the scratch for (BwdCfg::BM, checked). dtype 0 bf16, 1 f32.
// The dQ kernel first: it writes the D, bounds and unseen scratch that the
// dK/dV kernel reads.
extern "C" int flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* m, const void* l, const void* qpos,
    int qpos64, const void* kpos, int kpos64, const void* kval, void* dq,
    void* dk, void* dv, void* dsum, void* unseen, void* bounds, int B,
    int Sq, int Skv, int KV, int G, int hd, int bm, const long long* strides,
    int causal, int window, float scale, int dtype, void* stream) {
  const int nblk = (Sq * G + bm - 1) / bm;
  const BwdArgs a = make_args(q, k, v, o, dout, m, l, qpos, qpos64, kpos,
                              kpos64, kval, dq, dk, dv, dsum, unseen, bounds,
                              Sq, Skv, KV, G, nblk, strides, causal, window,
                              scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_route(dtype, hd, [&](auto mma, auto h) -> cudaError_t {
    using M = decltype(mma);
    constexpr int HD = decltype(h)::value;
    using C = BwdCfg<M, HD>;
    if (bm != C::BM) return cudaErrorInvalidValue;
    static bool ready = false;
    return launch_smem(attn_bwd_dq<M, HD>, ready, dim3(nblk, KV, B),
                       C::DQ_THREADS, C::DQ_SMEM, s, a);
  });
}

extern "C" int flash_attn_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* m, const void* l, const void* qpos,
    int qpos64, const void* kpos, int kpos64, const void* kval, void* dq,
    void* dk, void* dv, void* dsum, void* unseen, void* bounds, int B,
    int Sq, int Skv, int KV, int G, int hd, int bm, const long long* strides,
    int causal, int window, float scale, int dtype, void* stream) {
  const int nblk = (Sq * G + bm - 1) / bm;
  const BwdArgs a = make_args(q, k, v, o, dout, m, l, qpos, qpos64, kpos,
                              kpos64, kval, dq, dk, dv, dsum, unseen, bounds,
                              Sq, Skv, KV, G, nblk, strides, causal, window,
                              scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_route(dtype, hd, [&](auto mma, auto h) -> cudaError_t {
    using M = decltype(mma);
    constexpr int HD = decltype(h)::value;
    using C = BwdCfg<M, HD>;
    if (bm != C::BM) return cudaErrorInvalidValue;
    static bool ready = false;
    return launch_smem(attn_bwd_dkdv<M, HD>, ready,
                       dim3((Skv + C::BK - 1) / C::BK, KV, B), C::KV_THREADS,
                       C::KV_SMEM, s, a);
  });
}
