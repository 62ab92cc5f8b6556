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
// Prefill (flash_attn_fwd): a block holds 64 rows of one (lane, KV head)
// -- query position s and query head g flattened as s * G + g, so the G
// heads of a KV head share each K/V tile -- and walks key tiles of a fixed
// length BN from key row 0, so a row's result depends only on its q row,
// its lane's k/v and the masks (never on B, KV, Sq, its neighbours or the
// SM count). bf16: 4 warps of 16 rows on mma.sync m16n8k16 (f32
// accumulators, P passed from the score accumulators as the A operand);
// f32: 4 threads a row on FMA. A tile whose mask is false for every row of
// the block (no valid key; or, from the position bounds, causal or window
// excludes all) is skipped: for a row that has a valid key that is what
// computing it would give bit for bit (p = exp(_NEG - m) = 0, correction
// 1; or, before its first valid key, a state the first valid tile
// multiplies by exp(_NEG - m) = 0). A row with no valid key at all gets
// the plain version's value, sum(v) / (the padded key count), in a pass of
// its own. Given m and l, it also writes each row's softmax stats, which a
// call that needs a gradient keeps for the backward. Bound at long
// context: the tensor cores.
//
// Decode (flash_decode): a block reads one split of split_rows cache rows
// of one (lane, KV head) once for up to 8 query heads, and only the rows
// that can be valid (<= pos - kpos_offset, inside the window). More than
// one split: a second kernel merges the splits' (acc, m, l) in split
// order. Splits and tiles depend on S_max alone. Bound: the bytes of the
// valid rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// _NEG of models/flash.py (-0.7 * FLT_MAX) as torch rounds it to f32
__device__ __forceinline__ float neg_big() { return __int_as_float(0xff333332); }

constexpr int NT = 128;          // threads a block, every kernel

struct Pos {
  const void* p;
  int wide;
  // position i, or dflt where the array was not given (an arange)
  __device__ __forceinline__ long long at(long long i, long long dflt) const {
    if (!p) return dflt;
    return wide ? static_cast<const long long*>(p)[i]
                : static_cast<long long>(static_cast<const int*>(p)[i]);
  }
};

__device__ __forceinline__ bool allowed(long long qp, long long kp, int causal,
                                        int window) {
  if (causal && kp > qp) return false;
  if (window > 0 && qp - kp >= window) return false;
  return true;
}

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// p cast to v's dtype, as a float
__device__ __forceinline__ float round_as(float x, bf16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_as(float x, float) { return x; }

// eight consecutive values (16-byte aligned) as floats
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// What the masks leave of key tile [key0, key0 + BN) for the block's rows,
// whose query positions lie in [qmin, qmax], judged from the tile's valid
// keys' position bounds by each warp alone (all warps reach the same
// answer): 0 nothing (the tile is skipped), 2 every (row, key) pair (no
// mask to apply), 1 some.
template <int BN>
__device__ __forceinline__ int tile_state(const Pos& kpos,
                                          const unsigned char* kval, int key0,
                                          int Skv, long long qmin,
                                          long long qmax, int causal,
                                          int window) {
  const int lane = threadIdx.x & 31;
  bool any = false, all = true;
  long long kmin = 0x7fffffffffffffffLL, kmax = -0x7fffffffffffffffLL;
#pragma unroll
  for (int i = lane; i < BN; i += 32) {
    const int key = key0 + i;
    if (key < Skv && (!kval || kval[key])) {
      const long long kp = kpos.at(key, key);
      any = true;
      kmin = kp < kmin ? kp : kmin;
      kmax = kp > kmax ? kp : kmax;
    } else {
      all = false;
    }
  }
  if (!__any_sync(0xffffffffu, any)) return 0;
  all = __all_sync(0xffffffffu, all);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const long long a = __shfl_xor_sync(0xffffffffu, kmin, o);
    const long long b = __shfl_xor_sync(0xffffffffu, kmax, o);
    kmin = a < kmin ? a : kmin;
    kmax = b > kmax ? b : kmax;
  }
  if (causal && kmin > qmax) return 0;
  if (window > 0 && qmin - kmax >= window) return 0;
  if (all && (!causal || kmax <= qmin) && (window <= 0 || qmax - kmin < window))
    return 2;
  return 1;
}

// The block's rows' query positions: rowpos[r] for r < rows (rows past M
// keep the block's first position) and, by every warp, their bounds.
__device__ __forceinline__ void row_positions(const Pos& qpos, int row0,
                                              int rows, int M, int G,
                                              long long* rowpos,
                                              long long* qmin,
                                              long long* qmax) {
  for (int r = threadIdx.x; r < rows; r += NT) {
    const int gr = row0 + r < M ? row0 + r : row0;
    rowpos[r] = qpos.at(gr / G, gr / G);
  }
  __syncthreads();
  long long lo = rowpos[0], hi = rowpos[0];
  for (int r = threadIdx.x & 31; r < rows; r += 32) {
    if (row0 + r < M) {
      lo = rowpos[r] < lo ? rowpos[r] : lo;
      hi = rowpos[r] > hi ? rowpos[r] : hi;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const long long a = __shfl_xor_sync(0xffffffffu, lo, o);
    const long long b = __shfl_xor_sync(0xffffffffu, hi, o);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
  *qmin = lo;
  *qmax = hi;
}

// Rows of the block with no valid key (rowflag set): sum(v) / den over
// every key of the (lane, KV head), as the plain version gives them.
template <typename T>
__device__ void fill_unseen(const T* v, T* out, const int* rowflag, int row0,
                            int rows, int M, int G, int Sq, int Skv, int KV,
                            int HD, int b, int kvh, long long vs0,
                            long long vs1, long long vs2, float den) {
  for (int d = threadIdx.x; d < HD; d += NT) {
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pair_bf16(const bf16* lo, const bf16* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
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

// ---------------------------------------------------------------- bf16
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// 16 bytes from global to shared, asynchronously; zeros where !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// 4 warps of 16 rows on mma.sync m16n8k16. The K and V tiles go through
// two shared-memory buffers: the next live tile is copied (cp.async)
// while the current one is computed. Fragments come from ldmatrix (V's
// transposed); q's stay in registers for hd <= 128. The exponentials are
// the hardware's (__expf, ex2 of x log2 e: a few ulp from expf, far below
// the bf16 rounding of p that follows; the difference comes first, so
// exp(_NEG - _NEG) is still 1 and exp(_NEG - m) still 0): at the tensor
// cores' rate the accurate expf would take longer than the products.
template <int HD, int BN>
__global__ void __launch_bounds__(NT) attn_fwd_bf16(FwdArgs a) {
  constexpr int BM = 64, LD = HD + 8, CH = HD / 8, KS = HD / 16;
  constexpr bool QREG = HD <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * LD;            // [2][BN][LD]
  bf16* Vs = Ks + 2 * BN * LD;        // [2][BN][LD]
  constexpr int MAXT = 1024;
  __shared__ long long rowpos[BM], kpos_s[2][BN];
  __shared__ int kval_s[2][BN], rowflag[BM];
  __shared__ unsigned char state_s[MAXT];

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  bf16* out = static_cast<bf16*>(a.out);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, kvh = blockIdx.y, M = a.Sq * a.G;
  const int row0 = blockIdx.x * BM;

  for (int i = tid; i < BM * CH; i += NT) {
    const int r = i / CH, c = i % CH, gr = row0 + r;
    const bool in = gr < M;
    const int s = in ? gr / a.G : 0, g = in ? gr % a.G : 0;
    cp_async16(Qs + r * LD + c * 8,
               q + b * a.qs0 + s * a.qs1 + kvh * a.qs2 + g * a.qs3 + c * 8,
               in);
  }
  cp_async_commit();
  long long qmin, qmax;
  row_positions(a.qpos, row0, BM, M, a.G, rowpos, &qmin, &qmax);

  const int rA = warp * 16 + (lane >> 2), rB = rA + 8, cq = (lane & 3) * 2;
  const long long qpA = rowpos[rA], qpB = rowpos[rB];
  // the lane's ldmatrix row: A (q) and K by row of the 8x8 matrices, V
  // transposed
  const int lm = lane >> 3, lr = lane & 7;
  float m_r[2] = {neg_big(), neg_big()}, l_r[2] = {0.f, 0.f};
  float o[CH][4];
#pragma unroll
  for (int n = 0; n < CH; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[QREG ? KS : 1][4];

  const int ntiles = (a.Skv + BN - 1) / BN;
  // the tiles' states (tile_state) for a window of MAXT tiles at a time,
  // each warp a quarter of them, so that no tile of the loop below waits
  // on its positions' loads
  int base = -MAXT;
  auto next_live = [&](int t, int* state) {
    for (; t < ntiles; ++t) {
      if (t >= base + MAXT) {
        base = t;
        __syncthreads();                  // the last window's readers
#pragma unroll 4
        for (int u = base + warp; u < base + MAXT && u < ntiles;
             u += NT / 32) {
          const int st = tile_state<BN>(a.kpos, a.kval, u * BN, a.Skv, qmin,
                                        qmax, a.causal, a.window);
          if (lane == 0) state_s[u - base] = static_cast<unsigned char>(st);
        }
        __syncthreads();
      }
      *state = state_s[t - base];
      if (*state) return t;
    }
    return ntiles;
  };
  // a fully live tile (state 2) needs no positions: nothing is masked
  auto issue = [&](int t, int buf, int st) {
    const int key0 = t * BN;
    bf16* kd = Ks + buf * BN * LD;
    bf16* vd = Vs + buf * BN * LD;
    for (int i = tid; i < BN * CH; i += NT) {
      const int j = i / CH, c = i % CH, key = key0 + j;
      const bool in = key < a.Skv;
      const int kk = in ? key : 0;
      cp_async16(kd + j * LD + c * 8,
                 k + b * a.ks0 + kk * a.ks1 + kvh * a.ks2 + c * 8, in);
      cp_async16(vd + j * LD + c * 8,
                 v + b * a.vs0 + kk * a.vs1 + kvh * a.vs2 + c * 8, in);
    }
    cp_async_commit();
    for (int j = tid; j < BN && st == 1; j += NT) {
      const int key = key0 + j;
      kpos_s[buf][j] = key < a.Skv ? a.kpos.at(key, key) : 0;
      kval_s[buf][j] = key >= a.Skv ? -1 : (a.kval && !a.kval[key] ? 0 : 1);
    }
  };

  int state = 0, buf = 0;
  int t = next_live(0, &state);
  if (t < ntiles) issue(t, 0, state);
  bool first = true;
  while (t < ntiles) {
    int next_state = 0;
    const int tn = next_live(t + 1, &next_state);
    if (tn < ntiles) {
      issue(tn, buf ^ 1, next_state);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (QREG && first) {
#pragma unroll
      for (int kk = 0; kk < (QREG ? KS : 1); ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + lr + (lm & 1) * 8) * LD + kk * 16 +
                            (lm >> 1) * 8);
    }
    first = false;
    const bf16* Kt = Ks + buf * BN * LD;
    const bf16* Vt = Vs + buf * BN * LD;

    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t af[4];
      if (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) af[i] = qf[QREG ? kk : 0][i];
      } else {
        ldsm_x4(af, Qs + (warp * 16 + lr + (lm & 1) * 8) * LD + kk * 16 +
                        (lm >> 1) * 8);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, Kt + (j * 8 + (lm >> 1) * 8 + lr) * LD + kk * 16 +
                        (lm & 1) * 8);
        mma_bf16(s[j], af, bf[0], bf[1]);
        mma_bf16(s[j + 1], af, bf[2], bf[3]);
      }
    }
    // scale and mask; the tile's row max (rows rA, rB)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + cq + (e & 1), h = e >> 1;
        float sv;
        if (state == 2) {
          sv = s[j][e] * a.scale;
        } else {
          const int kv = kval_s[buf][col];
          if (kv < 0)
            sv = -INFINITY;               // past Skv: no key at all
          else if (kv == 0 || !allowed(h ? qpB : qpA, kpos_s[buf][col],
                                       a.causal, a.window))
            sv = neg_big();
          else
            sv = s[j][e] * a.scale;
        }
        s[j][e] = sv;
        tmax[h] = fmaxf(tmax[h], sv);
      }
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m_r[h], tmax[h]);
      corr[h] = __expf(m_r[h] - m_new);
      m_r[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[j][e] = __expf(s[j][e] - m_r[h]);
        rsum[h] += s[j][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
      l_r[h] = l_r[h] * corr[h] + rsum[h];
    }
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }
    // O += P V, P (bf16) straight from the score accumulators
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < CH; n += 2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, Vt + (kk * 16 + (lm & 1) * 8 + lr) * LD +
                          (n + (lm >> 1)) * 8);
        mma_bf16(o[n], pf, vf[0], vf[1]);
        mma_bf16(o[n + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();                      // buf is free for the next copy
    t = tn;
    state = next_state;
    buf ^= 1;
  }
  cp_async_wait<0>();

  if ((lane & 3) == 0) {
    rowflag[rA] = m_r[0] == neg_big();
    rowflag[rB] = m_r[1] == neg_big();
    for (int h = 0; h < 2 && a.m; ++h) {
      const int gr = row0 + (h ? rB : rA);
      if (gr < M)
        write_stats(a.m, a.l, gr, a.G, a.Sq, a.KV, b, kvh, m_r[h], l_r[h],
                    a.den);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + (h ? rB : rA);
    if (gr >= M || m_r[h] == neg_big()) continue;
    const int s_ = gr / a.G, g = gr % a.G;
    bf16* dst = out + (((long long)b * a.Sq + s_) * a.KV + kvh) * a.G * HD +
                (long long)g * HD + cq;
    const float den = fmaxf(l_r[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          o[n][2 * h] / den, o[n][2 * h + 1] / den);
    }
  }
  const bool mine = (row0 + rA < M && m_r[0] == neg_big()) ||
                    (row0 + rB < M && m_r[1] == neg_big());
  if (__syncthreads_or(mine))
    fill_unseen<bf16>(v, out, rowflag, row0, BM, M, a.G, a.Sq, a.Skv, a.KV,
                      HD, b, kvh, a.vs0, a.vs1, a.vs2, a.den);
}

// ----------------------------------------------------------------- f32
template <int HD>
__global__ void __launch_bounds__(NT) attn_fwd_f32(FwdArgs a) {
  constexpr int BM = 32, BN = 32, NC = HD / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BN * HD;
  __shared__ long long rowpos[BM], kpos_s[BN];
  __shared__ int kval_s[BN], rowflag[BM];

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* out = static_cast<float*>(a.out);
  const int tid = threadIdx.x, r = tid >> 2, qi = tid & 3;
  const int b = blockIdx.z, kvh = blockIdx.y, M = a.Sq * a.G;
  const int row0 = blockIdx.x * BM, gr = row0 + r;

  // this thread's columns of its row: 4 i + qi
  float qv[NC], acc[NC];
  {
    const int s_ = gr < M ? gr / a.G : 0, g = gr < M ? gr % a.G : 0;
    const float* src = q + b * a.qs0 + s_ * a.qs1 + kvh * a.qs2 + g * a.qs3;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      qv[i] = gr < M ? src[4 * i + qi] : 0.f;
      acc[i] = 0.f;
    }
  }
  long long qmin, qmax;
  row_positions(a.qpos, row0, BM, M, a.G, rowpos, &qmin, &qmax);
  const long long qp = rowpos[r];
  float m = neg_big(), l = 0.f;

  const int ntiles = (a.Skv + BN - 1) / BN;
  for (int t = 0; t < ntiles; ++t) {
    const int key0 = t * BN;
    if (!tile_state<BN>(a.kpos, a.kval, key0, a.Skv, qmin, qmax, a.causal,
                        a.window))
      continue;
    __syncthreads();
    for (int i = tid; i < BN * (HD / 4); i += NT) {
      const int j = i / (HD / 4), c = i % (HD / 4), key = key0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (key < a.Skv) {
        kk = *reinterpret_cast<const float4*>(k + b * a.ks0 + key * a.ks1 +
                                              kvh * a.ks2 + c * 4);
        vv = *reinterpret_cast<const float4*>(v + b * a.vs0 + key * a.vs1 +
                                              kvh * a.vs2 + c * 4);
      }
      *reinterpret_cast<float4*>(Ks + j * HD + c * 4) = kk;
      *reinterpret_cast<float4*>(Vs + j * HD + c * 4) = vv;
    }
    for (int j = tid; j < BN; j += NT) {
      const int key = key0 + j;
      kpos_s[j] = key < a.Skv ? a.kpos.at(key, key) : 0;
      kval_s[j] = key >= a.Skv ? -1 : (a.kval && !a.kval[key] ? 0 : 1);
    }
    __syncthreads();

    float s[BN];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) part += qv[i] * Ks[j * HD + 4 * i + qi];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kv = kval_s[j];
      float sv;
      if (kv < 0)
        sv = -INFINITY;
      else if (kv == 0 || !allowed(qp, kpos_s[j], a.causal, a.window))
        sv = neg_big();
      else
        sv = part * a.scale;
      s[j] = sv;
      tmax = fmaxf(tmax, sv);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    m = m_new;
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      s[j] = expf(s[j] - m);
      rsum += s[j];
    }
    l = l * corr + rsum;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      float pv = 0.f;
#pragma unroll
      for (int j = 0; j < BN; ++j) pv += s[j] * Vs[j * HD + 4 * i + qi];
      acc[i] = acc[i] * corr + pv;
    }
  }

  if (qi == 0) {
    rowflag[r] = m == neg_big();
    if (a.m && gr < M)
      write_stats(a.m, a.l, gr, a.G, a.Sq, a.KV, b, kvh, m, l, a.den);
  }
  if (gr < M && m != neg_big()) {
    const int s_ = gr / a.G, g = gr % a.G;
    float* dst = out + (((long long)b * a.Sq + s_) * a.KV + kvh) * a.G * HD +
                 (long long)g * HD;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i) dst[4 * i + qi] = acc[i] / den;
  }
  if (__syncthreads_or(gr < M && m == neg_big()))
    fill_unseen<float>(v, out, rowflag, row0, BM, M, a.G, a.Sq, a.Skv, a.KV,
                       HD, b, kvh, a.vs0, a.vs1, a.vs2, a.den);
}

// -------------------------------------------------------------- decode
struct DecArgs {
  const void *q, *k, *v;
  Pos pos;
  void* out;
  float *acc, *m, *l;     // the stats (return_stats), else null
  float *pacc, *pml;      // the splits' partials (nsplit > 1), else null
  int S_max, KV, G, nsplit, split_rows;   // cache rows a split
  long long qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2;
  int window;
  long long koff;
  float scale;
  int stats;
};

constexpr int GB = 8;    // query heads a decode block

// One split of the cache for one (lane, KV head) and up to GB query heads.
// The split's rows that can be valid go by in tiles of NT rows (aligned to
// the split's start). A row is read by LPR lanes, 8 values (16 bytes of
// bf16) a lane: the scores' partial dots are summed across the row's
// lanes by an xor butterfly (every lane ends with the same bits), the
// softmax stats of a tile are taken a query head a warp, and each thread
// accumulates p * v for its 8 columns over the rows it reads; the row
// slots' accumulators are summed in slot order at the end.
template <typename T, int HD>
__global__ void __launch_bounds__(NT) decode_split(DecArgs a) {
  constexpr int CPR = HD / 8;                       // 8-value chunks a row
  constexpr int LPR = CPR <= 4 ? 4 : CPR <= 8 ? 8 : CPR <= 16 ? 16 : 32;
  constexpr int RP = NT / LPR;                      // rows a pass
  __shared__ float S[GB][NT];
  __shared__ __align__(16) float red[RP][GB][HD];
  __shared__ float m_s[GB], l_s[GB], c_s[GB];

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rl = tid / LPR, c = tid % LPR;
  const bool col = c < CPR;
  const int split = blockIdx.x, b = blockIdx.z;
  const int ngroups = (a.G + GB - 1) / GB;
  const int kvh = blockIdx.y / ngroups, g0 = (blockIdx.y % ngroups) * GB;
  const int gn = a.G - g0 < GB ? a.G - g0 : GB;

  float qv[GB][8], acc[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[g][e] = acc[g][e] = 0.f;
    if (g < gn && col)
      load8(q + b * a.qs0 + kvh * a.qs1 + (g0 + g) * a.qs2 + c * 8, qv[g]);
  }
  if (tid < GB) {
    m_s[tid] = neg_big();
    l_s[tid] = 0.f;
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
  const T* kb = k + b * a.ks0 + kvh * a.ks2 + c * 8;
  const T* vb = v + b * a.vs0 + kvh * a.vs2 + c * 8;
  __syncthreads();

  for (long long t0 = s0 + (r0 - s0) / NT * NT; r0 <= r1 && t0 <= r1;
       t0 += NT) {
    for (int i = 0; i < NT / RP; ++i) {
      const int slot = i * RP + rl;
      const long long row = t0 + slot;
      const bool in = row >= r0 && row <= r1;
      float dot[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) dot[g] = 0.f;
      if (in && col) {
        float f[8];
        load8(kb + row * a.ks1, f);
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
        if (c == 0 && g < gn)
          S[g][slot] = !in ? -INFINITY : (masked ? neg_big() : dot[g] * a.scale);
      }
    }
    __syncthreads();
    for (int g = warp; g < gn; g += NT / 32) {
      float x[4], tmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = S[g][lane * 4 + i];
        tmax = fmaxf(tmax, x[i]);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m_s[g], tmax);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pe = expf(x[i] - m_new);
        sum += pe;
        S[g][lane * 4 + i] = round_as(pe, T());
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_s[g] - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float corr = g < gn ? c_s[g] : 1.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
    }
    for (int i = 0; i < NT / RP; ++i) {
      const int slot = i * RP + rl;
      const long long row = t0 + slot;
      if (row < r0 || row > r1 || !col) continue;
      float f[8];
      load8(vb + row * a.vs1, f);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float pg = g < gn ? S[g][slot] : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] += pg * f[e];
      }
    }
    __syncthreads();
  }

  // the row slots' accumulators, summed in slot order
  if (col) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[rl][g][c * 8 + e] = acc[g][e];
  }
  __syncthreads();
  const long long head = (long long)b * a.KV + kvh;
  for (int i = tid; i < gn * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float sum = 0.f;
    for (int r = 0; r < RP; ++r) sum += red[r][g][d];
    const long long hg = head * a.G + g0 + g;
    if (a.nsplit > 1)
      a.pacc[((head * a.nsplit + split) * a.G + g0 + g) * HD + d] = sum;
    else if (a.stats)
      a.acc[hg * HD + d] = sum;
    else
      static_cast<T*>(a.out)[hg * HD + d] =
          from_f<T>(sum / fmaxf(l_s[g], 1e-30f));
  }
  if (tid < gn) {
    const long long hg = head * a.G + g0 + tid;
    if (a.nsplit > 1) {
      float* ml = a.pml + ((head * a.nsplit + split) * a.G + g0 + tid) * 2;
      ml[0] = m_s[tid];
      ml[1] = l_s[tid];
    } else if (a.stats) {
      a.m[hg] = m_s[tid];
      a.l[hg] = l_s[tid];
    }
  }
}

// the splits' (acc, m, l) merged in split order
template <typename T>
__global__ void __launch_bounds__(NT) decode_merge(DecArgs a, int HD) {
  const long long head = (long long)blockIdx.y * a.KV + blockIdx.x;
  for (int i = threadIdx.x; i < a.G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float mg = neg_big();
    for (int j = 0; j < a.nsplit; ++j)
      mg = fmaxf(mg, a.pml[((head * a.nsplit + j) * a.G + g) * 2]);
    float acc = 0.f, l = 0.f;
    for (int j = 0; j < a.nsplit; ++j) {
      const float* ml = a.pml + ((head * a.nsplit + j) * a.G + g) * 2;
      const float w = expf(ml[0] - mg);
      acc += a.pacc[((head * a.nsplit + j) * a.G + g) * HD + d] * w;
      l += ml[1] * w;
    }
    const long long hg = head * a.G + g;
    if (a.stats) {
      a.acc[hg * HD + d] = acc;
      if (d == 0) {
        a.m[hg] = mg;
        a.l[hg] = l;
      }
    } else {
      static_cast<T*>(a.out)[hg * HD + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
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

template <int HD>
cudaError_t launch_fwd(const FwdArgs& a, int B, int dtype,
                       cudaStream_t stream) {
  const int M = a.Sq * a.G;
  if (dtype == 0) {
    constexpr int BN = HD <= 128 ? 64 : 32;
    const int bytes = (64 + 4 * BN) * (HD + 8) * 2;
    static bool ready = false;
    if (!ready) {
      cudaError_t e = smem_limit(attn_fwd_bf16<HD, BN>, bytes);
      if (e != cudaSuccess) return e;
      ready = true;
    }
    attn_fwd_bf16<HD, BN><<<dim3((M + 63) / 64, a.KV, B), NT, bytes, stream>>>(a);
  } else {
    const int bytes = 2 * 32 * HD * 4;
    static bool ready = false;
    if (!ready) {
      cudaError_t e = smem_limit(attn_fwd_f32<HD>, bytes);
      if (e != cudaSuccess) return e;
      ready = true;
    }
    attn_fwd_f32<HD><<<dim3((M + 31) / 32, a.KV, B), NT, bytes, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_decode(const DecArgs& a, int B, cudaStream_t stream) {
  const int ngroups = (a.G + GB - 1) / GB;
  decode_split<T, HD><<<dim3(a.nsplit, a.KV * ngroups, B), NT, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  decode_merge<T><<<dim3(a.KV, B), NT, 0, stream>>>(a, HD);
  return cudaGetLastError();
}

template <typename T>
cudaError_t decode_hd(const DecArgs& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_decode<T, 32>(a, B, stream);
    case 64: return launch_decode<T, 64>(a, B, stream);
    case 80: return launch_decode<T, 80>(a, B, stream);
    case 128: return launch_decode<T, 128>(a, B, stream);
    case 256: return launch_decode<T, 256>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attn_fwd(
    const void* q, const void* k, const void* v, void* out, void* m,
    void* l, const void* qpos, int qpos64, const void* kpos, int kpos64, const void* kval, int B, int Sq,
    int Skv, int KV, int G, int hd, long long qs0, long long qs1,
    long long qs2, long long qs3, long long ks0, long long ks1, long long ks2,
    long long vs0, long long vs1, long long vs2, int causal, int window,
    float scale, float den, int dtype, void* stream) {
  FwdArgs a{q, k, v, out, static_cast<float*>(m), static_cast<float*>(l),
            {qpos, qpos64}, {kpos, kpos64},
            static_cast<const unsigned char*>(kval), Sq, Skv, KV, G,
            qs0, qs1, qs2, qs3, ks0, ks1, ks2, vs0, vs1, vs2, causal, window,
            scale, den};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_fwd<32>(a, B, dtype, s);
    case 64: return launch_fwd<64>(a, B, dtype, s);
    case 80: return launch_fwd<80>(a, B, dtype, s);
    case 128: return launch_fwd<128>(a, B, dtype, s);
    case 256: return launch_fwd<256>(a, B, dtype, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int flash_decode(
    const void* q, const void* k, const void* v, const void* pos, int pos64,
    void* out, void* acc, void* m, void* l, void* pacc, void* pml, int B,
    int S_max, int KV, int G, int hd, int nsplit, int split_rows,
    long long qs0,
    long long qs1, long long qs2, long long ks0, long long ks1, long long ks2,
    long long vs0, long long vs1, long long vs2, int window, long long koff,
    float scale, int stats, int dtype, void* stream) {
  DecArgs a{q, k, v, {pos, pos64}, out, static_cast<float*>(acc),
            static_cast<float*>(m), static_cast<float*>(l),
            static_cast<float*>(pacc), static_cast<float*>(pml), S_max, KV, G,
            nsplit, split_rows, qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2, window, koff,
            scale, stats};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? decode_hd<bf16>(a, B, hd, s)
                    : decode_hd<float>(a, B, hd, s);
}
