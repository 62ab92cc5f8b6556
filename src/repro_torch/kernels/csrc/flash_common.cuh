// Device helpers of the attention kernels, shared by flash_attention.cu
// (the prefill forward and the decode step) and flash_attention_bwd.cu (the
// prefill's backward): positions, masks, 16-byte loads and cp.async, the
// tile states of a key tile's mask from position bounds, base-2
// exponentials, bf16 packing, and the TF32 split and mma.sync of the
// tf32x3 route.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_common {

typedef __nv_bfloat16 bf16;

// _NEG of models/flash.py (-0.7 * FLT_MAX) as torch rounds it to f32
__device__ __forceinline__ float neg_big() { return __int_as_float(0xff333332); }

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

// A key tile's valid keys (key < Skv, kept by kval): whether it has any,
// whether every key of it is one, and their positions' bounds
struct KeyBounds {
  bool any, all;
  long long kmin, kmax;
};

// This lane's share of the BN keys from key0 (lane, lane + 32, ...); no key
// is valid where the tile is not live
template <int BN>
__device__ __forceinline__ KeyBounds scan_keys(const Pos& kpos,
                                               const unsigned char* kval,
                                               int key0, bool live, int Skv) {
  const int lane = threadIdx.x & 31;
  KeyBounds k{false, true, 0x7fffffffffffffffLL, -0x7fffffffffffffffLL};
#pragma unroll
  for (int i = lane; i < BN; i += 32) {
    const int key = key0 + i;
    if (live && key < Skv && (!kval || kval[key])) {
      const long long kp = kpos.at(key, key);
      k.any = true;
      k.kmin = kp < k.kmin ? kp : k.kmin;
      k.kmax = kp > k.kmax ? kp : k.kmax;
    } else {
      k.all = false;
    }
  }
  return k;
}

// The tile's bounds from its lanes' shares, in every lane
__device__ __forceinline__ KeyBounds warp_bounds(KeyBounds k) {
  k.any = __any_sync(0xffffffffu, k.any);
  k.all = __all_sync(0xffffffffu, k.all);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const long long x = __shfl_xor_sync(0xffffffffu, k.kmin, o);
    const long long y = __shfl_xor_sync(0xffffffffu, k.kmax, o);
    k.kmin = x < k.kmin ? x : k.kmin;
    k.kmax = y > k.kmax ? y : k.kmax;
  }
  return k;
}

// What the masks leave of the pairs of rows whose query positions lie in
// [qmin, qmax] and a key tile of bounds k: 0 nothing (the tile is
// skipped), 2 every (row, key) pair (no mask to apply), 1 some. The one
// rule of the forward's and the backward's tile skipping.
__device__ __forceinline__ int state_from_bounds(long long qmin,
                                                 long long qmax,
                                                 const KeyBounds& k,
                                                 int causal, int window) {
  if (!k.any) return 0;
  if (causal && k.kmin > qmax) return 0;
  if (window > 0 && qmin - k.kmax >= window) return 0;
  if (k.all && (!causal || k.kmax <= qmin) &&
      (window <= 0 || qmax - k.kmin < window))
    return 2;
  return 1;
}

// What the masks leave of key tiles t0 .. t0 + N - 1 (each BN keys from
// key t BN; a tile past the last reads 0) for the block's rows, whose
// query positions lie in [qmin, qmax], judged by state_from_bounds from
// the tiles' valid keys' position bounds by each warp alone (all warps
// reach the same answer). All N tiles' loads go out before any tile's
// reductions: one round trip for N tiles.
template <int BN, int N>
__device__ __forceinline__ void tile_states(const Pos& kpos,
                                            const unsigned char* kval,
                                            int t0, int ntiles, int Skv,
                                            long long qmin, long long qmax,
                                            int causal, int window,
                                            int* st) {
  KeyBounds k[N];
#pragma unroll
  for (int n = 0; n < N; ++n)
    k[n] = scan_keys<BN>(kpos, kval, (t0 + n) * BN, t0 + n < ntiles, Skv);
#pragma unroll
  for (int n = 0; n < N; ++n)
    st[n] = state_from_bounds(qmin, qmax, warp_bounds(k[n]), causal, window);
}

// The states of the window of MAXT tiles from base, by warp w of nw, two
// tiles a round trip, into state[0, MAXT)
template <int BN, int MAXT>
__device__ __forceinline__ void fill_states(unsigned char* state, int base,
                                            int w, int nw, const Pos& kpos,
                                            const unsigned char* kval,
                                            int ntiles, int Skv,
                                            long long qmin, long long qmax,
                                            int causal, int window) {
  for (int u = base + 2 * w; u < base + MAXT && u < ntiles; u += 2 * nw) {
    int st[2];
    tile_states<BN, 2>(kpos, kval, u, ntiles, Skv, qmin, qmax, causal,
                       window, st);
    if ((threadIdx.x & 31) == 0) {
      state[u - base] = static_cast<unsigned char>(st[0]);
      if (u + 1 - base < MAXT)
        state[u + 1 - base] = static_cast<unsigned char>(st[1]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ------------------------------------------------------------- cp.async
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

// x = big + small to f32's precision, both TF32 values: big x's top 19
// bits, small what remains (x - big, exact) with the same mask
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

// C (16 x 8, f32) += A (16 x 8) B (8 x 8), tf32, a warp: A's element
// (row, k) a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8,
// t + 4); B's b0 (t, g), b1 (t + 4, g); C's (g, 2t), (g, 2t + 1), (g + 8,
// 2t), (g + 8, 2t + 1), g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace flash_common
