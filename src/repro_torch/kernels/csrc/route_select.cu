// Fused MoE routing for Hopper (sm_90a): one launch routes one layer.
//
// Replaces the TPU kernel router_topk_pallas (src/repro/kernels/router.py:47)
// together with the tensor ops around it in the reference's routing stage
// (src/repro/models/moe.py: route, _select_slots with _assignment_uniforms,
// _masked_tally, _aux_loss). For a layer's activations x (T, D) bf16 and its
// router w (D, E) f32 it computes
//     logits = f32(x) @ w, p = softmax(logits)           (T, E)
//     weights, idx = top-K of p (ties to the smallest column), weights
//         divided by their sum clamped at 1e-9, zero on rows row_valid masks
//     slots[t, k] = slots_of[e, copy], copy = #{r : u >= cdf[e, r]} clamped
//         to n_copies[e] - 1, u the uint32 hash of a = t K + k and the seed
//     tally[e] = #{(t, k) : idx = e, row t valid}, tally[E] = 0
//     mean_prob = mean over all T rows of p, aux = E dot(tally / max(sum
//         tally, 1), mean_prob)
// and, as a second entry (router_topk_f32), the TPU kernel's own function:
// logits (T, E) f32 -> top-K weights and indices, through the same epilogue.
// For training the forward also writes p (T, E) f32, and a third entry
// (route_select_bwd_f32, below) is the stage's backward to its logits.
//
// What bounds it on an H100. Bytes: x and w (decode, T = 8, D = 1536,
// E = 40: 24.6 KB + 245.8 KB, 0.08 us at 3.35 TB/s). Operations: the f32
// product, 2 T D E (T = 4096: 503 MFLOP, 7.5 us at 67 TFLOP/s). At the
// path's T (8 to 512) neither: a launch's fixed cost and the chain of
// dependent steps (load, product, cross-block sum, softmax, K sweeps)
// set the time, so the design spends its care on one launch with no host
// work, no second pass and enough blocks in flight.
//
// Design:
// * The product is f32 on CUDA cores, not tensor cores. The reference takes
//   it in f32; TF32 or bf16 wgmma would move logits by ~1e-3 and flip
//   routing. bf16 -> f32 is exact, so only the order of the sum differs
//   from cuBLAS. A thread owns 4 rows x 4 columns; per 8-deep step it reads
//   4 x 16 B of x and 8 x 16 B of w from shared memory for 128 FMAs.
// * Staging. w (245.8 KB for granite) does not fit one block's shared
//   memory, but its rows [d0, d0 + DC) are contiguous, so each DC-deep
//   chunk of w and of the x tile arrives by 16-byte cp.async (rows past T or
//   D zero-filled by the copy), double-buffered: chunk c + 1 is in flight
//   while chunk c is summed. Shapes the 16-byte copy cannot take (D not a
//   multiple of 8, E not of 4) load element by element into the same
//   layout.
// * Parallelism: a grid of (S, n_rb). Row blocks of TR rows give the
//   parallelism at prefill; at decode (one row block) D is split into S
//   ranges (split-K), so S blocks read w together instead of one SM
//   reading all of it. The host picks TR and S (route_select.py: plan) for
//   about two blocks an SM. With S > 1 each block writes partial logits to
//   scratch; the last block of a row block, found by an atomic ticket after
//   a __threadfence, sums the S partials in split order (so the logits and
//   the tie rule do not depend on which block finished last) and runs the
//   epilogue for its rows.
// * Epilogue: a warp a row, E / 32 columns a lane (J = 2 for E <= 64, up
//   to 32 for E <= 1024). Softmax by shuffles with expf, then K sweeps of a
//   shuffle argmax on (value, column) pairs, ties to the smallest column
//   (lax.top_k's rule), the winner masked to -1; lane k keeps sweep k.
//   A row takes ~2 us at K = 8 (measured with timer stamps); two or four
//   rows a warp at a time, or a rank-based top-k from 32 J independent
//   shuffles, measured no faster.
// * Replica selection in native uint32: u = ((a + seed 2246822519)
//   2654435761 mod 2^32) >> 8, times 2^-24, bit for bit the reference's
//   _assignment_uniforms. The seed is read on the device.
// * Tally and mean_prob: per row block, integer counts (shared-memory
//   atomics, exact in any order) and a sum of p over the block's rows;
//   with several row blocks these go to scratch and the last row block to
//   finish (a second ticket) sums them and computes aux. Every sum runs in
//   an order fixed by the shapes alone (column_sums), so reruns are
//   bit-identical. The finishing block stages the replica tables in shared
//   memory (cp.async) while it sums, and the seed is loaded at the start.
// * Nothing on the host waits: no synchronisation, no data-dependent host
//   decision. Each ticket is reset to 0 by the block that consumed it, so
//   the counters (zeroed once by the wrapper) are ready for the next launch
//   and a captured launch can replay. Launches that share a ticket buffer
//   must be ordered (one stream). The kernel allocates nothing; the wrapper
//   allocates the outputs and keeps the scratch.
//
// Where the time goes (an H100, timer stamps at the phase boundaries, T = 8,
// E = 40, ~12 us in all): ~4.5 us the product (three chunks of cp.async
// round trips), ~1.7 us the partial stores, fence and ticket, ~1.4 us the
// finishing block's sum, ~2 us the epilogue, ~2 us the tally and aux. The
// chain, not the bytes or the operations, sets it; a thread-block cluster
// summing the partials through distributed shared memory would cut the
// ticket and the global round trips.
//
// Launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RT = 4;                 // rows a thread in the product
constexpr int CT = 4;                 // columns a thread in the product
constexpr int XPAD = 8;               // bf16 pad of an x row in shared memory
constexpr int MAX_SMEM = 200 * 1024;  // dynamic shared memory allowed
constexpr unsigned HASH_MULT = 2654435761u;
constexpr unsigned SEED_MULT = 2246822519u;

struct Params {
  const __nv_bfloat16* x;   // (T, D)
  const float* w;           // (D, E)
  const int* slots_of;      // (E, R)
  const int* n_copies;      // (E,)
  const float* cdf;         // (E, R)
  const int* seed;          // ()
  const bool* row_valid;    // (T,) or null
  float* weights;           // (T, K)
  float* probs;             // (T, E) softmax, for the backward; or null
  int* idx;                 // (T, K)
  int* slots;               // (T, K)
  float* tally;             // (E + 1,)
  float* mean_prob;         // (E,)
  float* aux;               // ()
  float* part;              // (S, T, E) partial logits, S > 1
  float* rb_prob;           // (n_rb, E) per row block sums of p, n_rb > 1
  int* rb_count;            // (n_rb, E) per row block counts, n_rb > 1
  int* tickets;             // (n_rb + 1,), 0 between launches
  int T, D, E, K, R, TR, DC, cps, EP, vec;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One DC-deep chunk starting at d0: the x tile into xs (TR rows of DC + XPAD
// bf16, row-major) and w's rows into ws (DC rows of EP floats). Out of range
// entries are zero.
__device__ __forceinline__ void load_chunk(const Params& p, __nv_bfloat16* xs,
                                           float* ws, int r0, int d0) {
  const int tid = threadIdx.x;
  const int xrow = p.DC + XPAD;
  if (p.vec) {
    const int per_row = p.DC / 8;
    for (int i = tid; i < p.TR * per_row; i += THREADS) {
      const int r = i / per_row, q = i - r * per_row;
      const int row = r0 + r, d = d0 + 8 * q;
      const bool ok = row < p.T && d < p.D;
      const __nv_bfloat16* src =
          ok ? p.x + static_cast<int64_t>(row) * p.D + d : p.x;
      cp_async16(xs + r * xrow + 8 * q, src, ok ? 16 : 0);
    }
    const int per_wrow = p.E / 4;
    for (int i = tid; i < p.DC * per_wrow; i += THREADS) {
      const int dd = i / per_wrow, q = i - dd * per_wrow;
      const int d = d0 + dd;
      const bool ok = d < p.D;
      const float* src = ok ? p.w + static_cast<int64_t>(d) * p.E + 4 * q
                            : p.w;
      cp_async16(ws + dd * p.EP + 4 * q, src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < p.TR * p.DC; i += THREADS) {
      const int r = i / p.DC, dd = i - r * p.DC;
      const int row = r0 + r, d = d0 + dd;
      xs[r * xrow + dd] = (row < p.T && d < p.D)
                              ? p.x[static_cast<int64_t>(row) * p.D + d]
                              : __float2bfloat16(0.0f);
    }
    for (int i = tid; i < p.DC * p.EP; i += THREADS) {
      const int dd = i / p.EP, c = i - dd * p.EP;
      const int d = d0 + dd;
      ws[i] = (d < p.D && c < p.E) ? p.w[static_cast<int64_t>(d) * p.E + c]
                                   : 0.0f;
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
  const unsigned v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

// Softmax over a row held J values a lane (column lane + 32 j); columns past
// E hold -inf on entry and -1 on exit, so they never win a sweep.
template <int J>
__device__ __forceinline__ void softmax_row(float (&v)[J], int E, int lane) {
  float m = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < J; ++j) m = fmaxf(m, v[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    v[j] = (lane + 32 * j < E) ? expf(v[j] - m) : 0.0f;
    s += v[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
  for (int j = 0; j < J; ++j) v[j] = (lane + 32 * j < E) ? v[j] / s : -1.0f;
}

// K sweeps of max / first argmax / mask. Lane k < K ends with sweep k's
// probability and column; every lane ends with their sum (in sweep order).
template <int J>
__device__ __forceinline__ void top_k(float (&v)[J], int K, int lane,
                                      float& my_w, int& my_i, float& total) {
  total = 0.0f;
  my_w = 0.0f;
  my_i = 0;
  for (int k = 0; k < K; ++k) {
    float bv = v[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < J; ++j) {
      if (v[j] > bv) {  // strict: the first of equal columns stays
        bv = v[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    total += bv;
    if (lane == k) {
      my_w = bv;
      my_i = bi;
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (lane + 32 * j == bi) v[j] = -1.0f;
  }
}

// The replica tables, staged in shared memory by the finishing block.
struct Tables {
  int* slots_of;   // (E, R)
  int* n_copies;   // (E,)
  float* cdf;      // (E, R)
};

__device__ __forceinline__ int select_slot(const Tables& t, int R, int a,
                                           int e, unsigned seed) {
  const int* so = t.slots_of + e * R;
  if (R == 1) return so[0];
  const unsigned h = (static_cast<unsigned>(a) + seed * SEED_MULT) * HASH_MULT;
  const float u = static_cast<float>(h >> 8) * 5.9604644775390625e-08f;
  const float* cdf = t.cdf + e * R;
  int copy = 0;
  for (int r = 0; r < R; ++r) copy += (u >= cdf[r]) ? 1 : 0;
  copy = max(min(copy, t.n_copies[e] - 1), 0);
  return so[copy];
}

// out(e, sum over r < n of load(r, e)) for every e < E, load giving float2
// (two sums at once), in an order fixed by (n, E) alone: with
// G = THREADS / E > 1 groups of threads, group g sums rows
// [g n / G, (g + 1) n / G) and thread e adds the G partials in group order.
// buf holds THREADS float2. Every thread of the block calls it.
template <typename Load, typename Out>
__device__ __forceinline__ void column_sums(int n, int E, float2* buf,
                                            Load load, Out out) {
  const int tid = threadIdx.x;
  const int G = min(THREADS / E, n);
  if (G > 1) {
    const int g = tid / E, e = tid - g * E;
    if (g < G) {
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll 4
      for (int r = (n * g) / G; r < (n * (g + 1)) / G; ++r) {
        const float2 v = load(r, e);
        acc.x += v.x;
        acc.y += v.y;
      }
      buf[g * E + e] = acc;
    }
    __syncthreads();
    for (int c = tid; c < E; c += THREADS) {
      float2 acc = make_float2(0.0f, 0.0f);
      for (int k = 0; k < G; ++k) {
        acc.x += buf[k * E + c].x;
        acc.y += buf[k * E + c].y;
      }
      out(c, acc);
    }
    __syncthreads();
  } else {
    for (int c = tid; c < E; c += THREADS) {
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const float2 v = load(r, c);
        acc.x += v.x;
        acc.y += v.y;
      }
      out(c, acc);
    }
  }
}

// Shared memory: the two stage buffers, later reused by the finishing block
// as lg (TR x EP floats: logits, then p), cnt (EP ints), ft and fp (EP
// floats), buf (THREADS float2) and the replica tables (E (2 R + 1) words).
// J columns a lane in the epilogue.
template <int J>
__global__ void __launch_bounds__(THREADS)
route_select_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = blockIdx.x, S = gridDim.x;
  const int rb = blockIdx.y, n_rb = gridDim.y;
  const int r0 = rb * p.TR;
  const unsigned seed = static_cast<unsigned>(*p.seed);   // used at the end
  const int xs_elems = p.TR * (p.DC + XPAD);
  const int ws_elems = p.DC * p.EP;
  __nv_bfloat16* xs[2];
  float* ws[2];
  xs[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  xs[1] = xs[0] + xs_elems;
  ws[0] = reinterpret_cast<float*>(xs[1] + xs_elems);
  ws[1] = ws[0] + ws_elems;

  // ---- product: rows [r0, r0 + TR), depth [dbeg, dbeg + n_chunks DC)
  const int ncg = p.EP / CT;
  const int items = (p.TR / RT) * ncg;
  const int rg = tid / ncg, cg = tid - (tid / ncg) * ncg;
  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;
  const int dbeg = s * p.cps * p.DC;
  const int n_chunks =
      max(0, min(p.cps, (p.D - dbeg + p.DC - 1) / p.DC));
  if (n_chunks > 0) load_chunk(p, xs[0], ws[0], r0, dbeg);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load_chunk(p, xs[(c + 1) & 1], ws[(c + 1) & 1], r0,
                 dbeg + (c + 1) * p.DC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tid < items) {
      const __nv_bfloat16* xb = xs[c & 1] + (RT * rg) * (p.DC + XPAD);
      const float* wb = ws[c & 1] + CT * cg;
      for (int d = 0; d < p.DC; d += 8) {
        float xv[RT][8];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          unpack8(*reinterpret_cast<const uint4*>(xb + i * (p.DC + XPAD) + d),
                  xv[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b =
              *reinterpret_cast<const float4*>(wb + (d + j) * p.EP);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            acc[i][0] = fmaf(xv[i][j], b.x, acc[i][0]);
            acc[i][1] = fmaf(xv[i][j], b.y, acc[i][1]);
            acc[i][2] = fmaf(xv[i][j], b.z, acc[i][2]);
            acc[i][3] = fmaf(xv[i][j], b.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  float* lg = reinterpret_cast<float*>(smem);
  int* cnt = reinterpret_cast<int*>(lg + p.TR * p.EP);
  float* ft = reinterpret_cast<float*>(cnt + p.EP);
  float* fp = ft + p.EP;
  float2* buf = reinterpret_cast<float2*>(fp + p.EP);   // EP % 4 == 0
  Tables tab;
  {
    int* so_s = reinterpret_cast<int*>(buf + THREADS);
    int* nc_s = so_s + p.E * p.R;
    float* cdf_s = reinterpret_cast<float*>(nc_s + p.E);
    tab = Tables{so_s, nc_s, cdf_s};
  }
  // the finishing block stages the replica tables while it sums
  auto stage_tables = [&]() {
    for (int i = tid; i < p.E * p.R; i += THREADS) {
      cp_async4(tab.slots_of + i, p.slots_of + i);
      if (p.R > 1) cp_async4(tab.cdf + i, p.cdf + i);
    }
    if (p.R > 1)
      for (int e = tid; e < p.E; e += THREADS)
        cp_async4(tab.n_copies + e, p.n_copies + e);
    cp_async_commit();
  };
  if (S == 1) {
    stage_tables();
    if (tid < items) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j)
          lg[(RT * rg + i) * p.EP + CT * cg + j] = acc[i][j];
    }
  } else {
    // ---- split-K: partial logits to scratch; the last block sums them
    if (tid < items) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = r0 + RT * rg + i;
        if (row >= p.T) continue;
        float* dst = p.part + (static_cast<int64_t>(s) * p.T + row) * p.E;
#pragma unroll
        for (int j = 0; j < CT; ++j)
          if (CT * cg + j < p.E) dst[CT * cg + j] = acc[i][j];
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = (atomicAdd(p.tickets + rb, 1) == S - 1);
    __syncthreads();
    if (!s_last) return;
    if (tid == 0) p.tickets[rb] = 0;   // consumed: ready for the next launch
    __threadfence();
    stage_tables();
    for (int i = tid; i < p.TR * p.E; i += THREADS) {
      const int r = i / p.E, e = i - r * p.E;
      const int row = r0 + r;
      float v = 0.0f;
      if (row < p.T) {
        const float* src = p.part + static_cast<int64_t>(row) * p.E + e;
#pragma unroll 8
        for (int k = 0; k < S; ++k)
          v += __ldcg(src + static_cast<int64_t>(k) * p.T * p.E);
      }
      lg[r * p.EP + e] = v;
    }
  }
  for (int i = tid; i < p.EP; i += THREADS) cnt[i] = 0;
  cp_async_wait<0>();
  __syncthreads();

  // ---- epilogue: a warp a row
  for (int r = warp; r < p.TR; r += WARPS) {
    const int row = r0 + r;
    float* lrow = lg + r * p.EP;
    if (row >= p.T) {   // no row: p counts 0 in the mean
      for (int c = lane; c < p.E; c += 32) lrow[c] = 0.0f;
      continue;
    }
    float v[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < p.E ? lrow[c] : -CUDART_INF_F;
    }
    softmax_row<J>(v, p.E, lane);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      if (c < p.E) lrow[c] = v[j];
    }
    if (p.probs != nullptr) {
      float* prow = p.probs + static_cast<int64_t>(row) * p.E;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < p.E) prow[c] = v[j];
      }
    }
    float my_w, total;
    int my_i;
    top_k<J>(v, p.K, lane, my_w, my_i, total);
    if (lane < p.K) {
      const bool valid = p.row_valid == nullptr || p.row_valid[row];
      const int64_t o = static_cast<int64_t>(row) * p.K + lane;
      p.weights[o] = valid ? my_w / fmaxf(total, 1e-9f) : 0.0f;
      p.idx[o] = my_i;
      p.slots[o] = select_slot(tab, p.R, static_cast<int>(o), my_i, seed);
      if (valid) atomicAdd(cnt + my_i, 1);
    }
  }
  __syncthreads();

  // ---- this row block's counts and sum of p
  column_sums(
      min(p.TR, p.T - r0), p.E, buf,
      [&](int r, int e) { return make_float2(lg[r * p.EP + e], 0.0f); },
      [&](int e, float2 v) {
        fp[e] = v.x;
        ft[e] = static_cast<float>(cnt[e]);
      });
  if (n_rb > 1) {
    // ---- several row blocks: the last to finish sums theirs
    for (int e = tid; e < p.E; e += THREADS) {
      p.rb_prob[static_cast<int64_t>(rb) * p.E + e] = fp[e];
      p.rb_count[static_cast<int64_t>(rb) * p.E + e] = cnt[e];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = (atomicAdd(p.tickets + n_rb, 1) == n_rb - 1);
    __syncthreads();
    if (!s_last) return;
    if (tid == 0) p.tickets[n_rb] = 0;
    __threadfence();
    // the sums of p and the counts (as floats: exact integers) in one pass
    column_sums(
        n_rb, p.E, buf,
        [&](int b, int e) {
          const int64_t o = static_cast<int64_t>(b) * p.E + e;
          return make_float2(__ldcg(p.rb_prob + o),
                             static_cast<float>(__ldcg(p.rb_count + o)));
        },
        [&](int e, float2 v) {
          fp[e] = v.x;
          ft[e] = v.y;
        });
  }
  __syncthreads();
  for (int e = tid; e < p.E; e += THREADS) {
    fp[e] = fp[e] / static_cast<float>(p.T);
    p.tally[e] = ft[e];
    p.mean_prob[e] = fp[e];
  }
  __syncthreads();
  if (warp == 0) {   // aux, reduced in a fixed order; lane 0 writes
    float n = 0.0f;
    for (int e = lane; e < p.E; e += 32) n += ft[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      n += __shfl_xor_sync(0xffffffffu, n, off);
    const float den = fmaxf(n, 1.0f);
    float dot = 0.0f;
    for (int e = lane; e < p.E; e += 32) dot += (ft[e] / den) * fp[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) {
      p.tally[p.E] = 0.0f;
      *p.aux = static_cast<float>(p.E) * dot;
    }
  }
}

// The TPU kernel's function: logits (T, E) f32 -> weights, idx (T, K).
template <int J>
__global__ void __launch_bounds__(THREADS)
router_topk_kernel(const float* __restrict__ logits, float* __restrict__ w,
                   int* __restrict__ idx, int T, int E, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= T) return;
  const float* src = logits + static_cast<int64_t>(row) * E;
  float v[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < E ? src[c] : -CUDART_INF_F;
  }
  softmax_row<J>(v, E, lane);
  float my_w, total;
  int my_i;
  top_k<J>(v, K, lane, my_w, my_i, total);
  if (lane < K) {
    const int64_t o = static_cast<int64_t>(row) * K + lane;
    w[o] = my_w / fmaxf(total, 1e-9f);
    idx[o] = my_i;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The routing stage's backward to its logits, one warp a row (J columns a
// lane, as in the forward's epilogue). With frac = tally / max(sum tally, 1)
// held constant (counts have no gradient):
//   dmean = E frac daux + dmean_prob
//   on a valid row, s = sum_k p[idx_k] and
//     dp[idx_k] = (dw_k - sum_j dw_j w_j) / s   (the renormalisation)
//   dp += dmean / T on every row (the mean runs over all T rows)
//   dlogits = p (dp - sum p dp)
// Lane k < K holds assignment k; every sum is a fixed shuffle tree, so
// reruns are bit-identical. No atomics: each row is one warp's alone.
template <int J>
__global__ void __launch_bounds__(THREADS)
route_select_bwd_kernel(const float* __restrict__ probs,
                        const int* __restrict__ idx,
                        const float* __restrict__ weights,
                        const float* __restrict__ dweights,
                        const float* __restrict__ tally,
                        const float* __restrict__ dmean_prob,
                        const float* __restrict__ daux,
                        const bool* __restrict__ row_valid,
                        float* __restrict__ dlogits, int T, int E, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= T) return;
  float n = 0.0f;
  for (int e = lane; e < E; e += 32) n += tally[e];
  const float den = fmaxf(warp_sum(n), 1.0f);
  const float da = *daux;
  const float* prow = probs + static_cast<int64_t>(row) * E;
  float pv[J], dp[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    pv[j] = c < E ? prow[c] : 0.0f;
    dp[j] = c < E ? (static_cast<float>(E) * (tally[c] / den) * da +
                     dmean_prob[c]) / static_cast<float>(T)
                  : 0.0f;
  }
  if (row_valid == nullptr || row_valid[row]) {
    float pk = 0.0f, wk = 0.0f, dwk = 0.0f;
    int ik = 0;
    if (lane < K) {
      const int64_t o = static_cast<int64_t>(row) * K + lane;
      ik = idx[o];
      wk = weights[o];
      dwk = dweights[o];
      pk = prow[ik];
    }
    const float s = warp_sum(pk);
    const float inner = warp_sum(dwk * wk);
    const float gk = lane < K ? (dwk - inner) / s : 0.0f;
    for (int k = 0; k < K; ++k) {
      const int ek = __shfl_sync(0xffffffffu, ik, k);
      const float g = __shfl_sync(0xffffffffu, gk, k);
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j == ek) dp[j] += g;
    }
  }
  float dot = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) dot += pv[j] * dp[j];
  dot = warp_sum(dot);
  float* drow = dlogits + static_cast<int64_t>(row) * E;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    if (c < E) drow[c] = pv[j] * (dp[j] - dot);
  }
}

template <int J>
cudaError_t launch_route(const Params& p, int S, int n_rb, size_t smem,
                         cudaStream_t stream) {
  static bool ready = false;   // past 48 KB a block must ask, once
  if (smem > 48 * 1024 && !ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        route_select_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  route_select_kernel<J><<<dim3(S, n_rb), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

int cols_per_lane(int E) {   // J of the epilogue
  if (E <= 64) return 2;
  if (E <= 128) return 4;
  if (E <= 256) return 8;
  return 32;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" {

// One launch, its arguments packed in a host array of 23 int64 (read
// before this returns, so the caller may reuse it at once), in order:
//   x (T, D) bf16, w (D, E) f32, slots_of (E, R) int32, n_copies (E,) int32,
//   copy_cdf (E, R) f32, seed () int32, row_valid (T,) bool or 0,
//   packed (3, T, K) int32: weights (as f32), idx, slots,
//   stats (2 E + 2,) f32: tally (E + 1), mean_prob (E), aux,
//   scratch: int32 words, partial logits (S T E, S > 1), then per row block
//     sums of p and counts (n_rb E each, n_rb > 1),
//   tickets (n_rb + 1,) int32, zero on entry and on return,
//   the stream, T, D, E, K, R,
//   TR rows a block (a multiple of 4, TR / 4 * ceil(E / 4) <= 256),
//   DC-deep chunks (a multiple of 8), cps chunks a split, S splits
//   (S cps DC >= D),
//   probs (T, E) f32 or 0 (written for the backward when given),
//   weights (T, K) f32 or 0 (0: the first plane of packed).
// All tensors contiguous, on the current device.
int route_select_bf16(const int64_t* args) {
  const auto ptr = [&](int i) { return reinterpret_cast<void*>(args[i]); };
  const int T = static_cast<int>(args[12]), D = static_cast<int>(args[13]);
  const int E = static_cast<int>(args[14]), K = static_cast<int>(args[15]);
  const int R = static_cast<int>(args[16]), TR = static_cast<int>(args[17]);
  const int DC = static_cast<int>(args[18]), cps = static_cast<int>(args[19]);
  const int S = static_cast<int>(args[20]);
  const int ncg = (E + CT - 1) / CT;
  if (T <= 0 || D <= 0 || E <= 0 || E > 1024 || K <= 0 || K > E || K > 32 ||
      R <= 0 || TR <= 0 || TR % RT != 0 || (TR / RT) * ncg > THREADS ||
      DC <= 0 || DC % 8 != 0 || cps <= 0 || S <= 0 ||
      static_cast<int64_t>(S) * cps * DC < D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_rb = (T + TR - 1) / TR;
  if (n_rb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(ptr(0));
  p.w = static_cast<const float*>(ptr(1));
  p.slots_of = static_cast<const int*>(ptr(2));
  p.n_copies = static_cast<const int*>(ptr(3));
  p.cdf = static_cast<const float*>(ptr(4));
  p.seed = static_cast<const int*>(ptr(5));
  p.row_valid = static_cast<const bool*>(ptr(6));
  int* packed = static_cast<int*>(ptr(7));
  p.weights = args[22] != 0 ? static_cast<float*>(ptr(22))
                            : reinterpret_cast<float*>(packed);
  p.probs = static_cast<float*>(ptr(21));
  p.idx = packed + static_cast<int64_t>(T) * K;
  p.slots = packed + 2 * static_cast<int64_t>(T) * K;
  p.tally = static_cast<float*>(ptr(8));
  p.mean_prob = p.tally + E + 1;
  p.aux = p.tally + 2 * E + 1;
  const int64_t n_part = S > 1 ? static_cast<int64_t>(S) * T * E : 0;
  p.part = static_cast<float*>(ptr(9));
  p.rb_prob = p.part + n_part;
  p.rb_count = reinterpret_cast<int*>(p.rb_prob + (n_rb > 1 ? n_rb * E : 0));
  p.tickets = static_cast<int*>(ptr(10));
  p.T = T;
  p.D = D;
  p.E = E;
  p.K = K;
  p.R = R;
  p.TR = TR;
  p.DC = DC;
  p.cps = cps;
  p.EP = ncg * CT;
  p.vec = (D % 8 == 0 && E % 4 == 0 && aligned16(p.x) && aligned16(p.w)) ? 1
                                                                         : 0;
  const size_t stage = 2 * (static_cast<size_t>(TR) * (DC + XPAD) * 2 +
                            static_cast<size_t>(DC) * p.EP * 4);
  const size_t epi = (static_cast<size_t>(TR) * p.EP + 3 * p.EP +
                      2 * THREADS + static_cast<size_t>(E) * (2 * R + 1)) * 4;
  const size_t smem = stage > epi ? stage : epi;
  if (smem > static_cast<size_t>(MAX_SMEM))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(ptr(11));
  cudaError_t err;
  switch (cols_per_lane(E)) {
    case 2:
      err = launch_route<2>(p, S, n_rb, smem, s);
      break;
    case 4:
      err = launch_route<4>(p, S, n_rb, smem, s);
      break;
    case 8:
      err = launch_route<8>(p, S, n_rb, smem, s);
      break;
    default:
      err = launch_route<32>(p, S, n_rb, smem, s);
  }
  return static_cast<int>(err);
}

// logits (T, E) f32 -> weights (T, K) f32 and idx (T, K) int32; one warp a
// row, 8 rows a block.
int router_topk_f32(const void* logits, void* weights, void* idx, int T,
                    int E, int K, void* stream) {
  if (T <= 0 || E <= 0 || E > 1024 || K <= 0 || K > E || K > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(logits);
  float* w = static_cast<float*>(weights);
  int* i = static_cast<int*>(idx);
  const dim3 grid((T + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols_per_lane(E)) {
    case 2:
      router_topk_kernel<2><<<grid, THREADS, 0, s>>>(l, w, i, T, E, K);
      break;
    case 4:
      router_topk_kernel<4><<<grid, THREADS, 0, s>>>(l, w, i, T, E, K);
      break;
    case 8:
      router_topk_kernel<8><<<grid, THREADS, 0, s>>>(l, w, i, T, E, K);
      break;
    default:
      router_topk_kernel<32><<<grid, THREADS, 0, s>>>(l, w, i, T, E, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// The routing stage's backward to its logits (route_select_bwd_kernel):
// probs (T, E), weights and dweights (T, K) f32, idx (T, K) int32, tally
// (E,) f32 counts, dmean_prob (E,) f32, daux () f32, row_valid (T,) bool or null
// -> dlogits (T, E) f32. One warp a row, 8 rows a block.
int route_select_bwd_f32(const void* probs, const void* idx,
                         const void* weights, const void* dweights,
                         const void* tally, const void* dmean_prob,
                         const void* daux, const void* row_valid,
                         void* dlogits, int T, int E, int K, void* stream) {
  if (T <= 0 || E <= 0 || E > 1024 || K <= 0 || K > E || K > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pr = static_cast<const float*>(probs);
  const auto* ix = static_cast<const int*>(idx);
  const auto* w = static_cast<const float*>(weights);
  const auto* dw = static_cast<const float*>(dweights);
  const auto* tl = static_cast<const float*>(tally);
  const auto* dm = static_cast<const float*>(dmean_prob);
  const auto* dx = static_cast<const float*>(daux);
  const auto* rv = static_cast<const bool*>(row_valid);
  auto* dl = static_cast<float*>(dlogits);
  const dim3 grid((T + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols_per_lane(E)) {
    case 2:
      route_select_bwd_kernel<2><<<grid, THREADS, 0, s>>>(
          pr, ix, w, dw, tl, dm, dx, rv, dl, T, E, K);
      break;
    case 4:
      route_select_bwd_kernel<4><<<grid, THREADS, 0, s>>>(
          pr, ix, w, dw, tl, dm, dx, rv, dl, T, E, K);
      break;
    case 8:
      route_select_bwd_kernel<8><<<grid, THREADS, 0, s>>>(
          pr, ix, w, dw, tl, dm, dx, rv, dl, T, E, K);
      break;
    default:
      route_select_bwd_kernel<32><<<grid, THREADS, 0, s>>>(
          pr, ix, w, dw, tl, dm, dx, rv, dl, T, E, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
