// The fused NRMS encoder tail, shared by its forward (fused_tail_fwd.cu,
// row 13) and backward (fused_tail_bwd.cu, row 14): exp-MHSA over a biased
// fused [q|k|v] row -> dropout -> additive attention pooling, with the
// row's f32 context kept in shared memory.
//
// Contract (the TPU kernels' of newsrecommendation_tpu/ops/pallas/
// experimental_fused_encoder.py, _fwd_kernel / _bwd_kernel):
//   qkv  (N, T, 3*H*D) with the bias already added, in the input dtype T;
//        head h's q/k/v at lanes h*D, H*D + h*D, 2*H*D + h*D
//   mask (N, T) f32 over keys or null: it multiplies after the exp in the
//        attention scores and in the pooling scores
//   w1 (HD, Q) and w2 (Q, 1) in the input dtype; b1 (1, Q), b2 (1, 1) f32
//   seed (1,) int32 on the device, read by every block (no host sync)
// Per row:
//   ctx_h  = a_h (rounded to v's dtype) v_h, f32 sums, a_h as row 1's
//            forward computes it (qkv_fwd.cuh); the heads' contexts side
//            by side in f32, NOT rounded
//   ctx   *= keep * 1/(1 - rate) with keep = hash(global flat index
//            (row*T + t)*HD + c, seed) >= rate * 2^32 (uint32 arithmetic,
//            the JAX package's _keep_mask bit for bit), when dropout is on
//   e      = tanh(round(ctx) w1 + b1)    ctx rounded to w1's dtype, f32 sums
//   s_t    = round(e_t) . w2 + b2        e rounded to w2's dtype, f32 sums
//   alpha  = exp(s - m) * mask / (sum + 1e-8 exp(-m)), m over all T
//   out    = sum_t alpha_t ctx_t         the f32 ctx; out rounded to T
//
// Design: one block per row. The heads run one after another, each head's
// q, k, v staged in shared memory (odd row stride) and one warp per query;
// the row's f32 context (T x HD), the pooling's e (T x Q) and the scores
// stay in shared memory. The pooling's products with w1 (T x HD by HD x Q,
// and the backward's d_z w1^T) run as register tiles of 4 x 4 f32 FMAs
// per thread on the CUDA cores, w1 read from global memory (L2/L1
// resident: 160 KB in bf16). A row needs (T*HD + T*Q + 3*T*(D|1) + ...)
// * 4 bytes of shared memory: at H = D = 20, Q = 200 that fits up to
// T = 86 in the forward and T = 85 in the backward.
//
// Longer rows (the user encoder over a long history) run the same phases
// with the big buffers in global memory: the forward keeps ctx, e and the
// staged q, k, v in a per-slot scratch of T*(HD + Q + 3*(D|1)) floats, the
// backward keeps ctx and d_z in the scratch it writes anyway for dw1 and
// q, k, v in a per-slot scratch of 3*T*(D|1) floats. A grid of `slots`
// blocks walks the rows, so the scratch is bounded by the slots, not by N.
// The row buffers and the small vectors stay in shared memory up to
// T = 6456 in the forward and 5771 in the backward at those widths; past
// that they move into the slot too (the *_small_global functions), so any
// T runs. Which variant runs is decided by T before the launch (the
// *_global functions below); the wrapper allocates the scratch.
#pragma once

#include "common.cuh"
#include "qkv_bwd.cuh"  // recompute_a_row: row 1's probs row, one warp

namespace nrk {

constexpr int kTile = 4;  // register tile of the products, kTile x kTile

// The SplitMix32-style mix of the JAX package's _keep_mask.
__device__ __forceinline__ uint32_t tail_hash(uint32_t idx, uint32_t seed) {
  uint32_t x = idx + seed * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Dropout state of one launch; `on` false leaves the context as it is.
struct TailDropout {
  bool on;
  uint32_t seed, thr;
  float scale;  // f32(1 / (1 - rate))

  // keep * scale of element (row, t, c) of the (N, T, HD) context
  __device__ __forceinline__ float keep(int64_t row, int t, int c, int t_len,
                                        int hd) const {
    const uint32_t idx = (uint32_t)row * (uint32_t)(t_len * hd) +
                         (uint32_t)t * (uint32_t)hd + (uint32_t)c;
    return tail_hash(idx, seed) >= thr ? scale : 0.f;
  }
};

// C(m, n) for m < M, n < N from sum_k A(m, k) B(k, n), f32 FMAs in k
// order, by the block's kThreads threads. Each thread takes tiles of
// kTile rows (m0..m0+3) by kTile columns strided by the column-tile count
// (n0, n0 + nt, ...), so neighbouring threads read neighbouring columns.
// Every (m, n) is computed by the same thread on every call with the same
// sizes, so a caller may accumulate into C across calls without a race.
template <int kThreads, typename LoadA, typename LoadB, typename Store>
__device__ __forceinline__ void tile_product(int M, int N, int K, LoadA la,
                                             LoadB lb, Store st) {
  const int mt = (M + kTile - 1) / kTile;
  const int nt = (N + kTile - 1) / kTile;
  for (int item = threadIdx.x; item < mt * nt; item += kThreads) {
    const int m0 = (item / nt) * kTile;
    const int n0 = item % nt;
    int mi[kTile], ni[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      mi[r] = min(m0 + r, M - 1);
      ni[r] = min(n0 + r * nt, N - 1);
    }
    float acc[kTile][kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[r][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float a[kTile], b[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) a[r] = la(mi[r], k);
#pragma unroll
      for (int j = 0; j < kTile; ++j) b[j] = lb(k, ni[j]);
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        if (m0 + r < M && n0 + j * nt < N) st(m0 + r, n0 + j * nt, acc[r][j]);
  }
}

// Stage head h's q, k, v of one row (src: the row's (T, 3HD) block) as f32
// into three (T, stride) buffers from `qs` on.
template <typename T, int kThreads>
__device__ __forceinline__ void stage_head(float* qs, const T* src, int h,
                                           int t_len, int d_head, int hd,
                                           int stride) {
  const int per_part = t_len * d_head;
  for (int idx = threadIdx.x; idx < 3 * per_part; idx += kThreads) {
    const int part = idx / per_part;
    const int rem = idx - part * per_part;
    const int t = rem / d_head;
    const int d = rem - t * d_head;
    qs[(part * t_len + t) * stride + d] =
        to_f32(src[(int64_t)t * 3 * hd + part * hd + h * d_head + d]);
  }
}

// The row's f32 context after dropout into ctx (T, HD), head by head. qs:
// 3 * T * stride floats; rows: one T-float buffer per warp. Starts and ends
// with every thread's shared writes visible (a __syncthreads on each side).
template <typename T, int kThreads>
__device__ void tail_context(float* ctx, float* qs, float* rows, const T* src,
                             const float* mrow, int64_t row, int n_heads,
                             int t_len, int d_head, int stride, float inv,
                             const TailDropout& drop) {
  constexpr int kWarps = kThreads / 32;
  const int hd = n_heads * d_head;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* k = qs + t_len * stride;
  const float* v = k + t_len * stride;
  float* p = rows + warp * t_len;
  for (int h = 0; h < n_heads; ++h) {
    __syncthreads();  // the previous head's (or caller's) readers are done
    stage_head<T, kThreads>(qs, src, h, t_len, d_head, hd, stride);
    __syncthreads();
    for (int i = warp; i < t_len; i += kWarps) {
      recompute_a_row(p, qs + i * stride, k, mrow, t_len, d_head, stride, inv,
                      nullptr, nullptr, lane);
      for (int j = lane; j < t_len; j += 32) p[j] = round_to<T>(p[j]);
      __syncwarp();
      for (int d = lane; d < d_head; d += 32) {
        float acc = 0.f;
        for (int j = 0; j < t_len; ++j)
          acc = fmaf(p[j], v[j * stride + d], acc);
        const int c = h * d_head + d;
        if (drop.on) acc *= drop.keep(row, i, c, t_len, hd);
        ctx[i * hd + c] = acc;
      }
      __syncwarp();  // the next query overwrites p
    }
  }
  __syncthreads();
}

// The pooling's scores: e (T, Q) = tanh(round(ctx) w1 + b1), then alpha (T)
// from s = round(e) w2 + b2 over the key mask; unless it is null, *rest
// gets 1 - sum(alpha) as the exact expression gives it, 1e-8 exp(-m) / den
// (0 on a fully masked row). Ends with a __syncthreads.
template <typename T, int kThreads>
__device__ void tail_pool_scores(float* e, float* alpha, const float* ctx,
                                 const T* __restrict__ w1,
                                 const float* __restrict__ b1,
                                 const T* __restrict__ w2,
                                 const float* __restrict__ b2,
                                 const float* mrow, int t_len, int hd,
                                 int q_dim, float* rest = nullptr) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  tile_product<kThreads>(
      t_len, q_dim, hd,
      [&](int i, int c) { return round_to<T>(ctx[i * hd + c]); },
      [&](int c, int q) { return to_f32(w1[(int64_t)c * q_dim + q]); },
      [&](int i, int q, float z) { e[i * q_dim + q] = tanhf(z + b1[q]); });
  __syncthreads();
  for (int i = warp; i < t_len; i += kWarps) {
    float part = 0.f;
    for (int q = lane; q < q_dim; q += 32)
      part = fmaf(round_to<T>(e[i * q_dim + q]), to_f32(w2[q]), part);
    const float s = warp_sum(part) + b2[0];
    if (lane == 0) alpha[i] = s;
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
    for (int i = lane; i < t_len; i += 32) mx = fmaxf(mx, alpha[i]);
    const float m = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < t_len; i += 32) {
      float x = expf(alpha[i] - m);
      if (mrow) x *= mrow[i];
      alpha[i] = x;
      sum += x;
    }
    const float den = warp_sum(sum) + kEps * expf(-m);
    for (int i = lane; i < t_len; i += 32)
      alpha[i] = den > 0.f ? alpha[i] / den : 0.f;
    if (rest && lane == 0) *rest = den > 0.f ? kEps * expf(-m) / den : 0.f;
  }
  __syncthreads();
}

// The big buffers of a row (ctx, e, q/k/v), in floats, and the forward's
// small ones (one row per warp, alpha).
__host__ __device__ inline size_t tail_big_floats(int t_len,
                                                      int n_heads,
                                                      int d_head, int q_dim) {
  const size_t t = t_len;
  return t * n_heads * d_head + t * q_dim + 3 * t * (d_head | 1);
}

__host__ __device__ inline size_t tail_fwd_small_floats(int t_len,
                                                        int warps) {
  return (size_t)(warps + 1) * t_len;
}

// whether the forward keeps its big buffers in global memory
inline bool tail_fwd_global(int t_len, int n_heads, int d_head, int q_dim,
                            int warps) {
  return tail_big_floats(t_len, n_heads, d_head, q_dim) +
             tail_fwd_small_floats(t_len, warps) >
         (size_t)kMaxSmemFloats;
}

// The backward's per-row block: big buffers as the forward's (ctx, e then
// d_z, the q/k/v of a head); small ones one row per warp, alpha, d_alpha,
// g and 1 - sum(alpha).
__host__ __device__ inline size_t tail_bwd_small_floats(int t_len,
                                                        int n_heads,
                                                        int d_head,
                                                        int warps) {
  return (size_t)(warps + 2) * t_len + (size_t)n_heads * d_head + 1;
}

inline bool tail_bwd_global(int t_len, int n_heads, int d_head, int q_dim,
                            int warps) {
  return tail_big_floats(t_len, n_heads, d_head, q_dim) +
             tail_bwd_small_floats(t_len, n_heads, d_head, warps) >
         (size_t)kMaxSmemFloats;
}

// Past these (T > 6456 in the forward, T > 5771 in the backward at the
// NRMS width) the small buffers too move to the row's global slot.
inline bool tail_fwd_small_global(int t_len, int warps) {
  return tail_fwd_small_floats(t_len, warps) > (size_t)kMaxSmemFloats;
}

inline bool tail_bwd_small_global(int t_len, int n_heads, int d_head,
                                  int warps) {
  return tail_bwd_small_floats(t_len, n_heads, d_head, warps) >
         (size_t)kMaxSmemFloats;
}

}  // namespace nrk
