// The fused NRMS encoder tail, shared by its forward (fused_tail_fwd.cu,
// row 13) and backward (fused_tail_bwd.cu, row 14): exp-MHSA over a biased
// fused [q|k|v] row -> dropout -> additive attention pooling, with the
// row's f32 context kept in shared memory in the resident regime.
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
// Design, by regime (tail_regime; the plan is ops/experimental_fused_
// encoder.py:tail_launch_plan):
//   resident (T <= 64, heads of up to 64): items of batch rows walked as
//     row 15's sub-items, its attention pass reused; fc1 in k order on
//     CUDA cores, the backward's d_z w1^T on tensor cores in bf16. The
//     section "the resident regime" below.
//   tiled (past it while a head's K, V and 16 queries' probs fit a block:
//     T up to 1024 at D = 20): the work of a row spread over many blocks,
//     each phase its own launch with the f32 context, the scores and the
//     pooling's row vectors in global scratch. The last section of this
//     file.
//   global (heads wider than 64, or rows longer than the tiled regime
//     takes): one block per row, below. The heads run one after another,
//     each head's q, k, v staged (odd row stride) and one warp per query,
//     into the row's f32 context (T x HD) and the pooling's e (T x Q). The
//     pooling's products with w1 (T x HD by HD x Q, and the backward's
//     d_z w1^T) run as register tiles of 4 x 4 f32 FMAs per thread on the
//     CUDA cores, w1 read from global memory (L2/L1 resident: 160 KB in
//     bf16).
//
// The big buffers of the global regime live in global memory: the forward
// keeps ctx, e and the staged q, k, v in a per-slot scratch of
// T*(HD + Q + 3*(D|1)) floats, the backward keeps ctx and d_z in the
// scratch it writes anyway for dw1 and q, k, v in a per-slot scratch of
// 3*T*(D|1) floats. A grid of `slots` blocks walks the rows, so the
// scratch is bounded by the slots, not by N. The row buffers and the small
// vectors stay in shared memory up to T = 6456 in the forward and 5771 in
// the backward at those widths; past that they move into the slot too
// (the *_small_global functions), so any T runs. The wrapper allocates the
// scratch.
//
// Every regime computes each element with the per-row kernels' arithmetic
// (the same f32 FMA chains, in the same order, rounded at the same
// points), so the tiled regime gives their bits in both dtypes.
#pragma once

#include "blanes_resident.cuh"  // row 15's resident design, row 16's kernel
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

// s_m = round(e_m) . w2 + b2 for the m_rows rows of e (es elements apart,
// in T or f32), one warp a row: each lane's q in order, then the xor tree.
template <typename T, int kThreads, typename E>
__device__ __forceinline__ void tail_scores(float* s, const E* e, int es,
                                            int m_rows, int q_dim,
                                            const T* __restrict__ w2,
                                            const float* __restrict__ b2) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < m_rows; i += kThreads / 32) {
    float part = 0.f;
    for (int q = lane; q < q_dim; q += 32)
      part = fmaf(round_to<T>(to_f32(e[i * es + q])), to_f32(w2[q]), part);
    const float v = warp_sum(part) + b2[0];
    if (lane == 0) s[i] = v;
  }
}

// One warp: alpha (T) in place from the scores over the key mask, the max
// over all T; unless it is null, *rest gets 1 - sum(alpha) as the exact
// expression gives it, 1e-8 exp(-m) / den (0 on a fully masked row).
__device__ __forceinline__ void tail_alpha(float* alpha, const float* mrow,
                                           int t_len, int lane, float* rest) {
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
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  tile_product<kThreads>(
      t_len, q_dim, hd,
      [&](int i, int c) { return round_to<T>(ctx[i * hd + c]); },
      [&](int c, int q) { return to_f32(w1[(int64_t)c * q_dim + q]); },
      [&](int i, int q, float z) { e[i * q_dim + q] = tanhf(z + b1[q]); });
  __syncthreads();
  tail_scores<T, kThreads>(alpha, e, q_dim, t_len, q_dim, w2, b2);
  __syncthreads();
  if (warp == 0) tail_alpha(alpha, mrow, t_len, lane, rest);
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

// The backward's per-row block: big buffers as the forward's (ctx, e then
// d_z, the q/k/v of a head); small ones one row per warp, alpha, d_alpha,
// g and 1 - sum(alpha).
__host__ __device__ inline size_t tail_bwd_small_floats(int t_len,
                                                        int n_heads,
                                                        int d_head,
                                                        int warps) {
  return (size_t)(warps + 2) * t_len + (size_t)n_heads * d_head + 1;
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


// ---- the resident regime: T <= 64, heads of up to 64 -----------------------
//
// An item is one batch row, walked as sub-items of up to four heads: row
// 15's items (blanes_resident.cuh: its Params, staging and per-(head,
// query) pass, short_context), every sub-item of a row on one block in
// turn, the next one's q, k, v copied in by cp.async while the current one
// computes. Each sub-item's context times keep goes into the row's f32
// ctx; after its last sub-item the pooling runs over the row's T
// positions: fc1 in k order on CUDA cores in both dtypes (tail_fma: the
// per-row kernels' sums, so e rounds where the plain version's k-order
// sums round it; on tensor cores it rounded apart often enough to put
// dqkv outside the bf16 tolerance, PERF.md); then the scores, alpha and
// out (forward), or the pooling backward and d_ctx (backward: round(d_z)
// w1^T on tensor cores in bf16, in k order in f32). Items of two rows,
// which read w1 half as often, were slower: their shared memory halves
// the blocks an SM holds (PERF.md).
//
// Shared memory, in order: the stage buffers (nbuf of row 15's), row 15's
// f32 arrays (K's copy in bf16, round(a)) sharing their bytes with e (T
// rows, es a row: in T in the forward, whose scores read round(e) only;
// f32 in the backward, e then d_z), ctx (T rows, cs floats a row), then
// alpha (T) and, in the backward, d_alpha (T), g (HD) and 1 - sum(alpha).

enum TailRegime { kTailResident = 0, kTailGlobal = 1, kTailTiled = 2 };

// Row strides of ctx and e: whole 32-element rows, then 16 more, so the
// fragments' 16-byte loads of two rows (16 mod 32 words apart) hit every
// bank once per quarter warp.
__host__ __device__ inline int tail_cs(int hd) {
  return (hd + 31) / 32 * 32 + 16;
}
__host__ __device__ inline int tail_es(int q) {
  return (q + 31) / 32 * 32 + 16;
}

inline size_t tail_round16(size_t x) { return (x + 15) / 16 * 16; }

struct TailRes {
  int subs;                  // sub-items of a row: its head groups
  int q, cs, es;             // Q, and the row strides of ctx and e
  size_t e_off, ctx_off, small_off, bytes;
};

// The resident layout of the forward (bwd 0) or backward (bwd 1) under
// the plan (heads, nbuf).
inline TailRes tail_res(int bwd, int t_len, int n_heads, int d_head,
                        int q_dim, int esize, int heads, int nbuf) {
  const bl::Layout lay =
      bl::layout_of(bl::kFwd, t_len, d_head, esize, heads, t_len);
  TailRes r;
  const int hd = n_heads * d_head;
  r.subs = (n_heads + heads - 1) / heads;
  r.q = q_dim;
  r.cs = tail_cs(hd);
  r.es = tail_es(q_dim);
  const size_t e_bytes = (size_t)t_len * r.es * (bwd ? 4 : esize);
  const size_t small = bwd ? 2 * (size_t)t_len + hd + 1 : t_len;
  r.e_off = nbuf * lay.stage;
  r.ctx_off = r.e_off + tail_round16(lay.rows > e_bytes ? lay.rows : e_bytes);
  r.small_off = r.ctx_off + (size_t)t_len * r.cs * 4;
  r.bytes = r.small_off + tail_round16(4 * small);
  return r;
}

// The tiled regime's layout (its kernels: the last section of this file).
// An attention block takes one (row, head): that head's K^T (D rows of
// ks floats, keys zero-padded to kw, a whole number of 64-key blocks) and
// V (t4 rows of vs floats, T rounded up to 4) stay in shared memory while
// the row's queries go by in sub-tiles of m, each with its Q^T (D rows of
// m), its scores then probs (m rows of ps floats, ps 4 mod 32 so that the
// PV loads of eight rows hit 32 banks) and its rows' maxima per 64-key
// block. m is 64, 32 or 16: the largest that fits.
// 32 warps: at m = 64 one score tile and two rows of probs each
constexpr int kTileThreads = 1024;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileMaxHead = 64;
// positions of a pooling block: at H*D = 400, Q = 200 fc1's 4 x 4 tiles
// over 40 rows are 500, two rounds of a block's 256 threads
constexpr int kPoolRows = 40;
constexpr int kOutCols = 128;   // pooled columns of an output block
constexpr int kPvRows = 2;      // queries of a thread's p V tile, 32 apart

struct TileLay {
  int m, t4, kw, ks, vs, ps;
  size_t v_off, q_off, p_off, x_off, bytes;  // floats from the start; bytes
};

__host__ __device__ inline TileLay tile_lay(int t_len, int d_head, int m) {
  TileLay l;
  l.m = m;
  l.t4 = (t_len + 3) / 4 * 4;
  l.kw = (l.t4 + 63) / 64 * 64;
  l.ks = l.kw + 4;
  l.vs = (d_head + 3) / 4 * 4;
  l.ps = l.kw + 4;
  l.v_off = (size_t)d_head * l.ks;
  l.q_off = l.v_off + (size_t)l.t4 * l.vs;
  l.p_off = l.q_off + (size_t)d_head * m;
  l.x_off = l.p_off + (size_t)m * l.ps;
  l.bytes = 4 * (l.x_off + (size_t)(l.kw / 64) * m);
  return l;
}

// The sub-tile of the tiled attention at (T, D): the largest of 64, 32, 16
// whose block fits; 0 where none does.
inline int tail_tile_m(int t_len, int d_head) {
  for (int m = 64; m >= 16; m /= 2)
    if (tile_lay(t_len, d_head, m).bytes <= (size_t)bl::kMaxSmem) return m;
  return 0;
}

// Shared bytes of a pooling block: kPoolRows rows of the f32 context and
// of e (the backward's d_ctx block takes less: d_z's rows and alpha).
inline size_t tail_pool_bytes(int hd, int q_dim) {
  return 4 * (size_t)kPoolRows * (tail_cs(hd) + tail_es(q_dim));
}

inline bool tail_tiled_fits(int t_len, int n_heads, int d_head, int q_dim) {
  return d_head <= kTileMaxHead && tail_tile_m(t_len, d_head) > 0 &&
         tail_pool_bytes(n_heads * d_head, q_dim) <= (size_t)bl::kMaxSmem;
}

// The regime of the forward (bwd 0) or backward (bwd 1) at (T, H, D, Q) in
// a dtype of esize bytes: resident where T <= 64, D <= 64 and one row with
// one head and one buffer fit a block; else tiled where its blocks fit;
// else global, the per-row kernel with its working set in global memory.
inline int tail_regime(int bwd, int t_len, int n_heads, int d_head, int q_dim,
                       int esize) {
  if (t_len <= bl::kShortT && d_head <= 64 &&
      tail_res(bwd, t_len, n_heads, d_head, q_dim, esize, 1, 1).bytes <=
          (size_t)bl::kMaxSmem)
    return kTailResident;
  if (tail_tiled_fits(t_len, n_heads, d_head, q_dim)) return kTailTiled;
  return kTailGlobal;
}

// Whether (heads, nbuf, blocks) is a resident plan the kernels take.
inline bool tail_res_ok(const TailRes& r, int n_heads, int heads, int nbuf,
                        int blocks) {
  return heads >= 1 && heads <= 4 && heads <= n_heads && nbuf >= 1 &&
         nbuf <= 2 && blocks >= 1 && r.bytes <= (size_t)bl::kMaxSmem;
}

// Four elements of a row rounded to T and back (bf16: two packed
// conversions, round_to's bits).
template <typename T>
__device__ __forceinline__ float4 tail_round4(float4 x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const float2 lo = __bfloat1622float2(__floats2bfloat162_rn(x.x, x.y));
    const float2 hi = __bfloat1622float2(__floats2bfloat162_rn(x.z, x.w));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  } else {
    return x;
  }
}

// Four elements n .. n + 3 of one row of B in T, as loaded: one 8-byte
// (bf16) or 16-byte (f32) load where vec, else each column clamped to
// N - 1; tail_b4_unpack gives them as f32.
template <typename T>
struct TailQuad {
  using type = float4;
};
template <>
struct TailQuad<__nv_bfloat16> {
  using type = uint2;
};

template <typename T>
__device__ __forceinline__ typename TailQuad<T>::type tail_b4_load(
    const T* __restrict__ row, int n, int n_len, bool vec) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (vec) return __ldg(reinterpret_cast<const uint2*>(row + n));
    const auto* u = reinterpret_cast<const unsigned short*>(row);
    unsigned x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __ldg(u + min(n + j, n_len - 1));
    return make_uint2(x[0] | x[1] << 16, x[2] | x[3] << 16);
  } else {
    if (vec) return __ldg(reinterpret_cast<const float4*>(row + n));
    return make_float4(__ldg(row + min(n, n_len - 1)),
                       __ldg(row + min(n + 1, n_len - 1)),
                       __ldg(row + min(n + 2, n_len - 1)),
                       __ldg(row + min(n + 3, n_len - 1)));
  }
}

__device__ __forceinline__ void tail_b4_unpack(uint2 x, float* v) {
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void tail_b4_unpack(float4 x, float* v) {
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// C = round(A) B in k order on CUDA cores: A (M x K) f32 in shared memory,
// rows lda floats apart (lda a multiple of 4, rows 16-byte aligned),
// rounded to AR as it loads (float: as it is); B (K x N) in T in global
// memory, rows ldb elements apart. A thread takes 4 rows by 4
// neighbouring columns, so A loads as one float4 a row and 4 k, B as one
// vector a row of B, and each element serves 4 FMAs; B's next 4 rows are
// loaded while the current 4 are summed (faster than loading them as they
// are used; 4 x 8 tiles and A two k at a time were not: PERF.md). Every
// C(m, n) is one f32 FMA chain over k from 0, tile_product's: the per-row
// kernels' sums, so f32 keeps their bits. epi(m, n, c) for m < M, n < N.
template <typename AR, typename T, typename Epi>
__device__ __forceinline__ void tail_fma(int m_len, int n_len, int k_len,
                                         const float* a, int lda,
                                         const T* __restrict__ b, int ldb,
                                         Epi epi) {
  using Quad = typename TailQuad<T>::type;
  const int ng = (n_len + 3) / 4;
  const int tiles = (m_len + 3) / 4 * ng;
  const bool vec = n_len % 4 == 0 && ldb % 4 == 0 &&
                   (uintptr_t)b % (4 * sizeof(T)) == 0;
  const int k4 = k_len / 4 * 4;
  for (int tile = threadIdx.x; tile < tiles; tile += bl::kThreads) {
    const int m0 = tile / ng * 4;
    const int n0 = tile % ng * 4;
    const float* ar[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) ar[r] = a + min(m0 + r, m_len - 1) * lda;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    Quad bn[4];
    if (k4 > 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        bn[kk] = tail_b4_load(b + (int64_t)kk * ldb, n0, n_len, vec);
    }
    for (int k = 0; k < k4; k += 4) {
      Quad bc[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) bc[kk] = bn[kk];
      if (k + 4 < k4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          bn[kk] = tail_b4_load(b + (int64_t)(k + 4 + kk) * ldb, n0, n_len,
                                vec);
      }
      float av[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 x =
            tail_round4<AR>(*reinterpret_cast<const float4*>(ar[r] + k));
        av[r][0] = x.x;
        av[r][1] = x.y;
        av[r][2] = x.z;
        av[r][3] = x.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[4];
        tail_b4_unpack(bc[kk], bv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[r][j] = fmaf(av[r][kk], bv[j], acc[r][j]);
      }
    }
    for (int k = k4; k < k_len; ++k) {
      float bv[4];
      tail_b4_unpack(tail_b4_load(b + (int64_t)k * ldb, n0, n_len, false),
                     bv);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = round_to<AR>(ar[r][k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(x, bv[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + r < m_len && n0 + j < n_len) epi(m0 + r, n0 + j, acc[r][j]);
  }
}

// The tensor-core product below takes each k-step's 16 elements in the
// order of the fragments' k slots permuted: lane tq's slots 2tq, 2tq + 1
// hold k0 + 4tq, + 1 and its slots 2tq + 8, + 9 hold k0 + 4tq + 2, + 3, in A
// and in B alike (the same 16 products, summed by the tensor core), so each
// lane reads four neighbouring k of a row at once.

// Four f32 elements k .. k + 3 of a row (k a multiple of 4) rounded to
// bf16 and packed as two A fragment registers; 0 past K.
__device__ __forceinline__ uint2 tail_a_quad(const float* row, int k,
                                             int k_len) {
  float4 v;
  if (k + 3 < k_len) {
    v = *reinterpret_cast<const float4*>(row + k);
  } else {
    v.x = k < k_len ? row[k] : 0.f;
    v.y = k + 1 < k_len ? row[k + 1] : 0.f;
    v.z = k + 2 < k_len ? row[k + 2] : 0.f;
    v.w = k + 3 < k_len ? row[k + 3] : 0.f;
  }
  return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// Four bf16 elements k .. k + 3 of a row of B held transposed (col[k], k
// contiguous), as two B fragment registers; 0 past K.
__device__ __forceinline__ uint2 tail_b_quad(const __nv_bfloat16* col, int k,
                                             int k_len) {
  const auto* u = reinterpret_cast<const unsigned short*>(col);
  if (k + 3 < k_len && ((uintptr_t)(u + k) & 7) == 0)
    return __ldg(reinterpret_cast<const uint2*>(u + k));
  unsigned x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = k + e < k_len ? __ldg(u + k + e) : 0u;
  return make_uint2(x[0] | x[1] << 16, x[2] | x[3] << 16);
}

// C = round(A) B on tensor cores (the backward's round(d_z) w1^T in
// bf16), A (M x K) f32 rows lda floats apart
// (lda a multiple of 4), B (K x N) bf16 given as its transpose bt (N x K,
// rows ldb apart). A warp takes kMmaRows 16-row tiles by kMmaCols
// 8-column tiles of C at a time (column tiles warp, warp + 8, ...), so
// each A fragment serves kMmaCols products and each B fragment kMmaRows,
// with the next k-step's B fragments loaded from global memory (L2)
// before the current step's products. K goes in steps of 16, in order:
// each step's 16 products summed by the tensor core from 0, the steps
// added in f32 (round to nearest). Accumulating in the tensor core instead
// aligns every product to the running sum and drops its low bits, which
// put d_ctx outside the bf16 tolerance at (16, 20). epi(m, n, c0, c1) gets
// C(m, n) and C(m, n + 1); m may pass M and n + 1 may pass N.
constexpr int kMmaRows = 2;
constexpr int kMmaCols = 4;

template <typename Epi>
__device__ __forceinline__ void tail_mma(int m_len, int n_len, int k_len,
                                         const float* a, int lda,
                                         const __nv_bfloat16* bt, int ldb,
                                         Epi epi) {
  constexpr int kW = bl::kWarps;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int mt = (m_len + 15) / 16;
  const int nt = (n_len + 7) / 8;
  const int steps = (k_len + 15) / 16;
  for (int nb = warp; nb < nt; nb += kW * kMmaCols) {
    const __nv_bfloat16* col[kMmaCols];
#pragma unroll
    for (int j = 0; j < kMmaCols; ++j)
      col[j] = bt + (int64_t)min((nb + j * kW) * 8 + g, n_len - 1) * ldb;
    for (int mb = 0; mb < mt; mb += kMmaRows) {
      float c[kMmaRows][kMmaCols][4];
#pragma unroll
      for (int i = 0; i < kMmaRows; ++i)
#pragma unroll
        for (int j = 0; j < kMmaCols; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
      uint2 bnext[kMmaCols];
#pragma unroll
      for (int j = 0; j < kMmaCols; ++j)
        bnext[j] = tail_b_quad(col[j], 4 * tq, k_len);
      for (int s = 0; s < steps; ++s) {
        const int k = 16 * s + 4 * tq;
        uint2 bq[kMmaCols];
#pragma unroll
        for (int j = 0; j < kMmaCols; ++j) {
          bq[j] = bnext[j];
          bnext[j] = tail_b_quad(col[j], k + 16, k_len);
        }
#pragma unroll
        for (int i = 0; i < kMmaRows; ++i) {
          if (mb + i < mt) {
            const int m = (mb + i) * 16 + g;
            const uint2 r0 = tail_a_quad(a + min(m, m_len - 1) * lda, k,
                                         k_len);
            const uint2 r1 = tail_a_quad(a + min(m + 8, m_len - 1) * lda, k,
                                         k_len);
            const unsigned af[4] = {r0.x, r1.x, r0.y, r1.y};
#pragma unroll
            for (int j = 0; j < kMmaCols; ++j) {
              if (nb + j * kW < nt) {
                const unsigned bf[2] = {bq[j].x, bq[j].y};
                float step[4] = {0.f, 0.f, 0.f, 0.f};
                mma_bf16(step, af, bf);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  c[i][j][e] = __fadd_rn(c[i][j][e], step[e]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMmaRows; ++i)
#pragma unroll
        for (int j = 0; j < kMmaCols; ++j) {
          const int m = (mb + i) * 16 + g;
          const int n = (nb + j * kW) * 8 + 2 * tq;
          if (mb + i >= mt || nb + j * kW >= nt) continue;
          epi(m, n, c[i][j][0], c[i][j][1]);
          epi(m + 8, n, c[i][j][2], c[i][j][3]);
        }
    }
  }
}

// fc1 over the item's m_len positions: e (es a row, in E) =
// tanh(round(ctx) w1 + b1), ctx cs floats a row rounded to AR as it loads
// (float where it is rounded already), w1 (HD x Q) in k order on CUDA
// cores, the per-row kernels' arithmetic.
template <typename AR, typename T, typename E>
__device__ __forceinline__ void tail_fc1(E* e, int es, const float* ctx,
                                         int cs, int m_len, int hd, int q_dim,
                                         const T* __restrict__ w1,
                                         const float* __restrict__ b1) {
  tail_fma<AR>(m_len, q_dim, hd, ctx, cs, w1, q_dim,
               [&](int i, int q, float z) {
                 e[i * es + q] = from_f32<E>(tanhf(z + b1[q]));
               });
}

// Walks this block's rows (b, b + gridDim.x, ...), each as its sub-items
// in order: the context of each into ctx, times keep; after the last,
// pool(row), all threads.
template <typename T, int DM, typename Pool>
__device__ __forceinline__ void tail_walk(const T* __restrict__ qkv,
                                          const float* __restrict__ mask,
                                          const bl::Params& p,
                                          const TailRes& r,
                                          const TailDropout& drop,
                                          Pool pool) {
  extern __shared__ __align__(16) unsigned char tail_smem[];
  const int hd = p.h * p.d;
  float* ctx = reinterpret_cast<float*>(tail_smem + r.ctx_off);
  auto next = [&](int k) {
    if ((k + 1) % r.subs) return k + 1;
    const int64_t x = (int64_t)k + 1 + ((int64_t)gridDim.x - 1) * r.subs;
    return x < p.items ? (int)x : p.items;
  };
  auto stage = [&](int k, int b) {
    bl::stage_qkv(tail_smem, b, bl::item_of(p, k), qkv, p);
  };
  auto compute = [&](int k, int b) {
    const bl::Item it = bl::item_of(p, k);
    bl::short_context<T, DM, false, false>(
        tail_smem, b, it, nullptr, mask, nullptr, p,
        [&](int hl, int i, int d, float o00, float o01, float o10,
            float o11) {
          const int c = (it.h0 + hl) * p.d + d;
          const bool d1 = d + 1 < p.d;
          const bool i1 = i + 1 < p.t;
          if (drop.on) {
            o00 *= drop.keep(it.n, i, c, p.t, hd);
            if (d1) o01 *= drop.keep(it.n, i, c + 1, p.t, hd);
            if (i1) o10 *= drop.keep(it.n, i + 1, c, p.t, hd);
            if (i1 && d1) o11 *= drop.keep(it.n, i + 1, c + 1, p.t, hd);
          }
          float* x = ctx + i * r.cs + c;
          x[0] = o00;
          if (d1) x[1] = o01;
          if (i1) x[r.cs] = o10;
          if (i1 && d1) x[r.cs + 1] = o11;
        });
    if ((k + 1) % r.subs == 0) {
      __syncthreads();  // the row's ctx is whole; row 15's arrays are free
      pool(it.n);
    }
  };
  bl::walk_items(p, tail_smem, (int)blockIdx.x * r.subs, next, stage,
                 compute);
}

// Blocks an SM holds of the resident kernels at heads of up to 24 lanes
// (the NRMS head): their registers are held to what that many need
// (unbounded they took 103-110 at DM = 24, two blocks). bf16 runs fastest
// with three, f32 with two (PERF.md).
constexpr int kTailBlocksBf16 = 3;
constexpr int kTailBlocksF32 = 2;

template <typename T, int DM>
constexpr int tail_blocks() {
  return DM > 24 ? 1 : sizeof(T) == 2 ? kTailBlocksBf16 : kTailBlocksF32;
}

// Row 13, resident: out (N, HD) in T.
template <typename T, int DM>
__global__ void __launch_bounds__(bl::kThreads, (tail_blocks<T, DM>()))
tail_resident_fwd_kernel(const T* __restrict__ qkv,
                         const float* __restrict__ mask,
                         const T* __restrict__ w1,
                         const float* __restrict__ b1,
                         const T* __restrict__ w2,
                         const float* __restrict__ b2,
                         const int* __restrict__ seed, T* __restrict__ out,
                         bl::Params p, TailRes r, int use_dropout,
                         uint32_t thr, float scale) {
  extern __shared__ __align__(16) unsigned char tail_smem[];
  const int hd = p.h * p.d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const TailDropout drop{use_dropout != 0,
                         use_dropout ? (uint32_t)seed[0] : 0u, thr, scale};
  const float* ctx = reinterpret_cast<const float*>(tail_smem + r.ctx_off);
  T* e = reinterpret_cast<T*>(tail_smem + r.e_off);
  float* alpha = reinterpret_cast<float*>(tail_smem + r.small_off);
  tail_walk<T, DM>(qkv, mask, p, r, drop, [&](int64_t row) {
    tail_fc1<T>(e, r.es, ctx, r.cs, p.t, hd, r.q, w1, b1);
    __syncthreads();
    tail_scores<T, bl::kThreads>(alpha, e, r.es, p.t, r.q, w2, b2);
    __syncthreads();
    if (warp == 0)
      tail_alpha(alpha, mask ? mask + row * p.t : nullptr, p.t, lane,
                 nullptr);
    __syncthreads();
    for (int c = threadIdx.x; c < hd; c += bl::kThreads) {
      float acc = 0.f;
      for (int i = 0; i < p.t; ++i)
        acc = fmaf(alpha[i], ctx[i * r.cs + c], acc);
      out[row * hd + c] = from_f32<T>(acc);
    }
  });
}

// Row 14's first kernel, resident: the forward again, the pooling backward
// and d_ctx, as the per-row kernel computes them (fused_tail_bwd.cu);
// writes d_ctx (N, T, HD) in T, the f32 ctx and d_z to ctxs and dzs and
// each row's sums of db1, dw2, db2 to rowpart (N, 2Q + 1).
template <typename T, int DM>
__global__ void __launch_bounds__(bl::kThreads, (tail_blocks<T, DM>()))
tail_resident_bwd_kernel(const T* __restrict__ qkv,
                         const float* __restrict__ mask,
                         const T* __restrict__ w1, const T* __restrict__ w1t,
                         const float* __restrict__ b1,
                         const T* __restrict__ w2,
                         const float* __restrict__ b2,
                         const int* __restrict__ seed,
                         const T* __restrict__ g, T* __restrict__ dctx,
                         float* __restrict__ ctxs, float* __restrict__ dzs,
                         float* __restrict__ rowpart, bl::Params p, TailRes r,
                         int use_dropout, uint32_t thr, float scale) {
  extern __shared__ __align__(16) unsigned char tail_smem[];
  const int hd = p.h * p.d;
  const int q_dim = r.q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const TailDropout drop{use_dropout != 0,
                         use_dropout ? (uint32_t)seed[0] : 0u, thr, scale};
  float* ctx = reinterpret_cast<float*>(tail_smem + r.ctx_off);
  float* e = reinterpret_cast<float*>(tail_smem + r.e_off);  // e, then d_z
  float* alpha = reinterpret_cast<float*>(tail_smem + r.small_off);
  float* dal = alpha + p.t;  // d_alpha, then d_a
  float* gv = dal + p.t;     // the row's g
  float* rest = gv + hd;     // 1 - sum(alpha)
  tail_walk<T, DM>(qkv, mask, p, r, drop, [&](int64_t row) {
    const float* mrow = mask ? mask + row * p.t : nullptr;
    for (int c = threadIdx.x; c < hd; c += bl::kThreads)
      gv[c] = to_f32(g[row * hd + c]);
    __syncthreads();
    // the f32 ctx for dw1, and d_alpha = ctx . g: the last reads of the
    // f32 ctx, which is then rounded in place for fc1 (once, where the
    // forward rounds each element as fc1 loads it: the same values)
    float* ctx_out = ctxs + row * p.t * hd;
    for (int idx = threadIdx.x; idx < p.t * hd; idx += bl::kThreads) {
      const int i = idx / hd;
      ctx_out[idx] = ctx[i * r.cs + idx - i * hd];
    }
    for (int i = warp; i < p.t; i += bl::kWarps) {
      float s = 0.f;
      for (int c = lane; c < hd; c += 32)
        s = fmaf(ctx[i * r.cs + c], gv[c], s);
      s = warp_sum(s);
      if (lane == 0) dal[i] = s;
    }
    if constexpr (!std::is_same<T, float>::value) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < p.t * hd; idx += bl::kThreads) {
        float* x = ctx + idx / hd * r.cs + idx % hd;
        *x = round_to<T>(*x);
      }
    }
    __syncthreads();
    tail_fc1<float>(e, r.es, ctx, r.cs, p.t, hd, q_dim, w1, b1);
    __syncthreads();
    tail_scores<T, bl::kThreads>(alpha, e, r.es, p.t, q_dim, w2, b2);
    __syncthreads();
    if (warp == 0) tail_alpha(alpha, mrow, p.t, lane, rest);
    __syncthreads();
    float* part = rowpart + row * (2 * q_dim + 1);
    if (warp == 0) {
      float s = 0.f;
      for (int i = lane; i < p.t; i += 32) s = fmaf(dal[i], alpha[i], s);
      const float rr = warp_sum(s);
      for (int i = lane; i < p.t; i += 32) dal[i] = (dal[i] - rr) * alpha[i];
      // this row's db2 = sum_i d_a_i = r (1 - sum(alpha)), exactly
      if (lane == 0) part[2 * q_dim] = rr * *rest;
    }
    __syncthreads();
    // this row's sums of db1 and dw2 per column q, and d_z over e
    for (int q = threadIdx.x; q < q_dim; q += bl::kThreads) {
      const float w2q = to_f32(w2[q]);
      float s2 = 0.f, s1 = 0.f;
      for (int i = 0; i < p.t; ++i) {
        const float ei = e[i * r.es + q];
        s2 = fmaf(ei, dal[i], s2);
        const float dz = __fmul_rn(__fmul_rn(dal[i], w2q),
                                   __fsub_rn(1.f, __fmul_rn(ei, ei)));
        e[i * r.es + q] = dz;
        s1 += dz;
      }
      part[q] = s1;
      part[q_dim + q] = s2;
    }
    __syncthreads();
    float* dz_out = dzs + row * p.t * q_dim;
    for (int idx = threadIdx.x; idx < p.t * q_dim; idx += bl::kThreads) {
      const int i = idx / q_dim;
      dz_out[idx] = e[i * r.es + idx - i * q_dim];
    }
    // d_ctx = (alpha g + round(d_z) w1^T) * keep, rounded to T, for the
    // attention backward
    auto store = [&](int i, int c, float x) {
      float d = __fadd_rn(__fmul_rn(alpha[i], gv[c]), x);
      if (drop.on) d *= drop.keep(row, i, c, p.t, hd);
      dctx[(row * p.t + i) * hd + c] = from_f32<T>(d);
    };
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      tail_mma(p.t, hd, q_dim, e, r.es, w1, q_dim,
               [&](int i, int c, float x0, float x1) {
                 if (i < p.t && c < hd) store(i, c, x0);
                 if (i < p.t && c + 1 < hd) store(i, c + 1, x1);
               });
    } else {
      tail_fma<T>(p.t, hd, q_dim, e, r.es, w1t, hd, store);
    }
  });
}

// ---- the tiled regime: the rows past T = 64 -------------------------------
//
// The per-row kernels ran one block of 8 warps per batch row (128 of the
// 132 SMs at N = 128, 64 at serving's 64 users), the heads one after
// another, a warp per query whose lanes walked the keys, then the d_head
// outputs of p V with 12 of 32 lanes idle. Here a row's work is spread
// over blocks, one launch per phase, with what a phase hands the next in
// global scratch (at (128, 512): the f32 context, 105 MB, written once and
// read once, about 0.06 ms at 3.35 TB/s):
//   attention  one block per (row, head), 32 warps: the head's K^T and V
//              staged once, then the row's queries in sub-tiles of m: the
//              scores as 4 x 8 register tiles over d (a warp takes 16
//              queries by 64 keys, so a k-step loads one 16-byte vector of
//              Q^T and two of K^T for 32 FMAs a lane), the exp-normalise
//              one warp a query as recompute_a_row orders it, then p V as
//              2 x 4 register tiles over the keys in order (a warp's lanes
//              32 queries of one column group: 5 warps at m = 64, D = 20),
//              times keep, to the f32 context;
//   pooling    kPoolRows positions a block (flat over N*T): fc1 by tail_fma
//              from their staged f32 context, then the scores (and, in the
//              backward, e to the d_z scratch and d_alpha = ctx . g);
//   per row    alpha over the whole row; the forward's out = sum alpha ctx
//              (kOutCols columns a block), the backward's d_a, db2 and,
//              one thread a column of e, the sums of db1 and dw2 with d_z;
//   d_ctx      (backward) kPoolRows positions a block: round(d_z) w1^T by
//              tail_fma, plus alpha g, times keep.
// Each element keeps the per-row kernels' FMA chain (scores over d from 0,
// p V over the keys from 0, fc1 and d_z w1^T in k order, out and the row
// sums over the positions from 0) and their reductions (tail_scores,
// tail_alpha, the exp-normalise's lane order and tree), so f32 keeps their
// bits, and bf16 too.

// One (row, head) of the attention: the f32 context after dropout, for
// every query of the row, into ctx (N, T, HD).
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
tail_tiled_attn_kernel(const T* __restrict__ qkv,
                       const float* __restrict__ mask,
                       const int* __restrict__ seed,
                       float* __restrict__ ctx, int n_heads, int t_len,
                       int d_head, float inv, TileLay l, int use_dropout,
                       uint32_t thr, float scale) {
  extern __shared__ __align__(16) float tile_smem[];
  const TailDropout drop{use_dropout != 0,
                         use_dropout ? (uint32_t)seed[0] : 0u, thr, scale};
  const int h = blockIdx.x % n_heads;
  const int64_t row = blockIdx.x / n_heads;
  const int hd = n_heads * d_head;
  const int w3 = 3 * hd;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* kt = tile_smem;
  float* vv = tile_smem + l.v_off;
  float* qt = tile_smem + l.q_off;
  float* pr = tile_smem + l.p_off;
  const T* src = qkv + row * t_len * w3 + h * d_head;
  const float* mrow = mask ? mask + row * t_len : nullptr;

  // K^T and V of the head, keys past T and columns past D zero
  for (int idx = threadIdx.x; idx < l.kw * l.vs; idx += kTileThreads) {
    const int j = idx / l.vs;
    const int d = idx - j * l.vs;
    float kx = 0.f, vx = 0.f;
    if (j < t_len && d < d_head) {
      const T* e = src + (int64_t)j * w3 + d;
      kx = to_f32(e[hd]);
      vx = to_f32(e[2 * hd]);
    }
    if (d < d_head) kt[d * l.ks + j] = kx;
    if (j < l.t4) vv[idx] = vx;
  }
  float* rmax = tile_smem + l.x_off;  // (kw / 64, m) the rows' maxima
  const int col_blocks = l.kw / 64;
  const int groups = (d_head + 3) / 4;
  for (int i0 = 0; i0 < t_len; i0 += l.m) {
    const int rows = min(l.m, t_len - i0);
    __syncthreads();  // the staging, or the last sub-tile's readers, done
    for (int idx = threadIdx.x; idx < d_head * l.m; idx += kTileThreads) {
      const int d = idx / l.m;
      const int i = idx - d * l.m;
      qt[idx] = i < rows ? to_f32(src[(int64_t)(i0 + i) * w3 + d]) : 0.f;
    }
    __syncthreads();
    // the scores s = (q . k) / sqrt(D), recompute_a_row's sums: a warp
    // takes 16 queries by 64 keys, a lane 4 queries by keys jb .. jb + 3
    // and jb + 32 .. jb + 35, so a step over d loads one vector of Q^T and
    // two of K^T for 32 FMAs; then each row's maximum over the block's
    // keys (those before T), exact in any order
    for (int wb = warp; wb < l.m / 16 * col_blocks; wb += kTileWarps) {
      const int wc = wb % col_blocks;
      const int ib = (wb / col_blocks) * 16 + (lane / 8) * 4;
      const int jb = wc * 64 + (lane % 8) * 4;
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < d_head; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(qt + d * l.m + ib);
        const float4 b0 = *reinterpret_cast<const float4*>(kt + d * l.ks + jb);
        const float4 b1 =
            *reinterpret_cast<const float4*>(kt + d * l.ks + jb + 32);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float sv[8];
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          sv[c] = __fmul_rn(acc[r][c], inv);
          if (jb + c % 4 + c / 4 * 32 < t_len) mx = fmaxf(mx, sv[c]);
        }
        float* dst = pr + (ib + r) * l.ps + jb;
        *reinterpret_cast<float4*>(dst) =
            make_float4(sv[0], sv[1], sv[2], sv[3]);
        *reinterpret_cast<float4*>(dst + 32) =
            make_float4(sv[4], sv[5], sv[6], sv[7]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        if (lane % 8 == 0) rmax[wc * l.m + ib + r] = mx;
      }
    }
    __syncthreads();
    // the probs, rounded to v's dtype: recompute_a_row's exp-normalise,
    // its quotients e / den as 0 where e is 0 (a masked key: IEEE's
    // division takes its slow path there) and else by div_by where e,
    // e / den and den lie in the normal range it holds for (in practice
    // all of them): IEEE's quotient in 3 instructions, not a dozen
    for (int i = warp; i < rows; i += kTileWarps) {
      float* a = pr + i * l.ps;
      float mx = -INFINITY;
      for (int c = lane; c < col_blocks; c += 32)
        mx = fmaxf(mx, rmax[c * l.m + i]);
      const float m = warp_max(mx);
      float sum = 0.f;
#pragma unroll 4
      for (int j = lane; j < t_len; j += 32) {
        float e = expf(a[j] - m);
        if (mrow) e *= mrow[j];
        a[j] = e;
        sum += e;
      }
      const float den = warp_sum(sum) + kEps * expf(-m);
      const float rcp = rcp_or_zero(den);
      const bool normal = den >= 0x1p-100f && den <= 0x1p100f;
#pragma unroll 4
      for (int j = lane; j < t_len; j += 32) {
        const float x = a[j];
        float p = 0.f;
        if (den > 0.f && x != 0.f) {
          const float q = __fmul_rn(x, rcp);
          p = normal && x >= 0x1p-100f && q >= 0x1p-100f ? div_by(x, den, rcp)
                                                         : x / den;
        }
        a[j] = round_to<T>(p);
      }
      for (int j = t_len + lane; j < l.t4; j += 32) a[j] = 0.f;
    }
    __syncthreads();
    // ctx = p V over the keys in order, times keep: a thread takes
    // kPvRows queries (32 apart) by 4 columns, a warp's lanes 32 queries of
    // one column group, so the warp's V loads are one address
    const int tiles =
        (rows + 32 * kPvRows - 1) / (32 * kPvRows) * 32 * groups;
    for (int tile = threadIdx.x; tile < tiles; tile += kTileThreads) {
      const int wg = tile / 32;
      const int i = wg / groups * 32 * kPvRows + tile % 32;
      const int d0 = wg % groups * 4;
      const float* a[kPvRows];
#pragma unroll
      for (int r = 0; r < kPvRows; ++r)
        a[r] = pr + min(i + 32 * r, rows - 1) * l.ps;
      const float* v = vv + d0;
      float acc[kPvRows][4];
#pragma unroll
      for (int r = 0; r < kPvRows; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < l.t4; j += 4) {
        float pj[kPvRows][4];
#pragma unroll
        for (int r = 0; r < kPvRows; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(a[r] + j);
          pj[r][0] = p4.x;
          pj[r][1] = p4.y;
          pj[r][2] = p4.z;
          pj[r][3] = p4.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(v + (j + u) * l.vs);
#pragma unroll
          for (int r = 0; r < kPvRows; ++r) {
            acc[r][0] = fmaf(pj[r][u], x.x, acc[r][0]);
            acc[r][1] = fmaf(pj[r][u], x.y, acc[r][1]);
            acc[r][2] = fmaf(pj[r][u], x.z, acc[r][2]);
            acc[r][3] = fmaf(pj[r][u], x.w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kPvRows; ++r) {
        const int ir = i + 32 * r;
        if (ir >= rows) break;
        float* dst = ctx + (row * t_len + i0 + ir) * hd + h * d_head;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int d = d0 + u;
          if (d >= d_head) break;
          float x = acc[r][u];
          if (drop.on)
            x *= drop.keep(row, i0 + ir, h * d_head + d, t_len, hd);
          dst[d] = x;
        }
      }
    }
  }
}

// fc1 and the scores of kPoolRows positions (flat over the N*T of ctx):
// e = tanh(round(ctx) w1 + b1) in k order (tail_fma), s = round(e) w2 + b2
// (tail_scores) to s. kBwd: also e (f32) to e_out (N*T, Q) and d_alpha =
// ctx . g (the per-row kernel's lane order and tree) to dal.
template <typename T, bool kBwd>
__global__ void __launch_bounds__(bl::kThreads)
tail_tiled_pool_kernel(const float* __restrict__ ctx,
                       const T* __restrict__ w1, const float* __restrict__ b1,
                       const T* __restrict__ w2, const float* __restrict__ b2,
                       const T* __restrict__ g, float* __restrict__ s,
                       float* __restrict__ e_out, float* __restrict__ dal,
                       int64_t n_pos, int t_len, int hd, int q_dim) {
  extern __shared__ __align__(16) float pool_smem[];
  const int cs = tail_cs(hd);
  const int es = tail_es(q_dim);
  float* cb = pool_smem;                 // (kPoolRows, cs) the f32 context
  float* e = pool_smem + kPoolRows * cs;  // (kPoolRows, es) e
  const int64_t p0 = (int64_t)blockIdx.x * kPoolRows;
  const int rows = (int)min((int64_t)kPoolRows, n_pos - p0);
  const float* src = ctx + p0 * hd;
  if (hd % 4 == 0) {
    const int h4 = hd / 4;
    for (int idx = threadIdx.x; idx < rows * h4; idx += bl::kThreads) {
      const int i = idx / h4;
      const int c = (idx - i * h4) * 4;
      *reinterpret_cast<float4*>(cb + i * cs + c) =
          *reinterpret_cast<const float4*>(src + (int64_t)i * hd + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * hd; idx += bl::kThreads) {
      const int i = idx / hd;
      cb[i * cs + idx - i * hd] = src[idx];
    }
  }
  __syncthreads();
  tail_fc1<T>(e, es, cb, cs, rows, hd, q_dim, w1, b1);
  __syncthreads();
  tail_scores<T, bl::kThreads>(s + p0, e, es, rows, q_dim, w2, b2);
  if constexpr (kBwd) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int idx = threadIdx.x; idx < rows * q_dim; idx += bl::kThreads) {
      const int i = idx / q_dim;
      e_out[p0 * q_dim + idx] = e[i * es + idx - i * q_dim];
    }
    for (int i = warp; i < rows; i += bl::kWarps) {
      const T* gr = g + (p0 + i) / t_len * hd;
      float acc = 0.f;
      for (int c = lane; c < hd; c += 32)
        acc = fmaf(cb[i * cs + c], to_f32(gr[c]), acc);
      acc = warp_sum(acc);
      if (lane == 0) dal[p0 + i] = acc;
    }
  }
}

}  // namespace nrk
