// Row 15's resident design (the batch-in-lanes forward at T <= 64):
// the block layout, the staging of work items, the per-query pass and the
// forward kernel that blanes.cu (rows 15-16) and qkv_fwd.cuh (rows 1-2)
// both launch; the per-query pass (short_context) is also rows 13-14's
// attention at T <= 64 (fused_tail.cuh), and row 16's resident backward
// kernel is also row 14's attention backward there (fused_tail_bwd.cu).
// Rows 15-16's other kernels stay in blanes.cu.
//
// An item is one batch row, up to four heads and every query; the grid
// holds at most as many blocks as fit on the card, each walking items with
// the next item's q, k, v copied in by cp.async (16, 8 or 4 bytes as the
// alignment allows) while it computes the current one. Operands are
// staged in their own dtype, one row of D padded to 16 bytes per head,
// rows an odd number of 16-byte units apart. One warp per (head, query):
// key j in lane j mod 32, each lane's keys in order, then the xor tree;
// a lane keeps its two scores in registers through the max, den and a,
// and writes its keys of round(a) to the item's (heads, T, T|1) array.
// Then threads by (head, query pair, d pair) sum the context in key order.
// That is rows 1 and 4's order of every sum, and PyTorch's.
//
// Two compile-time flags of its body (short_context) give rows 1-2 their
// contract on the same design (qkv_resident_kernel):
//   kBias   the projection's bias (3*H*D,) is added to the item's staged
//           q, k, v at the input dtype (round(x + b)) before the first
//           dot; row 15's qkv carries its bias already;
//   kProbs  each lane writes its keys' f32 a to probs (N, T, H*T), head h
//           at lanes [h*T, (h+1)*T), before a is rounded (row 2).
// Row 15's kernel takes neither, and keeps its bits.
#pragma once

#include "flash.cuh"  // with_head_width
#include "mma.cuh"

#include <type_traits>

namespace nrk {
namespace bl {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kShortT = 64;        // longest T of the resident regime
constexpr int kMaxSmem = 232448;   // what a block may use

enum Kind { kFwd = 0, kBwd = 1, kBwdQuery = 2, kBwdKey = 3 };

// Whether the long regime takes the tensor-core kernels: past the
// resident regime, bf16, heads of at most 32 (the forward, and both
// kernels of the backward).
__host__ __device__ inline bool long_mma(int t, int d_head, int esize) {
  return t > kShortT && esize == 2 && d_head <= 32;
}

// Elements a staged head row is padded to: 16 bytes, or 16 elements (one
// k-step of mma.m16n8k16) for the tensor-core kernels.
__host__ __device__ inline int head_align(int kind, int t, int d_head,
                                          int esize) {
  return kind != kBwd && long_mma(t, d_head, esize) ? 16 : 16 / esize;
}

// Bytes of one row of `heads` heads of D elements, each padded to a whole
// number of `ve` elements held at `width` bytes, the row padded to an odd
// number of 16-byte units (rows an odd number of units apart: a lane's, or
// ldmatrix's, 16 bytes of eight rows hit 32 banks).
inline int row_bytes(int d_head, int ve, int heads, int width) {
  const int rb = heads * ((d_head + ve - 1) / ve * ve) * width;
  return (rb / 16) % 2 == 0 ? rb + 16 : rb;
}

// Queries a warp of the long forward takes at once: two share each
// staged row they read, as far as registers allow. The long backward's
// kernels take one (rows of a and ds for two would cost the second block
// on an SM at T = 511).
__host__ __device__ inline int pair_of(int d_head) {
  return d_head <= 32 ? 2 : 1;
}

// Bytes of one stage buffer and of the f32 arrays after the buffers.
//   fwd, T <= 64:  Q, K, V [T];        bf16: K in f32; round(a), (heads, T, T|1)
//   fwd, T > 64:   Q [rows], K, V [T]; a row per warp and query it takes
//   bwd (T <= 64): Q, K, V, g [T];     bf16: K, V in f32; a and ds, each
//                                      (heads, T, T|1)
//   bwd query:     Q [rows], g [rows], K [T], V [T];   two rows per warp
//   bwd key:       Q [T], g [T], K [rows], V [rows], the m, den, r of the T
//                  queries;                           two rows per warp
// (on tensor cores, past T = 64, heads padded to 16 elements, no warp rows).
// The f32 copy of staged rows (bf16) keeps the stage's head offsets.
struct Layout {
  size_t stage, rows;
};

inline Layout layout_of(int kind, int t, int d_head, int esize, int heads,
                        int rows) {
  const size_t rb =
      row_bytes(d_head, head_align(kind, t, d_head, esize), heads, esize);
  const size_t wide =
      esize == 2 ? row_bytes(d_head, 16 / esize, heads, 4) : 0;
  const size_t t_ = t, r_ = rows;
  const size_t warp_rows = (size_t)kWarps * t * 4;
  const size_t tt = (size_t)heads * t_ * (t | 1) * 4;
  switch (kind) {
    case kFwd:
      if (t <= kShortT) return {3 * t_ * rb, t_ * wide + tt};
      if (long_mma(t, d_head, esize)) return {(r_ + 2 * t_) * rb, 0};
      return {(r_ + 2 * t_) * rb, pair_of(d_head) * warp_rows};
    case kBwd:
      return {4 * t_ * rb, 2 * t_ * wide + 2 * tt};
    case kBwdQuery:
      return {(2 * r_ + 2 * t_) * rb,
              long_mma(t, d_head, esize) ? 0 : 2 * warp_rows};
    default:
      return {(2 * t_ + 2 * r_) * rb + (12 * t_ + 15) / 16 * 16,
              long_mma(t, d_head, esize) ? 0 : 2 * warp_rows};
  }
}

struct Params {
  int n, t, h, d;       // batch rows, positions, heads, head width
  int heads, rows;      // heads and rows (queries or keys) of an item
  int groups, tiles;    // head groups and row tiles of a batch row
  int items;            // rows x groups x tiles, below 2^31
  int nbuf;             // stage buffers: 2 copies the next item in early
  int dp, rs;           // padded head width, staged row stride (elements)
  int rsf;              // row stride of an f32 copy of staged rows
  int chunk;            // bytes of one async copy; 0: element copies
  size_t stage;         // bytes of one stage buffer
  float inv_s, inv;     // the scale of the scores, and of ds
};

struct Item {
  int64_t n;
  int h0, gn, r0, rn;  // first head and heads; first row and rows
};

__device__ __forceinline__ Item item_of(const Params& p, int item) {
  Item it;
  const int rest = item / p.tiles;
  const int tile = item - rest * p.tiles;
  const int n = rest / p.groups;
  it.n = n;
  it.h0 = (rest - n * p.groups) * p.heads;
  it.gn = min(p.heads, p.h - it.h0);
  it.r0 = tile * p.rows;
  it.rn = min(p.rows, p.t - it.r0);
  return it;
}

// ---- staging ---------------------------------------------------------------

// Rows [row0, row0 + rows) of x (w elements a row), the D columns of head
// hl at col0 + hl*D for hl < gn, into dst[r*rs + hl*dp ...]. Each thread
// keeps one piece of a row (gn * D / step <= 128 of them) and walks the
// rows.
template <typename T>
__device__ __forceinline__ void stage_part(T* dst, const T* __restrict__ x,
                                           int64_t row0, int rows, int w,
                                           int col0, int gn,
                                           const Params& p) {
  const int step = p.chunk ? p.chunk / (int)sizeof(T) : 1;  // elements
  const int per = p.d / step;  // pieces of a head row
  const int cols = gn * per;
  const int rstep = kThreads / cols;
  const int r0 = threadIdx.x / cols;
  if (r0 >= rstep) return;
  const int col = threadIdx.x - r0 * cols;
  const int hl = col / per;
  const int e = (col - hl * per) * step;
  const T* src = x + row0 * w + col0 + hl * p.d + e;
  T* to = dst + hl * p.dp + e;
  for (int r = r0; r < rows; r += rstep) {
    if (p.chunk == 16) cp_async<16>(to + r * p.rs, src + (int64_t)r * w);
    else if (p.chunk == 8) cp_async<8>(to + r * p.rs, src + (int64_t)r * w);
    else if (p.chunk == 4) cp_async<4>(to + r * p.rs, src + (int64_t)r * w);
    else to[r * p.rs] = src[(int64_t)r * w];
  }
}

// An f32 copy of `rows` staged rows (gn heads, pads included) into dst,
// rows rsf floats apart, with the stage's head offsets: the dots of every
// query read it, so each element is converted once per item. With b (the
// bias of the item's first head, D lanes a head) each element below D is
// round(x + b) at the input dtype first.
template <typename T>
__device__ __forceinline__ void widen(float* dst, const T* src, int rows,
                                      int gn, const Params& p,
                                      const T* __restrict__ b) {
  const int cols = gn * p.dp;
  const int rstep = kThreads / cols;
  const int r0 = threadIdx.x / cols;
  if (r0 >= rstep) return;
  const int col = threadIdx.x - r0 * cols;
  const int hl = col / p.dp;
  const int d = col - hl * p.dp;
  const float bias = b && d < p.d ? to_f32(b[hl * p.d + d]) : 0.f;
  for (int r = r0; r < rows; r += rstep) {
    const float x = to_f32(src[r * p.rs + col]);
    dst[r * p.rsf + col] = b ? round_to<T>(x + bias) : x;
  }
}

// Walks this block's items from `first` on, next(item) after each, while
// below p.items: item k's operands are staged (stage(item, buffer)) while
// item k - 1 is computed when there are two buffers. The stage buffers are
// zeroed first: the pads past D are never copied. P: Params, or any with
// items, nbuf and stage (bytes of one buffer).
template <typename P, typename Next, typename Stage, typename Compute>
__device__ __forceinline__ void walk_items(const P& p,
                                           unsigned char* smem, int first,
                                           Next next, Stage stage,
                                           Compute compute) {
  const uint4 zero = {0u, 0u, 0u, 0u};
  for (size_t i = threadIdx.x * 16; i < p.nbuf * p.stage; i += kThreads * 16)
    *reinterpret_cast<uint4*>(smem + i) = zero;
  __syncthreads();
  int item = first;
  int b = 0;
  if (item < p.items) stage(item, 0);
  cp_commit();
  while (item < p.items) {
    const int later = next(item);
    if (p.nbuf == 2) {
      if (later < p.items) stage(later, b ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // the item's operands are in
    compute(item, b);
    __syncthreads();  // its buffer and rows are free again
    if (p.nbuf == 2) {
      b ^= 1;
    } else if (later < p.items) {
      stage(later, 0);
      cp_commit();
    }
    item = later;
  }
  cp_wait<0>();
}

// The grid's walk: block b takes items b, b + gridDim.x, ...
template <typename Stage, typename Compute>
__device__ __forceinline__ void run_items(const Params& p, unsigned char* smem,
                                          Stage stage, Compute compute) {
  walk_items(p, smem, (int)blockIdx.x,
             [](int item) { return item + (int)gridDim.x; }, stage, compute);
}

// ---- reading staged rows ----------------------------------------------------

// 16 staged bytes at p (16-byte aligned) as floats
__device__ __forceinline__ void load_chunk(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// NQ staged head rows, rs elements apart, as NQ vectors of DM floats
// (their zero pads included, 0 past them).
template <typename T, int DM, int NQ>
__device__ __forceinline__ void load_rows(float* x, const T* row, int rs,
                                          int d_head) {
  constexpr int VE = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int c = 0; c < DM / VE; ++c) {
      if (c * VE < d_head) {
        load_chunk(row + q * rs + c * VE, x + q * DM + c * VE);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) x[q * DM + c * VE + e] = 0.f;
      }
    }
}

// acc[q] = x_q . row for NQ vectors x_q, each in d order (the pads add
// exact zeros); the row is read once for all of them.
template <typename T, int DM, int NQ>
__device__ __forceinline__ void dot_rows(float* acc, const float* x,
                                         const T* row, int d_head) {
  constexpr int VE = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
#pragma unroll
  for (int c = 0; c < DM / VE; ++c) {
    if (c * VE < d_head) {
      float f[VE];
      load_chunk(row + c * VE, f);
#pragma unroll
      for (int e = 0; e < VE; ++e)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          acc[q] = fmaf(x[q * DM + c * VE + e], f[e], acc[q]);
    }
  }
}

// ---- one warp's rows ---------------------------------------------------------

// The max over a warp in one redux.sync: floats mapped to integers of the
// same order (a max is exact, so it equals warp_max's value).
__device__ __forceinline__ float redux_max(float v) {
  const int b = __float_as_int(v);
  const int key = __reduce_max_sync(0xffffffffu, b ^ ((b >> 31) & 0x7fffffff));
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

// T <= 64, one warp, one query: its two scores a lane holds (keys lane
// and lane + 32) stay in registers through the max, den and a; a's row,
// rounded to T, into arow. With g's row (kBwd) also da, r and ds: ds's
// row, rounded to T, into dsrow. The sums in the order of blanes.cu's
// a_rows and ds_rows. kreg: the lane's key row in registers (T <= 32),
// else the keys at ks. prow (or null): the row's f32 a, before rounding.
template <typename T, typename K, int DM, bool kBwd>
__device__ __forceinline__ void short_row(float* arow, float* dsrow,
                                          const T* qrow, const T* grow,
                                          const float* kreg, const K* ks,
                                          const K* vs, int krs,
                                          const float* mrow, const Params& p,
                                          int lane, float* prow) {
  constexpr int NS = (kShortT + 31) / 32;
  float x[NS], mx = -INFINITY, sum = 0.f;
  {
    float qf[DM];
    load_rows<T, DM, 1>(qf, qrow, 0, p.d);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = lane + 32 * k;
      x[k] = 0.f;
      if (j < p.t) {
        if (kreg) {
#pragma unroll
          for (int d = 0; d < DM; ++d) x[k] = fmaf(qf[d], kreg[d], x[k]);
        } else {
          dot_rows<K, DM, 1>(x + k, qf, ks + j * krs, p.d);
        }
        x[k] = __fmul_rn(x[k], p.inv_s);
        mx = fmaxf(mx, x[k]);
      }
    }
  }
  const float m = redux_max(mx);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int j = lane + 32 * k;
    if (j < p.t) {
      float e = expf(x[k] - m);
      if (mrow) e = e * mrow[j];
      x[k] = e;
      sum = __fadd_rn(sum, e);
    }
  }
  const float den = __fadd_rn(warp_sum(sum), __fmul_rn(kEps, expf(-m)));
#pragma unroll
  for (int k = 0; k < NS; ++k)
    if (lane + 32 * k < p.t) {
      x[k] = den > 0.f ? x[k] / den : 0.f;
      if (prow) prow[lane + 32 * k] = x[k];
    }
  if constexpr (kBwd) {
    float gf[DM], da[NS], part = 0.f;
    load_rows<T, DM, 1>(gf, grow, 0, p.d);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = lane + 32 * k;
      if (j < p.t) {
        dot_rows<K, DM, 1>(da + k, gf, vs + j * krs, p.d);
        part = __fadd_rn(part, __fmul_rn(da[k], x[k]));
      }
    }
    const float r = warp_sum(part);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = lane + 32 * k;
      if (j < p.t) dsrow[j] = round_to<T>((da[k] - r) * x[k] * p.inv);
    }
  }
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int j = lane + 32 * k;
    if (j < p.t) arow[j] = round_to<T>(x[k]);
  }
}

// Two neighbouring staged elements (an even offset) as floats.
__device__ __forceinline__ void load_pair(const float* x, float* f) {
  const float2 v = *reinterpret_cast<const float2*>(x);
  f[0] = v.x;
  f[1] = v.y;
}

__device__ __forceinline__ void load_pair(const __nv_bfloat16* x, float* f) {
  const unsigned w = *reinterpret_cast<const unsigned*>(x);
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// The short kernels' queries: with kRegK (the forward) at T <= 32 the
// warps split by head, each holding its lane's key row of that head in
// registers for every query it takes; else one warp per query, the keys
// read from shared memory (the backward: registers for K cost it the
// third block on an SM). body(key row or null, head, query).
template <int DM, bool kRegK, typename K, typename Body>
__device__ __forceinline__ void for_rows(int gn, const Params& p, int warp,
                                         int lane, const K* keys, int krs,
                                         Body body) {
  if (kRegK && p.t <= 32) {
    const int hl = warp % p.heads;
    if (hl >= gn) return;
    float kreg[DM];
    if (lane < p.t) {
      load_rows<K, DM, 1>(kreg, keys + lane * krs + hl * p.dp, 0, p.d);
    } else {
#pragma unroll
      for (int d = 0; d < DM; ++d) kreg[d] = 0.f;
    }
    // the warps of head hl: hl, hl + heads, ...
    const int nsub = (kWarps - 1 - hl) / p.heads + 1;
    for (int i = warp / p.heads; i < p.t; i += nsub) body(kreg, hl, i);
  } else {
    for (int task = warp; task < gn * p.t; task += kWarps)
      body(nullptr, task / p.t, task % p.t);
  }
}

// 16 bytes of floats back into a staged chunk (bf16: rounded to nearest,
// one rounding of each value).
__device__ __forceinline__ void store_chunk(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float* f) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&v);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The bias (3*H*D,) added in place to parts [part0, part1) of an item's
// staged q, k, v (0 q, 1 k, 2 v) at the input dtype, x = round(x + b), in
// 16-byte chunks of the padded head rows (the pads add 0 and stay 0):
// each thread keeps one chunk column (gn * dp / VE <= kThreads of them),
// its bias in registers, and walks the rows of each part.
template <typename T>
__device__ __forceinline__ void add_bias(T* s, const T* __restrict__ bias,
                                         int part0, int part1, const Item& it,
                                         const Params& p) {
  constexpr int VE = 16 / sizeof(T);
  const int per = p.dp / VE;  // chunks of a padded head row
  const int cols = it.gn * per;
  const int rstep = kThreads / cols;
  const int r0 = threadIdx.x / cols;
  if (r0 >= rstep) return;
  const int col = threadIdx.x - r0 * cols;
  const int hl = col / per;
  const int d0 = (col - hl * per) * VE;
  const int hd = p.h * p.d;
  for (int part = part0; part < part1; ++part) {
    float b[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e)
      b[e] = d0 + e < p.d
                 ? to_f32(bias[part * hd + (it.h0 + hl) * p.d + d0 + e])
                 : 0.f;
    T* x = s + part * p.t * p.rs + hl * p.dp + d0;
    for (int r = r0; r < p.t; r += rstep) {
      float f[VE];
      load_chunk(x + r * p.rs, f);
#pragma unroll
      for (int e = 0; e < VE; ++e) f[e] += b[e];
      store_chunk(x + r * p.rs, f);
    }
  }
}

// ---- the kernels -------------------------------------------------------------

// Stage item `it`'s q, k, v into stage buffer b.
template <typename T>
__device__ __forceinline__ void stage_qkv(unsigned char* smem, int b,
                                          const Item& it,
                                          const T* __restrict__ qkv,
                                          const Params& p) {
  T* s = reinterpret_cast<T*>(smem + b * p.stage);
  const int hd = p.h * p.d;
  const int64_t base = it.n * p.t;
  const int c = it.h0 * p.d;
  const int part = p.t * p.rs;
  stage_part(s, qkv, base, p.t, 3 * hd, c, it.gn, p);
  stage_part(s + part, qkv, base, p.t, 3 * hd, hd + c, it.gn, p);
  stage_part(s + 2 * part, qkv, base, p.t, 3 * hd, 2 * hd + c, it.gn, p);
}

// T <= 64, one item staged in buffer b: phase 1, one warp per query, writes
// the rows of round(a) into the item's (heads, T, T|1) array; phase 2 sums
// the context over threads by (head, query pair, d pair) and hands each
// thread's four sums to emit(hl, i, d, o00, o01, o10, o11): queries i and
// i + 1 (i even), lanes d and d + 1 (d even) of head hl, the second query
// or lane past T or D where i + 1 or d + 1 is. kBias: the bias is added in
// place to the staged q and v (and to k in f32; in bf16 as it is widened),
// in the pass before the dots; kProbs: probs (N, T, H*T) gets each row's
// f32 a.
template <typename T, int DM, bool kBias, bool kProbs, typename Emit>
__device__ __forceinline__ void short_context(unsigned char* smem, int b,
                                              const Item& it,
                                              const T* __restrict__ bias,
                                              const float* __restrict__ mask,
                                              float* __restrict__ probs,
                                              const Params& p, Emit emit) {
  constexpr bool kWiden = sizeof(T) == 2;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int hd = p.h * p.d;
  const int as = p.t | 1;  // odd: the rows of a query pair on other banks
  float* rest = reinterpret_cast<float*>(smem + p.nbuf * p.stage);
  float* kf = rest;  // the f32 copy of K (bf16)
  float* at = rest + (kWiden ? p.t * p.rsf : 0);  // (heads, T, as)
  const T* qs = reinterpret_cast<const T*>(smem + b * p.stage);
  const T* ks = qs + p.t * p.rs;
  const T* vs = ks + p.t * p.rs;
  const float* mrow = mask ? mask + it.n * p.t : nullptr;
  if constexpr (kBias) {  // q and v, and k where no widened copy takes it
    T* s = reinterpret_cast<T*>(smem + b * p.stage);
    add_bias(s, bias, 0, kWiden ? 1 : 2, it, p);
    add_bias(s, bias, 2, 3, it, p);
  }
  if constexpr (kWiden)
    widen(kf, ks, p.t, it.gn, p, kBias ? bias + hd + it.h0 * p.d : nullptr);
  if constexpr (kBias || kWiden) __syncthreads();
  using K = typename std::conditional<kWiden, float, T>::type;
  const K* keys = kWiden ? (const K*)kf : (const K*)ks;
  const int krs = kWiden ? p.rsf : p.rs;
  for_rows<DM, true>(it.gn, p, warp, lane, keys, krs,
                     [&](const float* kreg, int hl, int i) {
    // probs[n, i, h*T + j]: this query's row of head h
    float* prow = kProbs ? probs + ((it.n * p.t + i) * p.h + it.h0 + hl) *
                                       (int64_t)p.t
                         : nullptr;
    short_row<T, K, DM, false>(at + (hl * p.t + i) * as, nullptr,
                               qs + i * p.rs + hl * p.dp, nullptr, kreg,
                               keys + hl * p.dp, nullptr, krs, mrow, p, lane,
                               prow);
  });
  __syncthreads();  // every row of a is written
  const int dpairs = (p.d + 1) / 2;
  const int ipairs = (p.t + 1) / 2;
  for (int idx = threadIdx.x; idx < it.gn * ipairs * dpairs;
       idx += kThreads) {
    const int dpi = idx % dpairs;
    const int rest_i = idx / dpairs;
    const int hl = rest_i / ipairs;
    const int i = (rest_i - hl * ipairs) * 2;
    const int d = dpi * 2;
    const float* a0 = at + (hl * p.t + i) * as;
    const float* a1 = at + (hl * p.t + min(i + 1, p.t - 1)) * as;
    const T* v = vs + hl * p.dp + d;
    float o00 = 0.f, o01 = 0.f, o10 = 0.f, o11 = 0.f;
    for (int j = 0; j < p.t; ++j) {
      float vv[2];
      load_pair(v + j * p.rs, vv);
      const float x0 = a0[j], x1 = a1[j];
      o00 = fmaf(x0, vv[0], o00);
      o01 = fmaf(x0, vv[1], o01);
      o10 = fmaf(x1, vv[0], o10);
      o11 = fmaf(x1, vv[1], o11);
    }
    emit(hl, i, d, o00, o01, o10, o11);
  }
}

// The resident forward over every item: short_context with each context
// rounded to T into out (N, T, H*D).
template <typename T, int DM, bool kBias, bool kProbs>
__device__ __forceinline__ void fwd_short(const T* __restrict__ qkv,
                                          const T* __restrict__ bias,
                                          const float* __restrict__ mask,
                                          T* __restrict__ out,
                                          float* __restrict__ probs,
                                          const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = p.h * p.d;
  auto stage = [&](int item, int b) {
    stage_qkv(smem, b, item_of(p, item), qkv, p);
  };
  auto compute = [&](int item, int b) {
    const Item it = item_of(p, item);
    short_context<T, DM, kBias, kProbs>(
        smem, b, it, bias, mask, probs, p,
        [&](int hl, int i, int d, float o00, float o01, float o10,
            float o11) {
          T* o = out + (it.n * p.t + i) * hd + (it.h0 + hl) * p.d + d;
          o[0] = from_f32<T>(o00);
          if (d + 1 < p.d) o[1] = from_f32<T>(o01);
          if (i + 1 < p.t) {
            o[hd] = from_f32<T>(o10);
            if (d + 1 < p.d) o[hd + 1] = from_f32<T>(o11);
          }
        });
  };
  run_items(p, smem, stage, compute);
}

// Row 15's forward: fwd_short without bias or probs.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
blanes_fwd_short_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ mask, T* __restrict__ out,
                        Params p) {
  fwd_short<T, DM, false, false>(qkv, nullptr, mask, out, nullptr, p);
}

// Rows 1-2's: fwd_short with the bias, and row 2's probs. Heads of up to
// 24 lanes are held to 64 registers, four blocks an SM (unbounded they
// took 70-79, three blocks; on an H100 row 2 at (7040, 20) in f32 ran 14%
// faster so, bf16 the same: PERF.md).
template <typename T, int DM, bool kProbs>
__global__ void __launch_bounds__(kThreads, DM <= 24 ? 4 : 1)
qkv_resident_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                    const float* __restrict__ mask, T* __restrict__ out,
                    float* __restrict__ probs, Params p) {
  fwd_short<T, DM, true, kProbs>(qkv, bias, mask, out, probs, p);
}

// T <= 64: phase 1, one warp per query, writes each query's rows of
// round(a) and ds into the item's (heads, T, T|1) arrays (the dots read
// f32 copies of K and V); phase 2 sums dq, dk and dv from them over
// threads by (head, row, d pair).
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads, 3)
blanes_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                  const T* __restrict__ g, T* __restrict__ dqkv, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kWiden = sizeof(T) == 2;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int hd = p.h * p.d;
  const int as = p.t | 1;
  const int tt = p.t * as;
  float* rest = reinterpret_cast<float*>(smem + p.nbuf * p.stage);
  float* kf = rest;  // f32 copies of K and V (bf16)
  float* vf = kf + p.t * p.rsf;
  float* ats = rest + (kWiden ? 2 * p.t * p.rsf : 0);  // (heads, T, as)
  float* dss = ats + p.heads * tt;
  auto stage = [&](int item, int b) {
    const Item it = item_of(p, item);
    T* s = reinterpret_cast<T*>(smem + b * p.stage);
    const int64_t base = it.n * p.t;
    const int c = it.h0 * p.d;
    const int part = p.t * p.rs;
    stage_part(s, qkv, base, p.t, 3 * hd, c, it.gn, p);
    stage_part(s + part, qkv, base, p.t, 3 * hd, hd + c, it.gn, p);
    stage_part(s + 2 * part, qkv, base, p.t, 3 * hd, 2 * hd + c, it.gn, p);
    stage_part(s + 3 * part, g, base, p.t, hd, c, it.gn, p);
  };
  auto compute = [&](int item, int b) {
    const Item it = item_of(p, item);
    const T* qs = reinterpret_cast<const T*>(smem + b * p.stage);
    const T* ks = qs + p.t * p.rs;
    const T* vs = ks + p.t * p.rs;
    const T* gs = vs + p.t * p.rs;
    const float* mrow = mask ? mask + it.n * p.t : nullptr;
    if constexpr (kWiden) {
      widen(kf, ks, p.t, it.gn, p, static_cast<const T*>(nullptr));
      widen(vf, vs, p.t, it.gn, p, static_cast<const T*>(nullptr));
      __syncthreads();
    }
    using K = typename std::conditional<kWiden, float, T>::type;
    const K* keys = kWiden ? (const K*)kf : (const K*)ks;
    const K* vals = kWiden ? (const K*)vf : (const K*)vs;
    const int krs = kWiden ? p.rsf : p.rs;
    for_rows<DM, false>(it.gn, p, warp, lane, keys, krs,
                        [&](const float* kreg, int hl, int i) {
      const int at = i * p.rs + hl * p.dp;
      short_row<T, K, DM, true>(ats + hl * tt + i * as, dss + hl * tt + i * as,
                                qs + at, gs + at, kreg, keys + hl * p.dp,
                                vals + hl * p.dp, krs, mrow, p, lane,
                                nullptr);
    });
    __syncthreads();  // every row of a and ds is written
    T* dst = dqkv + it.n * p.t * 3 * hd;
    const int dpairs = (p.d + 1) / 2;
    for (int idx = threadIdx.x; idx < it.gn * p.t * dpairs; idx += kThreads) {
      const int dpi = idx % dpairs;
      const int rest_x = idx / dpairs;
      const int x = rest_x % p.t;
      const int hl = rest_x / p.t;
      const int d = dpi * 2;
      const float* ah = ats + hl * tt;
      const float* dsh = dss + hl * tt;
      const int col = hl * p.dp + d;
      float dq[2] = {0.f, 0.f}, dk[2] = {0.f, 0.f}, dv[2] = {0.f, 0.f};
      for (int j = 0; j < p.t; ++j) {
        float kk[2], qq[2], gg[2];
        load_pair(ks + j * p.rs + col, kk);
        load_pair(qs + j * p.rs + col, qq);
        load_pair(gs + j * p.rs + col, gg);
        const float ds_xj = dsh[x * as + j], ds_jx = dsh[j * as + x];
        const float a_jx = ah[j * as + x];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dq[e] = fmaf(ds_xj, kk[e], dq[e]);
          dk[e] = fmaf(ds_jx, qq[e], dk[e]);
          dv[e] = fmaf(a_jx, gg[e], dv[e]);
        }
      }
      T* o = dst + (int64_t)x * 3 * hd + (it.h0 + hl) * p.d + d;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (d + e < p.d) {
          o[e] = from_f32<T>(dq[e]);
          o[hd + e] = from_f32<T>(dk[e]);
          o[2 * hd + e] = from_f32<T>(dv[e]);
        }
    }
  };
  run_items(p, smem, stage, compute);
}
// ---- launch ------------------------------------------------------------------

// Bytes of one async copy: the largest of 16, 8, 4 that divides a head
// row's bytes and both base addresses (every row and head offset is a
// multiple of a head row); 0 for element copies.
inline int chunk_bytes(int d_head, int esize, const void* a, const void* b) {
  for (int c = 16; c >= 4; c /= 2)
    if ((d_head * esize) % c == 0 && (uintptr_t)a % c == 0 &&
        (uintptr_t)b % c == 0)
      return c;
  return 0;
}

// The Params of a launch of `kind` at (N, T, H, D) in a dtype of esize
// bytes under the plan (heads, rows, nbuf); a and b are the base addresses
// its copies read. items is 0 where the grid would pass 2^31 - 1 items.
inline Params params_of(int kind, int n, int t_len, int n_heads, int d_head,
                        int esize, int heads, int rows, int nbuf,
                        const void* a, const void* b) {
  Params p;
  p.n = n;
  p.t = t_len;
  p.h = n_heads;
  p.d = d_head;
  p.heads = heads;
  p.rows = rows;
  p.groups = (n_heads + heads - 1) / heads;
  p.tiles = (t_len + rows - 1) / rows;
  const int64_t items = (int64_t)n * p.groups * p.tiles;
  p.items = items > 0x7fffffff ? 0 : (int)items;
  p.nbuf = nbuf;
  const int ve = head_align(kind, t_len, d_head, esize);
  p.dp = (d_head + ve - 1) / ve * ve;
  p.rs = row_bytes(d_head, ve, heads, esize) / esize;
  p.rsf = row_bytes(d_head, 16 / esize, heads, 4) / 4;
  p.chunk = chunk_bytes(d_head, esize, a, b);
  p.stage = layout_of(kind, t_len, d_head, esize, heads, rows).stage;
  // the scale of the scores, computed as rows 1 and 4 compute it; 1/sqrt(D)
  // for ds rounded once from double, as the plain version's scalar is
  p.inv_s = 1.0f / sqrtf((float)d_head);
  p.inv = (float)(1.0 / sqrt((double)d_head));
  return p;
}

// Rows 1-2's launch of the resident forward, bias added in the kernel.
template <typename T>
struct QkvResident {
  const T *qkv, *bias;
  const float* mask;
  T* out;
  float* probs;
  Params p;
  size_t smem;
  unsigned blocks;
  cudaStream_t stream;

  template <typename K>
  int go(K kernel) const {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kThreads, smem, stream>>>(qkv, bias, mask, out, probs, p);
    return (int)cudaGetLastError();
  }

  template <int DM>
  int operator()() const {
    return probs ? go(qkv_resident_kernel<T, DM, true>)
                 : go(qkv_resident_kernel<T, DM, false>);
  }
};

// Rows 1-2 at T <= 64 and heads of up to 64 (qkv_fwd.cuh): the forward
// with its bias and, where probs is not null, row 2's probs, under the plan
// (heads, nbuf, blocks) of ops/fused_attention.py:fwd_launch_plan; refuses
// a shape or plan the kernel does not take.
template <typename T>
int qkv_resident_launch(const void* qkv, const void* bias, const void* mask,
                        void* out, void* probs, int n, int t_len,
                        int n_heads, int d_head, int heads, int nbuf,
                        int blocks, void* stream) {
  const int esize = (int)sizeof(T);
  if (t_len > kShortT || heads < 1 || heads > 4 || heads > n_heads ||
      nbuf < 1 || nbuf > 2 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout_of(kFwd, t_len, d_head, esize, heads, t_len);
  const size_t smem = nbuf * lay.stage + lay.rows;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const Params p = params_of(kFwd, n, t_len, n_heads, d_head, esize, heads,
                             t_len, nbuf, qkv, qkv);
  if (p.items == 0) return (int)cudaErrorInvalidConfiguration;
  return with_head_width(
      d_head, QkvResident<T>{static_cast<const T*>(qkv),
                             static_cast<const T*>(bias),
                             static_cast<const float*>(mask),
                             static_cast<T*>(out), static_cast<float*>(probs),
                             p, smem,
                             (unsigned)(blocks < p.items ? blocks : p.items),
                             (cudaStream_t)stream});
}

// Row 16 at T <= 64 (blanes.cu) and row 14's attention part there
// (fused_tail_bwd.cu): blanes_bwd_kernel under the plan (heads, nbuf,
// blocks) of ops/experimental_blanes.py:launch_plan; refuses a shape or
// plan the kernel does not take.
template <typename T>
struct BwdShort {
  const T *qkv, *g;
  const float* mask;
  T* dqkv;
  Params p;
  size_t smem;
  unsigned blocks;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    const cudaError_t err = cudaFuncSetAttribute(
        blanes_bwd_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    blanes_bwd_kernel<T, DM><<<blocks, kThreads, smem, stream>>>(
        qkv, mask, g, dqkv, p);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int bwd_short_launch(const void* qkv, const void* mask, const void* g,
                     void* dqkv, int n, int t_len, int n_heads, int d_head,
                     int heads, int nbuf, int blocks, void* stream) {
  const int esize = (int)sizeof(T);
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  if (t_len > kShortT || heads < 1 || heads > 4 || heads > n_heads ||
      nbuf < 1 || nbuf > 2 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout_of(kBwd, t_len, d_head, esize, heads, t_len);
  const size_t smem = nbuf * lay.stage + lay.rows;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const Params p = params_of(kBwd, n, t_len, n_heads, d_head, esize, heads,
                             t_len, nbuf, qkv, g);
  if (p.items == 0) return (int)cudaErrorInvalidConfiguration;
  return with_head_width(
      d_head, BwdShort<T>{static_cast<const T*>(qkv), static_cast<const T*>(g),
                          static_cast<const float*>(mask),
                          static_cast<T*>(dqkv), p, smem,
                          (unsigned)(blocks < p.items ? blocks : p.items),
                          (cudaStream_t)stream});
}

}  // namespace bl
}  // namespace nrk
