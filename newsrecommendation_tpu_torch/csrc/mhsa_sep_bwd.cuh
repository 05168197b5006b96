// Kernel rows 6 and 8 (the backward of exp-MHSA on separate q, k, v,
// unmasked and key-masked) in the two regimes that carry them on an H100;
// the wide route past both, and the contract, are in mhsa_sep.cu.
//
//   resident (T <= 64, f32 and bf16, heads of up to 64): row 16's resident
//     design (blanes.cu) on three base pointers and two widths. An item is
//     one batch row and a group of up to four heads over every query; the
//     grid holds at most as many blocks as fit on the card, each walking
//     its items and copying the next item's q, k, v and g in by cp.async
//     (16, 8 or 4 bytes, as the widths, row strides and base addresses
//     allow) while it computes the current one. Operands are staged in
//     their own dtype, every head padded to one width (the larger of d_k
//     and d_v, to 16 bytes) and rows an odd number of 16-byte units apart;
//     bf16 K and V are widened to f32 once per item. One warp per (head,
//     query): a lane keeps its two keys' scores in registers through m,
//     den, a, da, r and ds (keys in lane order, then the xor tree, the
//     plain order), and writes its row of round(a) and of ds once. Then
//     dq, dk (per head, query pair and four q/k lanes) and dv (per head,
//     key pair and four v lanes) are summed over threads, each sum in
//     index order.
//   tensor cores (T > 64, bf16, both widths up to 64): row 4's design
//     (qkv_bwd_mma.cuh) on three base pointers and two widths, without its
//     bias pass. A query-side kernel (a block per (row, head) and tile of
//     64 or 128 queries, a warp 16) walks the keys in staged chunks four
//     times: m over ALL keys, den, r = sum da a, then ds and dq; it writes
//     m, den and r to a (3, N*H, T) scratch. A key-side kernel (a block per
//     (row, head) and tile of keys) stages Q, g and the queries' m, den,
//     1/den and r per chunk and sums dv += round(a)^T g, dk += round(ds)^T
//     Q. mma.sync.m16n8k16 through mma.cuh, bf16 in, f32 sums; a = e / den
//     from a per-row reciprocal and one fma (flash.cuh div_by); no
//     atomics, every sum in a fixed order. Heads are staged at one padded
//     width (flash.cuh's layouts at the larger of d_k and d_v), so a head
//     of d_k = 20 beside d_v = 32 takes the k-steps and d tiles of 32, its
//     pads zero.
//
// The launch plans are chosen in Python (ops/fused_attention.py
// sep_bwd_launch_plan): the resident one lays a block out as row 16's
// backward at the larger width and takes the heads and buffers that leave
// room for the most blocks an SM (three, by the kernel's registers); the
// tensor-core one is row 4's.
#pragma once

#include "qkv_bwd_mma.cuh"  // flash.cuh, mma.cuh, quad_sum, quad_max

#include <type_traits>

namespace nrk {
namespace sep {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kShortT = 64;   // longest T of the resident regime
constexpr int kMaxHead = 64;  // widest head of both regimes
constexpr int kMaxSmem = 232448;

enum Regime { kResident = 0, kMma = 1, kWide = 2 };

// The regime of (T, d_k, d_v) in a dtype of esize bytes.
__host__ __device__ inline int regime(int t_len, int dk, int dv, int esize) {
  const int dmax = dk > dv ? dk : dv;
  if (dmax > kMaxHead) return kWide;
  if (t_len <= kShortT) return kResident;
  return esize == 2 ? kMma : kWide;
}

// Bytes of a staged row of `heads` heads of d elements, each padded to a
// whole number of `ve` elements held at `width` bytes, the row padded to
// an odd number of 16-byte units (blanes.cu row_bytes).
inline int row_bytes(int d, int ve, int heads, int width) {
  const int rb = heads * ((d + ve - 1) / ve * ve) * width;
  return (rb / 16) % 2 == 0 ? rb + 16 : rb;
}

// Shared bytes of a resident block: nbuf buffers of Q, K, V, g [T rows];
// bf16: f32 copies of K and V; round(a) and ds, each (heads, T, T|1) f32.
inline size_t resident_smem(int t_len, int dmax, int esize, int heads,
                            int nbuf) {
  const size_t rb = row_bytes(dmax, 16 / esize, heads, esize);
  const size_t wide = esize == 2 ? row_bytes(dmax, 16 / esize, heads, 4) : 0;
  const size_t tt = (size_t)heads * t_len * (t_len | 1) * 4;
  return nbuf * 4 * (size_t)t_len * rb + 2 * (size_t)t_len * wide + 2 * tt;
}

// ---- resident (T <= 64) --------------------------------------------------

struct ResParams {
  int t, h, dk, dv;        // positions, heads, widths of q/k and of v/g
  int ldq, ldk, ldv;       // row strides of q, k, v (elements)
  int heads, groups;       // heads of an item; head groups of a batch row
  int items, nbuf;         // rows x groups; stage buffers
  int dp, rs, rsf;         // padded head width, staged row stride, f32 copy
  int ck, cv;              // bytes of one async copy of q/k, of v/g rows
  size_t stage;            // bytes of one stage buffer
  float inv_s, inv;        // the scale of s, and of ds
};

struct Item {
  int64_t n;
  int h0, gn;  // first head, heads
};

__device__ __forceinline__ Item item_of(const ResParams& p, int item) {
  Item it;
  it.n = item / p.groups;
  it.h0 = (item - (int)it.n * p.groups) * p.heads;
  it.gn = min(p.heads, p.h - it.h0);
  return it;
}

// Rows [row0, row0 + T) of x (rows ld elements apart), the d lanes of
// heads h0 .. h0 + gn - 1 (head h at lanes h*d), into dst[r*rs + hl*dp
// ...], by cp.async pieces of `piece` bytes (element stores when 0). Each
// thread keeps one piece of a row and walks the rows.
template <typename T>
__device__ __forceinline__ void stage_heads(T* dst, const T* __restrict__ x,
                                            int64_t row0, int64_t ld, int h0,
                                            int gn, int d, int piece,
                                            const ResParams& p) {
  const int step = piece ? piece / (int)sizeof(T) : 1;  // elements
  const int per = d / step;
  const int cols = gn * per;
  const int rstep = kThreads / cols;
  const int r0 = threadIdx.x / cols;
  if (r0 >= rstep) return;
  const int col = threadIdx.x - r0 * cols;
  const int hl = col / per;
  const int e = (col - hl * per) * step;
  const T* src = x + row0 * ld + (int64_t)(h0 + hl) * d + e;
  T* to = dst + hl * p.dp + e;
  for (int r = r0; r < p.t; r += rstep) {
    if (piece == 16) cp_async<16>(to + r * p.rs, src + r * ld);
    else if (piece == 8) cp_async<8>(to + r * p.rs, src + r * ld);
    else if (piece == 4) cp_async<4>(to + r * p.rs, src + r * ld);
    else to[r * p.rs] = src[r * ld];
  }
}

// An f32 copy of T staged rows (gn heads, pads included) into dst, rows
// rsf floats apart, with the stage's head offsets.
template <typename T>
__device__ __forceinline__ void widen(float* dst, const T* src, int gn,
                                      const ResParams& p) {
  const int cols = gn * p.dp;
  const int rstep = kThreads / cols;
  const int r0 = threadIdx.x / cols;
  if (r0 >= rstep) return;
  const int col = threadIdx.x - r0 * cols;
  for (int r = r0; r < p.t; r += rstep)
    dst[r * p.rsf + col] = to_f32(src[r * p.rs + col]);
}

// Walks this block's items: item k's operands are staged (stage(item,
// buffer)) while item k - 1 is computed when there are two buffers. The
// stage buffers are zeroed first: the pads past each width are never
// copied.
template <typename Stage, typename Compute>
__device__ __forceinline__ void run_items(const ResParams& p,
                                          unsigned char* smem, Stage stage,
                                          Compute compute) {
  const uint4 zero = {0u, 0u, 0u, 0u};
  for (size_t i = threadIdx.x * 16; i < p.nbuf * p.stage; i += kThreads * 16)
    *reinterpret_cast<uint4*>(smem + i) = zero;
  __syncthreads();
  int item = blockIdx.x;
  int b = 0;
  if (item < p.items) stage(item, 0);
  cp_commit();
  for (; item < p.items; item += gridDim.x) {
    const int next = item + gridDim.x;
    if (p.nbuf == 2) {
      if (next < p.items) stage(next, b ^ 1);
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
    } else if (next < p.items) {
      stage(next, 0);
      cp_commit();
    }
  }
  cp_wait<0>();
}

// 16 staged bytes at x (16-byte aligned) as floats
__device__ __forceinline__ void load_chunk(const float* x, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(x);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* x, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(x);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// A staged head row as DM floats (its zero pads included, 0 past them).
template <typename T, int DM>
__device__ __forceinline__ void load_vec(float* x, const T* row, int d) {
  constexpr int VE = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < DM / VE; ++c) {
    if (c * VE < d) {
      load_chunk(row + c * VE, x + c * VE);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) x[c * VE + e] = 0.f;
    }
  }
}

// x . row in d order (the pads add exact zeros).
template <typename K, int DM>
__device__ __forceinline__ float dot_vec(const float* x, const K* row, int d) {
  constexpr int VE = 16 / sizeof(K);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DM / VE; ++c) {
    if (c * VE < d) {
      float f[VE];
      load_chunk(row + c * VE, f);
#pragma unroll
      for (int e = 0; e < VE; ++e) acc = fmaf(x[c * VE + e], f[e], acc);
    }
  }
  return acc;
}

// Four neighbouring staged elements (an offset a multiple of four) as
// floats.
__device__ __forceinline__ void load_quad(const float* x, float* f) {
  load_chunk(x, f);
}

__device__ __forceinline__ void load_quad(const __nv_bfloat16* x, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(x);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}

// The max over a warp in one redux.sync: floats mapped to integers of the
// same order (a max is exact in any order).
__device__ __forceinline__ float redux_max(float v) {
  const int b = __float_as_int(v);
  const int key = __reduce_max_sync(0xffffffffu, b ^ ((b >> 31) & 0x7fffffff));
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

// One warp, one query: the lane's two scores (keys lane and lane + 32)
// stay in registers through m, den, a, da, r and ds; the rows of round(a)
// and of ds (rounded to T) go to arow and dsrow. Keys at ks (q . k over
// d_k), values at vs (g . v over d_v), rows krs apart.
template <typename T, typename K, int DM>
__device__ __forceinline__ void a_ds_row(float* arow, float* dsrow,
                                         const T* qrow, const T* grow,
                                         const K* ks, const K* vs, int krs,
                                         const float* mrow,
                                         const ResParams& p, int lane) {
  constexpr int NS = (kShortT + 31) / 32;
  float x[NS], mx = -INFINITY, sum = 0.f;
  {
    float qf[DM];
    load_vec<T, DM>(qf, qrow, p.dk);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = lane + 32 * k;
      x[k] = 0.f;
      if (j < p.t) {
        x[k] = __fmul_rn(dot_vec<K, DM>(qf, ks + j * krs, p.dk), p.inv_s);
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
    if (lane + 32 * k < p.t) x[k] = den > 0.f ? x[k] / den : 0.f;
  float gf[DM], da[NS], part = 0.f;
  load_vec<T, DM>(gf, grow, p.dv);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int j = lane + 32 * k;
    da[k] = 0.f;
    if (j < p.t) {
      da[k] = dot_vec<K, DM>(gf, vs + j * krs, p.dv);
      part = __fadd_rn(part, __fmul_rn(da[k], x[k]));
    }
  }
  const float r = warp_sum(part);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int j = lane + 32 * k;
    if (j < p.t) {
      dsrow[j] = round_to<T>((da[k] - r) * x[k] * p.inv);
      arow[j] = round_to<T>(x[k]);
    }
  }
}

// T <= 64: phase 1, one warp per (head, query), writes the rows of
// round(a) and ds into the item's (heads, T, T|1) arrays; phase 2 sums
// dq, dk and dv over threads, each sum in index order.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads, 3)
sep_bwd_resident_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ mask,
                        const T* __restrict__ g, T* __restrict__ dq,
                        T* __restrict__ dk, T* __restrict__ dv, ResParams p) {
  extern __shared__ __align__(16) unsigned char sep_smem[];
  unsigned char* smem = sep_smem;
  constexpr bool kWiden = sizeof(T) == 2;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int hdk = p.h * p.dk, hdv = p.h * p.dv;
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
    const int64_t row0 = it.n * p.t;
    const int part = p.t * p.rs;
    stage_heads(s, q, row0, p.ldq, it.h0, it.gn, p.dk, p.ck, p);
    stage_heads(s + part, k, row0, p.ldk, it.h0, it.gn, p.dk, p.ck, p);
    stage_heads(s + 2 * part, v, row0, p.ldv, it.h0, it.gn, p.dv, p.cv, p);
    stage_heads(s + 3 * part, g, row0, hdv, it.h0, it.gn, p.dv, p.cv, p);
  };
  auto compute = [&](int item, int b) {
    const Item it = item_of(p, item);
    const T* qs = reinterpret_cast<const T*>(smem + b * p.stage);
    const T* ks = qs + p.t * p.rs;
    const T* vs = ks + p.t * p.rs;
    const T* gs = vs + p.t * p.rs;
    const float* mrow = mask ? mask + it.n * p.t : nullptr;
    if constexpr (kWiden) {
      widen(kf, ks, it.gn, p);
      widen(vf, vs, it.gn, p);
      __syncthreads();
    }
    using K = typename std::conditional<kWiden, float, T>::type;
    const K* keys = kWiden ? (const K*)kf : (const K*)ks;
    const K* vals = kWiden ? (const K*)vf : (const K*)vs;
    const int krs = kWiden ? p.rsf : p.rs;
    for (int task = warp; task < it.gn * p.t; task += kWarps) {
      const int hl = task / p.t;
      const int i = task - hl * p.t;
      const int at = i * p.rs + hl * p.dp;
      a_ds_row<T, K, DM>(ats + hl * tt + i * as, dss + hl * tt + i * as,
                         qs + at, gs + at, keys + hl * p.dp,
                         vals + hl * p.dp, krs, mrow, p, lane);
    }
    __syncthreads();  // every row of a and ds is written
    // dq[x] = sum_j ds[x, j] k[j] and dk[x] = sum_j ds[j, x] q[j] over the
    // d_k lanes, dv[x] = sum_j round(a)[j, x] g[j] over the d_v lanes: a
    // thread takes a pair of rows x and four lanes, each sum in j order
    const int kq = (p.dk + 3) / 4, vq = (p.dv + 3) / 4;
    const int xp = (p.t + 1) / 2;
    const int n_qk = it.gn * xp * kq;
    const int n_all = n_qk + it.gn * xp * vq;
    const int64_t r0 = it.n * p.t;
    for (int idx = threadIdx.x; idx < n_all; idx += kThreads) {
      const bool qk = idx < n_qk;
      const int quads = qk ? kq : vq;
      const int rel = qk ? idx : idx - n_qk;
      const int dqi = rel % quads;
      const int rest_x = rel / quads;
      const int x0 = rest_x % xp * 2;
      const int x1 = min(x0 + 1, p.t - 1);
      const int hl = rest_x / xp;
      const int d = dqi * 4;
      const int col = hl * p.dp + d;
      const int rows = x0 + 1 < p.t ? 2 : 1;
      if (qk) {
        const float* dsh = dss + hl * tt;
        float sq[2][4] = {}, sk[2][4] = {};
        for (int j = 0; j < p.t; ++j) {
          float kk[4], qq[4];
          load_quad(ks + j * p.rs + col, kk);
          load_quad(qs + j * p.rs + col, qq);
          const float ds0 = dsh[x0 * as + j], ds1 = dsh[x1 * as + j];
          const float dt0 = dsh[j * as + x0], dt1 = dsh[j * as + x1];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sq[0][e] = fmaf(ds0, kk[e], sq[0][e]);
            sq[1][e] = fmaf(ds1, kk[e], sq[1][e]);
            sk[0][e] = fmaf(dt0, qq[e], sk[0][e]);
            sk[1][e] = fmaf(dt1, qq[e], sk[1][e]);
          }
        }
        for (int r = 0; r < rows; ++r) {
          const int64_t o =
              (r0 + x0 + r) * hdk + (int64_t)(it.h0 + hl) * p.dk + d;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (d + e < p.dk) {
              dq[o + e] = from_f32<T>(sq[r][e]);
              dk[o + e] = from_f32<T>(sk[r][e]);
            }
        }
      } else {
        const float* ah = ats + hl * tt;
        float sv[2][4] = {};
        for (int j = 0; j < p.t; ++j) {
          float gg[4];
          load_quad(gs + j * p.rs + col, gg);
          const float a0 = ah[j * as + x0], a1 = ah[j * as + x1];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sv[0][e] = fmaf(a0, gg[e], sv[0][e]);
            sv[1][e] = fmaf(a1, gg[e], sv[1][e]);
          }
        }
        for (int r = 0; r < rows; ++r) {
          const int64_t o =
              (r0 + x0 + r) * hdv + (int64_t)(it.h0 + hl) * p.dv + d;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (d + e < p.dv) dv[o + e] = from_f32<T>(sv[r][e]);
        }
      }
    }
  };
  run_items(p, smem, stage, compute);
}

template <typename T>
struct ResidentLaunch {
  const T *q, *k, *v, *g;
  const float* mask;
  T *dq, *dk, *dv;
  ResParams p;
  size_t smem;
  unsigned blocks;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    auto* kernel = sep_bwd_resident_kernel<T, DM>;
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != (int)cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, stream>>>(q, k, v, mask, g, dq, dk, dv,
                                               p);
    return (int)cudaGetLastError();
  }
};

// One launch of the resident plan (heads, nbuf, blocks); refuses a plan
// the kernel does not take.
template <typename T>
int resident_launch(const void* q, const void* k, const void* v,
                    const void* mask, const void* g, void* dq, void* dk,
                    void* dv, int n, int t_len, int n_heads, int dk_w,
                    int dv_w, int ldq, int ldk, int ldv, int heads, int nbuf,
                    int blocks, void* stream) {
  const int esize = (int)sizeof(T);
  const int dmax = dk_w > dv_w ? dk_w : dv_w;
  if (heads < 1 || heads > 4 || heads > n_heads || nbuf < 1 || nbuf > 2 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = resident_smem(t_len, dmax, esize, heads, nbuf);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  ResParams p;
  p.t = t_len;
  p.h = n_heads;
  p.dk = dk_w;
  p.dv = dv_w;
  p.ldq = ldq;
  p.ldk = ldk;
  p.ldv = ldv;
  p.heads = heads;
  p.groups = (n_heads + heads - 1) / heads;
  const int64_t items = (int64_t)n * p.groups;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  p.items = (int)items;
  p.nbuf = nbuf;
  const int ve = 16 / esize;
  p.dp = (dmax + ve - 1) / ve * ve;
  p.rs = row_bytes(dmax, ve, heads, esize) / esize;
  p.rsf = row_bytes(dmax, ve, heads, 4) / 4;
  const void* qk[2] = {q, k};
  const void* vg[2] = {v, g};
  p.ck = flash_piece(dk_w, esize, ldq, ldk, qk, 2);
  p.cv = flash_piece(dv_w, esize, ldv, n_heads * dv_w, vg, 2);
  p.stage = 4 * (size_t)t_len * row_bytes(dmax, ve, heads, esize);
  // the forward's scale of s; ds's 1/sqrt(d_k) rounded once from double,
  // as the plain version's scalar is
  p.inv_s = 1.0f / sqrtf((float)dk_w);
  p.inv = (float)(1.0 / sqrt((double)dk_w));
  const ResidentLaunch<T> body{
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(mask), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), p, smem,
      (unsigned)(blocks < p.items ? blocks : p.items), (cudaStream_t)stream};
  return with_head_width(dmax, body);
}

// ---- tensor cores (T > 64, bf16) -------------------------------------------

struct MmaParams {
  int h, t, dk, dv;     // heads, positions, widths of q/k and of v/g
  int ldq, ldk, ldv;    // row strides of q, k, v (elements)
  int tile, chunk;      // own rows of a block; rows of one stage
  int nbuf;             // stage buffers
  int rs;               // staged row stride (elements)
  int pk, pv;           // bytes of one async copy of q/k, of v/g rows
  int own, stage;       // bytes of the block's own rows, of one buffer
  float inv_s, inv;     // the scale of s, and of ds
  int64_t plane;        // floats of one stats plane: N*H*T
};

// The query side: passes 0 max, 1 den, 2 r, 3 ds and dq over all keys.
template <int DM, bool kMask>
__global__ void __launch_bounds__(256, 3)
sep_bwd_query_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ g,
                     __nv_bfloat16* __restrict__ dq,
                     float* __restrict__ stats, MmaParams p) {
  using T = __nv_bfloat16;
  constexpr int KS = (DM + 15) / 16;
  constexpr int ND = (DM + 7) / 8;
  extern __shared__ __align__(16) unsigned char sep_mma_smem[];
  unsigned char* smem = sep_mma_smem;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tq = lane % 4;
  const int row = blockIdx.x / p.h;
  const int h = blockIdx.x - row * p.h;
  const int hdk = p.h * p.dk, hdv = p.h * p.dv;
  const int i0 = blockIdx.y * p.tile;  // the tile's first query
  const int nq = min(p.tile, p.t - i0);
  const int q0 = warp * 16;  // the warp's first query in the tile
  const bool active = q0 < nq;
  const int64_t first = (int64_t)row * p.t;  // the row's position 0
  const T* qh = q + first * p.ldq + h * p.dk;
  const T* kh = k + first * p.ldk + h * p.dk;
  const T* vh = v + first * p.ldv + h * p.dv;
  const T* gh = g + first * hdv + h * p.dv;
  const int64_t item = (int64_t)row * p.h + h;
  const float* mrow = kMask ? mask + first : nullptr;
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = qs + p.tile * p.rs;
  auto kbuf = [&](int b) {
    return reinterpret_cast<T*>(smem + p.own + (size_t)b * p.stage);
  };
  const int nc = (p.t + p.chunk - 1) / p.chunk;

  zero_smem(smem, p.own + (size_t)p.nbuf * p.stage);
  auto stage = [&](int task, int b) {
    const int j0 = task % nc * p.chunk;
    const int nj = min(p.chunk, p.t - j0);
    T* ks = kbuf(b);
    stage_rows(ks, p.rs, kh + (int64_t)j0 * p.ldk, p.ldk, nj, p.dk, p.pk);
    stage_rows(ks + p.chunk * p.rs, p.rs, vh + (int64_t)j0 * p.ldv, p.ldv,
               nj, p.dv, p.pv);
    if (kMask)
      stage_floats(reinterpret_cast<float*>(ks + 2 * p.chunk * p.rs),
                   mrow + j0, nj, 1);
  };
  stage_rows(qs, p.rs, qh + (int64_t)i0 * p.ldq, p.ldq, nq, p.dk, p.pk);
  stage_rows(gs, p.rs, gh + (int64_t)i0 * hdv, hdv, nq, p.dv, p.pv);
  stage(0, 0);

  unsigned qa[KS][4], ga[KS][4];
  // the lane's rows are queries q0 + lane / 4 and q0 + lane / 4 + 8
  float mi[2] = {0.f, 0.f}, deni[2] = {0.f, 0.f}, rcpi[2] = {0.f, 0.f};
  float ri[2] = {0.f, 0.f};
  float acc[2] = {-INFINITY, -INFINITY};  // the pass's partial max or sum
  float dqt[ND][4] = {};

  auto compute = [&](int task, int b) {
    if (!active) return;
    const int pass = task / nc;
    const int c = task % nc;
    const int j0 = c * p.chunk;
    const int nj = min(p.chunk, p.t - j0);
    const T* ks = kbuf(b);
    const T* vs = ks + p.chunk * p.rs;
    if (task == 0) {
      load_a<KS>(qa, qs, p.rs, q0, nq, lane);
      load_a<KS>(ga, gs, p.rs, q0, nq, lane);
    }
    if (c == 0 && task > 0) {  // the previous pass is complete
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (pass == 1) {
          mi[r] = quad_max(acc[r]);
        } else if (pass == 2) {
          deni[r] = quad_sum(acc[r]) + kEps * expf(-mi[r]);
          rcpi[r] = rcp_or_zero(deni[r]);
        } else {
          ri[r] = quad_sum(acc[r]);
        }
        acc[r] = 0.f;
      }
    }
    const float* mk = reinterpret_cast<const float*>(vs + p.chunk * p.rs);
    for_steps(nj, [&](int j, auto edge) {
      // element e: query row (e % 4) / 2, key j + 8 (e / 4) + 2 tq + e % 2
      float s[8], da[8];
      mma_rows<KS>(s, qa, ks, p.rs, j, nj, p.inv_s, lane);
      mma_rows<KS>(s + 4, qa, ks, p.rs, j + 8, nj, p.inv_s, lane);
      if (pass >= 2) {
        mma_rows<KS>(da, ga, vs, p.rs, j, nj, 1.f, lane);
        mma_rows<KS>(da + 4, ga, vs, p.rs, j + 8, nj, 1.f, lane);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = e % 4 / 2;
        const int kj = j + 8 * (e / 4) + 2 * tq + e % 2;  // in the chunk
        bool in = true;
        if constexpr (decltype(edge)::value) in = kj < nj;
        if (pass == 0) {  // clamped keys repeat the last one
          acc[r] = fmaxf(acc[r], s[e]);
          continue;
        }
        float x = expf(s[e] - mi[r]);
        if (kMask) x = x * mk[min(kj, nj - 1)];
        if (pass == 1) {
          acc[r] += in ? x : 0.f;
          continue;
        }
        float a = div_by(x, deni[r], rcpi[r]);
        if (!in) a = 0.f;
        if (pass == 2) {
          acc[r] += da[e] * a;
        } else {
          s[e] = in ? (da[e] - ri[r]) * a * p.inv : 0.f;
        }
      }
      if (pass == 3) {
        unsigned pd[4];
        pack_a(pd, s);  // ds in k's dtype
        mma_acc<ND>(dqt, pd, ks, p.rs, j, nj, lane);
      }
    });
  };
  walk_tasks(4 * nc, p.nbuf, stage, compute);
  if (!active) return;
  if (tq == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + lane / 4 + 8 * r;
      if (qi < nq) {
        const int64_t at = item * p.t + i0 + qi;
        stats[at] = mi[r];
        stats[p.plane + at] = deni[r];
        stats[2 * p.plane + at] = ri[r];
      }
    }
  store_tiles<ND>(dq + h * p.dk, first + i0, hdk, dqt, q0, nq, p.dk, lane);
}

// The key side: dk and dv of a tile of keys over all queries.
template <int DM, bool kMask>
__global__ void __launch_bounds__(256)
sep_bwd_key_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ mask,
                   const __nv_bfloat16* __restrict__ g,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv,
                   const float* __restrict__ stats, MmaParams p) {
  using T = __nv_bfloat16;
  constexpr int KS = (DM + 15) / 16;
  constexpr int ND = (DM + 7) / 8;
  extern __shared__ __align__(16) unsigned char sep_mma_smem[];
  unsigned char* smem = sep_mma_smem;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tq = lane % 4;
  const int row = blockIdx.x / p.h;
  const int h = blockIdx.x - row * p.h;
  const int hdk = p.h * p.dk, hdv = p.h * p.dv;
  const int j0 = blockIdx.y * p.tile;  // the tile's first key
  const int nk = min(p.tile, p.t - j0);
  const int k0 = warp * 16;  // the warp's first key in the tile
  const bool active = k0 < nk;
  const int64_t first = (int64_t)row * p.t;
  const T* qh = q + first * p.ldq + h * p.dk;
  const T* kh = k + first * p.ldk + h * p.dk;
  const T* vh = v + first * p.ldv + h * p.dv;
  const T* gh = g + first * hdv + h * p.dv;
  const int64_t sbase = ((int64_t)row * p.h + h) * p.t;  // stats
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + p.tile * p.rs;
  auto qbuf = [&](int b) {
    return reinterpret_cast<T*>(smem + p.own + (size_t)b * p.stage);
  };

  zero_smem(smem, p.own + (size_t)p.nbuf * p.stage);
  auto stage = [&](int c, int b) {
    const int i0 = c * p.chunk;
    const int ni = min(p.chunk, p.t - i0);
    T* qs = qbuf(b);
    stage_rows(qs, p.rs, qh + (int64_t)i0 * p.ldq, p.ldq, ni, p.dk, p.pk);
    stage_rows(qs + p.chunk * p.rs, p.rs, gh + (int64_t)i0 * hdv, hdv, ni,
               p.dv, p.pv);
    // per query: m, den, 1/den, r
    float* st = reinterpret_cast<float*>(qs + 2 * p.chunk * p.rs);
    const int64_t at = sbase + i0;
    stage_floats(st, stats + at, ni, 1);
    stage_floats(st + 3 * p.chunk, stats + 2 * p.plane + at, ni, 1);
    for (int i = threadIdx.x; i < ni; i += blockDim.x) {
      const float dn = stats[p.plane + at + i];
      st[p.chunk + i] = dn;
      st[2 * p.chunk + i] = rcp_or_zero(dn);
    }
  };
  stage_rows(ks, p.rs, kh + (int64_t)j0 * p.ldk, p.ldk, nk, p.dk, p.pk);
  stage_rows(vs, p.rs, vh + (int64_t)j0 * p.ldv, p.ldv, nk, p.dv, p.pv);
  stage(0, 0);

  unsigned ka[KS][4], va[KS][4];
  // the lane's rows are keys k0 + lane / 4 and k0 + lane / 4 + 8, clamped
  // in the tile
  float mk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mk[r] = kMask ? mask[first + j0 + min(k0 + lane / 4 + 8 * r, nk - 1)]
                  : 1.f;
  float dkt[ND][4] = {}, dvt[ND][4] = {};
  auto compute = [&](int c, int b) {
    if (!active) return;
    const int i0 = c * p.chunk;
    const int ni = min(p.chunk, p.t - i0);
    const T* qs = qbuf(b);
    if (c == 0) {
      load_a<KS>(ka, ks, p.rs, k0, nk, lane);
      load_a<KS>(va, vs, p.rs, k0, nk, lane);
    }
    const T* gs = qs + p.chunk * p.rs;
    const float* ms = reinterpret_cast<const float*>(gs + p.chunk * p.rs);
    const float* dens = ms + p.chunk;
    const float* rcps = dens + p.chunk;
    const float* rss = rcps + p.chunk;
    for_steps(ni, [&](int i, auto edge) {
      float ar[8], ds[8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s[4], da[4];  // (key, query) elements
        mma_rows<KS>(s, ka, qs, p.rs, i + 8 * half, ni, p.inv_s, lane);
        mma_rows<KS>(da, va, gs, p.rs, i + 8 * half, ni, 1.f, lane);
        const int qi = i + 8 * half + 2 * tq;  // queries qi, qi + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int odd = e % 2;
          const int qc = min(qi + odd, ni - 1);  // clamped in the chunk
          float x = expf(s[e] - ms[qc]);
          if (kMask) x = x * mk[e / 2];
          float a = div_by(x, dens[qc], rcps[qc]);
          float d_s = (da[e] - rss[qc]) * a * p.inv;
          if constexpr (decltype(edge)::value) {  // clamped rows: no query
            if (qi + odd >= ni) a = d_s = 0.f;
          }
          ar[4 * half + e] = a;
          ds[4 * half + e] = d_s;
        }
      }
      unsigned pa[4], pd[4];
      pack_a(pa, ar);  // a in g's dtype
      pack_a(pd, ds);  // ds in k's dtype
      mma_acc<ND>(dvt, pa, gs, p.rs, i, ni, lane);
      mma_acc<ND>(dkt, pd, qs, p.rs, i, ni, lane);
    });
  };
  walk_tasks((p.t + p.chunk - 1) / p.chunk, p.nbuf, stage, compute);
  if (!active) return;
  store_tiles<ND>(dk + h * p.dk, first + j0, hdk, dkt, k0, nk, p.dk, lane);
  store_tiles<ND>(dv + h * p.dv, first + j0, hdv, dvt, k0, nk, p.dv, lane);
}

struct MmaLaunch {
  const __nv_bfloat16 *q, *k, *v, *g;
  const float* mask;
  __nv_bfloat16 *dq, *dk, *dv;
  float* stats;
  int n, t_len, n_heads, dk_w, dv_w, ldq, ldk, ldv;
  int q_tile, q_chunk, q_nbuf, k_tile, k_chunk, k_nbuf;
  cudaStream_t stream;

  template <typename K, typename... A>
  int go(K kernel, dim3 grid, int threads, size_t smem, A... args) const {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, threads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
  }

  // a side's parameters: its layout is flash.cuh's `kind` at the larger
  // of the two widths
  MmaParams params(int kind, int tile, int chunk, int nbuf, int pk,
                   int pv) const {
    const int dmax = dk_w > dv_w ? dk_w : dv_w;
    const FlashLayout l = flash_layout(kind, dmax, 2, tile, chunk);
    return MmaParams{n_heads, t_len, dk_w, dv_w, ldq, ldk, ldv, tile, chunk,
                     nbuf, flash_row_elems(dmax), pk, pv, (int)l.own,
                     (int)l.stage, 1.0f / sqrtf((float)dk_w),
                     (float)(1.0 / sqrt((double)dk_w)),
                     (int64_t)n * n_heads * t_len};
  }

  template <int DM, bool kMask>
  int run() const {
    const int64_t rows = (int64_t)n * n_heads;
    const int q_tiles = (t_len + q_tile - 1) / q_tile;
    const int k_tiles = (t_len + k_tile - 1) / k_tile;
    if (rows > 0x7fffffff || q_tiles > 65535 || k_tiles > 65535)
      return (int)cudaErrorInvalidConfiguration;
    const void* qk[2] = {q, k};
    const void* vg[2] = {v, g};
    const int pk = flash_piece(dk_w, 2, ldq, ldk, qk, 2);
    const int pv = flash_piece(dv_w, 2, ldv, n_heads * dv_w, vg, 2);
    const MmaParams qp =
        params(kFlashBwdQuery, q_tile, q_chunk, q_nbuf, pk, pv);
    const MmaParams kp = params(kFlashBwdKey, k_tile, k_chunk, k_nbuf, pk, pv);
    int err = go(sep_bwd_query_kernel<DM, kMask>,
                 dim3((unsigned)rows, (unsigned)q_tiles), 2 * q_tile,
                 qp.own + q_nbuf * (size_t)qp.stage, q, k, v, mask, g, dq,
                 stats, qp);
    if (err != (int)cudaSuccess) return err;
    return go(sep_bwd_key_kernel<DM, kMask>,
              dim3((unsigned)rows, (unsigned)k_tiles), 2 * k_tile,
              kp.own + k_nbuf * (size_t)kp.stage, q, k, v, mask, g, dk, dv,
              (const float*)stats, kp);
  }

  template <int DM>
  int operator()() const {
    return mask ? run<DM, true>() : run<DM, false>();
  }
};

// Whether a tensor-core plan (tile, chunk, nbuf of each side) is one the
// kernels take: flash.cuh's check of the backward's sides at the larger
// width.
inline bool mma_plan_ok(int dmax, int q_tile, int q_chunk, int q_nbuf,
                        int k_tile, int k_chunk, int k_nbuf) {
  return flash_plan_ok(kFlashBwdQuery, dmax, 2, q_tile, q_chunk, q_nbuf) &&
         flash_plan_ok(kFlashBwdKey, dmax, 2, k_tile, k_chunk, k_nbuf);
}

}  // namespace sep
}  // namespace nrk
