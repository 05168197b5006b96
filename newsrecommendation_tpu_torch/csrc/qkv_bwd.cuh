// Backward of the exp-normalised multi-head self-attention over a fused
// [q|k|v] projection: one kernel template for two TPU kernels of
// newsrecommendation_tpu/ops/pallas/fused_attention.py,
//   _qkv_bwd_probs_kernel (row 3, _qkv_bwd_probs_call): a read from the f32
//       probs the forward saved (qkv_bwd_probs.cu, kRecompute = false);
//   _qkv_bwd_kernel (row 4, _qkv_bwd_call): a recomputed from qkv, bias
//       and the key mask as the forward computes it (qkv_bwd.cu,
//       kRecompute = true).
//
// Contract (same as the TPU kernels):
//   qkv   (N, T, 3*H*D) un-biased projection; bias (3*H*D,) added at the
//         input dtype, as in the forward
//   probs (N, T, H*T) f32 (row 3): a of head h at lanes [h*T, (h+1)*T); it
//         carries the mask (a masked key's a is 0)
//   mask  (N, T) f32 over keys, or null (row 4)
//   g     (N, T, H*D) incoming gradient of the context, in qkv's dtype
//   dqkv  (N, T, 3*H*D) in qkv's dtype: dq, dk, dv of head h at lanes h*D,
//         H*D + h*D, 2*H*D + h*D
// Per head, with f32 accumulation everywhere:
//   a  = exp(s - m) * mask / (sum_j exp(s - m) * mask + 1e-8 exp(-m))
//        (row 4: s = (q.k) / sqrt(D), m over ALL keys, as the forward)
//   dv = round(a)^T g                 a rounded to g's dtype first
//   da = g v^T
//   ds = (da - rowsum(da * a)) * a * (1/sqrt(D))    with the f32 a
//   dq = round(ds) k,  dk = round(ds)^T q           ds rounded to k's dtype
// d(bias) is the sum of dqkv over (N, T), a plain reduce left to the caller.
//
// Bound: memory. Row 3 reads qkv, probs and g once and writes dqkv once:
// at N=7040, T=20, H=20, D=20 in bf16 that is 338 + 225 + 113 + 338 MB,
// 1,014 MB, about 0.30 ms at 3.35 TB/s, against 8*N*H*T*T*D = 9.0 GFLOP.
// Row 4 moves no probs (789 MB, 0.24 ms) and does 10*N*H*T*T*D flops.
//
// Four regimes, chosen by T, D and the dtype (qkv_bwd_regime; the plan in
// Python is ops/fused_attention.py:bwd_launch_plan):
//   Resident (the T x T block of a fits: T up to 201 at D = 20, the news
//     and L = 50 user encoders; both dtypes): one block of 4 warps per
//     (row n, head h) stages q_h, k_h, v_h and g_h (T x D each, rounded to
//     the input dtype and held as f32, odd row stride) and a (T x T f32,
//     odd stride; staged from probs, or recomputed one warp per row
//     exactly as the forward's warp computes it) in shared memory. Threads
//     over (j, d) write dv; one warp per row computes da (in its own row
//     buffer), the row sum r by warp shuffles and ds over a in place; then
//     threads over (x, d) write dq and dk.
//   Tensor cores (bf16, D <= 64, past the resident kernel): qkv_bwd_mma.cuh,
//     a query-side and a key-side kernel on mma.sync with every operand
//     staged in chunks, so any T runs.
//   Tiled (f32, or D > 64; 8 warps, one block per (row, head)): the same
//     q, k, v, g and a tile of R rows of T floats, R as large as the rest
//     of the 227 KB allows (18 at T = 511, D = 20). Query tiles of R rows:
//     one warp per query makes a's row in its buffer and ds's row in the
//     tile, then threads over (i, d) write dq; then key tiles of R/2 keys:
//     threads over (key j, query i) pairs compute a_ij (probs read with a
//     stride, L1/L2 resident; or recomputed from the row's m_i and den_i),
//     da_ij and ds_ij into two tiles, and threads over (j, d) write dv and
//     dk. ds is computed twice there, by the same expression on the same
//     operands. At D = 20 every T up to 599 fits.
//   Tiled in global memory (the same, past what shared memory holds): q,
//     k, v, g, the row buffers, the row stats and a tile of 16 rows in one
//     global slot per block (qkv_bwd_global_floats), a grid of `slots`
//     blocks walking the (row, head) items. Any T runs.
// The resident and tiled kernels are two, not one with two paths: in one
// kernel with the tiled path (more registers, a run-time block size) the
// resident path ran 1.5-11% slower on the card. Every dot runs in index
// order, so both give the same values, and on them row 3 and row 4 give
// the same dqkv bit for bit when row 4's recomputed a equals the probs row
// 2 wrote. Left on the table: 2*D-byte runs instead of 16-byte loads, da
// computed twice on the tiled path, and no tensor cores in f32 (TF32 would
// change the result).
#pragma once

#include "common.cuh"
#include "qkv_bwd_mma.cuh"

#include <type_traits>

namespace nrk {

constexpr int kMaxSmemFloats = 232448 / 4;  // what a block may use
constexpr int kResidentWarps = 4;
constexpr int kTiledWarps = 8;
constexpr int kGlobalTileRows = 16;  // the tile of the tiled kernel in a slot

// shared floats of the resident kernel: q, k, v, g, the T x T block of a,
// one row buffer per warp
inline size_t qkv_bwd_resident_floats(int t_len, int d_head) {
  return 4 * (size_t)t_len * (d_head | 1) + (size_t)t_len * (t_len | 1) +
         (size_t)kResidentWarps * t_len;
}

inline bool qkv_bwd_resident(int t_len, int d_head) {
  return qkv_bwd_resident_floats(t_len, d_head) <= (size_t)kMaxSmemFloats;
}

// q, k, v and g of one (row, head), each (T, D|1) f32: the tiled kernel's
// stage, in shared memory or in one global slot
__host__ __device__ inline size_t qkv_bwd_stage_floats(int t_len,
                                                       int d_head) {
  return 4 * (size_t)t_len * (d_head | 1);
}

// one global slot of the tiled kernel past shared memory: the stage, the
// row buffers, the row stats (r, m, den) and a tile of kGlobalTileRows
__host__ __device__ inline size_t qkv_bwd_global_floats(int t_len,
                                                        int d_head) {
  return qkv_bwd_stage_floats(t_len, d_head) +
         (size_t)(kTiledWarps + 3) * t_len +
         (size_t)kGlobalTileRows * (t_len | 1);
}

// rows of the tiled kernel's tile: as many as fit beside `staged` floats
// (the stage when it is in shared memory, else 0), the row buffers and
// the row stats (r, m, den: 3T floats); 2 at the least (a launch that
// needs more shared memory than a block has is refused)
inline int qkv_bwd_tile_rows(int t_len, size_t staged) {
  const size_t used = staged + (size_t)(kTiledWarps + 3) * t_len;
  const size_t rows = used < (size_t)kMaxSmemFloats
                          ? (kMaxSmemFloats - used) / (size_t)(t_len | 1)
                          : 0;
  return (int)(rows < 2 ? 2 : rows);
}

// whether the tiled kernel's stage fits in shared memory beside 2 tile rows
inline bool qkv_bwd_tiled_in_smem(int t_len, int d_head) {
  return qkv_bwd_stage_floats(t_len, d_head) +
             (size_t)(kTiledWarps + 3) * t_len + 2 * (size_t)(t_len | 1) <=
         (size_t)kMaxSmemFloats;
}

// shared bytes of the tiled kernel, its stage in shared memory (`staged`)
// or in global memory
inline size_t qkv_bwd_tiled_smem_bytes(int t_len, size_t staged) {
  return sizeof(float) *
         (staged + (size_t)(kTiledWarps + 3) * t_len +
          (size_t)qkv_bwd_tile_rows(t_len, staged) * (t_len | 1));
}

enum QkvBwdRegime {
  kQkvResident = 0,
  kQkvMma = 1,
  kQkvTiled = 2,
  kQkvTiledGlobal = 3
};

// the regime of a (T, D) in a dtype of esize bytes
inline int qkv_bwd_regime(int t_len, int d_head, int esize) {
  if (qkv_bwd_resident(t_len, d_head)) return kQkvResident;
  if (flash_mma(d_head, esize)) return kQkvMma;
  return qkv_bwd_tiled_in_smem(t_len, d_head) ? kQkvTiled : kQkvTiledGlobal;
}

// floats of one global slot of the regime: 0 unless it is the tiled kernel
// in global memory
inline size_t qkv_bwd_slot_floats_for(int t_len, int d_head, int esize) {
  return qkv_bwd_regime(t_len, d_head, esize) == kQkvTiledGlobal
             ? qkv_bwd_global_floats(t_len, d_head)
             : 0;
}

// One warp: a's row i into `a` (f32), as the forward's warp computes it
// (qkv_fwd.cu, step for step), with the row's m and den kept (unless
// m_out is null).
__device__ __forceinline__ void recompute_a_row(
    float* a, const float* qi, const float* k, const float* mrow, int t_len,
    int d_head, int stride, float inv_s, float* m_out, float* den_out,
    int lane) {
  float mx = -INFINITY;
  for (int j = lane; j < t_len; j += 32) {
    const float* kj = k + j * stride;
    float acc = 0.f;
    for (int d = 0; d < d_head; ++d) acc = fmaf(qi[d], kj[d], acc);
    const float s = __fmul_rn(acc, inv_s);
    a[j] = s;
    mx = fmaxf(mx, s);
  }
  const float m = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < t_len; j += 32) {
    float e = expf(a[j] - m);
    if (mrow) e *= mrow[j];
    a[j] = e;
    sum += e;
  }
  const float den = warp_sum(sum) + kEps * expf(-m);
  for (int j = lane; j < t_len; j += 32) a[j] = den > 0.f ? a[j] / den : 0.f;
  if (lane == 0 && m_out) {
    *m_out = m;
    *den_out = den;
  }
}

// One warp: da's row i into `da`, r_i = rowsum(da * a) into *r_out (unless
// it is null), then
// ds's row, rounded to T, into `out` (which may be `a` or `da`: each lane
// rewrites only the entries it read).
template <typename T>
__device__ __forceinline__ void ds_row(float* out, const float* a, float* da,
                                       const float* gi, const float* v,
                                       int t_len, int d_head, int stride,
                                       float inv, float* r_out, int lane) {
  float part = 0.f;
  for (int j = lane; j < t_len; j += 32) {
    const float* vj = v + j * stride;
    float acc = 0.f;
    for (int d = 0; d < d_head; ++d) acc = fmaf(gi[d], vj[d], acc);
    da[j] = acc;
    part += acc * a[j];
  }
  const float r = warp_sum(part);
  if (lane == 0 && r_out) *r_out = r;
  for (int j = lane; j < t_len; j += 32)
    out[j] = round_to<T>((da[j] - r) * a[j] * inv);
}

// The resident kernel (row 4 recomputes a where row 3 stages it).
template <typename T, bool kRecompute>
__global__ void __launch_bounds__(32 * kResidentWarps)
qkv_bwd_resident_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                        const float* __restrict__ probs,
                        const float* __restrict__ mask,
                        const T* __restrict__ g, T* __restrict__ dqkv,
                        int n_heads, int t_len, int d_head, float inv) {
  constexpr int kThreads = 32 * kResidentWarps;
  extern __shared__ float smem[];
  const int row = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int hd = n_heads * d_head;
  const int w3 = 3 * hd;
  const int stride = d_head | 1;  // odd row strides: no bank conflicts
  const int astride = t_len | 1;

  float* q = smem;                   // (T, stride), then k, v, g
  float* k = q + t_len * stride;
  float* v = k + t_len * stride;
  float* gs = v + t_len * stride;
  float* a = gs + t_len * stride;    // (T, astride): a, then ds
  float* darow = a + t_len * astride;  // (kResidentWarps, T) da rows

  const T* src = qkv + (int64_t)row * t_len * w3;
  const int per_part = t_len * d_head;
  for (int idx = threadIdx.x; idx < 3 * per_part; idx += kThreads) {
    const int part = idx / per_part;
    const int rem = idx - part * per_part;
    const int t = rem / d_head;
    const int d = rem - t * d_head;
    const int lane = part * hd + h * d_head + d;
    // the bias add happens at the input dtype, as in the forward
    smem[part * t_len * stride + t * stride + d] = round_to<T>(
        to_f32(src[(int64_t)t * w3 + lane]) + to_f32(bias[lane]));
  }
  const T* gsrc = g + (int64_t)row * t_len * hd + h * d_head;
  for (int idx = threadIdx.x; idx < per_part; idx += kThreads) {
    const int t = idx / d_head;
    const int d = idx - t * d_head;
    gs[t * stride + d] = to_f32(gsrc[(int64_t)t * hd + d]);
  }
  if constexpr (kRecompute) {
    __syncthreads();
    const float* mrow = mask ? mask + (int64_t)row * t_len : nullptr;
    // the forward's scale of the scores, computed as the forward does
    const float inv_s = 1.0f / sqrtf((float)d_head);
    for (int i = threadIdx.x / 32; i < t_len; i += kResidentWarps)
      recompute_a_row(a + i * astride, q + i * stride, k, mrow, t_len,
                      d_head, stride, inv_s, nullptr, nullptr,
                      threadIdx.x % 32);
  } else {
    // probs[row, i, h*T + j] = a[i, j]
    const float* psrc = probs + (int64_t)row * t_len * n_heads * t_len +
                        h * t_len;
    for (int idx = threadIdx.x; idx < t_len * t_len; idx += kThreads) {
      const int i = idx / t_len;
      const int j = idx - i * t_len;
      a[i * astride + j] = psrc[(int64_t)i * n_heads * t_len + j];
    }
  }
  __syncthreads();

  T* dst = dqkv + (int64_t)row * t_len * w3 + h * d_head;
  // dv[j, d] = sum_i round(a[i, j]) * g[i, d]
  for (int idx = threadIdx.x; idx < per_part; idx += kThreads) {
    const int j = idx / d_head;
    const int d = idx - j * d_head;
    float acc = 0.f;
    for (int i = 0; i < t_len; ++i)
      acc = fmaf(round_to<T>(a[i * astride + j]), gs[i * stride + d], acc);
    dst[(int64_t)j * w3 + 2 * hd + d] = from_f32<T>(acc);
  }
  __syncthreads();  // a is overwritten with ds below

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* da = darow + warp * t_len;
  for (int i = warp; i < t_len; i += kResidentWarps) {
    // ds_row's arithmetic, written out: through the helper this kernel
    // ran slower on the card at the NRMS shapes
    const float* gi = gs + i * stride;
    float* ai = a + i * astride;
    float part = 0.f;
    for (int j = lane; j < t_len; j += 32) {
      const float* vj = v + j * stride;
      float acc = 0.f;
      for (int d = 0; d < d_head; ++d) acc = fmaf(gi[d], vj[d], acc);
      da[j] = acc;
      part += acc * ai[j];
    }
    const float r = warp_sum(part);
    // each lane rewrites only the entries it read: no sync within the warp
    for (int j = lane; j < t_len; j += 32)
      ai[j] = round_to<T>((da[j] - r) * ai[j] * inv);
  }
  __syncthreads();

  // dq[i, d] = sum_j ds[i, j] k[j, d];  dk[i, d] = sum_j ds[j, i] q[j, d]
  for (int idx = threadIdx.x; idx < per_part; idx += kThreads) {
    const int i = idx / d_head;
    const int d = idx - i * d_head;
    float dq = 0.f, dk = 0.f;
    for (int j = 0; j < t_len; ++j) {
      dq = fmaf(a[i * astride + j], k[j * stride + d], dq);
      dk = fmaf(a[j * astride + i], q[j * stride + d], dk);
    }
    dst[(int64_t)i * w3 + d] = from_f32<T>(dq);
    dst[(int64_t)i * w3 + hd + d] = from_f32<T>(dk);
  }
}

// The tiled kernel: T past what the resident kernel holds in f32 or at
// D > 64 (kGlobal: its whole working set in gstage, none in shared memory).
template <typename T, bool kRecompute, bool kGlobal>
__global__ void __launch_bounds__(32 * kTiledWarps)
qkv_bwd_tiled_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                     const float* __restrict__ probs,
                     const float* __restrict__ mask, const T* __restrict__ g,
                     T* __restrict__ dqkv, int n_heads, int t_len,
                     int d_head, int tile_rows, float inv, int64_t n_items,
                     float* gstage) {
  constexpr int warps = kTiledWarps;
  constexpr int kThreads = 32 * kTiledWarps;
  extern __shared__ float smem[];
  const int hd = n_heads * d_head;
  const int w3 = 3 * hd;
  const int stride = d_head | 1;  // odd row strides: no bank conflicts
  const int tstride = t_len | 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // q, k, v and g, then the rest, in shared memory or in this block's slot
  // of gstage
  float* q = kGlobal ? gstage + (int64_t)blockIdx.x *
                                    qkv_bwd_global_floats(t_len, d_head)
                     : smem;  // (T, stride), then k, v, g
  float* k = q + t_len * stride;
  float* v = k + t_len * stride;
  float* gs = v + t_len * stride;
  float* rest = gs + t_len * stride;
  float* wrow = rest + warp * t_len;   // this warp's buffer
  float* tile = rest + warps * t_len;  // (tile_rows, tstride)
  // the row stats, after the tile: rowsum(da * a), and (row 4) the row's
  // max and denominator
  float* rs = tile + tile_rows * tstride;
  float* ms = rs + t_len;
  float* dens = ms + t_len;

  // one (row, head) item per block, or, staged in global memory, a grid of
  // slots walking the items
  auto body = [&](int64_t item) {
    const int64_t row = item / n_heads;
    const int h = (int)(item % n_heads);

    // staging: all threads over (t, d) of each operand, loads unrolled so
    // that several are in flight at once
    const T* src = qkv + (int64_t)row * t_len * w3 + h * d_head;
    const T* gsrc = g + (int64_t)row * t_len * hd + h * d_head;
    const int per_part = t_len * d_head;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < 4 * per_part; idx += kThreads) {
      const int part = idx / per_part;  // q, k, v, then g
      const int rem = idx - part * per_part;
      const int t = rem / d_head;
      const int d = rem - t * d_head;
      // the bias add happens at the input dtype, as in the forward
      q[(part * t_len + t) * stride + d] =
          part < 3 ? round_to<T>(to_f32(src[(int64_t)t * w3 + part * hd + d]) +
                                 to_f32(bias[part * hd + h * d_head + d]))
                   : to_f32(gsrc[(int64_t)t * hd + d]);
    }
    // probs[row, i, h*T + j] = a[i, j]
    const int64_t pstride = (int64_t)n_heads * t_len;
    const float* prow0 = kRecompute ? nullptr
                                    : probs + (int64_t)row * t_len * pstride +
                                          h * t_len;
    __syncthreads();

    const float* mrow = mask ? mask + (int64_t)row * t_len : nullptr;
    // the forward's scale of the scores, computed as the forward does
    const float inv_s = 1.0f / sqrtf((float)d_head);
    T* dst = dqkv + (int64_t)row * t_len * w3 + h * d_head;

    // ---- query tiles: ds's rows, then dq --------------------------------
    for (int i0 = 0; i0 < t_len; i0 += tile_rows) {
      const int nq = min(tile_rows, t_len - i0);
      for (int ii = warp; ii < nq; ii += warps) {
        const int i = i0 + ii;
        if constexpr (kRecompute) {
          recompute_a_row(wrow, q + i * stride, k, mrow, t_len, d_head, stride,
                          inv_s, ms + i, dens + i, lane);
        } else {
          for (int j = lane; j < t_len; j += 32) wrow[j] = prow0[i * pstride + j];
        }
        float* dsi = tile + ii * tstride;  // da's row, then ds's
        ds_row<T>(dsi, wrow, dsi, gs + i * stride, v, t_len, d_head, stride,
                  inv, rs + i, lane);
        __syncwarp();  // the next query overwrites wrow
      }
      __syncthreads();
      // dq[i, d] = sum_j ds[i, j] k[j, d]
      for (int idx = threadIdx.x; idx < nq * d_head; idx += kThreads) {
        const int ii = idx / d_head;
        const int d = idx - ii * d_head;
        const float* dsi = tile + ii * tstride;
        float acc = 0.f;
        for (int j = 0; j < t_len; ++j) acc = fmaf(dsi[j], k[j * stride + d], acc);
        dst[(int64_t)(i0 + ii) * w3 + d] = from_f32<T>(acc);
      }
      __syncthreads();  // the next tile overwrites this one
    }

    // ---- key tiles: a's and ds's columns, then dv and dk -----------------
    const int tk = tile_rows / 2;
    float* a_cols = tile;                  // (tk, tstride) round(a)
    float* ds_cols = tile + tk * tstride;  // (tk, tstride) ds
    for (int j0 = 0; j0 < t_len; j0 += tk) {
      const int nk = min(tk, t_len - j0);
      for (int idx = threadIdx.x; idx < nk * t_len; idx += kThreads) {
        const int jj = idx / t_len;
        const int i = idx - jj * t_len;
        const int j = j0 + jj;
        float a;
        if constexpr (kRecompute) {
          const float* qi = q + i * stride;
          const float* kj = k + j * stride;
          float acc = 0.f;
          for (int d = 0; d < d_head; ++d) acc = fmaf(qi[d], kj[d], acc);
          float e = expf(__fmul_rn(acc, inv_s) - ms[i]);
          if (mrow) e *= mrow[j];
          a = dens[i] > 0.f ? e / dens[i] : 0.f;
        } else {
          a = prow0[i * pstride + j];
        }
        const float* gi = gs + i * stride;
        const float* vj = v + j * stride;
        float da = 0.f;
        for (int d = 0; d < d_head; ++d) da = fmaf(gi[d], vj[d], da);
        a_cols[jj * tstride + i] = round_to<T>(a);  // a in g's dtype, for dv
        ds_cols[jj * tstride + i] = round_to<T>((da - rs[i]) * a * inv);
      }
      __syncthreads();
      // dv[j, d] = sum_i round(a[i, j]) g[i, d];  dk[j, d] = sum_i ds[i, j] q[i, d]
      for (int idx = threadIdx.x; idx < nk * d_head; idx += kThreads) {
        const int jj = idx / d_head;
        const int d = idx - jj * d_head;
        const float* aj = a_cols + jj * tstride;
        const float* dsj = ds_cols + jj * tstride;
        float dv = 0.f, dk = 0.f;
        for (int i = 0; i < t_len; ++i) {
          dv = fmaf(aj[i], gs[i * stride + d], dv);
          dk = fmaf(dsj[i], q[i * stride + d], dk);
        }
        const int64_t o = (int64_t)(j0 + jj) * w3 + d;
        dst[o + hd] = from_f32<T>(dk);
        dst[o + 2 * hd] = from_f32<T>(dv);
      }
      __syncthreads();
    }
  };
  if constexpr (kGlobal) {
    for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x)
      body(item);  // ends with a __syncthreads
  } else {
    body(blockIdx.x);
  }
}

// What a launch of rows 3-4 is given beside its operands: the tensor-core
// plan of each side (ops/fused_attention.py:bwd_launch_plan: tile, chunk,
// buffers of the query side, then of the key side), and the scratch of the
// regime: `biased` (N, T, 3HD) bf16 for the biased qkv and `stats` (3, N*H,
// T) f32 (tensor cores; biased unused when qkv_biased, the caller's qkv
// carrying its bias already), `gstage` with `slots` slots of
// qkv_bwd_global_floats (the tiled kernel in global memory). A plan or
// scratch the regime needs and does not get is refused
// (cudaErrorInvalidValue).
struct QkvBwdWork {
  const int* plan;  // 6 ints
  void* biased;
  float* stats;
  float* gstage;
  int slots;
  bool qkv_biased;
};

template <typename T, bool kRecompute>
int qkv_bwd_launch(const void* qkv, const void* bias, const void* probs,
                   const void* mask, const void* g, void* dqkv, int n,
                   int t_len, int n_heads, int d_head, void* stream,
                   const QkvBwdWork& w) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (int64_t)n * n_heads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const int regime = qkv_bwd_regime(t_len, d_head, (int)sizeof(T));
  // 1/sqrt(D) for ds, rounded once from double, as the plain version's
  // scalar is
  const float inv = (float)(1.0 / sqrt((double)d_head));
  const auto* x = static_cast<const T*>(qkv);
  const auto* b = static_cast<const T*>(bias);
  const auto* p = static_cast<const float*>(probs);
  const auto* m = static_cast<const float*>(mask);
  const auto* gg = static_cast<const T*>(g);
  auto* out = static_cast<T*>(dqkv);
  auto* cs = (cudaStream_t)stream;
  cudaError_t err;
  if (regime == kQkvMma) {
    if constexpr (!std::is_same<T, __nv_bfloat16>::value) {
      return (int)cudaErrorInvalidValue;
    } else {
      const int* pl = w.plan;
      if (pl == nullptr || w.stats == nullptr ||
          (!w.qkv_biased && w.biased == nullptr) ||
          !qkv_bwd_mma_plan_ok(kRecompute, d_head, pl[0], pl[1], pl[2],
                               pl[3], pl[4], pl[5]))
        return (int)cudaErrorInvalidValue;
      const T* src = x;
      if (!w.qkv_biased) {
        const int64_t total = (int64_t)n * t_len * 3 * n_heads * d_head;
        const int64_t want = (total + 255) / 256;
        auto* biased = static_cast<T*>(w.biased);
        qkv_bias_kernel<<<(unsigned)(want < 4096 ? want : 4096), 256, 0,
                          cs>>>(x, b, biased, total, 3 * n_heads * d_head);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        src = biased;
      }
      return with_head_width(
          d_head, QkvBwdMmaLaunch{src, p, m, gg, out, w.stats, n, t_len,
                                  n_heads, d_head, pl[0], pl[1], pl[2], pl[3],
                                  pl[4], pl[5], kRecompute, cs});
    }
  }
  if (regime == kQkvResident) {
    const size_t smem = sizeof(float) * qkv_bwd_resident_floats(t_len, d_head);
    err = cudaFuncSetAttribute(qkv_bwd_resident_kernel<T, kRecompute>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    qkv_bwd_resident_kernel<T, kRecompute>
        <<<(unsigned)blocks, 32 * kResidentWarps, smem, cs>>>(
            x, b, p, m, gg, out, n_heads, t_len, d_head, inv);
  } else if (regime == kQkvTiledGlobal) {
    if (w.gstage == nullptr || w.slots <= 0) return (int)cudaErrorInvalidValue;
    qkv_bwd_tiled_kernel<T, kRecompute, true>
        <<<(unsigned)(w.slots < blocks ? w.slots : blocks), 32 * kTiledWarps,
           0, cs>>>(x, b, p, m, gg, out, n_heads, t_len, d_head,
                    kGlobalTileRows, inv, blocks, w.gstage);
  } else {
    const size_t staged = qkv_bwd_stage_floats(t_len, d_head);
    const size_t smem = qkv_bwd_tiled_smem_bytes(t_len, staged);
    err = cudaFuncSetAttribute(qkv_bwd_tiled_kernel<T, kRecompute, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    qkv_bwd_tiled_kernel<T, kRecompute, false>
        <<<(unsigned)blocks, 32 * kTiledWarps, smem, cs>>>(
            x, b, p, m, gg, out, n_heads, t_len, d_head,
            qkv_bwd_tile_rows(t_len, staged), inv, blocks, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // namespace nrk
