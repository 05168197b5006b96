// Rows 9-10 at head widths past 64 (news_dim 400 with 1, 2, 4 or 5 heads:
// D = 400, 200, 100, 80; and any wider), both dtypes: the contract of
// flash_fwd.cu and flash_bwd.cu, computed as their CUDA-core kernels
// compute it, with a warp per row and its lanes over the head's D lanes
// (lane l holds elements l, l + 32, ...), so no head is too wide for
// registers or shared memory. Nothing is staged: each warp reads the other side's rows from
// global memory (L2-resident: one head's K and V are T * D elements).
//   forward: a warp per query walks the key blocks (each twice: the
//     block's max of s, then e against the new max, its sum and
//     round(e) @ v), rescaling its running sums as the CUDA-core kernel
//     does; writes o, m and den;
//   backward, query side: a warp per query walks all keys for dq;
//   backward, key side: a warp per key walks all queries for dk and dv.
// Each dot is the lane's sequential f32 sum over its elements, then the
// warp's xor tree: another order than the CUDA-core kernels' sequential
// sum over d, within the f32 tolerance; e and a round at the same points
// (e in v's dtype against its key block's max; a in g's dtype, ds in k's).
// They replace the TPU kernels newsrecommendation_tpu/ops/pallas/
// blockwise.py:_flash_fwd_kernel and :_flash_bwd_kernel at those widths.
// Bound: bytes (each input read once, each output written once), as rows
// 9-10's. A simple path, correct first: it moves every K row once per
// query and pass through L2, and each score costs a warp reduction.
#pragma once

#include "flash.cuh"

namespace nrk {

// the lane's elements of one head row: d = lane + 32 c, zero past D
template <typename T, int DPL>
__device__ __forceinline__ void wide_load(float* f, const T* __restrict__ row,
                                          int d_head, int lane) {
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    const int d = lane + 32 * c;
    f[c] = d < d_head ? to_f32(row[d]) : 0.f;
  }
}

template <int DPL>
__device__ __forceinline__ float wide_dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc = fmaf(a[c], b[c], acc);
  return warp_sum(acc);
}

template <typename T, int DPL>
__device__ __forceinline__ void wide_store(T* __restrict__ row,
                                           const float* f, int d_head,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    const int d = lane + 32 * c;
    if (d < d_head) row[d] = from_f32<T>(f[c]);
  }
}

// Which (row, head) and which row of it a warp takes: grid (N*H, rows /
// kFlashWideWarps), false past T.
struct WideRow {
  int row, h, i;
};

__device__ __forceinline__ bool wide_row(WideRow& w, int n_heads,
                                         int t_len) {
  w.row = blockIdx.x / n_heads;
  w.h = blockIdx.x - w.row * n_heads;
  w.i = blockIdx.y * kFlashWideWarps + threadIdx.x / 32;
  return w.i < t_len;
}

// a . b over a whole head read from global memory: the lane's sequential
// sum over elements lane, lane + 32, ..., then the warp's xor tree (a head
// wider than one slice of the lanes' registers)
template <typename T>
__device__ __forceinline__ float wide_dot_global(const T* __restrict__ a,
                                                 const T* __restrict__ b,
                                                 int d_head, int lane) {
  float acc = 0.f;
  for (int d = lane; d < d_head; d += 32)
    acc = fmaf(to_f32(a[d]), to_f32(b[d]), acc);
  return warp_sum(acc);
}

// Each kernel writes its outputs a slice of 32 * DPL lanes at a time,
// recomputing the scores over the whole head for every slice: one slice
// (the dots from registers) for heads of up to 1024, more past that (the
// dots read from global memory).
template <typename T, int DPL>
__global__ void __launch_bounds__(32 * kFlashWideWarps)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ mask, T* __restrict__ out,
                      float* __restrict__ m_out,
                      float* __restrict__ den_out, int n_heads, int t_len,
                      int d_head, int ld, int block_kv, float inv) {
  constexpr int kSlice = 32 * DPL;
  WideRow w;
  if (!wide_row(w, n_heads, t_len)) return;
  const int lane = threadIdx.x % 32;
  const bool whole = d_head <= kSlice;
  const int64_t base = (int64_t)w.row * t_len * ld + w.h * d_head;
  const float* mrow = mask ? mask + (int64_t)w.row * t_len : nullptr;
  const T* qrow = q + base + (int64_t)w.i * ld;
  const int64_t at = (int64_t)w.row * t_len + w.i;
  float qi[DPL], acc[DPL], pv[DPL], x[DPL];
  if (whole) wide_load<T, DPL>(qi, qrow, d_head, lane);
  auto score = [&](int j) {
    const T* krow = k + base + (int64_t)j * ld;
    float dot;
    if (whole) {
      wide_load<T, DPL>(x, krow, d_head, lane);
      dot = wide_dot<DPL>(qi, x);
    } else {
      dot = wide_dot_global(qrow, krow, d_head, lane);
    }
    return __fmul_rn(dot, inv);
  };
  for (int d0 = 0; d0 < d_head; d0 += kSlice) {
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] = 0.f;
    float m_run = kNegBig, l = 0.f;
    for (int b0 = 0; b0 < t_len; b0 += block_kv) {
      const int b1 = min(b0 + block_kv, t_len);
      float mx = -INFINITY;  // the block's max of s
      for (int j = b0; j < b1; ++j) mx = fmaxf(mx, score(j));
      const float m_new = fmaxf(m_run, mx);
      const float scale = expf(m_run - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int c = 0; c < DPL; ++c) pv[c] = 0.f;
      for (int j = b0; j < b1; ++j) {
        const float e = expf(score(j) - m_new) * (mrow ? mrow[j] : 1.f);
        lsum += e;
        const float er = round_to<T>(e);  // e in v's dtype
        wide_load<T, DPL>(x, v + base + (int64_t)j * ld + d0, d_head - d0,
                          lane);
#pragma unroll
        for (int c = 0; c < DPL; ++c) pv[c] = fmaf(er, x[c], pv[c]);
      }
      l = l * scale + lsum;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[c] = acc[c] * scale + pv[c];
      m_run = m_new;
    }
    const float den = l + kEps * expf(-m_run);
    if (d0 == 0 && lane == 0) {
      m_out[at * n_heads + w.h] = m_run;
      den_out[at * n_heads + w.h] = den;
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] = den > 0.f ? acc[c] / den : 0.f;
    wide_store<T, DPL>(out + at * n_heads * d_head + w.h * d_head + d0, acc,
                       d_head - d0, lane);
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(32 * kFlashWideWarps)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ mask,
                         const T* __restrict__ g,
                         const float* __restrict__ m,
                         const float* __restrict__ den,
                         const float* __restrict__ delta,
                         T* __restrict__ dq, int n_heads, int t_len,
                         int d_head, int ld, float inv) {
  constexpr int kSlice = 32 * DPL;
  WideRow w;
  if (!wide_row(w, n_heads, t_len)) return;
  const int lane = threadIdx.x % 32;
  const bool whole = d_head <= kSlice;
  const int hd = n_heads * d_head;
  const int64_t base = (int64_t)w.row * t_len * ld + w.h * d_head;
  const int64_t gat = ((int64_t)w.row * t_len + w.i) * hd + w.h * d_head;
  const int64_t at = ((int64_t)w.row * t_len + w.i) * n_heads + w.h;
  const float* mrow = mask ? mask + (int64_t)w.row * t_len : nullptr;
  const float m_i = m[at], den_i = den[at], delta_i = delta[at];
  const T* qrow = q + base + (int64_t)w.i * ld;
  const T* grow = g + gat;
  float qi[DPL], gi[DPL], dqi[DPL], kj[DPL], vj[DPL];
  if (whole) {
    wide_load<T, DPL>(qi, qrow, d_head, lane);
    wide_load<T, DPL>(gi, grow, d_head, lane);
  }
  for (int d0 = 0; d0 < d_head; d0 += kSlice) {
#pragma unroll
    for (int c = 0; c < DPL; ++c) dqi[c] = 0.f;
    for (int j = 0; j < t_len; ++j) {
      const T* krow = k + base + (int64_t)j * ld;
      const T* vrow = v + base + (int64_t)j * ld;
      float s_dot, da;
      if (whole) {
        wide_load<T, DPL>(kj, krow, d_head, lane);
        wide_load<T, DPL>(vj, vrow, d_head, lane);
        s_dot = wide_dot<DPL>(qi, kj);
        da = wide_dot<DPL>(gi, vj);
      } else {
        s_dot = wide_dot_global(qrow, krow, d_head, lane);
        da = wide_dot_global(grow, vrow, d_head, lane);
        wide_load<T, DPL>(kj, krow + d0, d_head - d0, lane);
      }
      const float e =
          expf(__fmul_rn(s_dot, inv) - m_i) * (mrow ? mrow[j] : 1.f);
      const float a = den_i > 0.f ? e / den_i : 0.f;
      const float ds = round_to<T>((da - delta_i) * a * inv);
#pragma unroll
      for (int c = 0; c < DPL; ++c) dqi[c] = fmaf(ds, kj[c], dqi[c]);
    }
    wide_store<T, DPL>(dq + gat + d0, dqi, d_head - d0, lane);
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(32 * kFlashWideWarps)
flash_bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ mask,
                           const T* __restrict__ g,
                           const float* __restrict__ m,
                           const float* __restrict__ den,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv,
                           int n_heads, int t_len, int d_head, int ld,
                           float inv) {
  constexpr int kSlice = 32 * DPL;
  WideRow w;  // w.i is the key
  if (!wide_row(w, n_heads, t_len)) return;
  const int lane = threadIdx.x % 32;
  const bool whole = d_head <= kSlice;
  const int hd = n_heads * d_head;
  const int64_t base = (int64_t)w.row * t_len * ld + w.h * d_head;
  const int64_t gbase = (int64_t)w.row * t_len * hd + w.h * d_head;
  const int64_t sbase = (int64_t)w.row * t_len * n_heads + w.h;
  const float mask_j = mask ? mask[(int64_t)w.row * t_len + w.i] : 1.f;
  const T* krow = k + base + (int64_t)w.i * ld;
  const T* vrow = v + base + (int64_t)w.i * ld;
  float kj[DPL], vj[DPL], dkj[DPL], dvj[DPL], qi[DPL], gi[DPL];
  if (whole) {
    wide_load<T, DPL>(kj, krow, d_head, lane);
    wide_load<T, DPL>(vj, vrow, d_head, lane);
  }
  for (int d0 = 0; d0 < d_head; d0 += kSlice) {
#pragma unroll
    for (int c = 0; c < DPL; ++c) dkj[c] = dvj[c] = 0.f;
    for (int i = 0; i < t_len; ++i) {
      const T* qrow = q + base + (int64_t)i * ld;
      const T* grow = g + gbase + (int64_t)i * hd;
      float s_dot, da;
      if (whole) {
        wide_load<T, DPL>(qi, qrow, d_head, lane);
        wide_load<T, DPL>(gi, grow, d_head, lane);
        s_dot = wide_dot<DPL>(qi, kj);
        da = wide_dot<DPL>(gi, vj);
      } else {
        s_dot = wide_dot_global(qrow, krow, d_head, lane);
        da = wide_dot_global(grow, vrow, d_head, lane);
        wide_load<T, DPL>(qi, qrow + d0, d_head - d0, lane);
        wide_load<T, DPL>(gi, grow + d0, d_head - d0, lane);
      }
      const int64_t at = sbase + (int64_t)i * n_heads;
      const float e = expf(__fmul_rn(s_dot, inv) - m[at]) * mask_j;
      const float dn = den[at];
      const float a = dn > 0.f ? e / dn : 0.f;
      const float al = round_to<T>(a);  // a in g's dtype, for dv
      const float ds = round_to<T>((da - delta[at]) * a * inv);
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        dvj[c] = fmaf(al, gi[c], dvj[c]);
        dkj[c] = fmaf(ds, qi[c], dkj[c]);
      }
    }
    const int64_t at = gbase + (int64_t)w.i * hd + d0;
    wide_store<T, DPL>(dk + at, dkj, d_head - d0, lane);
    wide_store<T, DPL>(dv + at, dvj, d_head - d0, lane);
  }
}

// Calls body.template operator()<DPL>() with the least DPL of 4, 8, 16, 32
// whose 32 * DPL lanes hold d_head; 32 (slices of 1024) past that.
template <typename Body>
int with_wide_width(int d_head, Body body) {
  if (d_head <= 128) return body.template operator()<4>();
  if (d_head <= 256) return body.template operator()<8>();
  if (d_head <= 512) return body.template operator()<16>();
  return body.template operator()<32>();
}

}  // namespace nrk
