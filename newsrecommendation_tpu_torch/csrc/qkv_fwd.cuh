// Exp-normalised multi-head self-attention forward over a fused [q|k|v]
// projection, with the projection bias added in the kernel, an optional
// key mask and, for training, an optional f32 probs output.
//
// Replaces the TPU kernel newsrecommendation_tpu/ops/pallas/fused_attention.py
// :_qkv_fwd_kernel in two of its calls: _qkv_fwd_call (bias and bias+mask,
// no probs: serving and eval) and _qkv_fwd_probs_call (the same with
// probs_ref: the forward under differentiation, whose probs feed the
// backward in qkv_bwd_probs.cu).
//
// Contract (same as the TPU kernel):
//   qkv  (N, T, 3*H*D), head h's q/k/v at lanes h*D, H*D + h*D, 2*H*D + h*D
//   bias (3*H*D,) added to qkv at the input dtype before anything else
//   mask (N, T) f32 over keys, or null
//   out  (N, T, H*D), head h at lanes h*D
//   probs (N, T, H*T) f32 or null: a of head h at lanes [h*T, (h+1)*T),
//        written before a is rounded for a@v (0 on a fully masked row)
//   s = (q_h . k_h) * (1/sqrt(D))             f32 accumulate, scale after
//   m = max_j s_j                              over ALL keys, masked included
//   e = exp(s - m) * mask                      mask after the exp
//   a = e / (sum_j e_j + 1e-8 * exp(-m))       0 where that is not > 0
//   out = a (cast to v's dtype) @ v_h           f32 accumulate, cast to dtype
// This is not softmax: a fully masked row gives a = 0 and an output of 0.
//
// Bound: memory. One call reads qkv once and writes out once, 4*N*H*T*T*D
// flops against 4*T*D bytes per output row in f32 -- at N=1024, T=20,
// H*D=400 that is 131 MB, about 39 us at 3.35 TB/s, while the 0.66 GFLOP
// take about 10 us at the 67 TFLOP/s f32 rate. With probs the call also
// writes 4*H*T bytes per row: at N=7040, T=20 in bf16, 676 MB in all.
//
// Rows 11 (qkv2d.cu, the 2-D-I/O forward) runs this kernel as row 2 does.
//
// Design (simple, correct first): one block of 4 warps per (row n, head h).
// The block stages q_h, k_h, v_h (T x D each, biased and rounded at the
// input dtype, held as f32) in shared memory with an odd row stride so that
// lanes walking keys hit distinct banks. Past what shared memory holds (T >
// 370 at D = 50, 867 at D = 20) the same kernel keeps q_h, k_h, v_h and the
// warps' score rows in one global slot per block (L2-resident at the sizes
// it serves), a grid of `slots` blocks walking the (row, head) items: the
// same arithmetic in the same order, so the same bits. Each warp takes one query at a
// time: lanes over keys compute the scores into a per-warp row buffer,
// warp shuffles give the max and the sum, then lanes over d accumulate the
// context. Left on the table: the q/k/v loads are 2*D-byte runs rather than
// 16-byte vector loads, T=20 keeps 12 of 32 lanes idle, nothing overlaps
// loads with math, and no tensor cores (mma/wgmma) are used.

#pragma once

#include "common.cuh"

namespace nrk {

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;

// shared bytes of a block: q, k, v of one head, one score row per warp
__host__ __device__ inline size_t qkv_fwd_floats(int t_len, int d_head) {
  return 3 * (size_t)t_len * (d_head | 1) + (size_t)kFwdWarps * t_len;
}

inline size_t qkv_fwd_smem_bytes_for(int t_len, int d_head) {
  return sizeof(float) * qkv_fwd_floats(t_len, d_head);
}

// whether the working set moves to a global slot (past 227 KB)
inline bool qkv_fwd_global(int t_len, int d_head) {
  return qkv_fwd_smem_bytes_for(t_len, d_head) > 232448;
}

// floats of one global slot: 0 when the working set fits in shared memory
inline size_t qkv_fwd_slot_floats_for(int t_len, int d_head) {
  return qkv_fwd_global(t_len, d_head) ? qkv_fwd_floats(t_len, d_head) : 0;
}

// kGlobal: the working set in this block's slot of gstage, the grid
// walking the n_items (row, head) items
template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kFwdThreads)
qkv_fwd_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
               const float* __restrict__ mask, T* __restrict__ out,
               float* __restrict__ probs, int n_heads, int t_len, int d_head,
               int stride, int64_t n_items, float* gstage) {
  extern __shared__ float smem[];
  float* const work =
      kGlobal ? gstage + blockIdx.x * qkv_fwd_floats(t_len, d_head) : smem;
  auto body = [&](int64_t item) {
    const int row = (int)(item / n_heads);
    const int h = (int)(item % n_heads);
    const int hd = n_heads * d_head;
    const int w3 = 3 * hd;

    float* q = work;                       // (T, stride)
    float* k = q + t_len * stride;         // (T, stride)
    float* v = k + t_len * stride;         // (T, stride)
    float* prow = v + t_len * stride;      // (kFwdWarps, T) per-warp score row

    const T* src = qkv + (int64_t)row * t_len * w3;
    const int per_part = t_len * d_head;
    for (int idx = threadIdx.x; idx < 3 * per_part; idx += kFwdThreads) {
      const int part = idx / per_part;
      const int rem = idx - part * per_part;
      const int t = rem / d_head;
      const int d = rem - t * d_head;
      const int lane = part * hd + h * d_head + d;
      // the bias add happens at the input dtype, as in the TPU kernel
      const float x = round_to<T>(to_f32(src[(int64_t)t * w3 + lane]) +
                                  to_f32(bias[lane]));
      work[part * t_len * stride + t * stride + d] = x;
    }
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const float inv = 1.0f / sqrtf((float)d_head);
    const float* mrow = mask ? mask + (int64_t)row * t_len : nullptr;
    float* p = prow + warp * t_len;
    T* dst = out + (int64_t)row * t_len * hd + h * d_head;

    for (int i = warp; i < t_len; i += kFwdWarps) {
      const float* qi = q + i * stride;
      float mx = -INFINITY;
      for (int j = lane; j < t_len; j += 32) {
        const float* kj = k + j * stride;
        float acc = 0.f;
        for (int d = 0; d < d_head; ++d) acc = fmaf(qi[d], kj[d], acc);
        const float s = acc * inv;
        p[j] = s;
        mx = fmaxf(mx, s);
      }
      const float m = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < t_len; j += 32) {
        float e = expf(p[j] - m);
        if (mrow) e *= mrow[j];
        p[j] = e;
        sum += e;
      }
      const float den = warp_sum(sum) + kEps * expf(-m);
      // probs[row, i, h*T + j]: this query's row of head h
      const int64_t at = (((int64_t)row * t_len + i) * n_heads + h) * t_len;
      float* arow = probs ? probs + at : nullptr;
      for (int j = lane; j < t_len; j += 32) {
        const float a = den > 0.f ? p[j] / den : 0.f;
        if (arow) arow[j] = a;  // f32, before the rounding for a@v
        p[j] = round_to<T>(a);  // a in v's dtype
      }
      __syncwarp();
      for (int d = lane; d < d_head; d += 32) {
        float acc = 0.f;
        for (int j = 0; j < t_len; ++j) acc = fmaf(p[j], v[j * stride + d], acc);
        dst[(int64_t)i * hd + d] = from_f32<T>(acc);
      }
      __syncwarp();  // the next query overwrites p
    }
  };
  if constexpr (kGlobal) {
    for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
      body(item);
      __syncthreads();  // the next item overwrites the slot
    }
  } else {
    body(blockIdx.x);
  }
}

// gstage (`slots` slots of qkv_fwd_slot_floats_for) is read only past
// shared memory; without it such a T is refused (cudaErrorInvalidValue).
template <typename T>
int qkv_fwd_launch(const void* qkv, const void* bias, const void* mask,
                   void* out, void* probs, int n, int t_len, int n_heads,
                   int d_head, void* stream, float* gstage = nullptr,
                   int slots = 0) {
  if (n <= 0) return (int)cudaSuccess;
  const int stride = d_head | 1;  // odd row stride: no bank conflicts
  const int64_t blocks = (int64_t)n * n_heads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const auto* x = static_cast<const T*>(qkv);
  const auto* b = static_cast<const T*>(bias);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<T*>(out);
  auto* pr = static_cast<float*>(probs);
  if (qkv_fwd_global(t_len, d_head)) {
    if (gstage == nullptr || slots <= 0) return (int)cudaErrorInvalidValue;
    qkv_fwd_kernel<T, true><<<(unsigned)(slots < blocks ? slots : blocks),
                              kFwdThreads, 0, (cudaStream_t)stream>>>(
        x, b, m, o, pr, n_heads, t_len, d_head, stride, blocks, gstage);
    return (int)cudaGetLastError();
  }
  const size_t smem = qkv_fwd_smem_bytes_for(t_len, d_head);
  cudaError_t err = cudaFuncSetAttribute(
      qkv_fwd_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qkv_fwd_kernel<T, false><<<(unsigned)blocks, kFwdThreads, smem,
                             (cudaStream_t)stream>>>(
      x, b, m, o, pr, n_heads, t_len, d_head, stride, blocks, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace nrk

