// Backward of the exp-normalised multi-head self-attention over a fused
// [q|k|v] projection, from the f32 probs its forward saved.
//
// Replaces the TPU kernel newsrecommendation_tpu/ops/pallas/fused_attention.py
// :_qkv_bwd_probs_kernel (called by _qkv_bwd_probs_call, bias variant).
//
// Contract (same as the TPU kernel):
//   qkv   (N, T, 3*H*D) un-biased projection; bias (3*H*D,) added at the
//         input dtype, as in the forward
//   probs (N, T, H*T) f32 from qkv_fwd.cu: a of head h at lanes [h*T, (h+1)*T)
//         (it carries the mask: a masked key's a is 0, so no mask operand)
//   g     (N, T, H*D) incoming gradient of the context, in qkv's dtype
//   dqkv  (N, T, 3*H*D) in qkv's dtype: dq, dk, dv of head h at lanes h*D,
//         H*D + h*D, 2*H*D + h*D
// Per head, with f32 accumulation everywhere:
//   dv = round(a)^T g                 a rounded to g's dtype first
//   da = g v^T
//   ds = (da - rowsum(da * a)) * a * (1/sqrt(D))    with the f32 a
//   dq = round(ds) k,  dk = round(ds)^T q           ds rounded to k's dtype
// d(bias) is the sum of dqkv over (N, T), a plain reduce left to the caller.
//
// Bound: memory. One call reads qkv, probs and g once and writes dqkv once:
// at N=7040, T=20, H=20, D=20 in bf16 that is 338 + 225 + 113 + 338 MB,
// 1,014 MB, about 0.30 ms at 3.35 TB/s, against 8*N*H*T*T*D = 9.0 GFLOP.
//
// Design (simple, correct first): one block of 4 warps per (row n, head h).
// The block stages q_h, k_h, v_h and g_h (T x D each, rounded to the input
// dtype and held as f32, with an odd row stride) and a (T x T f32, odd
// stride) in shared memory: 27.8 KB at T=50, D=20. Threads over (j, d)
// write dv; one warp per query row computes da into a per-warp row, the
// row sum by warp shuffles, and overwrites that row of a with ds; then
// threads over (i, d) write dq and dk. Left on the table, as in the
// forward: 2*D-byte runs instead of 16-byte loads, idle lanes at T=20, and
// no tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline size_t smem_floats(int t_len, int d_head) {
  return 4 * (size_t)t_len * (d_head | 1) + (size_t)t_len * (t_len | 1) +
         (size_t)kWarps * t_len;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qkv_bwd_probs_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                     const float* __restrict__ probs,
                     const T* __restrict__ g, T* __restrict__ dqkv,
                     int n_heads, int t_len, int d_head, float inv) {
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
  float* darow = a + t_len * astride;  // (kWarps, T) per-warp da row

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
  const float* psrc = probs + (int64_t)row * t_len * n_heads * t_len +
                      h * t_len;
  for (int idx = threadIdx.x; idx < t_len * t_len; idx += kThreads) {
    const int i = idx / t_len;
    const int j = idx - i * t_len;
    a[i * astride + j] = psrc[(int64_t)i * n_heads * t_len + j];
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
  for (int i = warp; i < t_len; i += kWarps) {
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

template <typename T>
int launch(const void* qkv, const void* bias, const void* probs,
           const void* g, void* dqkv, int n, int t_len, int n_heads,
           int d_head, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * smem_floats(t_len, d_head);
  cudaError_t err = cudaFuncSetAttribute(
      qkv_bwd_probs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)n * n_heads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  // 1/sqrt(D) rounded once from double, as the plain version's scalar is
  const float inv = (float)(1.0 / sqrt((double)d_head));
  qkv_bwd_probs_kernel<T><<<(unsigned)blocks, kThreads, smem,
                            (cudaStream_t)stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(bias),
      static_cast<const float*>(probs), static_cast<const T*>(g),
      static_cast<T*>(dqkv), n_heads, t_len, d_head, inv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch: 0 when the kernel was queued.
int qkv_bwd_probs_f32(const void* qkv, const void* bias, const void* probs,
                      const void* g, void* dqkv, int n, int t_len,
                      int n_heads, int d_head, void* stream) {
  return launch<float>(qkv, bias, probs, g, dqkv, n, t_len, n_heads, d_head,
                       stream);
}

int qkv_bwd_probs_bf16(const void* qkv, const void* bias, const void* probs,
                       const void* g, void* dqkv, int n, int t_len,
                       int n_heads, int d_head, void* stream) {
  return launch<__nv_bfloat16>(qkv, bias, probs, g, dqkv, n, t_len, n_heads,
                               d_head, stream);
}

int qkv_bwd_probs_smem_bytes(int t_len, int d_head) {
  return (int)(sizeof(float) * smem_floats(t_len, d_head));
}

}  // extern "C"
