// Kernel row 9: the key-blocked exp-normalised multi-head self-attention
// forward, for sequences of flash_min_seq (512) keys and more.
//
// Replaces the TPU kernel newsrecommendation_tpu/ops/pallas/blockwise.py
// :_flash_fwd_kernel (called by _fwd_call, unmasked and masked).
//
// Contract (same as the TPU kernel), per (row, head, query), over key
// blocks of block_kv keys in order, from m = -1e30, l = 0, acc = 0:
//   s     = (q . k_j) * (1/sqrt(D))               f32 dot
//   m'    = max(m, max_{j in block} s_j)           masked keys included
//   scale = exp(m - m')
//   e_j   = exp(s_j - m') * mask_j                 mask after the exp
//   l     = l * scale + sum_j e_j
//   acc   = acc * scale + sum_j round(e_j) v_j      e rounded to v's dtype
//   m     = m'
// then den = l + 1e-8 * exp(-m), o = acc / den (0 where den is not > 0:
// a fully masked row whose max underflowed exp(-m)), and m, den are
// written for the backward. The rounding point differs from rows 1-2 (they
// round the normalised a): the un-normalised e against the running max is
// what meets v here, so a bf16 result depends on block_kv, which is why
// the caller passes JAX's key block.
//
// Bound: at N=128, T=512, H=20, D=20 in bf16 it reads q, k, v and writes
// o (4 * 52 MB) and m, den (10.5 MB): about 0.066 ms at 3.35 TB/s, while
// the 4*N*H*T*T*D = 53.7 GFLOP take 0.054 ms on bf16 tensor cores.
//
// Design (simple, correct first): one thread per query, 128 queries of one
// (row, head) per block; q_i and the two accumulators (acc and the block's
// e@v) live in registers, padded to DM lanes. Per key block, the block
// stages up to 256 keys of k, v and the mask in shared memory as f32; a
// first pass over them takes the block max of s, a second recomputes s,
// e and accumulates. Every thread reads the same key at once, so the
// shared-memory reads are broadcasts. Left on the table: the scores are
// computed twice, the products run on the CUDA cores in f32 (no tensor
// cores: f32 inputs would need TF32, which changes the result), and a
// block of 256 keys leaves at most 4 blocks per SM.

#include "flash.cuh"

namespace {

using namespace nrk;

template <typename T, int DM>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ den_out, int n_heads, int t_len,
                 int d_head, int ld, int block_kv, float inv) {
  extern __shared__ float smem[];
  float* ks = smem;                  // (kFlashTile, DM)
  float* vs = ks + kFlashTile * DM;  // (kFlashTile, DM)
  float* mk = vs + kFlashTile * DM;  // (kFlashTile)
  const int row = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int i = blockIdx.y * kFlashThreads + threadIdx.x;
  const bool active = i < t_len;
  const int64_t base = (int64_t)row * t_len * ld + h * d_head;
  const float* mrow = mask ? mask + (int64_t)row * t_len : nullptr;

  float qi[DM], acc[DM], pv[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    qi[d] = active && d < d_head ? to_f32(q[base + (int64_t)i * ld + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m_run = kNegBig, l = 0.f;

  for (int b0 = 0; b0 < t_len; b0 += block_kv) {
    const int b1 = min(b0 + block_kv, t_len);
    const bool one_tile = b1 - b0 <= kFlashTile;
    // pass 1: the block max of s
    float mx = -INFINITY;
    for (int t0 = b0; t0 < b1; t0 += kFlashTile) {
      const int t1 = min(t0 + kFlashTile, b1);
      __syncthreads();  // the previous tile is no longer read
      load_rows<T, DM>(ks, k, base, ld, t0, t1, d_head);
      load_rows<T, DM>(vs, v, base, ld, t0, t1, d_head);
      for (int j = threadIdx.x; j < t1 - t0; j += blockDim.x)
        mk[j] = mrow ? mrow[t0 + j] : 1.f;
      __syncthreads();
      if (active)
        for (int j = 0; j < t1 - t0; ++j)
          mx = fmaxf(mx, __fmul_rn(dot<DM>(qi, ks + j * DM), inv));
    }
    const float m_new = fmaxf(m_run, mx);
    const float scale = expf(m_run - m_new);
    // pass 2: e against the new max, and e@v
    float lsum = 0.f;
#pragma unroll
    for (int d = 0; d < DM; ++d) pv[d] = 0.f;
    for (int t0 = b0; t0 < b1; t0 += kFlashTile) {
      const int t1 = min(t0 + kFlashTile, b1);
      if (!one_tile) {
        __syncthreads();
        load_rows<T, DM>(ks, k, base, ld, t0, t1, d_head);
        load_rows<T, DM>(vs, v, base, ld, t0, t1, d_head);
        for (int j = threadIdx.x; j < t1 - t0; j += blockDim.x)
          mk[j] = mrow ? mrow[t0 + j] : 1.f;
        __syncthreads();
      }
      if (!active) continue;
      for (int j = 0; j < t1 - t0; ++j) {
        const float s = __fmul_rn(dot<DM>(qi, ks + j * DM), inv);
        const float e = expf(s - m_new) * mk[j];
        lsum += e;
        const float er = round_to<T>(e);  // e in v's dtype
        const float* vj = vs + j * DM;
#pragma unroll
        for (int d = 0; d < DM; ++d) pv[d] = fmaf(er, vj[d], pv[d]);
      }
    }
    l = l * scale + lsum;
#pragma unroll
    for (int d = 0; d < DM; ++d) acc[d] = acc[d] * scale + pv[d];
    m_run = m_new;
  }
  if (!active) return;
  const float den = l + kEps * expf(-m_run);
  const int64_t at = (int64_t)row * t_len + i;
  m_out[at * n_heads + h] = m_run;
  den_out[at * n_heads + h] = den;
  T* o = out + at * n_heads * d_head + h * d_head;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < d_head) o[d] = from_f32<T>(den > 0.f ? acc[d] / den : 0.f);
}

template <typename T>
struct Launch {
  const void *q, *k, *v, *mask;
  void *out, *m, *den;
  int n, t_len, n_heads, d_head, ld, block_kv;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    const size_t smem = sizeof(float) * (2 * kFlashTile * DM + kFlashTile);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t rows = (int64_t)n * n_heads;
    const int tiles = (t_len + kFlashThreads - 1) / kFlashThreads;
    if (rows > 0x7fffffff || tiles > 65535)
      return (int)cudaErrorInvalidConfiguration;
    // 1/sqrt(D) rounded once from double, as the plain version's scalar is
    const float inv = (float)(1.0 / sqrt((double)d_head));
    flash_fwd_kernel<T, DM>
        <<<dim3((unsigned)rows, (unsigned)tiles), kFlashThreads, smem,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v),
                     static_cast<const float*>(mask), static_cast<T*>(out),
                     static_cast<float*>(m), static_cast<float*>(den),
                     n_heads, t_len, d_head, ld, block_kv, inv);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* m, void* den, int n, int t_len, int n_heads,
           int d_head, int ld, int block_kv, void* stream) {
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  if (block_kv <= 0) return (int)cudaErrorInvalidValue;
  return with_head_width(
      d_head, Launch<T>{q, k, v, mask, out, m, den, n, t_len, n_heads,
                        d_head, ld, block_kv, (cudaStream_t)stream});
}

}  // namespace

extern "C" {

// mask may be null. Returns cudaGetLastError() after the launch: 0 when
// the kernel was queued.
int flash_fwd_f32(const void* q, const void* k, const void* v,
                  const void* mask, void* out, void* m, void* den, int n,
                  int t_len, int n_heads, int d_head, int ld, int block_kv,
                  void* stream) {
  return launch<float>(q, k, v, mask, out, m, den, n, t_len, n_heads, d_head,
                       ld, block_kv, stream);
}

int flash_fwd_bf16(const void* q, const void* k, const void* v,
                   const void* mask, void* out, void* m, void* den, int n,
                   int t_len, int n_heads, int d_head, int ld, int block_kv,
                   void* stream) {
  return launch<__nv_bfloat16>(q, k, v, mask, out, m, den, n, t_len, n_heads,
                               d_head, ld, block_kv, stream);
}

}  // extern "C"
