// Kernel row 10: the backward of the key-blocked exp-normalised multi-head
// self-attention (flash_fwd.cu), from the forward's per-row m and den.
//
// Replaces the TPU kernel newsrecommendation_tpu/ops/pallas/blockwise.py
// :_flash_bwd_kernel (called by _bwd_call, unmasked and masked).
//
// Contract (same as the TPU kernel), per (row, head):
//   a_ij  = exp(s_ij - m_i) * mask_j / den_i        (0 where den_i is not > 0)
//   dv_j  = sum_i round(a_ij) g_i                   a rounded to g's dtype
//   da_ij = g_i . v_j
//   ds_ij = (da_ij - delta_i) * a_ij / sqrt(D)      delta_i = g_i . o_i, f32,
//                                                   computed by the caller
//   dq_i  = sum_j round(ds_ij) k_j,  dk_j = sum_i round(ds_ij) q_i
// with ds rounded to k's dtype and f32 accumulation everywhere.
//
// Bound: at N=128, T=512, H=20, D=20 in bf16 it reads q, k, v, g and
// writes dq, dk, dv (7 * 52 MB) and reads m, den, delta (15.7 MB): 0.114
// ms at 3.35 TB/s, while the 10*N*H*T*T*D = 134 GFLOP take 0.136 ms on
// bf16 tensor cores, so operations bound it.
//
// Design: the TPU kernel sums dq over the key blocks of a sequential grid
// axis in scratch. Blocks of a GPU run in no order, so this is two
// kernels, neither with atomics, and each sum runs in index order, the
// same on every run:
//   dk/dv: one thread per key j (128 keys of one (row, head) per block)
//     holds k_j, v_j and the two accumulators in registers and walks all
//     queries in tiles of 256 staged in shared memory (q, g, m, den,
//     delta);
//   dq: one thread per query i holds q_i, g_i and dq_i and walks all keys
//     in tiles of 256 (k, v, mask).
// Both recompute s, a, da and ds. Left on the table, as in the forward:
// the products run on the CUDA cores in f32, each pair's s and da are
// computed by both kernels, and no tensor cores.

#include "flash.cuh"

namespace {

using namespace nrk;

template <typename T, int DM>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ mask,
                      const T* __restrict__ g, const float* __restrict__ m,
                      const float* __restrict__ den,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int n_heads, int t_len, int d_head,
                      int ld, float inv) {
  extern __shared__ float smem[];
  float* qs = smem;                  // (kFlashTile, DM)
  float* gs = qs + kFlashTile * DM;  // (kFlashTile, DM)
  float* ms = gs + kFlashTile * DM;  // (kFlashTile) m, den, delta
  float* dens = ms + kFlashTile;
  float* dls = dens + kFlashTile;
  const int row = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int hd = n_heads * d_head;
  const int j = blockIdx.y * kFlashThreads + threadIdx.x;
  const bool active = j < t_len;
  const int64_t base = (int64_t)row * t_len * ld + h * d_head;
  const int64_t gbase = (int64_t)row * t_len * hd + h * d_head;
  const float mask_j = mask && active ? mask[(int64_t)row * t_len + j] : 1.f;

  float kj[DM], vj[DM], dkj[DM], dvj[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    const bool in = active && d < d_head;
    kj[d] = in ? to_f32(k[base + (int64_t)j * ld + d]) : 0.f;
    vj[d] = in ? to_f32(v[base + (int64_t)j * ld + d]) : 0.f;
    dkj[d] = dvj[d] = 0.f;
  }

  for (int t0 = 0; t0 < t_len; t0 += kFlashTile) {
    const int t1 = min(t0 + kFlashTile, t_len);
    __syncthreads();  // the previous tile is no longer read
    load_rows<T, DM>(qs, q, base, ld, t0, t1, d_head);
    load_rows<T, DM>(gs, g, gbase, hd, t0, t1, d_head);
    for (int i = threadIdx.x; i < t1 - t0; i += blockDim.x) {
      const int64_t at = ((int64_t)row * t_len + t0 + i) * n_heads + h;
      ms[i] = m[at];
      dens[i] = den[at];
      dls[i] = delta[at];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < t1 - t0; ++i) {
      const float* qi = qs + i * DM;
      const float* gi = gs + i * DM;
      const float e = expf(__fmul_rn(dot<DM>(qi, kj), inv) - ms[i]) * mask_j;
      const float a = dens[i] > 0.f ? e / dens[i] : 0.f;
      const float al = round_to<T>(a);  // a in g's dtype, for dv
      const float ds = round_to<T>((dot<DM>(gi, vj) - dls[i]) * a * inv);
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        dvj[d] = fmaf(al, gi[d], dvj[d]);
        dkj[d] = fmaf(ds, qi[d], dkj[d]);
      }
    }
  }
  if (!active) return;
  const int64_t at = gbase + (int64_t)j * hd;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < d_head) {
      dk[at + d] = from_f32<T>(dkj[d]);
      dv[at + d] = from_f32<T>(dvj[d]);
    }
}

template <typename T, int DM>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ mask,
                    const T* __restrict__ g, const float* __restrict__ m,
                    const float* __restrict__ den,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n_heads, int t_len, int d_head, int ld, float inv) {
  extern __shared__ float smem[];
  float* ks = smem;                  // (kFlashTile, DM)
  float* vs = ks + kFlashTile * DM;  // (kFlashTile, DM)
  float* mk = vs + kFlashTile * DM;  // (kFlashTile)
  const int row = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int hd = n_heads * d_head;
  const int i = blockIdx.y * kFlashThreads + threadIdx.x;
  const bool active = i < t_len;
  const int64_t base = (int64_t)row * t_len * ld + h * d_head;
  const int64_t gbase = (int64_t)row * t_len * hd + h * d_head;
  const float* mrow = mask ? mask + (int64_t)row * t_len : nullptr;
  const int64_t at = ((int64_t)row * t_len + i) * n_heads + h;
  const float m_i = active ? m[at] : 0.f;
  const float den_i = active ? den[at] : 1.f;
  const float delta_i = active ? delta[at] : 0.f;

  float qi[DM], gi[DM], dqi[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    const bool in = active && d < d_head;
    qi[d] = in ? to_f32(q[base + (int64_t)i * ld + d]) : 0.f;
    gi[d] = in ? to_f32(g[gbase + (int64_t)i * hd + d]) : 0.f;
    dqi[d] = 0.f;
  }

  for (int t0 = 0; t0 < t_len; t0 += kFlashTile) {
    const int t1 = min(t0 + kFlashTile, t_len);
    __syncthreads();
    load_rows<T, DM>(ks, k, base, ld, t0, t1, d_head);
    load_rows<T, DM>(vs, v, base, ld, t0, t1, d_head);
    for (int j = threadIdx.x; j < t1 - t0; j += blockDim.x)
      mk[j] = mrow ? mrow[t0 + j] : 1.f;
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < t1 - t0; ++j) {
      const float* kj = ks + j * DM;
      const float e = expf(__fmul_rn(dot<DM>(qi, kj), inv) - m_i) * mk[j];
      const float a = den_i > 0.f ? e / den_i : 0.f;
      const float ds =
          round_to<T>((dot<DM>(gi, vs + j * DM) - delta_i) * a * inv);
#pragma unroll
      for (int d = 0; d < DM; ++d) dqi[d] = fmaf(ds, kj[d], dqi[d]);
    }
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < d_head) dq[gbase + (int64_t)i * hd + d] = from_f32<T>(dqi[d]);
}

template <typename T>
struct Launch {
  const void *q, *k, *v, *mask, *g, *m, *den, *delta;
  void *dq, *dk, *dv;
  int n, t_len, n_heads, d_head, ld;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    const size_t smem_kv =
        sizeof(float) * (2 * kFlashTile * DM + 3 * kFlashTile);
    const size_t smem_q = sizeof(float) * (2 * kFlashTile * DM + kFlashTile);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, DM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_q);
    if (err != cudaSuccess) return (int)err;
    const int64_t rows = (int64_t)n * n_heads;
    const int tiles = (t_len + kFlashThreads - 1) / kFlashThreads;
    if (rows > 0x7fffffff || tiles > 65535)
      return (int)cudaErrorInvalidConfiguration;
    // 1/sqrt(D) rounded once from double, as the plain version's scalar is
    const float inv = (float)(1.0 / sqrt((double)d_head));
    const dim3 grid((unsigned)rows, (unsigned)tiles);
    flash_bwd_dkdv_kernel<T, DM><<<grid, kFlashThreads, smem_kv, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(mask),
        static_cast<const T*>(g), static_cast<const float*>(m),
        static_cast<const float*>(den), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), n_heads, t_len, d_head, ld,
        inv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_kernel<T, DM><<<grid, kFlashThreads, smem_q, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(mask),
        static_cast<const T*>(g), static_cast<const float*>(m),
        static_cast<const float*>(den), static_cast<const float*>(delta),
        static_cast<T*>(dq), n_heads, t_len, d_head, ld, inv);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* g, const void* m, const void* den, const void* delta,
           void* dq, void* dk, void* dv, int n, int t_len, int n_heads,
           int d_head, int ld, void* stream) {
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  return with_head_width(
      d_head, Launch<T>{q, k, v, mask, g, m, den, delta, dq, dk, dv, n, t_len,
                        n_heads, d_head, ld, (cudaStream_t)stream});
}

}  // namespace

extern "C" {

// mask may be null. Returns cudaGetLastError() after the two launches: 0
// when both kernels were queued.
int flash_bwd_f32(const void* q, const void* k, const void* v,
                  const void* mask, const void* g, const void* m,
                  const void* den, const void* delta, void* dq, void* dk,
                  void* dv, int n, int t_len, int n_heads, int d_head, int ld,
                  void* stream) {
  return launch<float>(q, k, v, mask, g, m, den, delta, dq, dk, dv, n, t_len,
                       n_heads, d_head, ld, stream);
}

int flash_bwd_bf16(const void* q, const void* k, const void* v,
                   const void* mask, const void* g, const void* m,
                   const void* den, const void* delta, void* dq, void* dk,
                   void* dv, int n, int t_len, int n_heads, int d_head,
                   int ld, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, mask, g, m, den, delta, dq, dk, dv, n,
                               t_len, n_heads, d_head, ld, stream);
}

}  // extern "C"
