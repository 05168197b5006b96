// Kernel row 13: the fused NRMS encoder tail forward, exp-MHSA -> dropout
// -> additive attention pooling in one kernel, (N, T, 3HD) in, (N, HD) out.
//
// Replaces the TPU kernels newsrecommendation_tpu/ops/pallas/
// experimental_fused_encoder.py:_fwd_kernel and :_masked_fwd_kernel
// (called by _fwd_call). Contract and rounding points: fused_tail.cuh.
//
// Bound: at the news encoder of the headline step (N = 7040, T = 20,
// H = D = 20, Q = 200, bf16) the call reads qkv once (338 MB) and writes
// the pooled rows (5.6 MB): 0.10 ms at 3.35 TB/s. Its products are
// 4*N*H*T*T*D (4.5 GFLOP, attention) + 2*N*T*HD*Q (22.5 GFLOP, fc1), 0.03
// ms at the bf16 tensor-core peak: bytes bound it.
//
// Design, in three regimes chosen from (T, D, dtype) by the launch plan
// (ops/experimental_fused_encoder.py:tail_launch_plan); the entry points
// refuse a regime that is not the shape's (tail_regime):
//   resident (T <= 64, heads of up to 64): items of one batch row walked
//     as row 15's sub-items (fused_tail.cuh, the resident regime): the
//     attention is row 15's per-(head, query) pass with the f32 context
//     times keep kept in shared memory, fc1 runs in k order on CUDA cores
//     (tail_fma); only out leaves the block.
//   shared (T up to 86 at the NRMS width): one block of 8 warps per row,
//     the heads one after another (fused_tail.cuh's per-row phases), fc1
//     as f32 FMAs on the CUDA cores.
//   global: the same with ctx, e and q/k/v in the block slot's part of a
//     global scratch (past T = 6456 its row buffers and alpha too), and
//     `slots` blocks walk the rows.

#include "fused_tail.cuh"

namespace {

using namespace nrk;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// kGlobal: ctx, e and q/k/v in this block's slot of scratch; kSmallGlobal
// (past the small buffers' limit): the row buffers and alpha there too
template <typename T, bool kGlobal, bool kSmallGlobal>
__global__ void __launch_bounds__(kThreads)
fused_tail_fwd_kernel(const T* __restrict__ qkv,
                      const float* __restrict__ mask,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, const float* __restrict__ b2,
                      const int* __restrict__ seed, T* __restrict__ out,
                      float* scratch, int64_t n, int n_heads, int t_len,
                      int d_head, int q_dim, float inv, int use_dropout,
                      uint32_t thr, float scale) {
  extern __shared__ float smem[];
  const int hd = n_heads * d_head;
  const int stride = d_head | 1;  // odd row stride: no bank conflicts
  // the big buffers in shared memory, or in this block's scratch slot
  const size_t slot =
      tail_big_floats(t_len, n_heads, d_head, q_dim) +
      (kSmallGlobal ? tail_fwd_small_floats(t_len, kWarps) : 0);
  float* ctx = kGlobal ? scratch + blockIdx.x * slot : smem;  // (T, HD)
  float* e = ctx + t_len * hd;               // (T, Q) tanh(z)
  float* qs = e + t_len * q_dim;             // (3, T, stride) q, k, v
  float* rows = kGlobal && !kSmallGlobal
                    ? smem
                    : qs + 3 * t_len * stride;  // (kWarps, T)
  float* alpha = rows + kWarps * t_len;      // (T) pooling weights

  const TailDropout drop{use_dropout != 0,
                         use_dropout ? (uint32_t)seed[0] : 0u, thr, scale};
  auto body = [&](int64_t row) {
    const float* mrow = mask ? mask + row * t_len : nullptr;
    tail_context<T, kThreads>(ctx, qs, rows, qkv + row * t_len * 3 * hd,
                              mrow, row, n_heads, t_len, d_head, stride, inv,
                              drop);
    tail_pool_scores<T, kThreads>(e, alpha, ctx, w1, b1, w2, b2, mrow, t_len,
                                  hd, q_dim);
    for (int c = threadIdx.x; c < hd; c += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < t_len; ++i)
        acc = fmaf(alpha[i], ctx[i * hd + c], acc);
      out[row * hd + c] = from_f32<T>(acc);
    }
  };
  if constexpr (kGlobal) {
    for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
      body(row);
      __syncthreads();  // the next row overwrites ctx and alpha
    }
  } else {
    body(blockIdx.x);  // one row per block
  }
}

size_t smem_bytes(int t_len, int n_heads, int d_head, int q_dim) {
  if (tail_fwd_small_global(t_len, kWarps)) return 0;
  const size_t small = tail_fwd_small_floats(t_len, kWarps);
  return sizeof(float) *
         (tail_fwd_global(t_len, n_heads, d_head, q_dim, kWarps)
              ? small
              : small + tail_big_floats(t_len, n_heads, d_head, q_dim));
}

// Row 13 at T <= 64 under the resident plan (heads, nbuf, blocks).
template <typename T>
struct ResidentFwd {
  const T *qkv, *w1, *w2;
  const float *mask, *b1, *b2;
  const int* seed;
  T* out;
  bl::Params p;
  TailRes r;
  unsigned blocks;
  int use_dropout;
  uint32_t thr;
  float scale;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    auto* kernel = tail_resident_fwd_kernel<T, DM>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)r.bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, bl::kThreads, r.bytes, stream>>>(
        qkv, mask, w1, b1, w2, b2, seed, out, p, r, use_dropout, thr, scale);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int launch(const void* qkv, const void* mask, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* seed,
           void* out, void* scratch, int n, int t_len, int n_heads, int d_head,
           int q_dim, int regime, int heads, int nbuf, int blocks, int slots,
           int use_dropout, unsigned thr, float scale, void* stream) {
  const int esize = (int)sizeof(T);
  if (regime != tail_regime(0, t_len, n_heads, d_head, q_dim, esize))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  if (regime == kTailResident) {
    const TailRes r = tail_res(0, t_len, n_heads, d_head, q_dim, esize,
                               heads, nbuf);
    if (!tail_res_ok(r, n_heads, heads, nbuf, blocks))
      return (int)cudaErrorInvalidValue;
    const bl::Params p = bl::params_of(bl::kFwd, n, t_len, n_heads, d_head,
                                       esize, heads, t_len, nbuf, qkv, qkv);
    if (p.items == 0) return (int)cudaErrorInvalidConfiguration;
    return with_head_width(
        d_head,
        ResidentFwd<T>{static_cast<const T*>(qkv), static_cast<const T*>(w1),
                       static_cast<const T*>(w2),
                       static_cast<const float*>(mask),
                       static_cast<const float*>(b1),
                       static_cast<const float*>(b2),
                       static_cast<const int*>(seed), static_cast<T*>(out), p,
                       r, (unsigned)(blocks < n ? blocks : n),
                       use_dropout, thr, scale, (cudaStream_t)stream});
  }
  if (heads || nbuf || blocks) return (int)cudaErrorInvalidValue;
  const bool global = regime == kTailGlobal;
  if (global && (scratch == nullptr || slots <= 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(t_len, n_heads, d_head, q_dim);
  auto* kernel = tail_fwd_small_global(t_len, kWarps)
                     ? fused_tail_fwd_kernel<T, true, true>
                 : global ? fused_tail_fwd_kernel<T, true, false>
                          : fused_tail_fwd_kernel<T, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float inv = (float)(1.0 / sqrt((double)d_head));
  kernel<<<(unsigned)(global && slots < n ? slots : n), kThreads, smem,
           (cudaStream_t)stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const int*>(seed), static_cast<T*>(out),
      static_cast<float*>(scratch), n, n_heads, t_len, d_head, q_dim, inv,
      use_dropout, thr, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mask may be null (the unmasked variant). regime: the shape's (0
// resident, 1 the per-row kernel in shared memory, 2 with its working set
// in global memory: fused_tail_fwd_regime), with the resident plan (heads,
// nbuf, blocks) of ops/experimental_fused_encoder.py:tail_launch_plan
// (zeros in the other regimes). With use_dropout 0, thr and scale are not
// read. scratch, `slots` slots of fused_tail_fwd_scratch_floats each, is
// read only in the global regime. Returns cudaGetLastError() after the
// launch: 0 when the kernel was queued; cudaErrorInvalidValue for a regime
// that is not the shape's or a plan its kernel does not take.
#define NRK_TAIL_FWD(SUFFIX, T)                                               \
  int fused_tail_fwd_##SUFFIX(                                                \
      const void* qkv, const void* mask, const void* w1, const void* b1,      \
      const void* w2, const void* b2, const void* seed, void* out,            \
      void* scratch, int n, int t_len, int n_heads, int d_head,               \
      int q_dim, int regime, int heads, int nbuf, int blocks, int slots,      \
      int use_dropout, unsigned thr, float scale, void* stream) {             \
    return launch<T>(qkv, mask, w1, b1, w2, b2, seed, out, scratch, n,        \
                     t_len, n_heads, d_head, q_dim, regime, heads, nbuf,      \
                     blocks, slots, use_dropout, thr, scale, stream);         \
  }
NRK_TAIL_FWD(f32, float)
NRK_TAIL_FWD(bf16, __nv_bfloat16)
#undef NRK_TAIL_FWD

// The forward's regime at (T, H, D, Q) in a dtype of esize bytes (see
// fused_tail_fwd_f32), and the shared bytes of a resident block under
// (heads, nbuf): what tail_launch_plan computes in Python.
int fused_tail_fwd_regime(int t_len, int n_heads, int d_head, int q_dim,
                          int esize) {
  return tail_regime(0, t_len, n_heads, d_head, q_dim, esize);
}

int fused_tail_fwd_smem_bytes(int t_len, int n_heads, int d_head, int q_dim,
                              int esize, int heads, int nbuf) {
  return (int)tail_res(0, t_len, n_heads, d_head, q_dim, esize, heads, nbuf)
      .bytes;
}

// Floats of one scratch slot: 0 when the row fits in shared memory.
int fused_tail_fwd_scratch_floats(int t_len, int n_heads, int d_head,
                                  int q_dim) {
  if (!tail_fwd_global(t_len, n_heads, d_head, q_dim, kWarps)) return 0;
  return (int)(tail_big_floats(t_len, n_heads, d_head, q_dim) +
               (tail_fwd_small_global(t_len, kWarps)
                    ? tail_fwd_small_floats(t_len, kWarps)
                    : 0));
}

}  // extern "C"
