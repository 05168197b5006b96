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
// At the user encoder over 512-news histories (N = 128, T = 512) the
// products, 4*N*H*T*T*D + 2*N*T*HD*Q (53.7 + 10.5 GFLOP), take 0.96 ms at
// the f32 CUDA-core peak the f32-exact tiled regime runs on (0.065 ms at
// the bf16 tensor-core peak, the bound stated for bf16).
//
// Design, in three regimes chosen from (T, D, dtype) by the launch plan
// (ops/experimental_fused_encoder.py:tail_launch_plan); the entry points
// refuse a regime that is not the shape's (tail_regime):
//   resident (T <= 64, heads of up to 64): items of one batch row walked
//     as row 15's sub-items (fused_tail.cuh, the resident regime): the
//     attention is row 15's per-(head, query) pass with the f32 context
//     times keep kept in shared memory, fc1 runs in k order on CUDA cores
//     (tail_fma); only out leaves the block.
//   tiled (past it, T up to 1024 at D = 20): three launches (fused_tail.cuh,
//     the tiled regime): the attention per (row, head) into an f32
//     context in scratch, fc1 and the scores per 40 positions, then alpha
//     and out per row (tail_tiled_out_kernel below).
//   global (heads wider than 64, or longer rows): one block of 8 warps per
//     row, the heads one after another (fused_tail.cuh's per-row phases),
//     fc1 as f32 FMAs on the CUDA cores, ctx, e and q/k/v in the block
//     slot's part of a global scratch (past T = 6456 its row buffers and
//     alpha too), and `slots` blocks walk the rows.

#include "fused_tail.cuh"

namespace {

using namespace nrk;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ctx, e and q/k/v in this block's slot of scratch; kSmallGlobal (past the
// small buffers' limit): the row buffers and alpha there too
template <typename T, bool kSmallGlobal>
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
  // the big buffers in this block's scratch slot
  const size_t slot =
      tail_big_floats(t_len, n_heads, d_head, q_dim) +
      (kSmallGlobal ? tail_fwd_small_floats(t_len, kWarps) : 0);
  float* ctx = scratch + blockIdx.x * slot;  // (T, HD)
  float* e = ctx + t_len * hd;               // (T, Q) tanh(z)
  float* qs = e + t_len * q_dim;             // (3, T, stride) q, k, v
  float* rows = kSmallGlobal ? qs + 3 * t_len * stride : smem;  // (kWarps, T)
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
  for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
    body(row);
    __syncthreads();  // the next row overwrites ctx and alpha
  }
}

// The tiled regime's last phase: alpha over the row's scores s (N, T),
// then out = sum_t alpha_t ctx_t over the positions in order, for
// kOutCols columns of the row (blockIdx.y); alpha in shared memory (T
// floats).
template <typename T>
__global__ void __launch_bounds__(kOutCols)
tail_tiled_out_kernel(const float* __restrict__ ctx,
                      const float* __restrict__ s,
                      const float* __restrict__ mask, T* __restrict__ out,
                      int t_len, int hd) {
  extern __shared__ float alpha[];
  const int64_t row = blockIdx.x;
  for (int i = threadIdx.x; i < t_len; i += kOutCols)
    alpha[i] = s[row * t_len + i];
  __syncthreads();
  if (threadIdx.x < 32)
    tail_alpha(alpha, mask ? mask + row * t_len : nullptr, t_len,
               threadIdx.x, nullptr);
  __syncthreads();
  const int c = blockIdx.y * kOutCols + threadIdx.x;
  if (c >= hd) return;
  const float* x = ctx + row * t_len * hd + c;
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < t_len; ++i)
    acc = fmaf(alpha[i], x[(int64_t)i * hd], acc);
  out[row * hd + c] = from_f32<T>(acc);
}

// Row 13 in the tiled regime (fused_tail.cuh): the attention, the pooling
// blocks, the output blocks; scratch holds the f32 context (N*T*HD) and
// the scores (N*T).
template <typename T>
int tiled(const T* qkv, const float* mask, const T* w1, const float* b1,
          const T* w2, const float* b2, const int* seed, T* out,
          float* scratch, int n, int t_len, int n_heads, int d_head,
          int q_dim, int tile, int use_dropout, uint32_t thr, float scale,
          cudaStream_t stream) {
  const TileLay l = tile_lay(t_len, d_head, tile);
  if ((tile != 16 && tile != 32 && tile != 64) ||
      l.bytes > (size_t)bl::kMaxSmem || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int hd = n_heads * d_head;
  const int64_t n_pos = (int64_t)n * t_len;
  float* ctx = scratch;
  float* s = scratch + n_pos * hd;
  auto* attn = tail_tiled_attn_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      attn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.bytes);
  if (err != cudaSuccess) return (int)err;
  attn<<<(unsigned)(n * n_heads), kTileThreads, l.bytes, stream>>>(
      qkv, mask, seed, ctx, n_heads, t_len, d_head,
      (float)(1.0 / sqrt((double)d_head)), l, use_dropout, thr, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto* pool = tail_tiled_pool_kernel<T, false>;
  const size_t pool_bytes = tail_pool_bytes(hd, q_dim);
  err = cudaFuncSetAttribute(
      pool, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pool_bytes);
  if (err != cudaSuccess) return (int)err;
  pool<<<(unsigned)((n_pos + kPoolRows - 1) / kPoolRows), bl::kThreads,
         pool_bytes, stream>>>(ctx, w1, b1, w2, b2, nullptr, s, nullptr,
                               nullptr, n_pos, t_len, hd, q_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tail_tiled_out_kernel<T>
      <<<dim3((unsigned)n, (hd + kOutCols - 1) / kOutCols), kOutCols,
         4 * (size_t)t_len, stream>>>(ctx, s, mask, out, t_len, hd);
  return (int)cudaGetLastError();
}

// shared bytes of the per-row kernel: its small buffers, 0 past their
// limit
size_t smem_bytes(int t_len) {
  if (tail_fwd_small_global(t_len, kWarps)) return 0;
  return sizeof(float) * tail_fwd_small_floats(t_len, kWarps);
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
           int q_dim, int regime, int heads, int nbuf, int blocks, int tile,
           int slots, int use_dropout, unsigned thr, float scale,
           void* stream) {
  const int esize = (int)sizeof(T);
  if (regime != tail_regime(0, t_len, n_heads, d_head, q_dim, esize) ||
      (tile != 0) != (regime == kTailTiled))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  if (regime == kTailTiled) {
    if (heads || nbuf || blocks || slots) return (int)cudaErrorInvalidValue;
    return tiled<T>(static_cast<const T*>(qkv),
                    static_cast<const float*>(mask),
                    static_cast<const T*>(w1), static_cast<const float*>(b1),
                    static_cast<const T*>(w2), static_cast<const float*>(b2),
                    static_cast<const int*>(seed), static_cast<T*>(out),
                    static_cast<float*>(scratch), n, t_len, n_heads, d_head,
                    q_dim, tile, use_dropout, thr, scale,
                    (cudaStream_t)stream);
  }
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
  if (heads || nbuf || blocks || scratch == nullptr || slots <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(t_len);
  auto* kernel = tail_fwd_small_global(t_len, kWarps)
                     ? fused_tail_fwd_kernel<T, true>
                     : fused_tail_fwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float inv = (float)(1.0 / sqrt((double)d_head));
  kernel<<<(unsigned)(slots < n ? slots : n), kThreads, smem,
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
// resident, 1 global, the per-row kernel with its working set in global
// memory, 2 tiled: fused_tail_fwd_regime), with the resident plan
// (heads, nbuf, blocks) and the tiled regime's sub-tile `tile` of
// ops/experimental_fused_encoder.py:tail_launch_plan (zeros in the other
// regimes). With use_dropout 0, thr and scale are not read. scratch: in
// the global regime `slots` slots of fused_tail_fwd_scratch_floats each;
// in the tiled regime N rows of fused_tail_fwd_row_floats (slots 0);
// else not read. Returns cudaGetLastError() after the launches: 0 when
// the kernels were queued; cudaErrorInvalidValue for a regime that is not
// the shape's or a plan its kernels do not take.
#define NRK_TAIL_FWD(SUFFIX, T)                                               \
  int fused_tail_fwd_##SUFFIX(                                                \
      const void* qkv, const void* mask, const void* w1, const void* b1,      \
      const void* w2, const void* b2, const void* seed, void* out,            \
      void* scratch, int n, int t_len, int n_heads, int d_head,               \
      int q_dim, int regime, int heads, int nbuf, int blocks, int tile,       \
      int slots, int use_dropout, unsigned thr, float scale, void* stream) {  \
    return launch<T>(qkv, mask, w1, b1, w2, b2, seed, out, scratch, n,        \
                     t_len, n_heads, d_head, q_dim, regime, heads, nbuf,      \
                     blocks, tile, slots, use_dropout, thr, scale, stream);   \
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

// The tiled regime's attention block bytes at sub-tile m (tile_lay), and
// the floats of scratch a batch row takes in that regime (its f32 context
// and scores; 0 in the other regimes).
int fused_tail_tiled_smem_bytes(int t_len, int d_head, int m) {
  return (int)tile_lay(t_len, d_head, m).bytes;
}

int fused_tail_fwd_row_floats(int t_len, int n_heads, int d_head, int q_dim,
                              int esize) {
  if (tail_regime(0, t_len, n_heads, d_head, q_dim, esize) != kTailTiled)
    return 0;
  return t_len * (n_heads * d_head + 1);
}

// Floats of one scratch slot of the per-row kernel (the global regime).
int fused_tail_fwd_scratch_floats(int t_len, int n_heads, int d_head,
                                  int q_dim) {
  return (int)(tail_big_floats(t_len, n_heads, d_head, q_dim) +
               (tail_fwd_small_global(t_len, kWarps)
                    ? tail_fwd_small_floats(t_len, kWarps)
                    : 0));
}

}  // extern "C"
