// Kernel rows 5-8: exp-normalised multi-head self-attention on separate q,
// k and v, forward (rows 5 and 7) and the backward that recomputes the
// probs (rows 6 and 8), unmasked and key-masked.
//
// Replaces the TPU kernels newsrecommendation_tpu/ops/pallas/
// fused_attention.py:_fwd_kernel (row 5, _fwd_call), :_bwd_kernel (row 6,
// _bwd_call), :_masked_fwd_kernel (row 7, _masked_fwd_call) and
// :_masked_bwd_kernel (row 8, _masked_bwd_call). The JAX package reaches
// them when the q/k/v widths differ.
//
// Contract (the TPU kernels', with d_v a width of its own):
//   q, k (N, T, H*Dk) and v (N, T, H*Dv) in the input dtype, lanes
//        contiguous, rows ldq, ldk, ldv elements apart (views of one fused
//        projection may share a stride); head h at lanes h*Dk (q, k) and
//        h*Dv (v)
//   mask (N, T) f32 over keys, or null
//   s = (q_h . k_h) * (1/sqrt(Dk))            f32 sum, scale after
//   a = exp(s - m) * mask / (sum + 1e-8 exp(-m)), m over ALL keys
//   out = round(a) v_h                          (N, T, H*Dv), f32 sums
// backward, g (N, T, H*Dv) in the input dtype:
//   dv = round(a)^T g,  da = g v^T,  ds = round((da - rowsum(da a)) a
//   / sqrt(Dk)),  dq = ds k,  dk = ds^T q      dq, dk (N, T, H*Dk) and dv
//   (N, T, H*Dv), contiguous, in the input dtype.
// The TPU kernels size the output and v's head slice by q's width, so at
// Dv != Dk they return the wrong shape; these take Dv as its own loop
// bound and compute what the JAX package computes with Pallas off.
//
// Bound: memory. At N = 7040, T = 20, H = 20, Dk = 20, Dv = 32 in bf16 the
// forward reads q, k, v and writes out (586 MB, 0.175 ms at 3.35 TB/s); the
// backward reads q, k, v, g and writes dq, dk, dv (991 MB, 0.296 ms)
// against N*H*T*T*(6*Dk + 4*Dv) = 14.0 GFLOP (0.014 ms at the bf16
// tensor-core peak). Past T = 64 the forward is still bound by its bytes,
// as chip_smoke.py's kernel-sep phase reckons it (in and out once, the
// mask; 2*N*H*T*T*(Dk + Dv) flops at 989 TFLOP/s): at (64, 511), Dv = 32,
// bf16, 136.0 MB, 0.0406 ms (34.8 GFLOP, 0.0351 ms); at (128, 300) 159.7
// MB, 0.0477 ms (24.0 GFLOP, 0.0242 ms).
//
// Forward (rows 5 and 7), in three regimes chosen by the launch plan
// (ops/fused_attention.py sep_fwd_launch_plan, mhsa_sep_fwd_regime here):
//   rowwise, T <= 64 at any width and heads wider than 64 at any T: row
//     1's design (qkv_fwd.cuh) on three base pointers: one block per (row,
//     head) stages q_h, k_h, v_h as f32 with odd row strides; one warp per
//     query makes a's row; threads over (row, lane) write the products.
//     Past shared memory (T > 735 at Dk = 20, Dv = 32) the working set
//     lives in its block slot's part of a global scratch and `slots`
//     blocks walk the (row, head) items. Kept bit for bit from the first
//     port: at T <= 64 it beats SDPA.
//   tensor cores, T > 64, bf16, both widths up to 64: row 9's tensor-core
//     forward with a walk for (m, den) over all keys, then a = e * (1/den)
//     rounded to bf16 into the A fragment of a@V (mhsa_sep_fwd.cuh);
//   tiled, T > 64, f32, both widths up to 64: row 9's CUDA-core design, a
//     thread per query with q_i and its output row in registers, key
//     chunks staged as f32 and read as broadcasts, the same walks
//     (mhsa_sep_fwd.cuh).
//
// Backward (rows 6 and 8), in three regimes chosen by the launch plan
// (ops/fused_attention.py sep_bwd_launch_plan, mhsa_sep_bwd_regime here):
//   resident, T <= 64, heads of up to 64, f32 and bf16: row 16's resident
//     design on three pointers and two widths (mhsa_sep_bwd.cuh);
//   tensor cores, T > 64, bf16, heads of up to 64: row 4's query-side and
//     key-side kernels with a (3, N*H, T) stats scratch (mhsa_sep_bwd.cuh);
//   wide, otherwise (f32 past T = 64, heads wider than 64): the design
//     rows 5-8 were first ported with, row 4's old resident kernel on three
//     pointers: one block of 4 warps per (row, head) stages q, k, v, g as
//     f32 and the T x T block of a, in a global slot past shared memory
//     (T > 191 at Dk = 20, Dv = 32). It is correct at any T and slow.
// Left on the table: in the resident regime the per-(head, query) pass
// (two dots, two warp sums, exp and an IEEE division, each lane unpacking
// the whole bf16 q and g rows) is most of the time
// (scripts/mhsa_sep_variants.py cuts), and both widths are padded to the
// larger (d_k = 20 beside d_v = 32 stages 32 lanes of q and k); on tensor
// cores the backward's query side recomputes s in each of its four passes
// and the forward in each of its walks, and the k-steps and d tiles of q
// and k run at the larger width too; the forward's tensor-core and tiled
// kernels are bound by the instructions of each score's exp, mask and
// division, far from their byte bound; f32 past T = 64 has no backward of its
// own design, and the row-wise forward keeps row 1's design at T <= 64.

#include "mhsa_sep_bwd.cuh"
#include "mhsa_sep_fwd.cuh"
#include "qkv_bwd.cuh"  // recompute_a_row, kMaxSmemFloats

namespace {

using namespace nrk;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// the forward's working set: q, k (T, Dk|1), v (T, Dv|1), one row per warp
__host__ __device__ size_t fwd_floats(int t_len, int dk, int dv) {
  return (size_t)t_len * (2 * (dk | 1) + (dv | 1) + kWarps);
}

// the backward's: q, k (T, Dk|1), v, g (T, Dv|1), a (T, T|1), one row per
// warp
__host__ __device__ size_t bwd_floats(int t_len, int dk, int dv) {
  return (size_t)t_len * (2 * (dk | 1) + 2 * (dv | 1) + (t_len | 1) + kWarps);
}

// dst (T, width|1) <- head h of x (rows ld apart) as f32
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x,
                                      int64_t row, int t_len, int ld, int h,
                                      int width) {
  const T* src = x + row * t_len * ld + (int64_t)h * width;
  const int stride = width | 1;
  for (int idx = threadIdx.x; idx < t_len * width; idx += kThreads) {
    const int t = idx / width;
    const int d = idx - t * width;
    dst[t * stride + d] = to_f32(src[(int64_t)t * ld + d]);
  }
}

// kGlobal: the working set in this block's slot of gscratch
template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
mhsa_sep_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ mask,
                    T* __restrict__ out, float* gscratch, int64_t n_items,
                    int n_heads, int t_len, int dk, int dv, int ldq, int ldk,
                    int ldv) {
  extern __shared__ float smem[];
  const int sk = dk | 1, sv = dv | 1;  // odd row strides: no bank conflicts
  float* qs = kGlobal ? gscratch + blockIdx.x * fwd_floats(t_len, dk, dv)
                      : smem;  // (T, sk)
  float* ks = qs + t_len * sk;   // (T, sk)
  float* vs = ks + t_len * sk;   // (T, sv)
  float* prow = vs + t_len * sv;  // (kWarps, T) one score row per warp
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float inv = 1.0f / sqrtf((float)dk);
  float* p = prow + warp * t_len;
  const int hdv = n_heads * dv;

  for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int64_t row = item / n_heads;
    const int h = (int)(item % n_heads);
    stage(qs, q, row, t_len, ldq, h, dk);
    stage(ks, k, row, t_len, ldk, h, dk);
    stage(vs, v, row, t_len, ldv, h, dv);
    __syncthreads();
    const float* mrow = mask ? mask + row * t_len : nullptr;
    T* dst = out + row * t_len * hdv + (int64_t)h * dv;
    for (int i = warp; i < t_len; i += kWarps) {
      const float* qi = qs + i * sk;
      float mx = -INFINITY;
      for (int j = lane; j < t_len; j += 32) {
        const float* kj = ks + j * sk;
        float acc = 0.f;
        for (int d = 0; d < dk; ++d) acc = fmaf(qi[d], kj[d], acc);
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
      for (int j = lane; j < t_len; j += 32)
        p[j] = round_to<T>(den > 0.f ? p[j] / den : 0.f);  // a in v's dtype
      __syncwarp();
      for (int d = lane; d < dv; d += 32) {
        float acc = 0.f;
        for (int j = 0; j < t_len; ++j) acc = fmaf(p[j], vs[j * sv + d], acc);
        dst[(int64_t)i * hdv + d] = from_f32<T>(acc);
      }
      __syncwarp();  // the next query overwrites p
    }
    __syncthreads();  // the next item overwrites the staged operands
  }
}

template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
mhsa_sep_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ mask,
                    const T* __restrict__ g, T* __restrict__ dq,
                    T* __restrict__ dk, T* __restrict__ dv, float* gscratch,
                    int64_t n_items, int n_heads, int t_len, int dk_w,
                    int dv_w, int ldq, int ldk, int ldv, float inv) {
  extern __shared__ float smem[];
  const int sk = dk_w | 1, sv = dv_w | 1;  // odd row strides
  const int astride = t_len | 1;
  float* qs = kGlobal
                  ? gscratch + blockIdx.x * bwd_floats(t_len, dk_w, dv_w)
                  : smem;         // (T, sk)
  float* ks = qs + t_len * sk;    // (T, sk)
  float* vs = ks + t_len * sk;    // (T, sv)
  float* gs = vs + t_len * sv;    // (T, sv)
  float* a = gs + t_len * sv;     // (T, astride): a, then ds
  float* darow = a + t_len * astride;  // (kWarps, T) da rows
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the forward's scale of the scores, computed as the forward does
  const float inv_s = 1.0f / sqrtf((float)dk_w);
  const int hdk = n_heads * dk_w, hdv = n_heads * dv_w;
  float* da = darow + warp * t_len;

  for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int64_t row = item / n_heads;
    const int h = (int)(item % n_heads);
    stage(qs, q, row, t_len, ldq, h, dk_w);
    stage(ks, k, row, t_len, ldk, h, dk_w);
    stage(vs, v, row, t_len, ldv, h, dv_w);
    stage(gs, g, row, t_len, hdv, h, dv_w);
    __syncthreads();
    const float* mrow = mask ? mask + row * t_len : nullptr;
    for (int i = warp; i < t_len; i += kWarps)
      recompute_a_row(a + i * astride, qs + i * sk, ks, mrow, t_len, dk_w, sk,
                      inv_s, nullptr, nullptr, lane);
    __syncthreads();

    // dv[j, e] = sum_i round(a[i, j]) g[i, e]
    T* dvo = dv + row * t_len * hdv + (int64_t)h * dv_w;
    for (int idx = threadIdx.x; idx < t_len * dv_w; idx += kThreads) {
      const int j = idx / dv_w;
      const int e = idx - j * dv_w;
      float acc = 0.f;
      for (int i = 0; i < t_len; ++i)
        acc = fmaf(round_to<T>(a[i * astride + j]), gs[i * sv + e], acc);
      dvo[(int64_t)j * hdv + e] = from_f32<T>(acc);
    }
    __syncthreads();  // a is overwritten with ds below

    for (int i = warp; i < t_len; i += kWarps) {
      const float* gi = gs + i * sv;
      float* ai = a + i * astride;
      float part = 0.f;
      for (int j = lane; j < t_len; j += 32) {
        const float* vj = vs + j * sv;
        float acc = 0.f;
        for (int e = 0; e < dv_w; ++e) acc = fmaf(gi[e], vj[e], acc);
        da[j] = acc;
        part += acc * ai[j];
      }
      const float r = warp_sum(part);
      // each lane rewrites only the entries it read
      for (int j = lane; j < t_len; j += 32)
        ai[j] = round_to<T>((da[j] - r) * ai[j] * inv);
      __syncwarp();  // the next query overwrites da
    }
    __syncthreads();

    // dq[i, d] = sum_j ds[i, j] k[j, d];  dk[i, d] = sum_j ds[j, i] q[j, d]
    T* dqo = dq + row * t_len * hdk + (int64_t)h * dk_w;
    T* dko = dk + row * t_len * hdk + (int64_t)h * dk_w;
    for (int idx = threadIdx.x; idx < t_len * dk_w; idx += kThreads) {
      const int i = idx / dk_w;
      const int d = idx - i * dk_w;
      float accq = 0.f, acck = 0.f;
      for (int j = 0; j < t_len; ++j) {
        accq = fmaf(a[i * astride + j], ks[j * sk + d], accq);
        acck = fmaf(a[j * astride + i], qs[j * sk + d], acck);
      }
      dqo[(int64_t)i * hdk + d] = from_f32<T>(accq);
      dko[(int64_t)i * hdk + d] = from_f32<T>(acck);
    }
    __syncthreads();  // the next item overwrites the staged operands
  }
}

// The grid of n * n_heads items: one block each with the working set
// (`floats`) in shared memory, or `slots` blocks with it in gscratch.
// Returns 0 with *grid and *smem set, or a CUDA error code.
int plan(size_t floats, int n, int n_heads, const void* gscratch, int slots,
         int64_t* grid, size_t* smem) {
  const int64_t items = (int64_t)n * n_heads;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const bool global = floats > (size_t)kMaxSmemFloats;
  if (global && (gscratch == nullptr || slots <= 0))
    return (int)cudaErrorInvalidValue;
  *smem = global ? 0 : sizeof(float) * floats;
  *grid = global && slots < items ? slots : items;
  return (int)cudaSuccess;
}

// The row-wise route: one block per (row, head) with the working set in
// shared memory, or `slots` blocks with it in gscratch.
template <typename T>
int fwd_rowwise(const void* q, const void* k, const void* v,
                const void* mask, void* out, void* gscratch, int n,
                int t_len, int n_heads, int dk, int dv, int ldq, int ldk,
                int ldv, int slots, void* stream) {
  int64_t grid;
  size_t smem;
  int err = plan(fwd_floats(t_len, dk, dv), n, n_heads, gscratch, slots,
                 &grid, &smem);
  if (err != (int)cudaSuccess) return err;
  auto* kernel = smem ? mhsa_sep_fwd_kernel<T, false>
                      : mhsa_sep_fwd_kernel<T, true>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != (int)cudaSuccess) return err;
  kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), smem ? nullptr : static_cast<float*>(gscratch),
      (int64_t)n * n_heads, n_heads, t_len, dk, dv, ldq, ldk, ldv);
  return (int)cudaGetLastError();
}

// The forward in `regime` (sepf::Regime), which must be the shape's:
// row-wise, gscratch the global slots (`slots` of them) or null; tensor
// cores and tiled, args = (tile, chunk, nbuf).
template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* mask,
        void* out, void* gscratch, int n, int t_len, int n_heads, int dk,
        int dv, int ldq, int ldk, int ldv, int regime, const int* args,
        int slots, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (t_len <= 0 || regime != sepf::regime(t_len, dk, dv, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  if (regime == sepf::kRowwise)
    return fwd_rowwise<T>(q, k, v, mask, out, gscratch, n, t_len, n_heads,
                          dk, dv, ldq, ldk, ldv, slots, stream);
  return sepf::launch<T>(regime, q, k, v, mask, out, n, t_len, n_heads, dk,
                         dv, ldq, ldk, ldv, args[0], args[1], args[2],
                         stream);
}

// The wide route: one block per (row, head) with the working set in shared
// memory, or `slots` blocks with it in gscratch.
template <typename T>
int bwd_wide(const void* q, const void* k, const void* v, const void* mask,
             const void* g, void* dq, void* dk, void* dv, void* gscratch,
             int n, int t_len, int n_heads, int dk_w, int dv_w, int ldq,
             int ldk, int ldv, int slots, void* stream) {
  int64_t grid;
  size_t smem;
  int err = plan(bwd_floats(t_len, dk_w, dv_w), n, n_heads, gscratch, slots,
                 &grid, &smem);
  if (err != (int)cudaSuccess) return err;
  auto* kernel = smem ? mhsa_sep_bwd_kernel<T, false>
                      : mhsa_sep_bwd_kernel<T, true>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != (int)cudaSuccess) return err;
  // 1/sqrt(Dk) for ds, rounded once from double, as the plain version's
  // scalar is
  const float inv = (float)(1.0 / sqrt((double)dk_w));
  kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), smem ? nullptr : static_cast<float*>(gscratch),
      (int64_t)n * n_heads, n_heads, t_len, dk_w, dv_w, ldq, ldk, ldv, inv);
  return (int)cudaGetLastError();
}

// The backward in `regime` (sep::Regime), which must be the shape's:
// resident, args = (heads, nbuf, blocks, -, -, -); tensor cores, args =
// (tile, chunk, nbuf) of the query side then of the key side and scratch
// the (3, N*H, T) stats; wide, scratch the global slots (`slots` of them)
// or null.
template <typename T>
int bwd(const void* q, const void* k, const void* v, const void* mask,
        const void* g, void* dq, void* dk, void* dv, void* scratch, int n,
        int t_len, int n_heads, int dk_w, int dv_w, int ldq, int ldk,
        int ldv, int regime, const int* args, int slots, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (t_len <= 0 || regime != sep::regime(t_len, dk_w, dv_w, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  if (regime == sep::kResident)
    return sep::resident_launch<T>(q, k, v, mask, g, dq, dk, dv, n, t_len,
                                   n_heads, dk_w, dv_w, ldq, ldk, ldv,
                                   args[0], args[1], args[2], stream);
  if (regime == sep::kWide)
    return bwd_wide<T>(q, k, v, mask, g, dq, dk, dv, scratch, n, t_len,
                       n_heads, dk_w, dv_w, ldq, ldk, ldv, slots, stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int dmax = dk_w > dv_w ? dk_w : dv_w;
    if (scratch == nullptr ||
        !sep::mma_plan_ok(dmax, args[0], args[1], args[2], args[3], args[4],
                          args[5]))
      return (int)cudaErrorInvalidValue;
    using B = __nv_bfloat16;
    const sep::MmaLaunch body{
        static_cast<const B*>(q), static_cast<const B*>(k),
        static_cast<const B*>(v), static_cast<const B*>(g),
        static_cast<const float*>(mask), static_cast<B*>(dq),
        static_cast<B*>(dk), static_cast<B*>(dv), static_cast<float*>(scratch),
        n, t_len, n_heads, dk_w, dv_w, ldq, ldk, ldv, args[0], args[1],
        args[2], args[3], args[4], args[5], (cudaStream_t)stream};
    return with_head_width(dmax, body);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// mask may be null (rows 5 and 6; with a mask, rows 7 and 8). The
// forward's regime: 0 row-wise, 1 tensor cores, 2 tiled
// (mhsa_sep_fwd_regime); p0..p2 its plan (tile, chunk, nbuf; zeros
// row-wise); gscratch, `slots` slots of mhsa_sep_fwd_scratch_floats each,
// is read only row-wise and when those are not 0. Each returns
// cudaGetLastError() after its launch: 0 when the kernel was queued;
// cudaErrorInvalidValue for a regime that is not the shape's or a plan the
// regime's kernel does not take.
#define NRK_SEP_FWD(SUFFIX, T)                                                \
  int mhsa_sep_fwd_##SUFFIX(const void* q, const void* k, const void* v,     \
                            const void* mask, void* out, void* gscratch,     \
                            int n, int t_len, int n_heads, int dk, int dv,   \
                            int ldq, int ldk, int ldv, int regime, int p0,   \
                            int p1, int p2, int slots, void* stream) {       \
    const int args[3] = {p0, p1, p2};                                        \
    return fwd<T>(q, k, v, mask, out, gscratch, n, t_len, n_heads, dk, dv,   \
                  ldq, ldk, ldv, regime, args, slots, stream);               \
  }
NRK_SEP_FWD(f32, float)
NRK_SEP_FWD(bf16, __nv_bfloat16)
#undef NRK_SEP_FWD

// regime: 0 resident, 1 tensor cores, 2 wide (mhsa_sep_bwd_regime);
// p0..p5 its plan; scratch the stats (tensor cores) or the global slots
// (wide, `slots` of mhsa_sep_bwd_scratch_floats each, null when 0).
#define NRK_SEP_BWD(SUFFIX, T)                                                \
  int mhsa_sep_bwd_##SUFFIX(const void* q, const void* k, const void* v,     \
                            const void* mask, const void* g, void* dq,       \
                            void* dk, void* dv, void* scratch, int n,        \
                            int t_len, int n_heads, int dk_w, int dv_w,      \
                            int ldq, int ldk, int ldv, int regime, int p0,   \
                            int p1, int p2, int p3, int p4, int p5,          \
                            int slots, void* stream) {                       \
    const int args[6] = {p0, p1, p2, p3, p4, p5};                            \
    return bwd<T>(q, k, v, mask, g, dq, dk, dv, scratch, n, t_len, n_heads,  \
                  dk_w, dv_w, ldq, ldk, ldv, regime, args, slots, stream);   \
  }
NRK_SEP_BWD(f32, float)
NRK_SEP_BWD(bf16, __nv_bfloat16)
#undef NRK_SEP_BWD

// The forward's regime at (T, Dk, Dv) in a dtype of esize bytes: 0
// row-wise, 1 tensor cores, 2 tiled.
int mhsa_sep_fwd_regime(int t_len, int dk, int dv, int esize) {
  return nrk::sepf::regime(t_len, dk, dv, esize);
}

// Shared bytes of one block of the forward in `regime` under the plan
// (tile, chunk, nbuf); row-wise (no plan) the working set's, 0 past shared
// memory; 0 for a plan the kernels refuse.
int mhsa_sep_fwd_smem_bytes(int regime, int t_len, int dk, int dv,
                            int esize, int tile, int chunk, int nbuf) {
  namespace f = nrk::sepf;
  if (regime != f::regime(t_len, dk, dv, esize)) return 0;
  if (regime == f::kRowwise) {
    const size_t floats = fwd_floats(t_len, dk, dv);
    return floats > (size_t)kMaxSmemFloats ? 0 : (int)(4 * floats);
  }
  if (!f::plan_ok(regime, dk, dv, tile, chunk, nbuf)) return 0;
  if (regime == f::kTiled) return (int)f::tiled_smem(dk, dv);
  const nrk::FlashLayout l =
      nrk::flash_layout(nrk::kFlashFwd, dk > dv ? dk : dv, 2, tile, chunk);
  return (int)(l.own + nbuf * l.stage);
}

// The backward's regime at (T, Dk, Dv) in a dtype of esize bytes: 0
// resident, 1 tensor cores, 2 wide.
int mhsa_sep_bwd_regime(int t_len, int dk, int dv, int esize) {
  return nrk::sep::regime(t_len, dk, dv, esize);
}

// Shared bytes of one block of the backward: kind 0 resident (a = heads,
// c = nbuf), 1 the tensor-core key side, 2 its query side (a = tile, b =
// chunk, c = nbuf); 0 for a plan the kernels refuse.
int mhsa_sep_bwd_smem_bytes(int kind, int t_len, int dk, int dv, int esize,
                            int a, int b, int c) {
  const int dmax = dk > dv ? dk : dv;
  if (kind == 0) {
    const size_t smem = nrk::sep::resident_smem(t_len, dmax, esize, a, c);
    return a >= 1 && a <= 4 && c >= 1 && c <= 2 &&
                   smem <= (size_t)nrk::sep::kMaxSmem
               ? (int)smem
               : 0;
  }
  if (!nrk::flash_mma(dmax, esize) ||
      !nrk::flash_plan_ok(kind, dmax, esize, a, b, c))
    return 0;
  const nrk::FlashLayout l = nrk::flash_layout(kind, dmax, esize, a, b);
  return (int)(l.own + c * l.stage);
}

// Floats of one gscratch slot: 0 when the working set fits in a block's
// shared memory.
int mhsa_sep_fwd_scratch_floats(int t_len, int dk, int dv) {
  const size_t f = fwd_floats(t_len, dk, dv);
  return f > (size_t)kMaxSmemFloats ? (int)f : 0;
}

int mhsa_sep_bwd_scratch_floats(int t_len, int dk, int dv) {
  const size_t f = bwd_floats(t_len, dk, dv);
  return f > (size_t)kMaxSmemFloats ? (int)f : 0;
}

}  // extern "C"
