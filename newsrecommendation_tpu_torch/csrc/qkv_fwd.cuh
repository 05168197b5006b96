// Exp-normalised multi-head self-attention forward over a fused [q|k|v]
// projection, with the projection bias added in the kernel, an optional
// key mask and, for training, an optional f32 probs output: kernel rows 1
// (no probs) and 2 (probs), and row 11 (qkv2d.cu), which is row 2 on a
// 2-D view of the same memory.
//
// Replaces the TPU kernel newsrecommendation_tpu/ops/pallas/fused_attention.py
// :_qkv_fwd_kernel in two of its calls: _qkv_fwd_call (bias and bias+mask,
// no probs: serving, eval, training with bwd_residuals "recompute") and
// _qkv_fwd_probs_call (the same with probs_ref: the forward under
// differentiation, whose probs feed the backward in qkv_bwd_probs.cu).
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
//   a = e / (sum_j e_j + 1e-8 * exp(-m))       0 where that is not > 0, and
//                                              where it is inf
//   out = a (cast to v's dtype) @ v_h           f32 accumulate, cast to dtype
// This is not softmax: a fully masked row gives a = 0 and an output of 0.
// Row 2's context is row 1's bit for bit in every regime: one kernel, the
// probs store its only addition.
//
// Bound: memory. Each input read once and each output written once at
// 3.35 TB/s, against 4*N*H*T*T*D flops: at (1024, 20) f32 (the corpus
// encoder's chunk) row 1 moves 131.1 MB, 0.0391 ms (0.66 GFLOP, 0.0098 ms
// at 67 TFLOP/s); at (7040, 20) bf16 (the headline step's news encoder)
// 450.6 MB, 0.1345 ms, and row 2's probs add 225.3 MB (0.2017 ms in all);
// at (128, 300) bf16 (the L = 300 step's user encoder) 122.9 MB, 0.0367 ms
// (18.4 GFLOP, 0.0186 ms at 989 TFLOP/s), and row 2's probs add 921.6 MB
// (0.3118 ms).
//
// Four regimes, chosen from T, D and the dtype by the launch plan
// (ops/fused_attention.py:fwd_launch_plan); the entry points refuse a
// regime that is not the shape's (qf::regime below):
//   resident (T <= 64, heads of up to 64, f32 and bf16): row 15's resident
//     design (blanes_resident.cuh, qkv_resident_kernel) with its two
//     flags: the bias added to each staged item at the input dtype, in
//     16-byte chunks in the pass before the dots, and row 2's probs
//     written by each lane from registers before a is rounded. An item is a
//     batch row,
//     up to four heads and every query, the next item copied in by
//     cp.async while the current one computes; a warp per (head, query),
//     key j in lane j mod 32, then the context summed over threads by
//     (head, query pair, d pair). Those are the first design's sums in the
//     same order, so the same outputs and probs.
//   mma (T > 64, bf16, heads of up to 64): rows 5 and 7's tensor-core
//     forward (mhsa_sep_fwd.cuh) on the three views of a biased copy of
//     qkv, written at the input dtype by a pass of its own
//     (qkv_bias_kernel, as rows 3-4's tensor-core regime adds it); a walk
//     for (m, den) over all keys, online, then a = e * (1/den) rounded to
//     bf16 into the A fragment of a@V; row 2's f32 a go through a tile of
//     32 keys of the warp's 16 queries in shared memory, a row a store.
//   tiled (T > 64, f32, heads of up to 64): rows 5 and 7's CUDA-core
//     kernel (mhsa_sep_fwd.cuh), a thread per query, the bias added as q
//     and each chunk of K and V are loaded (TF32 would change the result),
//     K and V at a width of 20 for the NRMS head; row 2's a go through a
//     tile of 32 keys of the warp's 32 queries, a row a store.
//   rowwise (heads wider than 64, any T): the first port's kernel below,
//     bit for bit. One block of 4 warps per (row, head) stages q_h, k_h,
//     v_h (biased and rounded at the input dtype, held as f32) with an odd
//     row stride; one warp per query makes a's row, lanes over d sum the
//     context. Past shared memory (T > 235 at D = 80) q, k, v and the
//     warps' score rows move to one global slot per block, a grid of
//     `slots` blocks walking the (row, head) items, the same arithmetic.
// Left on the table (PERF.md): the resident regime is bound by the
// per-query chain (a dot, a warp sum, exp and an IEEE division), 6.8x its
// bytes at (7040, 20) bf16, and its bias pass costs 10-15% over row 15;
// the tensor-core regime reads qkv twice more for its bias pass (adding
// the bias to each staged chunk instead, once per query tile and walk,
// was 3-12% slower), walks the keys twice (1.55x SDPA at (64, 511)
// unmasked) and writes row 2's probs at 1.6-2.4 TB/s, below what the card
// takes; the tiled regime runs on CUDA cores and writes row 2's probs at
// about 1.4 TB/s; the row-wise kernel keeps lanes idle and overlaps no
// loads with math.

#pragma once

#include "blanes_resident.cuh"  // the resident regime
#include "common.cuh"
#include "mhsa_sep_fwd.cuh"    // the tensor-core and tiled regimes

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

namespace qf {

// Rows 1-2's regimes, in ops/fused_attention.py FWD_REGIMES's order.
enum Regime { kResident = 0, kMma = 1, kTiled = 2, kRowwise = 3 };

constexpr int kMaxHead = 64;  // widest head of every regime but row-wise

// The regime of (T, D) in a dtype of esize bytes.
__host__ __device__ inline int regime(int t_len, int d_head, int esize) {
  if (d_head > kMaxHead) return kRowwise;
  if (t_len <= bl::kShortT) return kResident;
  return esize == 2 ? kMma : kTiled;
}

// Shared bytes of one block in `regime` under plan[3] (resident: heads,
// nbuf, blocks; tensor cores and tiled: tile, chunk, nbuf), with or
// without probs; row-wise the working set's, 0 past shared memory; 0 for
// a regime that is not the shape's or a plan its kernel does not take.
inline int smem_bytes(int reg, int t_len, int d_head, int esize, bool probs,
                      const int* plan) {
  if (t_len <= 0 || d_head <= 0 || reg != regime(t_len, d_head, esize))
    return 0;
  if (reg == kRowwise)
    return qkv_fwd_global(t_len, d_head)
               ? 0
               : (int)qkv_fwd_smem_bytes_for(t_len, d_head);
  if (reg == kResident) {
    if (plan[0] < 1 || plan[0] > 4 || plan[1] < 1 || plan[1] > 2) return 0;
    const bl::Layout l =
        bl::layout_of(bl::kFwd, t_len, d_head, esize, plan[0], t_len);
    const size_t smem = plan[1] * l.stage + l.rows;
    return smem > (size_t)bl::kMaxSmem ? 0 : (int)smem;
  }
  const int sreg = reg == kMma ? sepf::kMma : sepf::kTiled;
  if (!sepf::plan_ok(sreg, d_head, d_head, plan[0], plan[1], plan[2]))
    return 0;
  if (reg == kTiled) {
    const int w = sepf::qkv_tiled_width(d_head);
    return (int)sepf::tiled_smem_at(w, w, probs);
  }
  const FlashLayout l = flash_layout(kFlashFwd, d_head, 2, plan[0], plan[1]);
  return (int)(l.own + plan[2] * l.stage +
               (probs ? sepf::mma_probs_smem(plan[0]) : 0));
}

}  // namespace qf

// One launch of rows 1-2 (and 11) in `regime`, which must be the shape's:
// resident, plan = (heads, nbuf, blocks); tensor cores and tiled, (tile,
// chunk, nbuf), and on tensor cores `biased` the (N, T, 3*H*D) bf16 copy
// the bias pass writes; row-wise, gstage (`slots` slots of
// qkv_fwd_slot_floats_for) past shared memory. probs (row 2) or null.
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// regime that is not the shape's or a plan its kernel does not take.
template <typename T>
int qkv_fwd_run(const void* qkv, const void* bias, const void* mask,
                void* out, void* probs, void* biased, float* gstage, int n,
                int t_len, int n_heads, int d_head, int regime,
                const int* plan, int slots, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (t_len <= 0 || d_head <= 0 ||
      regime != qf::regime(t_len, d_head, (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  switch (regime) {
    case qf::kResident:
      return bl::qkv_resident_launch<T>(qkv, bias, mask, out, probs, n,
                                        t_len, n_heads, d_head, plan[0],
                                        plan[1], plan[2], stream);
    case qf::kMma:
    case qf::kTiled:
      return sepf::qkv_launch<T>(
          regime == qf::kMma ? sepf::kMma : sepf::kTiled, qkv, bias, mask,
          out, probs, biased, n, t_len, n_heads, d_head, plan[0], plan[1],
          plan[2], stream);
    default:
      return qkv_fwd_launch<T>(qkv, bias, mask, out, probs, n, t_len,
                               n_heads, d_head, stream, gstage, slots);
  }
}

}  // namespace nrk
