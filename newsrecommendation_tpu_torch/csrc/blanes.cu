// Kernel rows 15 and 16: exp-normalised multi-head self-attention over a
// biased fused [q|k|v] projection with the batch in the lanes ("blanes"):
// the forward and the backward that recomputes the probs, unmasked and
// key-masked.
//
// Replaces the TPU kernels newsrecommendation_tpu/ops/pallas/
// experimental_blanes.py:_blanes_fwd_kernel (row 15, _blanes_fwd_call) and
// :_blanes_bwd_kernel (row 16, _blanes_bwd_call).
//
// Contract (the TPU kernels': rows 1 and 4's on qkv with the bias already
// added):
//   qkv  (N, T, 3*H*D) in the input dtype; head h's q/k/v at lanes h*D,
//        H*D + h*D, 2*H*D + h*D
//   mask (N, T) f32 over keys, or null
//   s_ij = (q_i . k_j) * (1/sqrt(D))           f32 sum, scale after
//   m_i  = max_j s_ij                           over ALL keys
//   e_ij = exp(s_ij - m_i) * mask_j
//   a_ij = e_ij / (sum_j e_ij + 1e-8 exp(-m_i)) 0 where that is not > 0
//   out_i = sum_j round(a_ij) v_j               a in v's dtype, f32 sums
// backward, g (N, T, H*D) in qkv's dtype, dqkv (N, T, 3*H*D):
//   dv_j = sum_i round(a_ij) g_i,  da_ij = g_i . v_j,
//   r_i = sum_j da_ij a_ij,  ds_ij = round((da_ij - r_i) a_ij / sqrt(D)),
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i
// with ds rounded to k's dtype and f32 sums.
//
// Bound: memory. At N = 7040, T = 20, H = D = 20 in bf16 the forward reads
// qkv and writes out (451 MB, 0.135 ms at 3.35 TB/s; 4*N*H*T*T*D = 4.5
// GFLOP); the backward reads qkv and g and writes dqkv (789 MB, 0.236 ms).
//
// Design: the TPU kernel transposes a block of rows to (T, 3HD, bn) so
// that every elementwise step and reduction runs with the batch across
// the VPU's lanes. Here the batch runs across a warp's lanes: lane r of
// every warp of block (group b, head h) takes batch row 32*b + r, and each
// warp takes one query (or key) at a time, so the 32 lanes of a warp do
// the same step on 32 rows. The keys (or queries) are staged a tile of KT
// at a time in shared memory as [position][d][lane], lanes padded to 33,
// so the staging writes and the lanes' reads each hit 32 banks. A thread
// holds its query's q (and g) in registers and walks the keys once for
// the max, once for the sum and once for the context (the backward: also
// for r and for dq), recomputing s each time: the contract rounds
// a = e / den after the whole sum, so there is no online rescaling. The
// backward's second phase, in the same block after a barrier, gives each
// thread one key and walks the queries for dk and dv, with each query's m,
// den and r read back from a global scratch the first phase wrote.
// The sums over keys (den and r) run in the order of a warp reduction over
// keys in lanes (rows 1 and 4's, which equal PyTorch's own reductions bit
// for bit at T = 20 and 50 on an H100): key j into slot j mod 32, each slot
// in key order, then the xor tree over the 32 slots. In that order, a and ds round as the plain version's do, so at
// the NRMS shapes (T = 20, 50) a bf16 a does not flip its rounding and
// move the context by an ulp of a times v. Each thread keeps its 32 slots
// in a column of shared memory (32 KB a block).
// Left on the table: the scores are recomputed 3-5 times, KT-key tiles are
// staged again for each pass when T > KT, and no tensor cores.

#include "flash.cuh"  // with_head_width

namespace {

using namespace nrk;

constexpr int kLanes = 32;        // batch rows of a block, one per lane
constexpr int kPad = kLanes + 1;  // staged stride of a (position, d) pair
constexpr int kWarpsBl = 8;       // queries (or keys) of a block at once
constexpr int kThreadsBl = 32 * kWarpsBl;
constexpr int kMaxTile = 32;      // positions staged at once, at most
constexpr int kSmemFloats = 232448 / 4;  // what a block may use
constexpr int kSlotFloats = kLanes * kThreadsBl;  // tree_sum's slots

// Positions per staged tile: two (KT, D, kPad) operands and `vecs`
// (KT, kLanes) vectors (the mask, or the stats m, den, r), beside the
// slots.
inline int tile_len(int t_len, int d_head, int vecs) {
  const int per = 2 * d_head * kPad + vecs * kLanes;
  int kt = (kSmemFloats - kSlotFloats) / per;
  kt = kt < kMaxTile ? kt : kMaxTile;
  kt = kt < t_len ? kt : t_len;
  return kt < 1 ? 1 : kt;
}

inline size_t smem_bytes_for(int kt, int d_head, int vecs) {
  return sizeof(float) *
         ((size_t)kt * (2 * d_head * kPad + vecs * kLanes) + kSlotFloats);
}

// dst[(j*D + d)*kPad + r] = lanes [c0, c0 + D) of x at (row0 + r, t0 + j),
// for the block's 32 rows (0 past N) and positions t0 .. t0 + cnt - 1;
// x has rows of w elements.
template <typename T>
__device__ __forceinline__ void stage_op(float* dst, const T* __restrict__ x,
                                         int64_t row0, int n, int t_len,
                                         int w, int c0, int t0, int cnt,
                                         int d_head) {
  const int total = kLanes * cnt * d_head;
  for (int idx = threadIdx.x; idx < total; idx += kThreadsBl) {
    const int d = idx % d_head;
    const int rest = idx / d_head;
    const int j = rest % cnt;
    const int r = rest / cnt;
    const int64_t row = row0 + r;
    dst[(j * d_head + d) * kPad + r] =
        row < n ? to_f32(x[(row * t_len + t0 + j) * w + c0 + d]) : 0.f;
  }
}

// dst[j*kLanes + r] = v[(row0 + r) * t_len + t0 + j] (`fill` when v is
// null or past N).
__device__ __forceinline__ void stage_vec(float* dst,
                                          const float* __restrict__ v,
                                          int64_t row0, int n, int t_len,
                                          int t0, int cnt, float fill) {
  for (int idx = threadIdx.x; idx < kLanes * cnt; idx += kThreadsBl) {
    const int r = idx % kLanes;
    const int j = idx / kLanes;
    const int64_t row = row0 + r;
    dst[idx] = v && row < n ? v[row * t_len + t0 + j] : fill;
  }
}

// s = (x . staged[j]) * inv for this lane, the dot in d order
template <int DM>
__device__ __forceinline__ float score(const float* x, const float* staged,
                                       int j, int d_head, int lane,
                                       float inv) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < d_head) acc = fmaf(x[d], staged[(j * d_head + d) * kPad + lane],
                               acc);
  return __fmul_rn(acc, inv);
}

template <int DM>
__device__ __forceinline__ float dot_staged(const float* x,
                                            const float* staged, int j,
                                            int d_head, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < d_head) acc = fmaf(x[d], staged[(j * d_head + d) * kPad + lane],
                               acc);
  return acc;
}

// this lane's D-vector of x at (row, t, lanes c0 ..), zero padded to DM
template <typename T, int DM>
__device__ __forceinline__ void load_vec(float* dst, const T* __restrict__ x,
                                         int64_t row, int t, int t_len, int w,
                                         int c0, int d_head, bool active) {
#pragma unroll
  for (int d = 0; d < DM; ++d)
    dst[d] = active && d < d_head
                 ? to_f32(x[(row * t_len + t) * w + c0 + d]) : 0.f;
}

template <typename T, int DM>
__device__ __forceinline__ void store_vec(T* __restrict__ x, const float* v,
                                          int64_t row, int t, int t_len,
                                          int w, int c0, int d_head) {
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < d_head) x[(row * t_len + t) * w + c0 + d] = from_f32<T>(v[d]);
}

// sum over the keys of term(j) (j within the staged tile), in a warp
// reduction's order: slot (j0 + j) mod 32 per key, each slot in key order,
// then the xor tree over the slots. stage(j0) brings tile j0 in; `slots`
// is the block's (kLanes, kThreadsBl) slot array, this thread's column.
template <typename Stage, typename Term>
__device__ __forceinline__ float tree_sum(float* slots, int t_len, int kt,
                                          Stage stage, Term term) {
  float* slot = slots + threadIdx.x;  // slot l at slot[l * kThreadsBl]
  for (int l = 0; l < kLanes; ++l) slot[l * kThreadsBl] = 0.f;
  for (int j0 = 0; j0 < t_len; j0 += kt) {
    stage(j0);
    const int cnt = min(kt, t_len - j0);
    for (int j = 0; j < cnt; ++j) {
      float* at = slot + ((j0 + j) % kLanes) * kThreadsBl;
      *at = __fadd_rn(*at, term(j));
    }
  }
  for (int o = kLanes / 2; o > 0; o >>= 1)
    for (int l = 0; l < o; ++l)
      slot[l * kThreadsBl] =
          __fadd_rn(slot[l * kThreadsBl], slot[(l + o) * kThreadsBl]);
  return slot[0];
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreadsBl)
blanes_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                  T* __restrict__ out, int n, int n_heads, int t_len,
                  int d_head, int kt, float inv) {
  extern __shared__ float smem[];
  const int h = blockIdx.x % n_heads;
  const int64_t row0 = (int64_t)(blockIdx.x / n_heads) * kLanes;
  const int hd = n_heads * d_head;
  const int w3 = 3 * hd;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t row = row0 + lane;
  float* ks = smem;                     // (kt, D, kPad) keys
  float* vs = ks + kt * d_head * kPad;  // (kt, D, kPad) values
  float* ms = vs + kt * d_head * kPad;  // (kt, kLanes) key mask
  float* slots = ms + kt * kLanes;      // (kLanes, kThreadsBl) tree_sum
  int staged = -1;  // the key tile in shared memory (block-uniform)
  auto stage = [&](int j0) {
    if (j0 == staged) return;
    __syncthreads();  // the previous tile is no longer read
    const int cnt = min(kt, t_len - j0);
    stage_op(ks, qkv, row0, n, t_len, w3, hd + h * d_head, j0, cnt, d_head);
    stage_op(vs, qkv, row0, n, t_len, w3, 2 * hd + h * d_head, j0, cnt,
             d_head);
    stage_vec(ms, mask, row0, n, t_len, j0, cnt, 1.f);
    __syncthreads();
    staged = j0;
  };

  for (int i0 = 0; i0 < t_len; i0 += kWarpsBl) {
    const int i = i0 + warp;
    const bool active = row < n && i < t_len;
    float qi[DM], acc[DM];
    load_vec<T, DM>(qi, qkv, row, i, t_len, w3, h * d_head, d_head, active);
#pragma unroll
    for (int d = 0; d < DM; ++d) acc[d] = 0.f;
    float m = -INFINITY;
    for (int j0 = 0; j0 < t_len; j0 += kt) {
      stage(j0);
      const int cnt = min(kt, t_len - j0);
      for (int j = 0; j < cnt; ++j)
        m = fmaxf(m, score<DM>(qi, ks, j, d_head, lane, inv));
    }
    const float den = __fadd_rn(
        tree_sum(slots, t_len, kt, stage, [&](int j) {
          return expf(score<DM>(qi, ks, j, d_head, lane, inv) - m) *
                 ms[j * kLanes + lane];
        }),
        __fmul_rn(kEps, expf(-m)));
    for (int j0 = 0; j0 < t_len; j0 += kt) {
      stage(j0);
      const int cnt = min(kt, t_len - j0);
      for (int j = 0; j < cnt; ++j) {
        const float e = expf(score<DM>(qi, ks, j, d_head, lane, inv) - m) *
                        ms[j * kLanes + lane];
        const float al = round_to<T>(den > 0.f ? e / den : 0.f);
#pragma unroll
        for (int d = 0; d < DM; ++d)
          if (d < d_head)
            acc[d] = fmaf(al, vs[(j * d_head + d) * kPad + lane], acc[d]);
      }
    }
    if (active) store_vec<T, DM>(out, acc, row, i, t_len, hd, h * d_head,
                                 d_head);
  }
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreadsBl)
blanes_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                  const T* __restrict__ g, T* __restrict__ dqkv,
                  float* __restrict__ stats, int n, int n_heads, int t_len,
                  int d_head, int kt, float inv_s, float inv) {
  extern __shared__ float smem[];
  const int h = blockIdx.x % n_heads;
  const int64_t row0 = (int64_t)(blockIdx.x / n_heads) * kLanes;
  const int hd = n_heads * d_head;
  const int w3 = 3 * hd;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t row = row0 + lane;
  float* xs = smem;                     // (kt, D, kPad) k, then q
  float* ys = xs + kt * d_head * kPad;  // (kt, D, kPad) v, then g
  float* vec = ys + kt * d_head * kPad;  // (3, kt, kLanes) mask, or stats
  float* slots = vec + 3 * kt * kLanes;  // (kLanes, kThreadsBl) tree_sum
  // this block's stats, (3, T, kLanes): m, den, r of each (row, query)
  float* st = stats + (int64_t)blockIdx.x * 3 * t_len * kLanes;

  // ---- phase 1: one thread per (row, query): m, den, r, then dq ---------
  int staged = -1;  // the key tile in shared memory (block-uniform)
  auto stage_keys = [&](int j0) {
    if (j0 == staged) return;
    __syncthreads();
    const int cnt = min(kt, t_len - j0);
    stage_op(xs, qkv, row0, n, t_len, w3, hd + h * d_head, j0, cnt, d_head);
    stage_op(ys, qkv, row0, n, t_len, w3, 2 * hd + h * d_head, j0, cnt,
             d_head);
    stage_vec(vec, mask, row0, n, t_len, j0, cnt, 1.f);
    __syncthreads();
    staged = j0;
  };
  for (int i0 = 0; i0 < t_len; i0 += kWarpsBl) {
    const int i = i0 + warp;
    const bool active = row < n && i < t_len;
    float qi[DM], gi[DM], dq[DM];
    load_vec<T, DM>(qi, qkv, row, i, t_len, w3, h * d_head, d_head, active);
    load_vec<T, DM>(gi, g, row, i, t_len, hd, h * d_head, d_head, active);
#pragma unroll
    for (int d = 0; d < DM; ++d) dq[d] = 0.f;
    float m = -INFINITY;
    for (int j0 = 0; j0 < t_len; j0 += kt) {
      stage_keys(j0);
      const int cnt = min(kt, t_len - j0);
      for (int j = 0; j < cnt; ++j)
        m = fmaxf(m, score<DM>(qi, xs, j, d_head, lane, inv_s));
    }
    const float den = __fadd_rn(
        tree_sum(slots, t_len, kt, stage_keys, [&](int j) {
          return expf(score<DM>(qi, xs, j, d_head, lane, inv_s) - m) *
                 vec[j * kLanes + lane];
        }),
        __fmul_rn(kEps, expf(-m)));
    // r = sum_j da_ij a_ij, with the f32 a
    const float r = tree_sum(slots, t_len, kt, stage_keys, [&](int j) {
      const float e = expf(score<DM>(qi, xs, j, d_head, lane, inv_s) - m) *
                      vec[j * kLanes + lane];
      const float a = den > 0.f ? e / den : 0.f;
      return __fmul_rn(dot_staged<DM>(gi, ys, j, d_head, lane), a);
    });
    for (int j0 = 0; j0 < t_len; j0 += kt) {
      stage_keys(j0);
      const int cnt = min(kt, t_len - j0);
      for (int j = 0; j < cnt; ++j) {
        const float e = expf(score<DM>(qi, xs, j, d_head, lane, inv_s) - m) *
                        vec[j * kLanes + lane];
        const float a = den > 0.f ? e / den : 0.f;
        const float da = dot_staged<DM>(gi, ys, j, d_head, lane);
        const float ds = round_to<T>((da - r) * a * inv);
#pragma unroll
        for (int d = 0; d < DM; ++d)
          if (d < d_head)
            dq[d] = fmaf(ds, xs[(j * d_head + d) * kPad + lane], dq[d]);
      }
    }
    if (i < t_len) {
      st[(0 * t_len + i) * kLanes + lane] = m;
      st[(1 * t_len + i) * kLanes + lane] = den;
      st[(2 * t_len + i) * kLanes + lane] = r;
    }
    if (active) store_vec<T, DM>(dqkv, dq, row, i, t_len, w3, h * d_head,
                                 d_head);
  }
  __syncthreads();  // the stats are written; the key tiles are done

  // ---- phase 2: one thread per (row, key): dk and dv over the queries ---
  staged = -1;
  auto stage_queries = [&](int i0) {
    if (i0 == staged) return;
    __syncthreads();
    const int cnt = min(kt, t_len - i0);
    stage_op(xs, qkv, row0, n, t_len, w3, h * d_head, i0, cnt, d_head);
    stage_op(ys, g, row0, n, t_len, hd, h * d_head, i0, cnt, d_head);
    for (int idx = threadIdx.x; idx < 3 * kLanes * cnt; idx += kThreadsBl) {
      const int which = idx / (kLanes * cnt);
      const int rest = idx - which * kLanes * cnt;  // j * kLanes + r
      vec[which * kt * kLanes + rest] =
          st[(which * t_len + i0) * kLanes + rest];
    }
    __syncthreads();
    staged = i0;
  };
  for (int j0 = 0; j0 < t_len; j0 += kWarpsBl) {
    const int j = j0 + warp;
    const bool active = row < n && j < t_len;
    float kj[DM], vj[DM], dk[DM], dv[DM];
    load_vec<T, DM>(kj, qkv, row, j, t_len, w3, hd + h * d_head, d_head,
                    active);
    load_vec<T, DM>(vj, qkv, row, j, t_len, w3, 2 * hd + h * d_head, d_head,
                    active);
    const float mask_j = mask && active ? mask[row * t_len + j] : 1.f;
#pragma unroll
    for (int d = 0; d < DM; ++d) dk[d] = dv[d] = 0.f;
    for (int i0 = 0; i0 < t_len; i0 += kt) {
      stage_queries(i0);
      const int cnt = min(kt, t_len - i0);
      for (int ii = 0; ii < cnt; ++ii) {
        const float m_i = vec[ii * kLanes + lane];
        const float den_i = vec[(kt + ii) * kLanes + lane];
        const float r_i = vec[(2 * kt + ii) * kLanes + lane];
        const float e =
            expf(score<DM>(kj, xs, ii, d_head, lane, inv_s) - m_i) * mask_j;
        const float a = den_i > 0.f ? e / den_i : 0.f;
        const float da = dot_staged<DM>(vj, ys, ii, d_head, lane);
        const float ds = round_to<T>((da - r_i) * a * inv);
        const float al = round_to<T>(a);  // a in g's dtype, for dv
#pragma unroll
        for (int d = 0; d < DM; ++d)
          if (d < d_head) {
            const int at = (ii * d_head + d) * kPad + lane;
            dk[d] = fmaf(ds, xs[at], dk[d]);
            dv[d] = fmaf(al, ys[at], dv[d]);
          }
      }
    }
    if (active) {
      store_vec<T, DM>(dqkv, dk, row, j, t_len, w3, hd + h * d_head, d_head);
      store_vec<T, DM>(dqkv, dv, row, j, t_len, w3, 2 * hd + h * d_head,
                       d_head);
    }
  }
}

int check_grid(int n, int n_heads, int64_t* blocks) {
  *blocks = (int64_t)((n + kLanes - 1) / kLanes) * n_heads;
  return *blocks > 0x7fffffff ? (int)cudaErrorInvalidConfiguration
                              : (int)cudaSuccess;
}

template <typename T>
struct Fwd {
  const void *qkv, *mask;
  void* out;
  int n, t_len, n_heads, d_head;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    int64_t blocks;
    int err = check_grid(n, n_heads, &blocks);
    if (err != (int)cudaSuccess) return err;
    const int kt = tile_len(t_len, d_head, 1);
    const size_t smem = smem_bytes_for(kt, d_head, 1);
    err = (int)cudaFuncSetAttribute(
        blanes_fwd_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != (int)cudaSuccess) return err;
    // the scale of the scores, computed as rows 1 and 4 compute it
    const float inv = 1.0f / sqrtf((float)d_head);
    blanes_fwd_kernel<T, DM><<<(unsigned)blocks, kThreadsBl, smem, stream>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(mask),
        static_cast<T*>(out), n, n_heads, t_len, d_head, kt, inv);
    return (int)cudaGetLastError();
  }
};

template <typename T>
struct Bwd {
  const void *qkv, *mask, *g;
  void *dqkv, *stats;
  int n, t_len, n_heads, d_head;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    int64_t blocks;
    int err = check_grid(n, n_heads, &blocks);
    if (err != (int)cudaSuccess) return err;
    const int kt = tile_len(t_len, d_head, 3);
    const size_t smem = smem_bytes_for(kt, d_head, 3);
    err = (int)cudaFuncSetAttribute(
        blanes_bwd_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != (int)cudaSuccess) return err;
    const float inv_s = 1.0f / sqrtf((float)d_head);
    // 1/sqrt(D) for ds, rounded once from double, as the plain version's
    // scalar is
    const float inv = (float)(1.0 / sqrt((double)d_head));
    blanes_bwd_kernel<T, DM><<<(unsigned)blocks, kThreadsBl, smem, stream>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(mask),
        static_cast<const T*>(g), static_cast<T*>(dqkv),
        static_cast<float*>(stats), n, n_heads, t_len, d_head, kt, inv_s,
        inv);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// mask may be null (the unmasked variant). Returns cudaGetLastError()
// after the launch: 0 when the kernel was queued; cudaErrorInvalidValue
// for D > 64.
int blanes_fwd_f32(const void* qkv, const void* mask, void* out, int n,
                   int t_len, int n_heads, int d_head, void* stream) {
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  return with_head_width(d_head, Fwd<float>{qkv, mask, out, n, t_len, n_heads,
                                            d_head, (cudaStream_t)stream});
}

int blanes_fwd_bf16(const void* qkv, const void* mask, void* out, int n,
                    int t_len, int n_heads, int d_head, void* stream) {
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  return with_head_width(
      d_head, Fwd<__nv_bfloat16>{qkv, mask, out, n, t_len, n_heads, d_head,
                                 (cudaStream_t)stream});
}

// stats: blanes_bwd_stats_floats(n, t_len, n_heads) f32 of scratch.
int blanes_bwd_f32(const void* qkv, const void* mask, const void* g,
                   void* dqkv, void* stats, int n, int t_len, int n_heads,
                   int d_head, void* stream) {
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  return with_head_width(d_head,
                         Bwd<float>{qkv, mask, g, dqkv, stats, n, t_len,
                                    n_heads, d_head, (cudaStream_t)stream});
}

int blanes_bwd_bf16(const void* qkv, const void* mask, const void* g,
                    void* dqkv, void* stats, int n, int t_len, int n_heads,
                    int d_head, void* stream) {
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  return with_head_width(
      d_head, Bwd<__nv_bfloat16>{qkv, mask, g, dqkv, stats, n, t_len,
                                 n_heads, d_head, (cudaStream_t)stream});
}

// Floats of the backward's stats scratch: m, den and r of every (row,
// head, query), the rows rounded up to whole blocks.
int blanes_bwd_stats_floats(int n, int t_len, int n_heads) {
  return ((n + kLanes - 1) / kLanes) * n_heads * 3 * t_len * kLanes;
}

}  // extern "C"
