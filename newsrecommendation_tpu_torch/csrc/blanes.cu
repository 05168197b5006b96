// Kernel rows 15 and 16: exp-normalised multi-head self-attention over a
// biased fused [q|k|v] projection (the "batch-in-lanes" layout of the TPU
// kernels): the forward and the backward that recomputes the probs,
// unmasked and key-masked.
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
// Design. The TPU kernel puts the batch in the VPU's lanes; on this card
// the contract is the function, not the layout. A work item is one batch
// row, a group of heads and a tile of query (or key) rows; the grid is
// sized by items (rows x head groups x tiles), at most as many blocks as
// fit on the card, each block walking items with the next item's operands
// copied in (cp.async, 16/8/4 bytes as the alignment allows) while it
// computes the current one. Operands are staged in their own dtype, one
// padded row of D per head, rows an odd number of 16-byte units apart, so
// a lane reading its own key's row in 16-byte pieces hits 32 banks.
// On CUDA cores a warp owns one (row, head, query) at a time, its lanes
// over keys: key j in lane j mod 32, each lane taking its keys in order,
// then the xor tree.
// That is the order of rows 1 and 4 and of PyTorch's own reductions, which
// is why a and ds round where the plain version's do (the max, exact in
// any order, is one redux.sync). Each score is computed once.
// Two regimes, chosen from T before the launch (the launch plan is
// ops/experimental_blanes.py:launch_plan):
//   T <= 64: an item is up to four heads and every query. A lane keeps its
//     two scores in registers through the max, den and a (and da, r, ds);
//     the rows of round(a) (and ds) go to the item's (heads, T, T|1)
//     arrays in shared memory. The dots read an f32 copy of K (and V) made
//     once per item, and at T <= 32 the forward's warps split by head and
//     hold their lane's key row in registers. Then the context (or dq, dk,
//     dv) is summed in index order over threads by (head, query pair, d
//     pair). One kernel each way, no global scratch. Both kernels, the
//     layout and the staging are in blanes_resident.cuh: rows 1-2 launch
//     the same forward with the projection's bias added to each staged
//     item and row 2's probs written from registers (qkv_fwd.cuh); rows
//     13-14 take its per-query pass and launch the same backward
//     (fused_tail.cuh, fused_tail_bwd.cu).
//   T > 64: an item is one head and a tile of query (or key) rows, with
//     that head's K and V (or Q and g) staged once for the whole tile. The
//     backward takes two kernels and no atomics: the query side computes
//     m, den, r and dq and writes the per-query stats; the key side
//     recomputes a and ds from them and computes dk and dv. In bf16 with
//     D <= 32 (the NRMS heads) the products run on tensor cores
//     (mma.sync.m16n8k16, bf16 in, f32 sums; tiles of 128 rows, a warp 16
//     of them, fragments by ldmatrix): the forward's QK^T and round(a)V,
//     the backward's QK^T, gV^T, round(ds)K, KQ^T, Vg^T, round(a)g and
//     round(ds)Q; the scores are recomputed in each walk over the keys
//     rather than held. Only the order of the f32 sums changes (scores,
//     den, r, products): at these T, a is about 1/T, and a flipped
//     rounding of a or ds is far below the bf16 tolerance. Otherwise (f32,
//     D > 32) CUDA cores: the forward's warps take two queries at once,
//     a's rows in shared memory and the context with the lanes over d; the
//     backward's kernels recompute a and ds bit for bit (the same dots in
//     the same order).
// Past both regimes (heads wider than 64, or one head's K and V past a
// block's shared memory: f32 D = 64 past T = 318, f32 D = 20 past 941,
// bf16 D <= 32 past 1,232): the same function by row 1's launch (in the
// regime of its own plan: tensor cores, tiled or row-wise) with a zero
// bias and row 4's kernels on qkv (qkv_fwd.cu, qkv_bwd.cu; no bias in row
// 4's resident regime, a zero bias past it), which the
// wrappers launch under rows 15-16's counts
// (ops/experimental_blanes.py:regime).
// At T <= 64 no tensor cores: the FMA work is below the memory bound and
// the rounding of a and ds needs the plain order; f32 would miss its
// tolerance in TF32. What bounds the resident regime on the card is
// instruction throughput and latency: the per-query chain of a dot, a warp
// sum, exp and an IEEE division. Left on the table: the long CUDA-core kernels' context with
// the lanes past D idle (12 of 32 at D = 20), element copies when a head
// row is not 4-byte aligned (bf16 at odd D).

#include "blanes_resident.cuh"  // row 15's resident forward, the layout

#include <type_traits>

namespace nrk {
namespace bl {
namespace {

// Lanes over d (d and d + 32), for NQ weight rows w + q*t:
// sum_j w_q[j] * x[j*rs + d] for j < cnt, in j order, stored to
// dst[q*dstride + d] for d < D.
template <typename T, int NQ>
__device__ __forceinline__ void weighted_rows(T* __restrict__ dst,
                                              int64_t dstride, const float* w,
                                              int t, const T* x, int rs,
                                              int cnt, int d_head, int lane) {
  const int d0 = min(lane, d_head - 1);
  const int d1 = min(lane + 32, d_head - 1);
  float acc0[NQ], acc1[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc0[q] = acc1[q] = 0.f;
  if (d_head > 32) {
    for (int j = 0; j < cnt; ++j) {
      const float x0 = to_f32(x[j * rs + d0]);
      const float x1 = to_f32(x[j * rs + d1]);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        acc0[q] = fmaf(w[q * t + j], x0, acc0[q]);
        acc1[q] = fmaf(w[q * t + j], x1, acc1[q]);
      }
    }
  } else {
    for (int j = 0; j < cnt; ++j) {
      const float x0 = to_f32(x[j * rs + d0]);
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc0[q] = fmaf(w[q * t + j], x0, acc0[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (lane < d_head) dst[q * dstride + lane] = from_f32<T>(acc0[q]);
    if (lane + 32 < d_head) dst[q * dstride + lane + 32] = from_f32<T>(acc1[q]);
  }
}


// a's rows of NQ queries into arow + q*as (f32, or rounded to T with
// kRound) from their q (registers) and the keys (key j at ks + j*krs, in
// T or in an f32 copy); m[q] and den[q] out.
template <typename T, typename K, int DM, int NQ, bool kRound>
__device__ __forceinline__ void a_rows(float* arow, int as, const float* qf,
                                       const K* ks, int krs,
                                       const float* mrow, const Params& p,
                                       float* m, float* den, int lane) {
  float mx[NQ], sum[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    mx[q] = -INFINITY;
    sum[q] = 0.f;
  }
  for (int j = lane; j < p.t; j += 32) {
    float s[NQ];
    dot_rows<K, DM, NQ>(s, qf, ks + j * krs, p.d);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      s[q] = __fmul_rn(s[q], p.inv_s);
      arow[q * as + j] = s[q];
      mx[q] = fmaxf(mx[q], s[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) m[q] = redux_max(mx[q]);
  for (int j = lane; j < p.t; j += 32) {
    const float mj = mrow ? mrow[j] : 1.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float e = expf(arow[q * as + j] - m[q]);
      if (mrow) e = e * mj;
      arow[q * as + j] = e;
      sum[q] = __fadd_rn(sum[q], e);
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    den[q] = __fadd_rn(warp_sum(sum[q]), __fmul_rn(kEps, expf(-m[q])));
  for (int j = lane; j < p.t; j += 32)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float a = den[q] > 0.f ? arow[q * as + j] / den[q] : 0.f;
      arow[q * as + j] = kRound ? round_to<T>(a) : a;
    }
}

// da's rows (g_i . v_j) of NQ queries, r = sum_j da a, then ds's rows,
// rounded to T, into dsrow + q*as; a rounded to T in arow with kRoundA.
template <typename T, typename V, int DM, int NQ, bool kRoundA>
__device__ __forceinline__ void ds_rows(float* dsrow, float* arow, int as,
                                        const float* gf, const V* vs,
                                        int vrs, const Params& p, float* r,
                                        int lane) {
  float part[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) part[q] = 0.f;
  for (int j = lane; j < p.t; j += 32) {
    float da[NQ];
    dot_rows<V, DM, NQ>(da, gf, vs + j * vrs, p.d);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      dsrow[q * as + j] = da[q];
      part[q] = __fadd_rn(part[q], __fmul_rn(da[q], arow[q * as + j]));
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) r[q] = warp_sum(part[q]);
  for (int j = lane; j < p.t; j += 32)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float a = arow[q * as + j];
      dsrow[q * as + j] = round_to<T>((dsrow[q * as + j] - r[q]) * a * p.inv);
      if (kRoundA) arow[q * as + j] = round_to<T>(a);
    }
}

template <int N>
struct Int {
  static constexpr int value = N;
};

// A warp's tasks: `rows` rows of each of `gn` heads, taken kPair
// consecutive rows at a time, an odd last row alone; body(Int<NQ>, head,
// first row).
template <int kPair, typename Body>
__device__ __forceinline__ void for_tasks(int gn, int rows, int warp,
                                          Body body) {
  const int per = (rows + kPair - 1) / kPair;
  for (int task = warp; task < gn * per; task += kWarps) {
    const int hl = task / per;
    const int ii = (task - hl * per) * kPair;
    if (kPair == 2 && ii + 1 < rows) body(Int<kPair>{}, hl, ii);
    else body(Int<1>{}, hl, ii);
  }
}



// T > 64: an item is one head and a tile of queries; a warp takes two
// queries at once (one where D > 32), its rows of round(a) in shared
// memory, then their context with the lanes over d.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
blanes_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                  T* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPair = DM <= 32 ? 2 : 1;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int hd = p.h * p.d;
  float* arow = reinterpret_cast<float*>(smem + p.nbuf * p.stage) +
                warp * kPair * p.t;
  auto stage = [&](int item, int b) {
    const Item it = item_of(p, item);
    T* s = reinterpret_cast<T*>(smem + b * p.stage);
    const int64_t base = it.n * p.t;
    const int c = it.h0 * p.d;
    stage_part(s, qkv, base + it.r0, it.rn, 3 * hd, c, it.gn, p);
    stage_part(s + p.rows * p.rs, qkv, base, p.t, 3 * hd, hd + c, it.gn, p);
    stage_part(s + (p.rows + p.t) * p.rs, qkv, base, p.t, 3 * hd,
               2 * hd + c, it.gn, p);
  };
  auto compute = [&](int item, int b) {
    const Item it = item_of(p, item);
    const T* qs = reinterpret_cast<const T*>(smem + b * p.stage);
    const T* ks = qs + p.rows * p.rs;
    const T* vs = ks + p.t * p.rs;
    const float* mrow = mask ? mask + it.n * p.t : nullptr;
    for_tasks<kPair>(it.gn, it.rn, warp, [&](auto nq, int hl, int ii) {
      constexpr int NQ = decltype(nq)::value;
      float qf[NQ * DM], m[NQ], den[NQ];
      load_rows<T, DM, NQ>(qf, qs + ii * p.rs + hl * p.dp, p.rs, p.d);
      a_rows<T, T, DM, NQ, true>(arow, p.t, qf, ks + hl * p.dp, p.rs, mrow,
                                 p, m, den, lane);
      __syncwarp();
      weighted_rows<T, NQ>(
          out + (it.n * p.t + it.r0 + ii) * hd + (it.h0 + hl) * p.d, hd, arow,
          p.t, vs + hl * p.dp, p.rs, p.t, p.d, lane);
      __syncwarp();  // the next task overwrites the rows
    });
  };
  run_items(p, smem, stage, compute);
}

// ---- tensor cores (helpers in mma.cuh) -------------------------------------

// The long regime's stats of 16 queries (a warp's) in bf16 by mma: m and
// den of the rows g and g + 8 of each quad (lane / 4), from three walks
// over the keys in the forward's way. e_of(s, key, r) is e, 0 past T.
template <int KS>
__device__ __forceinline__ void mma_m_den(const unsigned (*qa)[4],
                                          const __nv_bfloat16* ks,
                                          const float* mrow, const Params& p,
                                          float* m, float* den, int lane) {
  const int tq = lane % 4;
  m[0] = m[1] = -INFINITY;
  for (int key0 = 0; key0 < p.t; key0 += 8) {
    float c[4];
    mma_rows<KS>(c, qa, ks, p.rs, key0, p.t, p.inv_s, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + 2 * tq + e % 2 < p.t) m[e / 2] = fmaxf(m[e / 2], c[e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
  den[0] = den[1] = 0.f;
  for (int key0 = 0; key0 < p.t; key0 += 8) {
    float c[4];
    mma_rows<KS>(c, qa, ks, p.rs, key0, p.t, p.inv_s, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = key0 + 2 * tq + e % 2;
      if (k < p.t) {
        float x = expf(c[e] - m[e / 2]);
        if (mrow) x = x * mrow[k];
        den[e / 2] = __fadd_rn(den[e / 2], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] = __fadd_rn(den[r], __shfl_xor_sync(0xffffffffu, den[r], 1));
    den[r] = __fadd_rn(den[r], __shfl_xor_sync(0xffffffffu, den[r], 2));
    den[r] = __fadd_rn(den[r], __fmul_rn(kEps, expf(-m[r])));
  }
}

// a (f32) of the fragment element (row r, key k) from its scaled score
__device__ __forceinline__ float a_of(float s, int k, float m, float den,
                                      const float* mrow, int t) {
  if (k >= t) return 0.f;
  float e = expf(s - m);
  if (mrow) e = e * mrow[k];
  return den > 0.f ? e / den : 0.f;
}

// T > 64 in bf16 with D <= 32: an item is one head and a tile of 128
// queries, a warp 16 of them. QK^T and round(a)V run on mma.sync with f32
// sums, the scores recomputed in three walks over the keys (the max, den,
// then a and the context) rather than held. Only the order of the f32
// sums changes (scores, den, context); at these T, a is about 1/T and a
// flipped rounding of it is far below the bf16 tolerance.
template <int DM>
__global__ void __launch_bounds__(kThreads)
blanes_fwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                      const float* __restrict__ mask,
                      __nv_bfloat16* __restrict__ out, Params p) {
  using T = __nv_bfloat16;
  constexpr int KS = (DM + 15) / 16;  // k-steps of QK^T
  constexpr int ND = (DM + 7) / 8;    // d tiles of the context
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tq = lane % 4;
  const int hd = p.h * p.d;
  auto stage = [&](int item, int b) {
    const Item it = item_of(p, item);
    T* s = reinterpret_cast<T*>(smem + b * p.stage);
    const int64_t base = it.n * p.t;
    const int c = it.h0 * p.d;
    stage_part(s, qkv, base + it.r0, it.rn, 3 * hd, c, 1, p);
    stage_part(s + p.rows * p.rs, qkv, base, p.t, 3 * hd, hd + c, 1, p);
    stage_part(s + (p.rows + p.t) * p.rs, qkv, base, p.t, 3 * hd,
               2 * hd + c, 1, p);
  };
  auto compute = [&](int item, int b) {
    const Item it = item_of(p, item);
    const int q0 = warp * 16;
    if (q0 >= it.rn) return;
    const T* qs = reinterpret_cast<const T*>(smem + b * p.stage);
    const T* ks = qs + p.rows * p.rs;
    const T* vs = ks + p.t * p.rs;
    const float* mrow = mask ? mask + it.n * p.t : nullptr;
    unsigned qa[KS][4];
    load_a<KS>(qa, qs, p.rs, q0, it.rn, lane);
    float m[2], den[2];
    mma_m_den<KS>(qa, ks, mrow, p, m, den, lane);
    float o[ND][4] = {};
    for (int key0 = 0; key0 < p.t; key0 += 16) {
      float c[2][4], a[8];
      mma_rows<KS>(c[0], qa, ks, p.rs, key0, p.t, p.inv_s, lane);
      mma_rows<KS>(c[1], qa, ks, p.rs, key0 + 8, p.t, p.inv_s, lane);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = e % 4 / 2;
        a[e] = a_of(c[e / 4][e % 4], key0 + 8 * (e / 4) + 2 * tq + e % 2,
                    m[r], den[r], mrow, p.t);
      }
      // round(a) as the A fragment of a (16 queries x 16 keys) . V
      unsigned pa[4];
      pack_a(pa, a);
      mma_acc<ND>(o, pa, vs, p.rs, key0, p.t, lane);
    }
    store_tiles<ND>(out + it.h0 * p.d, it.n * p.t + it.r0, hd, o, q0, it.rn,
                    p.d, lane);
  };
  run_items(p, smem, stage, compute);
}

// The long backward's query side in bf16 with D <= 32 (a tile of 128
// queries, a warp 16): m and den as the forward's, then r = sum_k da a
// with da = g V^T on mma, then ds rounded to bf16 and dq = ds K on mma;
// writes the stats for the key side.
template <int DM>
__global__ void __launch_bounds__(kThreads)
blanes_bwd_query_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ mask,
                            const __nv_bfloat16* __restrict__ g,
                            __nv_bfloat16* __restrict__ dqkv,
                            float* __restrict__ stats, Params p) {
  using T = __nv_bfloat16;
  constexpr int KS = (DM + 15) / 16;
  constexpr int ND = (DM + 7) / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tq = lane % 4;
  const int hd = p.h * p.d;
  const int64_t nht = (int64_t)p.n * p.h * p.t;
  auto stage = [&](int item, int b) {
    const Item it = item_of(p, item);
    T* s = reinterpret_cast<T*>(smem + b * p.stage);
    const int64_t base = it.n * p.t;
    const int c = it.h0 * p.d;
    stage_part(s, qkv, base + it.r0, it.rn, 3 * hd, c, 1, p);
    stage_part(s + p.rows * p.rs, g, base + it.r0, it.rn, hd, c, 1, p);
    stage_part(s + 2 * p.rows * p.rs, qkv, base, p.t, 3 * hd, hd + c, 1, p);
    stage_part(s + (2 * p.rows + p.t) * p.rs, qkv, base, p.t, 3 * hd,
               2 * hd + c, 1, p);
  };
  auto compute = [&](int item, int b) {
    const Item it = item_of(p, item);
    const int q0 = warp * 16;
    if (q0 >= it.rn) return;
    const T* qs = reinterpret_cast<const T*>(smem + b * p.stage);
    const T* gs = qs + p.rows * p.rs;
    const T* ks = gs + p.rows * p.rs;
    const T* vs = ks + p.t * p.rs;
    const float* mrow = mask ? mask + it.n * p.t : nullptr;
    unsigned qa[KS][4], ga[KS][4];
    load_a<KS>(qa, qs, p.rs, q0, it.rn, lane);
    load_a<KS>(ga, gs, p.rs, q0, it.rn, lane);
    float m[2], den[2], r[2] = {0.f, 0.f};
    mma_m_den<KS>(qa, ks, mrow, p, m, den, lane);
    for (int key0 = 0; key0 < p.t; key0 += 8) {
      float c[4], da[4];
      mma_rows<KS>(c, qa, ks, p.rs, key0, p.t, p.inv_s, lane);
      mma_rows<KS>(da, ga, vs, p.rs, key0, p.t, 1.f, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = key0 + 2 * tq + e % 2;
        r[e / 2] = __fadd_rn(r[e / 2], __fmul_rn(da[e], a_of(
            c[e], k, m[e / 2], den[e / 2], mrow, p.t)));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r[i] = __fadd_rn(r[i], __shfl_xor_sync(0xffffffffu, r[i], 1));
      r[i] = __fadd_rn(r[i], __shfl_xor_sync(0xffffffffu, r[i], 2));
    }
    float o[ND][4] = {};
    for (int key0 = 0; key0 < p.t; key0 += 16) {
      float c[2][4], da[2][4], ds[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_rows<KS>(c[h], qa, ks, p.rs, key0 + 8 * h, p.t, p.inv_s, lane);
        mma_rows<KS>(da[h], ga, vs, p.rs, key0 + 8 * h, p.t, 1.f, lane);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = e % 4 / 2;
        const float a = a_of(c[e / 4][e % 4],
                             key0 + 8 * (e / 4) + 2 * tq + e % 2, m[i],
                             den[i], mrow, p.t);
        ds[e] = (da[e / 4][e % 4] - r[i]) * a * p.inv;
      }
      unsigned pa[4];
      pack_a(pa, ds);
      mma_acc<ND>(o, pa, ks, p.rs, key0, p.t, lane);
    }
    store_tiles<ND>(dqkv + it.h0 * p.d, it.n * p.t + it.r0, 3 * hd, o, q0,
                    it.rn, p.d, lane);
    if (tq == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = q0 + lane / 4 + 8 * i;
        if (q < it.rn) {
          const int64_t at = (it.n * p.h + it.h0) * p.t + it.r0 + q;
          stats[at] = m[i];
          stats[nht + at] = den[i];
          stats[2 * nht + at] = r[i];
        }
      }
    }
  };
  run_items(p, smem, stage, compute);
}

// The long backward's key side in bf16 with D <= 32 (a tile of 128 keys,
// a warp 16): over the queries in tiles of 16, s = K Q^T and da = V g^T on
// mma, a and ds from the query side's stats, then dv += round(a) g and
// dk += ds Q on mma.
template <int DM>
__global__ void __launch_bounds__(kThreads)
blanes_bwd_key_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const float* __restrict__ mask,
                          const __nv_bfloat16* __restrict__ g,
                          __nv_bfloat16* __restrict__ dqkv,
                          const float* __restrict__ stats, Params p) {
  using T = __nv_bfloat16;
  constexpr int KS = (DM + 15) / 16;
  constexpr int ND = (DM + 7) / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tq = lane % 4;
  const int hd = p.h * p.d;
  const int64_t nht = (int64_t)p.n * p.h * p.t;
  const size_t stats_at = (size_t)(2 * p.t + 2 * p.rows) * p.rs * sizeof(T);
  auto stage = [&](int item, int b) {
    const Item it = item_of(p, item);
    unsigned char* buf = smem + b * p.stage;
    T* s = reinterpret_cast<T*>(buf);
    const int64_t base = it.n * p.t;
    const int c = it.h0 * p.d;
    stage_part(s, qkv, base, p.t, 3 * hd, c, 1, p);
    stage_part(s + p.t * p.rs, g, base, p.t, hd, c, 1, p);
    stage_part(s + 2 * p.t * p.rs, qkv, base + it.r0, it.rn, 3 * hd, hd + c,
               1, p);
    stage_part(s + (2 * p.t + p.rows) * p.rs, qkv, base + it.r0, it.rn,
               3 * hd, 2 * hd + c, 1, p);
    float* st = reinterpret_cast<float*>(buf + stats_at);
    const int64_t at = (it.n * p.h + it.h0) * p.t;
    for (int idx = threadIdx.x; idx < 3 * p.t; idx += kThreads) {
      const int which = idx / p.t;
      cp_async<4>(st + idx, stats + which * nht + at + (idx - which * p.t));
    }
  };
  auto compute = [&](int item, int b) {
    const Item it = item_of(p, item);
    const int k0 = warp * 16;
    if (k0 >= it.rn) return;
    const unsigned char* buf = smem + b * p.stage;
    const T* qs = reinterpret_cast<const T*>(buf);
    const T* gs = qs + p.t * p.rs;
    const T* ks = gs + p.t * p.rs;
    const T* vs = ks + p.rows * p.rs;
    const float* ms = reinterpret_cast<const float*>(buf + stats_at);
    const float* dens = ms + p.t;
    const float* rs = dens + p.t;
    unsigned ka[KS][4], va[KS][4];
    load_a<KS>(ka, ks, p.rs, k0, it.rn, lane);
    load_a<KS>(va, vs, p.rs, k0, it.rn, lane);
    // the key mask of this lane's rows (keys k0 + lane / 4, + 8)
    float mk[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = min(k0 + lane / 4 + 8 * i, it.rn - 1);
      mk[i] = mask ? mask[it.n * p.t + it.r0 + k] : 1.f;
    }
    float dk[ND][4] = {}, dv[ND][4] = {};
    for (int q0 = 0; q0 < p.t; q0 += 16) {
      float ar[8], ds[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float c[4], da[4];
        mma_rows<KS>(c, ka, qs, p.rs, q0 + 8 * h, p.t, p.inv_s, lane);
        mma_rows<KS>(da, va, gs, p.rs, q0 + 8 * h, p.t, 1.f, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 8 * h + 2 * tq + e % 2;  // c: (key, query)
          float a = 0.f, d_s = 0.f;
          if (q < p.t) {
            float x = expf(c[e] - ms[q]);
            if (mask) x = x * mk[e / 2];
            a = dens[q] > 0.f ? x / dens[q] : 0.f;
            d_s = (da[e] - rs[q]) * a * p.inv;
          }
          ar[4 * h + e] = a;
          ds[4 * h + e] = d_s;
        }
      }
      unsigned pa[4], pd[4];
      pack_a(pa, ar);
      pack_a(pd, ds);
      mma_acc<ND>(dv, pa, gs, p.rs, q0, p.t, lane);
      mma_acc<ND>(dk, pd, qs, p.rs, q0, p.t, lane);
    }
    const int64_t first = it.n * p.t + it.r0;
    store_tiles<ND>(dqkv + hd + it.h0 * p.d, first, 3 * hd, dk, k0, it.rn,
                    p.d, lane);
    store_tiles<ND>(dqkv + 2 * hd + it.h0 * p.d, first, 3 * hd, dv, k0, it.rn,
                    p.d, lane);
  };
  run_items(p, smem, stage, compute);
}

// T > 64, query side (one head, a tile of queries): m, den, r and dq; the
// stats (3, N*H*T) f32 for the key side.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
blanes_bwd_query_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ mask,
                        const T* __restrict__ g, T* __restrict__ dqkv,
                        float* __restrict__ stats, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int hd = p.h * p.d;
  const int64_t nht = (int64_t)p.n * p.h * p.t;
  float* arow = reinterpret_cast<float*>(smem + p.nbuf * p.stage) +
                2 * warp * p.t;
  float* dsrow = arow + p.t;
  auto stage = [&](int item, int b) {
    const Item it = item_of(p, item);
    T* s = reinterpret_cast<T*>(smem + b * p.stage);
    const int64_t base = it.n * p.t;
    const int c = it.h0 * p.d;
    stage_part(s, qkv, base + it.r0, it.rn, 3 * hd, c, 1, p);
    stage_part(s + p.rows * p.rs, g, base + it.r0, it.rn, hd, c, 1, p);
    stage_part(s + 2 * p.rows * p.rs, qkv, base, p.t, 3 * hd, hd + c, 1, p);
    stage_part(s + (2 * p.rows + p.t) * p.rs, qkv, base, p.t, 3 * hd,
               2 * hd + c, 1, p);
  };
  auto compute = [&](int item, int b) {
    const Item it = item_of(p, item);
    const T* qs = reinterpret_cast<const T*>(smem + b * p.stage);
    const T* gs = qs + p.rows * p.rs;
    const T* ks = gs + p.rows * p.rs;
    const T* vs = ks + p.t * p.rs;
    const float* mrow = mask ? mask + it.n * p.t : nullptr;
    for_tasks<1>(1, it.rn, warp, [&](auto nq, int, int ii) {
      constexpr int NQ = decltype(nq)::value;
      float m[NQ], den[NQ], r[NQ];
      {
        float qf[NQ * DM];
        load_rows<T, DM, NQ>(qf, qs + ii * p.rs, p.rs, p.d);
        a_rows<T, T, DM, NQ, false>(arow, p.t, qf, ks, p.rs, mrow, p, m, den,
                                    lane);
      }
      float gf[NQ * DM];
      load_rows<T, DM, NQ>(gf, gs + ii * p.rs, p.rs, p.d);
      ds_rows<T, T, DM, NQ, false>(dsrow, arow, p.t, gf, vs, p.rs, p, r,
                                   lane);
      __syncwarp();
      const int64_t i = it.n * p.t + it.r0 + ii;
      weighted_rows<T, NQ>(dqkv + i * 3 * hd + it.h0 * p.d, 3 * hd, dsrow,
                           p.t, ks, p.rs, p.t, p.d, lane);
      if (lane < NQ) {
        const int64_t at = (it.n * p.h + it.h0) * p.t + it.r0 + ii + lane;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          if (q == lane) {
            stats[at] = m[q];
            stats[nht + at] = den[q];
            stats[2 * nht + at] = r[q];
          }
      }
      __syncwarp();  // the next task overwrites the rows
    });
  };
  run_items(p, smem, stage, compute);
}

// T > 64, key side (one head, a tile of keys): each query's a and ds
// recomputed from the stats, then dk and dv.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
blanes_bwd_key_kernel(const T* __restrict__ qkv,
                      const float* __restrict__ mask,
                      const T* __restrict__ g, T* __restrict__ dqkv,
                      const float* __restrict__ stats, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int hd = p.h * p.d;
  const int64_t nht = (int64_t)p.n * p.h * p.t;
  float* arow = reinterpret_cast<float*>(smem + p.nbuf * p.stage) +
                2 * warp * p.t;
  float* dsrow = arow + p.t;
  const size_t stats_at = (size_t)(2 * p.t + 2 * p.rows) * p.rs * sizeof(T);
  auto stage = [&](int item, int b) {
    const Item it = item_of(p, item);
    unsigned char* buf = smem + b * p.stage;
    T* s = reinterpret_cast<T*>(buf);
    const int64_t base = it.n * p.t;
    const int c = it.h0 * p.d;
    stage_part(s, qkv, base, p.t, 3 * hd, c, 1, p);
    stage_part(s + p.t * p.rs, g, base, p.t, hd, c, 1, p);
    stage_part(s + 2 * p.t * p.rs, qkv, base + it.r0, it.rn, 3 * hd, hd + c,
               1, p);
    stage_part(s + (2 * p.t + p.rows) * p.rs, qkv, base + it.r0, it.rn,
               3 * hd, 2 * hd + c, 1, p);
    float* st = reinterpret_cast<float*>(buf + stats_at);
    const int64_t at = (it.n * p.h + it.h0) * p.t;
    for (int idx = threadIdx.x; idx < 3 * p.t; idx += kThreads) {
      const int which = idx / p.t;
      cp_async<4>(st + idx, stats + which * nht + at + (idx - which * p.t));
    }
  };
  auto compute = [&](int item, int b) {
    const Item it = item_of(p, item);
    const unsigned char* buf = smem + b * p.stage;
    const T* qs = reinterpret_cast<const T*>(buf);
    const T* gs = qs + p.t * p.rs;
    const T* ks = gs + p.t * p.rs;
    const T* vs = ks + p.rows * p.rs;
    const float* ms = reinterpret_cast<const float*>(buf + stats_at);
    const float* dens = ms + p.t;
    const float* rs = dens + p.t;
    for_tasks<1>(1, it.rn, warp, [&](auto nq, int, int jj) {
      constexpr int NQ = decltype(nq)::value;  // keys jj .. jj + NQ - 1
      const int64_t j = it.n * p.t + it.r0 + jj;
      float mask_j[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) mask_j[q] = mask ? mask[j + q] : 1.f;
      {
        float kf[NQ * DM];
        load_rows<T, DM, NQ>(kf, ks + jj * p.rs, p.rs, p.d);
        for (int i = lane; i < p.t; i += 32) {
          float s[NQ];
          dot_rows<T, DM, NQ>(s, kf, qs + i * p.rs, p.d);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            float e = expf(__fmul_rn(s[q], p.inv_s) - ms[i]);
            if (mask) e = e * mask_j[q];
            arow[q * p.t + i] = dens[i] > 0.f ? e / dens[i] : 0.f;
          }
        }
      }
      float vf[NQ * DM];
      load_rows<T, DM, NQ>(vf, vs + jj * p.rs, p.rs, p.d);
      for (int i = lane; i < p.t; i += 32) {
        float da[NQ];
        dot_rows<T, DM, NQ>(da, vf, gs + i * p.rs, p.d);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float a = arow[q * p.t + i];
          dsrow[q * p.t + i] = round_to<T>((da[q] - rs[i]) * a * p.inv);
          arow[q * p.t + i] = round_to<T>(a);  // a in g's dtype, for dv
        }
      }
      __syncwarp();
      T* o = dqkv + j * 3 * hd + it.h0 * p.d;
      weighted_rows<T, NQ>(o + hd, 3 * hd, dsrow, p.t, qs, p.rs, p.t, p.d,
                           lane);
      weighted_rows<T, NQ>(o + 2 * hd, 3 * hd, arow, p.t, gs, p.rs, p.t, p.d,
                           lane);
      __syncwarp();  // the next task overwrites the rows
    });
  };
  run_items(p, smem, stage, compute);
}

// ---- launch --------------------------------------------------------------------

template <typename T>
struct Launch {
  int kind;
  const T *qkv, *g;
  const float* mask;
  T* out;
  float* stats;
  Params p;
  size_t smem;
  unsigned blocks;
  cudaStream_t stream;

  template <typename K, typename... A>
  int go(K kernel, A... args) const {
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != (int)cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
  }

  template <int DM>
  int operator()() const {
    constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value && DM <= 32;
    switch (kind) {
      case kFwd:
        if (p.t <= kShortT)
          return go(blanes_fwd_short_kernel<T, DM>, qkv, mask, out, p);
        if constexpr (kMma) {
          if (long_mma(p.t, p.d, 2))
            return go(blanes_fwd_mma_kernel<DM>, qkv, mask, out, p);
        }
        return go(blanes_fwd_kernel<T, DM>, qkv, mask, out, p);
      case kBwdQuery:
        if constexpr (kMma) {
          if (long_mma(p.t, p.d, 2))
            return go(blanes_bwd_query_mma_kernel<DM>, qkv, mask, g, out,
                      stats, p);
        }
        return go(blanes_bwd_query_kernel<T, DM>, qkv, mask, g, out, stats,
                  p);
      default:
        if constexpr (kMma) {
          if (long_mma(p.t, p.d, 2))
            return go(blanes_bwd_key_mma_kernel<DM>, qkv, mask, g, out,
                      (const float*)stats, p);
        }
        return go(blanes_bwd_key_kernel<T, DM>, qkv, mask, g, out,
                  (const float*)stats, p);
    }
  }
};

// One kernel launch of the plan (heads, rows, nbuf, blocks) the wrapper
// chose, but the resident backward's (bwd_short_launch); refuses a plan
// the kind does not take.
template <typename T>
int launch(int kind, const void* qkv, const void* mask, const void* g,
           void* out, void* stats, int n, int t_len, int n_heads, int d_head,
           int heads, int rows, int nbuf, int blocks, void* stream) {
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  if (kind == kFwd && t_len <= kShortT) rows = t_len;
  const bool one_head = kind == kBwdQuery || kind == kBwdKey;
  if (heads < 1 || heads > 4 || heads > n_heads ||
      (one_head && heads != 1) || rows < 1 || rows > t_len ||
      kind == kBwd || (one_head && t_len <= kShortT) ||
      (one_head && stats == nullptr) || nbuf < 1 || nbuf > 2 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int esize = (int)sizeof(T);
  const Layout lay = layout_of(kind, t_len, d_head, esize, heads, rows);
  const size_t smem = nbuf * lay.stage + lay.rows;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const Params p = params_of(kind, n, t_len, n_heads, d_head, esize, heads,
                             rows, nbuf, qkv, g ? g : qkv);
  if (p.items == 0) return (int)cudaErrorInvalidConfiguration;
  const Launch<T> body{kind, static_cast<const T*>(qkv),
                       static_cast<const T*>(g),
                       static_cast<const float*>(mask), static_cast<T*>(out),
                       static_cast<float*>(stats), p, smem,
                       (unsigned)(blocks < p.items ? blocks : p.items),
                       (cudaStream_t)stream};
  return with_head_width(d_head, body);
}

template <typename T>
int fwd(const void* qkv, const void* mask, void* out, int n, int t_len,
        int n_heads, int d_head, int heads, int rows, int nbuf, int blocks,
        void* stream) {
  return launch<T>(kFwd, qkv, mask, nullptr, out, nullptr, n, t_len, n_heads,
                   d_head, heads, rows, nbuf, blocks, stream);
}

// T <= 64: one kernel (heads, nbuf, blocks); else the query side (rows,
// nbuf, blocks) then the key side (key_rows, key_nbuf, key_blocks).
template <typename T>
int bwd(const void* qkv, const void* mask, const void* g, void* dqkv,
        void* stats, int n, int t_len, int n_heads, int d_head, int heads,
        int rows, int nbuf, int blocks, int key_rows, int key_nbuf,
        int key_blocks, void* stream) {
  if (t_len <= kShortT)
    return bwd_short_launch<T>(qkv, mask, g, dqkv, n, t_len, n_heads, d_head,
                               heads, nbuf, blocks, stream);
  const int err = launch<T>(kBwdQuery, qkv, mask, g, dqkv, stats, n, t_len,
                            n_heads, d_head, heads, rows, nbuf, blocks,
                            stream);
  if (err != (int)cudaSuccess) return err;
  return launch<T>(kBwdKey, qkv, mask, g, dqkv, stats, n, t_len, n_heads,
                   d_head, heads, key_rows, key_nbuf, key_blocks, stream);
}

}  // namespace
}  // namespace bl
}  // namespace nrk

using namespace nrk::bl;

extern "C" {

// mask may be null (the unmasked variant). (heads, rows, nbuf, blocks) is
// the launch plan of ops/experimental_blanes.py:launch_plan. Returns
// cudaGetLastError() after the launch: 0 when the kernel was queued;
// cudaErrorInvalidValue for D > 64 or a plan the kernel does not take.
int blanes_fwd_f32(const void* qkv, const void* mask, void* out, int n,
                   int t_len, int n_heads, int d_head, int heads, int rows,
                   int nbuf, int blocks, void* stream) {
  return fwd<float>(qkv, mask, out, n, t_len, n_heads, d_head, heads, rows,
                    nbuf, blocks, stream);
}

int blanes_fwd_bf16(const void* qkv, const void* mask, void* out, int n,
                    int t_len, int n_heads, int d_head, int heads, int rows,
                    int nbuf, int blocks, void* stream) {
  return fwd<__nv_bfloat16>(qkv, mask, out, n, t_len, n_heads, d_head, heads,
                            rows, nbuf, blocks, stream);
}

// stats: 3*N*H*T f32 of scratch when T > 64 (m, den, r of every query),
// else unused.
int blanes_bwd_f32(const void* qkv, const void* mask, const void* g,
                   void* dqkv, void* stats, int n, int t_len, int n_heads,
                   int d_head, int heads, int rows, int nbuf, int blocks,
                   int key_rows, int key_nbuf, int key_blocks, void* stream) {
  return bwd<float>(qkv, mask, g, dqkv, stats, n, t_len, n_heads, d_head,
                    heads, rows, nbuf, blocks, key_rows, key_nbuf, key_blocks,
                    stream);
}

int blanes_bwd_bf16(const void* qkv, const void* mask, const void* g,
                    void* dqkv, void* stats, int n, int t_len, int n_heads,
                    int d_head, int heads, int rows, int nbuf, int blocks,
                    int key_rows, int key_nbuf, int key_blocks, void* stream) {
  return bwd<__nv_bfloat16>(qkv, mask, g, dqkv, stats, n, t_len, n_heads,
                            d_head, heads, rows, nbuf, blocks, key_rows,
                            key_nbuf, key_blocks, stream);
}

// Shared bytes of one block of `kind` (0 forward, 1 the T <= 64 backward,
// 2 its query side and 3 its key side past 64): what the launch plan
// computes in Python, for a test to hold the two equal.
int blanes_smem_bytes(int kind, int t_len, int d_head, int esize, int heads,
                      int rows, int nbuf) {
  const Layout lay = layout_of(kind, t_len, d_head, esize, heads, rows);
  return (int)(nbuf * lay.stage + lay.rows);
}

}  // extern "C"
