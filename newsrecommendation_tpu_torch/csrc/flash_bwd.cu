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
// kernels, neither with atomics, and each sum runs in a fixed order, the
// same on every run: a key-side kernel for dk and dv, a query-side kernel
// for dq, each recomputing s, a, da and ds. Two regimes (flash.cuh; the
// plan is ops/blockwise.py:launch_plan):
//   bf16, D <= 64: tensor cores (mma.sync.m16n8k16, bf16 in, f32 sums). A
//     block takes one (row, head) and a tile of 64 or 128 keys (or
//     queries), a warp 16 of them, their two A fragments loaded once; the
//     other side is staged in chunks of up to 256 rows by cp.async, one or
//     two buffers.
//     key side: over the queries, 16 at a time, S^T = K Q^T and dP^T =
//       V g^T, a and ds from the staged m, den, 1/den and delta, then dv
//       += round(a)^T g and dk += ds^T Q, a and ds repacked from the C
//       fragments into A fragments in registers (Q and g by
//       ldmatrix.trans);
//     query side: over the keys, 16 at a time, S = Q K^T and dP = g V^T,
//       then dq += ds K.
//     a = e / den is the IEEE quotient, from the row's 1/den and one fma
//     correction (flash.cuh div_by), not a division per element. What is
//     left is issue-bound: per element an expf, the quotient, ds and two
//     roundings.
//     The order of the f32 sums of s and da changes (the tensor core's),
//     so a rounded a or ds may flip by one ulp where it sits on a rounding
//     edge, far below the bf16 tolerance.
//   f32: CUDA cores (TF32 would change the result).
//     dk/dv: one thread per key j (128 keys of one (row, head) per block)
//       holds k_j, v_j and the two accumulators in registers and walks all
//       queries in tiles of 256 staged in shared memory (q, g, m, den,
//       delta);
//     dq: one thread per query i holds q_i, g_i and dq_i and walks all keys
//       in tiles of 256 (k, v, mask).

#include "flash.cuh"
#include "flash_wide.cuh"

#include <type_traits>

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

// bf16 with D <= 64, the key side: one (row, head) and a tile of keys per
// block, a warp 16 keys; Q, g and the queries' m, den, 1/den and delta
// staged per chunk of queries.
template <int DM, bool kMask>
__global__ void __launch_bounds__(256)
flash_bwd_key_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ m,
                         const float* __restrict__ den,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, FlashParams p) {
  using T = __nv_bfloat16;
  constexpr int KS = (DM + 15) / 16;
  constexpr int ND = (DM + 7) / 8;
  // a name of their own: the CUDA-core kernels declare it as float
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* smem = mma_smem;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tq = lane % 4;
  const int row = blockIdx.x / p.h;
  const int h = blockIdx.x - row * p.h;
  const int hd = p.h * p.d;
  const int j0 = blockIdx.y * p.tile;  // the tile's first key
  const int nk = min(p.tile, p.t - j0);
  const int k0 = warp * 16;  // the warp's first key in the tile
  const bool active = k0 < nk;
  const int64_t base = (int64_t)row * p.t * p.ld + h * p.d;
  const int64_t gbase = (int64_t)row * p.t * hd + h * p.d;
  const int64_t sbase = (int64_t)row * p.t * p.h + h;  // m, den, delta
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + p.tile * p.rs;
  auto qbuf = [&](int b) {
    return reinterpret_cast<T*>(smem + p.own + (size_t)b * p.stage);
  };

  zero_smem(smem, p.own + (size_t)p.nbuf * p.stage);
  auto stage = [&](int c, int b) {
    const int i0 = c * p.chunk;
    const int ni = min(p.chunk, p.t - i0);
    T* qs = qbuf(b);
    stage_rows(qs, p.rs, q + base + (int64_t)i0 * p.ld, p.ld, ni, p.d,
               p.piece);
    stage_rows(qs + p.chunk * p.rs, p.rs, g + gbase + (int64_t)i0 * hd, hd,
               ni, p.d, p.piece);
    float* st = reinterpret_cast<float*>(qs + 2 * p.chunk * p.rs);
    const int64_t at = sbase + (int64_t)i0 * p.h;
    stage_floats(st, m + at, ni, p.h);
    stage_floats(st + 3 * p.chunk, delta + at, ni, p.h);
    for (int i = threadIdx.x; i < ni; i += blockDim.x) {  // den and 1/den
      const float dn = den[at + (int64_t)i * p.h];
      st[p.chunk + i] = dn;
      st[2 * p.chunk + i] = rcp_or_zero(dn);
    }
  };
  stage_rows(ks, p.rs, k + base + (int64_t)j0 * p.ld, p.ld, nk, p.d, p.piece);
  stage_rows(vs, p.rs, v + base + (int64_t)j0 * p.ld, p.ld, nk, p.d, p.piece);
  stage(0, 0);

  unsigned ka[KS][4], va[KS][4];
  float mk[2];  // the key mask of the lane's rows (keys k0 + lane / 4, + 8)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = min(k0 + lane / 4 + 8 * r, nk - 1);
    mk[r] = kMask ? mask[(int64_t)row * p.t + j0 + j] : 1.f;
  }
  float dkt[ND][4] = {}, dvt[ND][4] = {};
  auto compute = [&](int c, int b) {
    if (!active) return;
    if (c == 0) {
      load_a<KS>(ka, ks, p.rs, k0, nk, lane);
      load_a<KS>(va, vs, p.rs, k0, nk, lane);
    }
    const T* qs = qbuf(b);
    const T* gs = qs + p.chunk * p.rs;
    const float* ms = reinterpret_cast<const float*>(gs + p.chunk * p.rs);
    const float* dens = ms + p.chunk;
    const float* rcps = dens + p.chunk;
    const float* dls = rcps + p.chunk;
    const int ni = min(p.chunk, p.t - c * p.chunk);
    for_steps(ni, [&](int i, auto edge) {
      float ar[8], ds[8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s[4], da[4];  // (key, query) elements
        mma_rows<KS>(s, ka, qs, p.rs, i + 8 * half, ni, p.inv, lane);
        mma_rows<KS>(da, va, gs, p.rs, i + 8 * half, ni, 1.f, lane);
        const int qi = i + 8 * half + 2 * tq;  // queries qi, qi + 1
        const float2 mq = *reinterpret_cast<const float2*>(ms + qi);
        const float2 dq2 = *reinterpret_cast<const float2*>(dens + qi);
        const float2 rq = *reinterpret_cast<const float2*>(rcps + qi);
        const float2 dl = *reinterpret_cast<const float2*>(dls + qi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e % 2;
          float x = expf(s[e] - (odd ? mq.y : mq.x));
          if (kMask) x = x * mk[e / 2];
          float a = div_by(x, odd ? dq2.y : dq2.x, odd ? rq.y : rq.x);
          float d_s = (da[e] - (odd ? dl.y : dl.x)) * a * p.inv;
          if constexpr (decltype(edge)::value) {  // clamped rows: no query
            if (qi + odd >= ni) a = d_s = 0.f;
          }
          ar[4 * half + e] = a;
          ds[4 * half + e] = d_s;
        }
      }
      unsigned pa[4], pd[4];
      pack_a(pa, ar);  // a in g's dtype
      pack_a(pd, ds);  // ds in k's dtype
      mma_acc<ND>(dvt, pa, gs, p.rs, i, ni, lane);
      mma_acc<ND>(dkt, pd, qs, p.rs, i, ni, lane);
    });
  };
  walk_tasks((p.t + p.chunk - 1) / p.chunk, p.nbuf, stage, compute);
  if (!active) return;
  const int64_t first = (int64_t)row * p.t + j0;
  store_tiles<ND>(dk + h * p.d, first, hd, dkt, k0, nk, p.d, lane);
  store_tiles<ND>(dv + h * p.d, first, hd, dvt, k0, nk, p.d, lane);
}

// bf16 with D <= 64, the query side: one (row, head) and a tile of queries
// per block, a warp 16 queries; K, V and the mask staged per chunk of keys.
template <int DM, bool kMask>
__global__ void __launch_bounds__(256, 3)  // three blocks an SM
flash_bwd_query_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ mask,
                           const __nv_bfloat16* __restrict__ g,
                           const float* __restrict__ m,
                           const float* __restrict__ den,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, FlashParams p) {
  using T = __nv_bfloat16;
  constexpr int KS = (DM + 15) / 16;
  constexpr int ND = (DM + 7) / 8;
  // a name of their own: the CUDA-core kernels declare it as float
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* smem = mma_smem;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tq = lane % 4;
  const int row = blockIdx.x / p.h;
  const int h = blockIdx.x - row * p.h;
  const int hd = p.h * p.d;
  const int i0 = blockIdx.y * p.tile;  // the tile's first query
  const int nq = min(p.tile, p.t - i0);
  const int q0 = warp * 16;  // the warp's first query in the tile
  const bool active = q0 < nq;
  const int64_t base = (int64_t)row * p.t * p.ld + h * p.d;
  const int64_t gbase = (int64_t)row * p.t * hd + h * p.d;
  const float* mrow = kMask ? mask + (int64_t)row * p.t : nullptr;
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = qs + p.tile * p.rs;
  auto kbuf = [&](int b) {
    return reinterpret_cast<T*>(smem + p.own + (size_t)b * p.stage);
  };

  zero_smem(smem, p.own + (size_t)p.nbuf * p.stage);
  auto stage = [&](int c, int b) {
    const int j0 = c * p.chunk;
    const int nj = min(p.chunk, p.t - j0);
    T* ks = kbuf(b);
    stage_rows(ks, p.rs, k + base + (int64_t)j0 * p.ld, p.ld, nj, p.d,
               p.piece);
    stage_rows(ks + p.chunk * p.rs, p.rs, v + base + (int64_t)j0 * p.ld,
               p.ld, nj, p.d, p.piece);
    if (kMask)
      stage_floats(reinterpret_cast<float*>(ks + 2 * p.chunk * p.rs),
                   mrow + j0, nj, 1);
  };
  stage_rows(qs, p.rs, q + base + (int64_t)i0 * p.ld, p.ld, nq, p.d, p.piece);
  stage_rows(gs, p.rs, g + gbase + (int64_t)i0 * hd, hd, nq, p.d, p.piece);
  stage(0, 0);

  unsigned qa[KS][4], ga[KS][4];
  // m, den, delta of the lane's rows (queries q0 + lane / 4, + 8)
  float mi[2], deni[2], rcpi[2], dli[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = min(q0 + lane / 4 + 8 * r, nq - 1);
    const int64_t at = ((int64_t)row * p.t + i0 + i) * p.h + h;
    mi[r] = m[at];
    deni[r] = den[at];
    rcpi[r] = rcp_or_zero(deni[r]);
    dli[r] = delta[at];
  }
  float dqt[ND][4] = {};
  auto compute = [&](int c, int b) {
    if (!active) return;
    if (c == 0) {
      load_a<KS>(qa, qs, p.rs, q0, nq, lane);
      load_a<KS>(ga, gs, p.rs, q0, nq, lane);
    }
    const T* ks = kbuf(b);
    const T* vs = ks + p.chunk * p.rs;
    const float* mk = reinterpret_cast<const float*>(vs + p.chunk * p.rs);
    const int nj = min(p.chunk, p.t - c * p.chunk);
    for_steps(nj, [&](int j, auto edge) {
      float s[8], da[8];
      mma_rows<KS>(s, qa, ks, p.rs, j, nj, p.inv, lane);
      mma_rows<KS>(s + 4, qa, ks, p.rs, j + 8, nj, p.inv, lane);
      mma_rows<KS>(da, ga, vs, p.rs, j, nj, 1.f, lane);
      mma_rows<KS>(da + 4, ga, vs, p.rs, j + 8, nj, 1.f, lane);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const int r = e % 4 / 2;
        const int kj = j + 8 * (e / 4) + 2 * tq;  // keys kj, kj + 1
        float x0 = expf(s[e] - mi[r]);
        float x1 = expf(s[e + 1] - mi[r]);
        if (kMask) {
          const float2 mm = *reinterpret_cast<const float2*>(mk + kj);
          x0 = x0 * mm.x;
          x1 = x1 * mm.y;
        }
        float d0 = (da[e] - dli[r]) * div_by(x0, deni[r], rcpi[r]) * p.inv;
        float d1 =
            (da[e + 1] - dli[r]) * div_by(x1, deni[r], rcpi[r]) * p.inv;
        if constexpr (decltype(edge)::value) {  // clamped rows: no key
          if (kj >= nj) d0 = 0.f;
          if (kj + 1 >= nj) d1 = 0.f;
        }
        s[e] = d0;
        s[e + 1] = d1;
      }
      unsigned pd[4];
      pack_a(pd, s);  // ds in k's dtype
      mma_acc<ND>(dqt, pd, ks, p.rs, j, nj, lane);
    });
  };
  walk_tasks((p.t + p.chunk - 1) / p.chunk, p.nbuf, stage, compute);
  if (!active) return;
  store_tiles<ND>(dq + h * p.d, (int64_t)row * p.t + i0, hd, dqt, q0, nq,
                  p.d, lane);
}

template <typename T>
struct Launch {
  const void *q, *k, *v, *mask, *g, *m, *den, *delta;
  void *dq, *dk, *dv;
  int n, t_len, n_heads, d_head, ld;
  int key_tile, key_chunk, key_nbuf, q_tile, q_chunk, q_nbuf;
  cudaStream_t stream;

  template <typename K, typename... A>
  int go(K kernel, dim3 grid, int threads, size_t smem, A... args) const {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, threads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
  }

  template <int DM>
  int operator()() const {
    const int64_t rows = (int64_t)n * n_heads;
    const int key_tiles = (t_len + key_tile - 1) / key_tile;
    const int q_tiles = (t_len + q_tile - 1) / q_tile;
    if (rows > 0x7fffffff || key_tiles > 65535 || q_tiles > 65535)
      return (int)cudaErrorInvalidConfiguration;
    // 1/sqrt(D) rounded once from double, as the plain version's scalar is
    const float inv = (float)(1.0 / sqrt((double)d_head));
    const int esize = (int)sizeof(T);
    const FlashLayout kl =
        flash_layout(kFlashBwdKey, d_head, esize, key_tile, key_chunk);
    const FlashLayout ql =
        flash_layout(kFlashBwdQuery, d_head, esize, q_tile, q_chunk);
    const size_t key_smem = kl.own + key_nbuf * kl.stage;
    const size_t q_smem = ql.own + q_nbuf * ql.stage;
    const dim3 key_grid((unsigned)rows, (unsigned)key_tiles);
    const dim3 q_grid((unsigned)rows, (unsigned)q_tiles);
    const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
            *tv = static_cast<const T*>(v), *tg = static_cast<const T*>(g);
    const float *fmask = static_cast<const float*>(mask),
                *fm = static_cast<const float*>(m),
                *fden = static_cast<const float*>(den),
                *fdelta = static_cast<const float*>(delta);
    T *tdq = static_cast<T*>(dq), *tdk = static_cast<T*>(dk),
      *tdv = static_cast<T*>(dv);
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // bf16 heads of up to 64 (every head the wrapper takes) are all on
      // tensor cores
      const void* ptrs[4] = {q, k, v, g};
      const int piece = flash_piece(d_head, esize, ld, n_heads * d_head,
                                    ptrs, 4);
      const int rs = flash_row_elems(d_head);
      const FlashParams kp{n_heads, t_len, d_head, ld, t_len, key_tile,
                           key_chunk, key_nbuf, rs, piece, (int)kl.own,
                           (int)kl.stage, inv};
      const FlashParams qp{n_heads, t_len, d_head, ld, t_len, q_tile,
                           q_chunk, q_nbuf, rs, piece, (int)ql.own,
                           (int)ql.stage, inv};
      int err = mask ? go(flash_bwd_key_mma_kernel<DM, true>, key_grid,
                          2 * key_tile, key_smem, tq, tk, tv, fmask, tg,
                          fm, fden, fdelta, tdk, tdv, kp)
                     : go(flash_bwd_key_mma_kernel<DM, false>, key_grid,
                          2 * key_tile, key_smem, tq, tk, tv, fmask, tg,
                          fm, fden, fdelta, tdk, tdv, kp);
      if (err != (int)cudaSuccess) return err;
      return mask ? go(flash_bwd_query_mma_kernel<DM, true>, q_grid,
                       2 * q_tile, q_smem, tq, tk, tv, fmask, tg, fm, fden,
                       fdelta, tdq, qp)
                  : go(flash_bwd_query_mma_kernel<DM, false>, q_grid,
                       2 * q_tile, q_smem, tq, tk, tv, fmask, tg, fm, fden,
                       fdelta, tdq, qp);
    } else {
      int err = go(flash_bwd_dkdv_kernel<T, DM>, key_grid, kFlashThreads,
                   key_smem, tq, tk, tv, fmask, tg, fm, fden, fdelta, tdk,
                   tdv, n_heads, t_len, d_head, ld, inv);
      if (err != (int)cudaSuccess) return err;
      return go(flash_bwd_dq_kernel<T, DM>, q_grid, kFlashThreads, q_smem,
                tq, tk, tv, fmask, tg, fm, fden, fdelta, tdq, n_heads, t_len,
                d_head, ld, inv);
    }
  }
};

// The wide kernels' launches at the lane width DPL (flash_wide.cuh): the
// key side, then the query side.
template <typename T>
struct WideBwd {
  const T *q, *k, *v;
  const float* mask;
  const T* g;
  const float *m, *den, *delta;
  T *dq, *dk, *dv;
  int n_heads, t_len, d_head, ld;
  float inv;
  dim3 grid;
  cudaStream_t stream;

  template <int DPL>
  int operator()() const {
    flash_bwd_dkdv_wide_kernel<T, DPL>
        <<<grid, 32 * kFlashWideWarps, 0, stream>>>(
            q, k, v, mask, g, m, den, delta, dk, dv, n_heads, t_len, d_head,
            ld, inv);
    const int err = (int)cudaGetLastError();
    if (err != (int)cudaSuccess) return err;
    flash_bwd_dq_wide_kernel<T, DPL>
        <<<grid, 32 * kFlashWideWarps, 0, stream>>>(
            q, k, v, mask, g, m, den, delta, dq, n_heads, t_len, d_head, ld,
            inv);
    return (int)cudaGetLastError();
  }
};

// The two launches of the plans (tile, chunk, nbuf) of the key side and
// the query side the wrapper chose; refuses a plan the regime does not
// take.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* g, const void* m, const void* den, const void* delta,
           void* dq, void* dk, void* dv, int n, int t_len, int n_heads,
           int d_head, int ld, int key_tile, int key_chunk, int key_nbuf,
           int q_tile, int q_chunk, int q_nbuf, void* stream) {
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  const int esize = (int)sizeof(T);
  if (!flash_plan_ok(kFlashBwdKey, d_head, esize, key_tile, key_chunk,
                     key_nbuf) ||
      !flash_plan_ok(kFlashBwdQuery, d_head, esize, q_tile, q_chunk, q_nbuf))
    return (int)cudaErrorInvalidValue;
  if (flash_wide(d_head)) {
    const int64_t rows = (int64_t)n * n_heads;
    const int tiles = (t_len + kFlashWideWarps - 1) / kFlashWideWarps;
    if (rows > 0x7fffffff || tiles > 65535)
      return (int)cudaErrorInvalidConfiguration;
    const float inv = (float)(1.0 / sqrt((double)d_head));
    return with_wide_width(
        d_head,
        WideBwd<T>{static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const float*>(mask),
                   static_cast<const T*>(g), static_cast<const float*>(m),
                   static_cast<const float*>(den),
                   static_cast<const float*>(delta), static_cast<T*>(dq),
                   static_cast<T*>(dk), static_cast<T*>(dv), n_heads, t_len,
                   d_head, ld, inv, dim3((unsigned)rows, (unsigned)tiles),
                   (cudaStream_t)stream});
  }
  return with_head_width(
      d_head, Launch<T>{q, k, v, mask, g, m, den, delta, dq, dk, dv, n, t_len,
                        n_heads, d_head, ld, key_tile, key_chunk, key_nbuf,
                        q_tile, q_chunk, q_nbuf, (cudaStream_t)stream});
}

}  // namespace

extern "C" {

// mask may be null. (key_tile, key_chunk, key_nbuf) and (q_tile, q_chunk,
// q_nbuf) are the plans of ops/blockwise.py:launch_plan for the key side
// and the query side. Returns cudaGetLastError() after the two launches: 0
// when both kernels were queued; cudaErrorInvalidValue for D > 64 or a
// plan the kernels do not take.
int flash_bwd_f32(const void* q, const void* k, const void* v,
                  const void* mask, const void* g, const void* m,
                  const void* den, const void* delta, void* dq, void* dk,
                  void* dv, int n, int t_len, int n_heads, int d_head, int ld,
                  int key_tile, int key_chunk, int key_nbuf, int q_tile,
                  int q_chunk, int q_nbuf, void* stream) {
  return launch<float>(q, k, v, mask, g, m, den, delta, dq, dk, dv, n, t_len,
                       n_heads, d_head, ld, key_tile, key_chunk, key_nbuf,
                       q_tile, q_chunk, q_nbuf, stream);
}

int flash_bwd_bf16(const void* q, const void* k, const void* v,
                   const void* mask, const void* g, const void* m,
                   const void* den, const void* delta, void* dq, void* dk,
                   void* dv, int n, int t_len, int n_heads, int d_head,
                   int ld, int key_tile, int key_chunk, int key_nbuf,
                   int q_tile, int q_chunk, int q_nbuf, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, mask, g, m, den, delta, dq, dk, dv, n,
                               t_len, n_heads, d_head, ld, key_tile,
                               key_chunk, key_nbuf, q_tile, q_chunk, q_nbuf,
                               stream);
}

}  // extern "C"
