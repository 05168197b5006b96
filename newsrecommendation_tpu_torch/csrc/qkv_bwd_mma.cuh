// Rows 3-4 past the resident kernel in bf16 (D <= 64): the backward of the
// fused-qkv exp-MHSA (contract: qkv_bwd.cuh) on tensor cores
// (mma.sync.m16n8k16 through mma.cuh), every operand staged in chunks, so
// nothing in shared memory grows with T. With qkv_bwd.cuh it replaces the
// TPU kernels newsrecommendation_tpu/ops/pallas/fused_attention.py
// :_qkv_bwd_probs_kernel (row 3) and :_qkv_bwd_kernel (row 4) at these
// shapes.
//
// Bound, at (N, T) = (64, 511), 20 heads of 20: row 3 reads qkv, 1,337 MB
// of f32 probs and g and writes dqkv, 1.52 GB, 0.45 ms at 3.35 TB/s; row 4
// moves 183 MB (0.055 ms) against 10*N*H*T*T*D = 66.8 GFLOP, 0.068 ms at
// the bf16 tensor-core peak. Row 3 reads the probs three times (two query
// passes, the key side), staged by 16-byte cp.async beside the chunk's K
// and V (or Q and g); row 4 recomputes s in every pass. Times on an H100:
// PERF.md (scripts/qkv_bwd_ab.py, chip_smoke.py).
//
// Two kernels, query side first, no atomics, every sum in a fixed order:
//   query side: a block takes one (row, head) and a tile of 64 or 128
//     queries, a warp 16 of them (their q and g A fragments loaded once);
//     K, V and the key mask (row 3: and the tile's probs over the chunk's
//     keys) are staged by cp.async in chunks of up to 256 keys, one or two
//     buffers. It walks all keys once per pass:
//       row 4: m (the max of s over ALL keys), then den = sum e + 1e-8
//              exp(-m), then r = sum da a, then ds and dq += round(ds) K;
//       row 3: r (a read from the staged f32 probs), then ds and dq.
//     Each pass ends in a sum over the four lanes that share a row; the
//     row's m, den and r go to `stats` (3 planes of N*H*T f32) for the
//     key side;
//   key side: a block takes one (row, head) and a tile of keys, a warp 16;
//     Q, g and the queries' m, den, 1/den and r (row 3: and the chunk's
//     probs over the tile's keys) are staged per chunk of queries.
//     dv += round(a)^T g and dk += round(ds)^T Q, a and ds repacked from C
//     fragments into A fragments in registers.
// a = e / den is the IEEE quotient, from the row's 1/den and one fma
// (flash.cuh div_by). s is scaled by the forward's 1.0f / sqrtf(D) and ds
// by 1/sqrt(D) rounded from double, as the CUDA-core kernels do. The
// tensor core sums s and da in its own order, so a rounded a or ds may
// flip by an ulp against the plain version (within the bf16 tolerance),
// and row 4 no longer equals row 3 bit for bit here.
//
// q, k, v are the biased projection in bf16 (the launch adds the bias at
// the input dtype in a pass of its own, qkv_bias_kernel, unless the
// caller's qkv carries it), rows 3*H*D apart. Adding it to each staged row
// in shared memory instead (no pass, no copy) made row 4 slower on an
// H100: its query side restages K and V in each of four passes, so every
// element took the add four times per query tile. The layout of shared
// memory and the plan's check
// are flash.cuh's (kFlashBwdQuery and kFlashBwdKey; row 3's
// kQkvProbsQuery and kQkvProbsKey add the probs tile), as the backward of
// row 10 stages the same operands. The plan is
// ops/fused_attention.py:bwd_launch_plan.
#pragma once

#include "flash.cuh"

namespace nrk {

struct QkvBwdParams {
  int h, t, d, ld;      // heads, positions, head width, row stride (3*H*D)
  int tile, chunk;      // own rows of a block; rows of one stage
  int nbuf;             // stage buffers
  int rs;               // staged row stride (elements)
  int piece;            // bytes of one async copy; 0: element copies
  int own, stage;       // bytes of the block's own rows, of one buffer
  int poff, prs;        // row 3: bytes into a buffer and row stride
                        // (floats) of the staged probs
  int pvec;             // row 3: the probs copied 16 bytes at a time
  float inv_s;          // the forward's scale of s: 1.0f / sqrtf(D)
  float inv;            // ds's scale: 1/sqrt(D) rounded from double
  int64_t plane;        // floats of one stats plane: N*H*T
};

// the sum of v over the four lanes of a quad (the lanes that hold one row
// of a C fragment), the same order on every lane
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// biased[i] = round(qkv[i] + bias[i % w3]) in bf16, as the forward adds it
__global__ void qkv_bias_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const __nv_bfloat16* __restrict__ bias,
                                __nv_bfloat16* __restrict__ biased,
                                int64_t total, int w3) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x)
    biased[i] = __float2bfloat16_rn(__bfloat162float(qkv[i]) +
                                    __bfloat162float(bias[i % w3]));
}

// Where float 0 of a staged probs row lies in its shared row: the source's
// offset from 16 bytes when the rows are copied 16 bytes at a time (every
// row of a copy has the same, its stride a multiple of 4 floats), else 0.
__device__ __forceinline__ int probs_shift(const float* src, int vec) {
  return vec ? (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3) : 0;
}

// `rows` runs of `cols` floats from src (rows `ld` floats apart) into dst
// (rows `prs` apart), float c of row r at dst[r * prs + shift + c]
// (probs_shift): with vec, 16-byte copies from the 16-byte boundary below
// each run to the one past it, which stay inside the probs (they start on
// 16 bytes and hold a multiple of 4 floats); else 4-byte copies.
__device__ __forceinline__ void stage_probs(float* dst, int prs,
                                            const float* __restrict__ src,
                                            int64_t ld, int rows, int cols,
                                            int vec) {
  if (vec) {
    const int shift = probs_shift(src, 1);
    const float* from = src - shift;
    const int pieces = (shift + cols + 3) / 4;
    for (int idx = threadIdx.x; idx < rows * pieces; idx += blockDim.x) {
      const int r = idx / pieces;
      const int c = 4 * (idx - r * pieces);
      cp_async<16>(dst + r * prs + c, from + r * ld + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
      const int r = idx / cols;
      const int c = idx - r * cols;
      cp_async<4>(dst + r * prs + c, src + r * ld + c);
    }
  }
}

// The query side. Passes of row 4: 0 max, 1 den, 2 r, 3 ds and dq; row 3
// takes passes 2 and 3.
template <int DM, bool kRecompute, bool kMask>
__global__ void __launch_bounds__(256, 3)
qkv_bwd_query_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const float* __restrict__ probs,
                         const float* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ g,
                         __nv_bfloat16* __restrict__ dqkv,
                         float* __restrict__ stats, QkvBwdParams p) {
  using T = __nv_bfloat16;
  constexpr int KS = (DM + 15) / 16;
  constexpr int ND = (DM + 7) / 8;
  constexpr int kPasses = kRecompute ? 4 : 2;
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
  const int64_t item = (int64_t)row * p.h + h;
  const float* mrow = kMask ? mask + (int64_t)row * p.t : nullptr;
  // probs[row, i, h*T + j] = a[i, j]; prow: the tile's first query
  const int64_t pstride = (int64_t)p.h * p.t;
  const float* prow = kRecompute ? nullptr
                                 : probs + ((int64_t)row * p.t + i0) *
                                               pstride +
                                       (int64_t)h * p.t;
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = qs + p.tile * p.rs;
  auto kbuf = [&](int b) {
    return reinterpret_cast<T*>(smem + p.own + (size_t)b * p.stage);
  };
  auto pbuf = [&](int b) {
    return reinterpret_cast<float*>(smem + p.own + (size_t)b * p.stage +
                                    p.poff);
  };
  const int nc = (p.t + p.chunk - 1) / p.chunk;

  zero_smem(smem, p.own + (size_t)p.nbuf * p.stage);
  auto stage = [&](int task, int b) {
    const int j0 = task % nc * p.chunk;
    const int nj = min(p.chunk, p.t - j0);
    T* ks = kbuf(b);
    stage_rows(ks, p.rs, qkv + base + hd + (int64_t)j0 * p.ld, p.ld, nj, p.d,
               p.piece);
    stage_rows(ks + p.chunk * p.rs, p.rs,
               qkv + base + 2 * hd + (int64_t)j0 * p.ld, p.ld, nj, p.d,
               p.piece);
    if (kMask)
      stage_floats(reinterpret_cast<float*>(ks + 2 * p.chunk * p.rs),
                   mrow + j0, nj, 1);
    if (!kRecompute)
      stage_probs(pbuf(b), p.prs, prow + j0, pstride, nq, nj, p.pvec);
  };
  stage_rows(qs, p.rs, qkv + base + (int64_t)i0 * p.ld, p.ld, nq, p.d,
             p.piece);
  stage_rows(gs, p.rs, g + gbase + (int64_t)i0 * hd, hd, nq, p.d, p.piece);
  stage(0, 0);

  unsigned qa[KS][4], ga[KS][4];
  // the lane's rows are queries q0 + lane / 4 and q0 + lane / 4 + 8
  float mi[2] = {0.f, 0.f}, deni[2] = {0.f, 0.f}, rcpi[2] = {0.f, 0.f};
  float ri[2] = {0.f, 0.f};
  // the pass's partial max (row 4's first pass) or sum
  float acc[2] = {kRecompute ? -INFINITY : 0.f, kRecompute ? -INFINITY : 0.f};
  float dqt[ND][4] = {};
  // the clamped tile row of each of the lane's rows (probs are read there)
  int qrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qrow[r] = min(q0 + lane / 4 + 8 * r, nq - 1);

  auto compute = [&](int task, int b) {
    if (!active) return;
    const int pass = (kRecompute ? 0 : 2) + task / nc;
    const int c = task % nc;
    const int j0 = c * p.chunk;
    const int nj = min(p.chunk, p.t - j0);
    const T* ks = kbuf(b);
    const T* vs = ks + p.chunk * p.rs;
    if (task == 0) {
      load_a<KS>(qa, qs, p.rs, q0, nq, lane);
      load_a<KS>(ga, gs, p.rs, q0, nq, lane);
    }
    if (c == 0 && task > 0) {  // the previous pass is complete
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (pass == 1) {
          mi[r] = quad_max(acc[r]);
        } else if (pass == 2) {
          if constexpr (kRecompute) {
            deni[r] = quad_sum(acc[r]) + kEps * expf(-mi[r]);
            rcpi[r] = rcp_or_zero(deni[r]);
          }
        } else {
          ri[r] = quad_sum(acc[r]);
        }
        acc[r] = 0.f;
      }
    }
    const float* mk = reinterpret_cast<const float*>(vs + p.chunk * p.rs);
    const float* ps = kRecompute ? nullptr
                                 : pbuf(b) + probs_shift(prow + j0, p.pvec);
    for_steps(nj, [&](int j, auto edge) {
      // element e: query row (e % 4) / 2, key j + 8 (e / 4) + 2 tq + e % 2
      float s[8], da[8];
      if (kRecompute) {
        mma_rows<KS>(s, qa, ks, p.rs, j, nj, p.inv_s, lane);
        mma_rows<KS>(s + 4, qa, ks, p.rs, j + 8, nj, p.inv_s, lane);
      }
      if (pass >= 2) {
        mma_rows<KS>(da, ga, vs, p.rs, j, nj, 1.f, lane);
        mma_rows<KS>(da + 4, ga, vs, p.rs, j + 8, nj, 1.f, lane);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = e % 4 / 2;
        const int kj = j + 8 * (e / 4) + 2 * tq + e % 2;  // in the chunk
        bool in = true;
        if constexpr (decltype(edge)::value) in = kj < nj;
        if (kRecompute && pass == 0) {  // clamped keys repeat the last one
          acc[r] = fmaxf(acc[r], s[e]);
          continue;
        }
        float a;
        if constexpr (kRecompute) {
          float x = expf(s[e] - mi[r]);
          if (kMask) x = x * mk[min(kj, nj - 1)];
          if (pass == 1) {
            acc[r] += in ? x : 0.f;
            continue;
          }
          a = div_by(x, deni[r], rcpi[r]);
        } else {
          a = in ? ps[qrow[r] * p.prs + kj] : 0.f;
        }
        if (!in) a = 0.f;
        if (pass == 2) {
          acc[r] += da[e] * a;
        } else {
          s[e] = in ? (da[e] - ri[r]) * a * p.inv : 0.f;
        }
      }
      if (pass == 3) {
        unsigned pd[4];
        pack_a(pd, s);  // ds in k's dtype
        mma_acc<ND>(dqt, pd, ks, p.rs, j, nj, lane);
      }
    });
  };
  walk_tasks(kPasses * nc, p.nbuf, stage, compute);
  if (!active) return;
  if (tq == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + lane / 4 + 8 * r;
      if (q < nq) {
        const int64_t at = item * p.t + i0 + q;
        if (kRecompute) {
          stats[at] = mi[r];
          stats[p.plane + at] = deni[r];
        }
        stats[2 * p.plane + at] = ri[r];
      }
    }
  store_tiles<ND>(dqkv + h * p.d, (int64_t)row * p.t + i0, 3 * hd, dqt, q0,
                  nq, p.d, lane);
}

// The key side: dk and dv of a tile of keys over all queries.
template <int DM, bool kRecompute, bool kMask>
__global__ void __launch_bounds__(256)
qkv_bwd_key_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const float* __restrict__ probs,
                       const float* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ g,
                       __nv_bfloat16* __restrict__ dqkv,
                       const float* __restrict__ stats, QkvBwdParams p) {
  using T = __nv_bfloat16;
  constexpr int KS = (DM + 15) / 16;
  constexpr int ND = (DM + 7) / 8;
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
  const int64_t sbase = ((int64_t)row * p.h + h) * p.t;  // stats
  // probs[row, i, h*T + j] = a[i, j]; pcol: the tile's first key
  const int64_t pstride = (int64_t)p.h * p.t;
  const float* pcol = kRecompute ? nullptr
                                 : probs + (int64_t)row * p.t * pstride +
                                       (int64_t)h * p.t + j0;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + p.tile * p.rs;
  auto qbuf = [&](int b) {
    return reinterpret_cast<T*>(smem + p.own + (size_t)b * p.stage);
  };
  auto pbuf = [&](int b) {
    return reinterpret_cast<float*>(smem + p.own + (size_t)b * p.stage +
                                    p.poff);
  };

  zero_smem(smem, p.own + (size_t)p.nbuf * p.stage);
  auto stage = [&](int c, int b) {
    const int i0 = c * p.chunk;
    const int ni = min(p.chunk, p.t - i0);
    T* qs = qbuf(b);
    stage_rows(qs, p.rs, qkv + base + (int64_t)i0 * p.ld, p.ld, ni, p.d,
               p.piece);
    stage_rows(qs + p.chunk * p.rs, p.rs, g + gbase + (int64_t)i0 * hd, hd,
               ni, p.d, p.piece);
    // per query: m, den, 1/den, r
    float* st = reinterpret_cast<float*>(qs + 2 * p.chunk * p.rs);
    const int64_t at = sbase + i0;
    stage_floats(st + 3 * p.chunk, stats + 2 * p.plane + at, ni, 1);
    if (kRecompute) {
      stage_floats(st, stats + at, ni, 1);
      for (int i = threadIdx.x; i < ni; i += blockDim.x) {
        const float dn = stats[p.plane + at + i];
        st[p.chunk + i] = dn;
        st[2 * p.chunk + i] = rcp_or_zero(dn);
      }
    } else {
      stage_probs(pbuf(b), p.prs, pcol + (int64_t)i0 * pstride, pstride, ni,
                  nk, p.pvec);
    }
  };
  stage_rows(ks, p.rs, qkv + base + hd + (int64_t)j0 * p.ld, p.ld, nk, p.d,
             p.piece);
  stage_rows(vs, p.rs, qkv + base + 2 * hd + (int64_t)j0 * p.ld, p.ld, nk,
             p.d, p.piece);
  stage(0, 0);

  unsigned ka[KS][4], va[KS][4];
  // the lane's rows are keys k0 + lane / 4 and k0 + lane / 4 + 8, clamped
  // in the tile (kl)
  float mk[2];
  int kl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kl[r] = min(k0 + lane / 4 + 8 * r, nk - 1);
    mk[r] = kMask ? mask[(int64_t)row * p.t + j0 + kl[r]] : 1.f;
  }
  float dkt[ND][4] = {}, dvt[ND][4] = {};
  auto compute = [&](int c, int b) {
    if (!active) return;
    const int i0 = c * p.chunk;
    const int ni = min(p.chunk, p.t - i0);
    const T* qs = qbuf(b);
    if (c == 0) {
      if (kRecompute) load_a<KS>(ka, ks, p.rs, k0, nk, lane);
      load_a<KS>(va, vs, p.rs, k0, nk, lane);
    }
    const T* gs = qs + p.chunk * p.rs;
    const float* ms = reinterpret_cast<const float*>(gs + p.chunk * p.rs);
    const float* dens = ms + p.chunk;
    const float* rcps = dens + p.chunk;
    const float* rss = rcps + p.chunk;
    const float* ps =
        kRecompute ? nullptr
                   : pbuf(b) + probs_shift(pcol + (int64_t)i0 * pstride,
                                           p.pvec);
    for_steps(ni, [&](int i, auto edge) {
      float ar[8], ds[8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s[4], da[4];  // (key, query) elements
        if (kRecompute)
          mma_rows<KS>(s, ka, qs, p.rs, i + 8 * half, ni, p.inv_s, lane);
        mma_rows<KS>(da, va, gs, p.rs, i + 8 * half, ni, 1.f, lane);
        const int qi = i + 8 * half + 2 * tq;  // queries qi, qi + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int odd = e % 2;
          const int q = min(qi + odd, ni - 1);  // clamped in the chunk
          float a;
          if constexpr (kRecompute) {
            float x = expf(s[e] - ms[q]);
            if (kMask) x = x * mk[e / 2];
            a = div_by(x, dens[q], rcps[q]);
          } else {
            a = ps[q * p.prs + kl[e / 2]];
          }
          float d_s = (da[e] - rss[q]) * a * p.inv;
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
  store_tiles<ND>(dqkv + hd + h * p.d, first, 3 * hd, dkt, k0, nk, p.d, lane);
  store_tiles<ND>(dqkv + 2 * hd + h * p.d, first, 3 * hd, dvt, k0, nk, p.d,
                  lane);
}

// Whether a plan (tile, chunk, nbuf) of each side is one the kernels take:
// flash.cuh's check of the backward's sides (bf16, D <= 64), row 3's with
// the probs tile.
inline bool qkv_bwd_mma_plan_ok(bool recompute, int d_head, int q_tile,
                                int q_chunk, int q_nbuf, int k_tile,
                                int k_chunk, int k_nbuf) {
  return flash_plan_ok(recompute ? kFlashBwdQuery : kQkvProbsQuery, d_head,
                       2, q_tile, q_chunk, q_nbuf) &&
         flash_plan_ok(recompute ? kFlashBwdKey : kQkvProbsKey, d_head, 2,
                       k_tile, k_chunk, k_nbuf);
}

struct QkvBwdMmaLaunch {
  const __nv_bfloat16* qkv;  // biased
  const float *probs, *mask;
  const __nv_bfloat16* g;
  __nv_bfloat16* dqkv;
  float* stats;
  int n, t_len, n_heads, d_head;
  int q_tile, q_chunk, q_nbuf, k_tile, k_chunk, k_nbuf;
  bool recompute;
  cudaStream_t stream;

  template <typename K>
  int go(K kernel, dim3 grid, int threads, size_t smem,
         const QkvBwdParams& p) const {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, threads, smem, stream>>>(qkv, probs, mask, g, dqkv, stats,
                                            p);
    return (int)cudaGetLastError();
  }

  // the side's parameters: its layout (flash_layout of `kind`) and, for
  // row 3, where the probs tile of `pcols` columns lies in a buffer
  QkvBwdParams params(int kind, int tile, int chunk, int nbuf, int pcols,
                      int piece, int pvec) const {
    const int hd = n_heads * d_head;
    const FlashLayout l = flash_layout(kind, d_head, 2, tile, chunk);
    const int key = kind == kFlashBwdKey || kind == kQkvProbsKey;
    const int poff = 4 * chunk * flash_row_elems(d_head) +
                     (4 * (key ? 4 : 1) * chunk + 15) / 16 * 16;
    return QkvBwdParams{n_heads, t_len, d_head, 3 * hd, tile, chunk, nbuf,
                        flash_row_elems(d_head), piece, (int)l.own,
                        (int)l.stage, poff, qkv_probs_stride(pcols), pvec,
                        1.0f / sqrtf((float)d_head),
                        (float)(1.0 / sqrt((double)d_head)),
                        (int64_t)n * n_heads * t_len};
  }

  template <int DM, bool kRecompute, bool kMask>
  int run() const {
    const int64_t rows = (int64_t)n * n_heads;
    const int q_tiles = (t_len + q_tile - 1) / q_tile;
    const int k_tiles = (t_len + k_tile - 1) / k_tile;
    if (rows > 0x7fffffff || q_tiles > 65535 || k_tiles > 65535)
      return (int)cudaErrorInvalidConfiguration;
    const int hd = n_heads * d_head;
    const void* ptrs[2] = {qkv, g};
    const int piece = flash_piece(d_head, 2, 3 * hd, hd, ptrs, 2);
    // row 3's probs in 16-byte copies: rows of H*T floats a multiple of 4
    // apart, from a 16-byte boundary
    const int pvec = !kRecompute && (int64_t)n_heads * t_len % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(probs) % 16 == 0;
    const QkvBwdParams qp =
        params(kRecompute ? kFlashBwdQuery : kQkvProbsQuery, q_tile, q_chunk,
               q_nbuf, q_chunk, piece, pvec);
    const QkvBwdParams kp =
        params(kRecompute ? kFlashBwdKey : kQkvProbsKey, k_tile, k_chunk,
               k_nbuf, k_tile, piece, pvec);
    int err = go(qkv_bwd_query_mma_kernel<DM, kRecompute, kMask>,
                 dim3((unsigned)rows, (unsigned)q_tiles), 2 * q_tile,
                 qp.own + q_nbuf * (size_t)qp.stage, qp);
    if (err != (int)cudaSuccess) return err;
    return go(qkv_bwd_key_mma_kernel<DM, kRecompute, kMask>,
              dim3((unsigned)rows, (unsigned)k_tiles), 2 * k_tile,
              kp.own + k_nbuf * (size_t)kp.stage, kp);
  }

  template <int DM>
  int operator()() const {
    if (!recompute) return run<DM, false, false>();
    return mask ? run<DM, true, true>() : run<DM, true, false>();
  }
};

}  // namespace nrk
