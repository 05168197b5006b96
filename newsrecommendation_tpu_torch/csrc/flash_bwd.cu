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
// bf16 tensor cores, so operations bound it; in f32 they take 2.00 ms at
// 67 TFLOP/s on CUDA cores.
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
//   f32: CUDA cores (TF32 would change the result; f32 FMAs only). A block
//     of 128 threads takes one (row, head) and a tile of 128 own rows, one
//     a thread, held in registers with its D-vectors -- a key's k, v and
//     sums dk, dv on the key side; a query's q, g, m, den, 1/den, delta and
//     dq on the query side -- and walks every row of the other side in
//     ascending order, staged in chunks of 256 by 16-byte cp.async as f32
//     rows (flash.cuh core_row_floats), one or two buffers; the key side
//     stages each query's m, den, 1/den and delta as one float4. Every
//     staged row is read as float4s, all threads at once (broadcasts).
//     The dots sum d in order from 0 and every dk, dv, dq sums the other
//     side in ascending order, one FMA at a time, and a = e / den is
//     div_by's IEEE quotient: the bits of a plain per-row walk (pinned by
//     tests/test_torch_kernel_gpu.py). Per (query, key) pair: 7 D FMAs over the two sides (5 D counted),
//     two expfs. Two rows a thread (each staged row feeding twice the
//     FMAs) ran slower on the H100: twice the registers halved the blocks
//     an SM holds.

#include "flash.cuh"
#include "flash_wide.cuh"

#include <type_traits>

namespace {

using namespace nrk;

// Blocks of a CUDA-core side an SM holds by registers: a thread's own row
// and its sums take ~125 registers up to D = 24, ~165 at 32.
__host__ __device__ constexpr int core_bwd_blocks(int dm) {
  return dm <= 24 ? 4 : dm <= 32 ? 3 : 1;
}

// f32 with D <= 64, the key side: one (row, head) and a tile of 128 keys
// per block, a key a thread; Q, g and the queries' (m, den, 1/den, delta)
// staged per chunk of queries.
template <int DM>
__global__ void __launch_bounds__(kCoreBwdThreads, core_bwd_blocks(DM))
flash_bwd_key_core_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ mask,
                          const float* __restrict__ g,
                          const float* __restrict__ m,
                          const float* __restrict__ den,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          FlashParams p) {
  constexpr int NU = DM / 4;               // float4s of a head row
  constexpr int RS = core_row_floats(DM);  // floats of a staged row
  extern __shared__ __align__(16) float core_smem[];
  const int row = blockIdx.x / p.h;
  const int h = blockIdx.x - row * p.h;
  const int hd = p.h * p.d;
  const int j = blockIdx.y * p.tile + threadIdx.x;  // the thread's key
  const bool active = j < p.t;
  const int64_t base = (int64_t)row * p.t * p.ld + h * p.d;
  const int64_t gbase = (int64_t)row * p.t * hd + h * p.d;
  const int64_t sbase = (int64_t)row * p.t * p.h + h;  // m, den, delta
  auto qbuf = [&](int b) {
    return core_smem + (size_t)b * p.stage / sizeof(float);
  };

  zero_smem(reinterpret_cast<unsigned char*>(core_smem),
            (size_t)p.nbuf * p.stage);
  auto stage = [&](int c, int b) {
    const int i0 = c * p.chunk;
    const int ni = min(p.chunk, p.t - i0);
    float* qs = qbuf(b);
    stage_rows(qs, p.rs, q + base + (int64_t)i0 * p.ld, p.ld, ni, p.d,
               p.piece);
    stage_rows(qs + p.chunk * p.rs, p.rs, g + gbase + (int64_t)i0 * hd, hd,
               ni, p.d, p.piece);
    float4* st = reinterpret_cast<float4*>(qs + 2 * p.chunk * p.rs);
    for (int i = threadIdx.x; i < ni; i += blockDim.x) {
      const int64_t at = sbase + (int64_t)(i0 + i) * p.h;
      const float dn = den[at];
      st[i] = make_float4(m[at], dn, rcp_or_zero(dn), delta[at]);
    }
  };
  stage(0, 0);

  float kj[DM], vj[DM], dkj[DM], dvj[DM];
  const float mask_j = mask && active ? mask[(int64_t)row * p.t + j] : 1.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    const bool in = active && d < p.d;
    kj[d] = in ? k[base + (int64_t)j * p.ld + d] : 0.f;
    vj[d] = in ? v[base + (int64_t)j * p.ld + d] : 0.f;
    dkj[d] = dvj[d] = 0.f;
  }
  auto compute = [&](int c, int b) {
    if (!active) return;
    const float* qs = qbuf(b);
    const float* gs = qs + kCoreChunk * RS;
    const float4* st = reinterpret_cast<const float4*>(gs + kCoreChunk * RS);
    const int ni = min(kCoreChunk, p.t - c * kCoreChunk);
    for (int i = 0; i < ni; ++i) {
      const float* qi = qs + i * RS;
      const float* gi = gs + i * RS;
      float sx = 0.f, da = 0.f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 qv = ld4(qi + 4 * u);
        const float4 gv = ld4(gi + 4 * u);
        sx = fmaf(qv.x, kj[4 * u], sx);
        sx = fmaf(qv.y, kj[4 * u + 1], sx);
        sx = fmaf(qv.z, kj[4 * u + 2], sx);
        sx = fmaf(qv.w, kj[4 * u + 3], sx);
        da = fmaf(gv.x, vj[4 * u], da);
        da = fmaf(gv.y, vj[4 * u + 1], da);
        da = fmaf(gv.z, vj[4 * u + 2], da);
        da = fmaf(gv.w, vj[4 * u + 3], da);
      }
      const float4 si = st[i];  // m, den, 1/den, delta of query i
      const float e = expf(__fmul_rn(sx, p.inv) - si.x) * mask_j;
      const float a = div_by(e, si.y, si.z);
      const float ds = (da - si.w) * a * p.inv;
#pragma unroll
      for (int u = 0; u < NU; ++u) {  // q and g again (the registers allow)
        const float4 qv = ld4(qi + 4 * u);
        const float4 gv = ld4(gi + 4 * u);
        dvj[4 * u] = fmaf(a, gv.x, dvj[4 * u]);
        dvj[4 * u + 1] = fmaf(a, gv.y, dvj[4 * u + 1]);
        dvj[4 * u + 2] = fmaf(a, gv.z, dvj[4 * u + 2]);
        dvj[4 * u + 3] = fmaf(a, gv.w, dvj[4 * u + 3]);
        dkj[4 * u] = fmaf(ds, qv.x, dkj[4 * u]);
        dkj[4 * u + 1] = fmaf(ds, qv.y, dkj[4 * u + 1]);
        dkj[4 * u + 2] = fmaf(ds, qv.z, dkj[4 * u + 2]);
        dkj[4 * u + 3] = fmaf(ds, qv.w, dkj[4 * u + 3]);
      }
    }
  };
  walk_tasks((p.t + p.chunk - 1) / p.chunk, p.nbuf, stage, compute);
  if (!active) return;
  const int64_t at = gbase + (int64_t)j * hd;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < p.d) {
      dk[at + d] = dkj[d];
      dv[at + d] = dvj[d];
    }
}

// f32 with D <= 64, the query side: one (row, head) and a tile of 128
// queries per block, a query a thread; K, V and the mask staged per chunk
// of keys.
template <int DM>
__global__ void __launch_bounds__(kCoreBwdThreads, core_bwd_blocks(DM))
flash_bwd_query_core_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ mask,
                            const float* __restrict__ g,
                            const float* __restrict__ m,
                            const float* __restrict__ den,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, FlashParams p) {
  constexpr int NU = DM / 4;
  constexpr int RS = core_row_floats(DM);
  extern __shared__ __align__(16) float core_smem[];
  const int row = blockIdx.x / p.h;
  const int h = blockIdx.x - row * p.h;
  const int hd = p.h * p.d;
  const int i = blockIdx.y * p.tile + threadIdx.x;  // the thread's query
  const bool active = i < p.t;
  const int64_t base = (int64_t)row * p.t * p.ld + h * p.d;
  const int64_t gbase = (int64_t)row * p.t * hd + h * p.d;
  const float* mrow = mask ? mask + (int64_t)row * p.t : nullptr;
  auto kbuf = [&](int b) {
    return core_smem + (size_t)b * p.stage / sizeof(float);
  };

  zero_smem(reinterpret_cast<unsigned char*>(core_smem),
            (size_t)p.nbuf * p.stage);
  auto stage = [&](int c, int b) {
    const int j0 = c * p.chunk;
    const int nj = min(p.chunk, p.t - j0);
    float* ks = kbuf(b);
    stage_rows(ks, p.rs, k + base + (int64_t)j0 * p.ld, p.ld, nj, p.d,
               p.piece);
    stage_rows(ks + p.chunk * p.rs, p.rs, v + base + (int64_t)j0 * p.ld,
               p.ld, nj, p.d, p.piece);
    if (mrow) stage_floats(ks + 2 * p.chunk * p.rs, mrow + j0, nj, 1);
  };
  stage(0, 0);

  const int64_t at = ((int64_t)row * p.t + i) * p.h + h;
  const float m_i = active ? m[at] : 0.f;
  const float den_i = active ? den[at] : 1.f;
  const float rcp_i = rcp_or_zero(den_i);
  const float delta_i = active ? delta[at] : 0.f;
  float qi[DM], gi[DM], dqi[DM];
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    const bool in = active && d < p.d;
    qi[d] = in ? q[base + (int64_t)i * p.ld + d] : 0.f;
    gi[d] = in ? g[gbase + (int64_t)i * hd + d] : 0.f;
    dqi[d] = 0.f;
  }
  auto compute = [&](int c, int b) {
    if (!active) return;
    const float* ks = kbuf(b);
    const float* vs = ks + kCoreChunk * RS;
    const float* mk = vs + kCoreChunk * RS;
    const int nj = min(kCoreChunk, p.t - c * kCoreChunk);
    for (int j = 0; j < nj; ++j) {
      const float* kj = ks + j * RS;
      const float* vj = vs + j * RS;
      float4 kv[NU];  // key j's k, read once
      float sx = 0.f, da = 0.f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        kv[u] = ld4(kj + 4 * u);
        const float4 vv = ld4(vj + 4 * u);
        sx = fmaf(qi[4 * u], kv[u].x, sx);
        sx = fmaf(qi[4 * u + 1], kv[u].y, sx);
        sx = fmaf(qi[4 * u + 2], kv[u].z, sx);
        sx = fmaf(qi[4 * u + 3], kv[u].w, sx);
        da = fmaf(gi[4 * u], vv.x, da);
        da = fmaf(gi[4 * u + 1], vv.y, da);
        da = fmaf(gi[4 * u + 2], vv.z, da);
        da = fmaf(gi[4 * u + 3], vv.w, da);
      }
      const float e =
          expf(__fmul_rn(sx, p.inv) - m_i) * (mrow ? mk[j] : 1.f);
      const float ds = (da - delta_i) * div_by(e, den_i, rcp_i) * p.inv;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        dqi[4 * u] = fmaf(ds, kv[u].x, dqi[4 * u]);
        dqi[4 * u + 1] = fmaf(ds, kv[u].y, dqi[4 * u + 1]);
        dqi[4 * u + 2] = fmaf(ds, kv[u].z, dqi[4 * u + 2]);
        dqi[4 * u + 3] = fmaf(ds, kv[u].w, dqi[4 * u + 3]);
      }
    }
  };
  walk_tasks((p.t + p.chunk - 1) / p.chunk, p.nbuf, stage, compute);
  if (!active) return;
#pragma unroll
  for (int d = 0; d < DM; ++d)
    if (d < p.d) dq[gbase + (int64_t)i * hd + d] = dqi[d];
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
    const void* ptrs[4] = {q, k, v, g};
    const int piece = flash_piece(d_head, esize, ld, n_heads * d_head, ptrs,
                                  4);
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // bf16 heads of up to 64 (every head the wrapper takes) are all on
      // tensor cores
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
      // f32 on CUDA cores at DM = core_dm(D), an own row a thread
      const int rs = core_row_floats(DM);
      const FlashParams kp{n_heads, t_len, d_head, ld, t_len, key_tile,
                           key_chunk, key_nbuf, rs, piece, (int)kl.own,
                           (int)kl.stage, inv};
      const FlashParams qp{n_heads, t_len, d_head, ld, t_len, q_tile,
                           q_chunk, q_nbuf, rs, piece, (int)ql.own,
                           (int)ql.stage, inv};
      const int err = go(flash_bwd_key_core_kernel<DM>, key_grid,
                         kCoreBwdThreads, key_smem, tq, tk, tv, fmask, tg,
                         fm, fden, fdelta, tdk, tdv, kp);
      if (err != (int)cudaSuccess) return err;
      return go(flash_bwd_query_core_kernel<DM>, q_grid, kCoreBwdThreads,
                q_smem, tq, tk, tv, fmask, tg, fm, fden, fdelta, tdq, qp);
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
  const Launch<T> body{q, k, v, mask, g, m, den, delta, dq, dk, dv, n,
                       t_len, n_heads, d_head, ld, key_tile, key_chunk,
                       key_nbuf, q_tile, q_chunk, q_nbuf,
                       (cudaStream_t)stream};
  if constexpr (std::is_same<T, float>::value)
    return with_core_width(d_head, body);
  else
    return with_head_width(d_head, body);
}

}  // namespace

extern "C" {

// mask may be null. (key_tile, key_chunk, key_nbuf) and (q_tile, q_chunk,
// q_nbuf) are the plans of ops/blockwise.py:launch_plan for the key side
// and the query side. Returns cudaGetLastError() after the two launches: 0
// when both kernels were queued; cudaErrorInvalidValue for a plan the
// kernels do not take.
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
