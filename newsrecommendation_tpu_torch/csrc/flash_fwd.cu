// Kernel row 9: the key-blocked exp-normalised multi-head self-attention
// forward, for sequences of flash_min_seq (512) keys and more.
//
// Replaces the TPU kernel newsrecommendation_tpu/ops/pallas/blockwise.py
// :_flash_fwd_kernel (called by _fwd_call, unmasked and masked).
//
// Contract (same as the TPU kernel), per (row, head, query), over key
// blocks of block_kv keys in order, from m = -1e30, l = 0, acc = 0:
//   s     = (q . k_j) * (1/sqrt(D))               f32 dot
//   m'    = max(m, max_{j in block} s_j)           masked keys included
//   scale = exp(m - m')
//   e_j   = exp(s_j - m') * mask_j                 mask after the exp
//   l     = l * scale + sum_j e_j
//   acc   = acc * scale + sum_j round(e_j) v_j      e rounded to v's dtype
//   m     = m'
// then den = l + 1e-8 * exp(-m), o = acc / den (0 where den is not > 0:
// a fully masked row whose max underflowed exp(-m)), and m, den are
// written for the backward. The rounding point differs from rows 1-2 (they
// round the normalised a): the un-normalised e against the running max is
// what meets v here, so a bf16 result depends on block_kv, which is why
// the caller passes JAX's key block.
//
// Bound: at N=128, T=512, H=20, D=20 in bf16 it reads q, k, v and writes
// o (4 * 52 MB) and m, den (10.5 MB): about 0.066 ms at 3.35 TB/s, while
// the 4*N*H*T*T*D = 53.7 GFLOP take 0.054 ms on bf16 tensor cores. In f32
// the same 53.7 GFLOP take 0.80 ms at 67 TFLOP/s on CUDA cores (the bytes
// 0.13 ms): operations bound it.
//
// Design. Two regimes (flash.cuh; the plan is ops/blockwise.py:
// launch_plan):
//   bf16, D <= 64: tensor cores (mma.sync.m16n8k16, bf16 in, f32 sums). A
//     block takes one (row, head) and a tile of 64 or 128 queries, a warp
//     16 of them, their A fragments loaded once. K and V are staged in
//     chunks of up to 256 keys by cp.async, in one or two buffers, each
//     chunk inside one key block (flash_task): per key block a max walk
//     (QK^T, then the quad shuffles of the C layout) and an exp walk (QK^T
//     again, e, l, and round(e) repacked from the C fragments into the A
//     fragment of e@V, V by ldmatrix.trans), the block's e@v summed apart
//     and folded into the accumulator with the block's scale, as the
//     contract has it. So e rounds against the key block's max, never a
//     partial one, whatever the chunk. Each score is computed twice and
//     every product is on the tensor cores; what is left is issue-bound:
//     the expf, the mask and the sum of each e.
//   f32: CUDA cores (TF32 would change the result; f32 FMAs only). A
//     block of 256 threads takes one (row, head) and a tile of 64 queries
//     (32 past D = 24); thread (qg, kg) -- qg = warp * 2 + lane / 16, kg =
//     lane % 16 -- holds QT = 4 of them (2 past D = 24), qg * QT on. K, V
//     (and the mask) are staged in chunks of 256 keys by 16-byte cp.async
//     as f32 rows (flash.cuh core_row_floats, a compile-time stride), two
//     buffers, on the same walk over key blocks as the tensor cores; of
//     each chunk the thread takes keys kg, kg + 16, ..., kg + 240. Q is
//     staged once. The scores of its QT queries over its 16 keys stay in
//     registers between the max walk and the exp walk, so a key block that
//     fits a chunk (every block but one of more than 256 keys, which is
//     walked twice) has QK^T computed once. s = q . k sums d in order from
//     0, as the plain version's dot, one float4 of q and of k a load, 16
//     FMAs each; the block max is the 16 key lanes' (shuffles); e@V reads
//     V as float4s, 16 FMAs each, into the thread's share of o, rescaled
//     where the running max grows and at the end summed over the 16 key
//     lanes in one fixed tree (flash.cuh reduce_scatter16), as are the
//     shares of l. So m equals the plain version's to the bit; o and den
//     move within the f32 tolerance. Per score: 2 D FMAs, an expf, a max
//     and a sum, and 2 D / 16 loads. Registers bound it (the scores and o fill 255: one block an SM).
//     Split-tf32 tensor cores (three products per product) met the f32
//     tolerance but ran slower on the H100 at D = 20.

#include "flash.cuh"
#include "flash_wide.cuh"

#include <type_traits>

namespace {

using namespace nrk;

// f32 with D <= 64: one (row, head) and a tile of 16 QT queries per block;
// thread (qg, kg) holds queries qg QT .. qg QT + QT - 1 and keys kg + 16 c
// of each chunk; K, V (and the mask) staged per task of the key walk.
template <int DM>
__global__ void __launch_bounds__(16 * kCoreFwdGroups, 1)
flash_fwd_core_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ mask, float* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ den_out,
                      FlashParams p) {
  constexpr int QT = core_fwd_rows(DM);        // queries a thread
  constexpr int KT = kCoreKeys;                 // keys of a chunk a thread
  constexpr int NU = DM / 4;                    // float4s of a head row
  constexpr int RS = core_row_floats(DM);       // floats of a staged row
  constexpr int NO = (QT * DM + 15) / 16 * 16;  // o's share, whole 16ths
  extern __shared__ __align__(16) float core_smem[];
  const int lane = threadIdx.x % 32;
  const int kg = lane % 16;
  const int qg = threadIdx.x / 32 * 2 + lane / 16;
  const int row = blockIdx.x / p.h;
  const int h = blockIdx.x - row * p.h;
  const int i0 = blockIdx.y * p.tile;  // the tile's first query
  const int nq = min(p.tile, p.t - i0);
  const int64_t base = (int64_t)row * p.t * p.ld + h * p.d;
  const float* mrow = mask ? mask + (int64_t)row * p.t : nullptr;
  float* qs = core_smem;
  auto kbuf = [&](int b) {
    return core_smem + (p.own + (size_t)b * p.stage) / sizeof(float);
  };

  // the pads past D are read as zeros; rows past a chunk's keys are read
  // and then ignored
  zero_smem(reinterpret_cast<unsigned char*>(core_smem),
            p.own + (size_t)p.nbuf * p.stage);
  auto stage = [&](int idx, int b) {
    const FlashTask tk = flash_task(idx, p.block, p.chunk);
    float* ks = kbuf(b);
    stage_rows(ks, p.rs, k + base + (int64_t)tk.key0 * p.ld, p.ld, tk.nkeys,
               p.d, p.piece);
    if (tk.exp_pass) {
      stage_rows(ks + p.chunk * p.rs, p.rs,
                 v + base + (int64_t)tk.key0 * p.ld, p.ld, tk.nkeys, p.d,
                 p.piece);
      if (mrow)
        stage_floats(ks + 2 * p.chunk * p.rs, mrow + tk.key0, tk.nkeys, 1);
    }
  };
  stage_rows(qs, p.rs, q + base + (int64_t)i0 * p.ld, p.ld, nq, p.d, p.piece);
  stage(0, 0);

  const float* qrow = qs + qg * QT * RS;
  float s[QT][KT];  // the scores of the task's chunk, then its e
  float o[NO] = {}, l[QT] = {}, m_run[QT], mx[QT];
#pragma unroll
  for (int a = 0; a < QT; ++a) m_run[a] = kNegBig;

  // s = (q . k) / sqrt(D) over the chunk's nk keys; `full` a whole chunk
  auto scores = [&](const float* ks, int nk, auto full) {
#pragma unroll
    for (int a = 0; a < QT; ++a)
#pragma unroll
      for (int c = 0; c < KT; ++c) s[a][c] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float4 qv[QT];
#pragma unroll
      for (int a = 0; a < QT; ++a) qv[a] = ld4(qrow + a * RS + 4 * u);
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        if (!decltype(full)::value && 16 * c >= nk) continue;
        const float4 kv = ld4(ks + (kg + 16 * c) * RS + 4 * u);
#pragma unroll
        for (int a = 0; a < QT; ++a) {
          s[a][c] = fmaf(qv[a].x, kv.x, s[a][c]);
          s[a][c] = fmaf(qv[a].y, kv.y, s[a][c]);
          s[a][c] = fmaf(qv[a].z, kv.z, s[a][c]);
          s[a][c] = fmaf(qv[a].w, kv.w, s[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < QT; ++a)
#pragma unroll
      for (int c = 0; c < KT; ++c) s[a][c] = __fmul_rn(s[a][c], p.inv);
  };
  // e against the block's max, l and o (the thread's shares)
  auto exps = [&](const float* vs, const float* mk, int nk, auto full) {
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      if (!decltype(full)::value && 16 * c >= nk) continue;
      const int j = kg + 16 * c;
      const bool in = decltype(full)::value || j < nk;
      const float mj = mrow && in ? mk[j] : 1.f;
#pragma unroll
      for (int a = 0; a < QT; ++a) {
        const float e = in ? expf(s[a][c] - m_run[a]) * mj : 0.f;
        l[a] += e;
        s[a][c] = e;
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 vv = ld4(vs + j * RS + 4 * u);
#pragma unroll
        for (int a = 0; a < QT; ++a) {
          const int at = a * DM + 4 * u;
          o[at] = fmaf(s[a][c], vv.x, o[at]);
          o[at + 1] = fmaf(s[a][c], vv.y, o[at + 1]);
          o[at + 2] = fmaf(s[a][c], vv.z, o[at + 2]);
          o[at + 3] = fmaf(s[a][c], vv.w, o[at + 3]);
        }
      }
    }
  };
  auto compute = [&](int idx, int b) {
    const FlashTask tk = flash_task(idx, p.block, p.chunk);
    const float* ks = kbuf(b);
    const float* vs = ks + kCoreChunk * RS;
    const float* mk = vs + kCoreChunk * RS;
    const int nk = tk.nkeys;
    const bool full = nk == kCoreChunk;
    if (full)
      scores(ks, nk, std::true_type{});
    else
      scores(ks, nk, std::false_type{});
    if (tk.first) {
#pragma unroll
      for (int a = 0; a < QT; ++a) mx[a] = -INFINITY;
    }
    if (tk.max_pass) {
#pragma unroll
      for (int c = 0; c < KT; ++c)
        if (kg + 16 * c < nk) {
#pragma unroll
          for (int a = 0; a < QT; ++a) mx[a] = fmaxf(mx[a], s[a][c]);
        }
    }
    if (tk.exp_first) {  // the block's max is whole: m', and the rescale
#pragma unroll
      for (int a = 0; a < QT; ++a) {
        const float m_new = fmaxf(m_run[a], max16(mx[a]));
        const float scale = expf(m_run[a] - m_new);
        l[a] *= scale;
#pragma unroll
        for (int d = 0; d < DM; ++d) o[a * DM + d] *= scale;
        m_run[a] = m_new;
      }
    }
    if (tk.exp_pass) {
      if (full)
        exps(vs, mk, nk, std::true_type{});
      else
        exps(vs, mk, nk, std::false_type{});
    }
  };
  walk_tasks(flash_walk_tasks(p.t, p.block, p.chunk), p.nbuf, stage,
             compute);

  // the 16 key lanes' shares: l on every lane, o a 16th on each
#pragma unroll
  for (int a = 0; a < QT; ++a) l[a] = sum16(l[a]);
  reduce_scatter16(o, kg);
  float den[QT];
#pragma unroll
  for (int a = 0; a < QT; ++a) den[a] = l[a] + kEps * expf(-m_run[a]);
  const int hd = p.h * p.d;
#pragma unroll
  for (int x = 0; x < NO / 16; ++x) {
    const int idx = kg * (NO / 16) + x;  // of o[a * DM + d]
    const int a = idx / DM;
    const int d = idx - a * DM;
    const int i = qg * QT + a;
    float dn = den[0];
#pragma unroll
    for (int b = 1; b < QT; ++b)
      if (a == b) dn = den[b];
    if (a < QT && d < p.d && i < nq)
      out[((int64_t)row * p.t + i0 + i) * hd + h * p.d + d] =
          dn > 0.f ? o[x] / dn : 0.f;
  }
  if (kg == 0) {
#pragma unroll
    for (int a = 0; a < QT; ++a) {
      const int i = qg * QT + a;
      if (i < nq) {
        const int64_t at = ((int64_t)row * p.t + i0 + i) * p.h + h;
        m_out[at] = m_run[a];
        den_out[at] = den[a];
      }
    }
  }
}

// bf16 with D <= 64: one (row, head) and a tile of queries per block, a warp
// 16 queries; K, V (and the mask) staged per task of the key walk.
template <int DM, bool kMask>
__global__ void __launch_bounds__(256, 3)  // three blocks an SM
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ den_out,
                     FlashParams p) {
  using T = __nv_bfloat16;
  constexpr int KS = (DM + 15) / 16;  // k-steps of QK^T
  constexpr int ND = (DM + 7) / 8;    // d tiles of e@V
  // a name of their own: the CUDA-core kernels declare it as float
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* smem = mma_smem;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tq = lane % 4;
  const int row = blockIdx.x / p.h;
  const int h = blockIdx.x - row * p.h;
  const int i0 = blockIdx.y * p.tile;  // the tile's first query
  const int nq = min(p.tile, p.t - i0);
  const int q0 = warp * 16;  // the warp's first query in the tile
  const bool active = q0 < nq;
  const int64_t base = (int64_t)row * p.t * p.ld + h * p.d;
  const float* mrow = kMask ? mask + (int64_t)row * p.t : nullptr;
  T* qs = reinterpret_cast<T*>(smem);
  auto kbuf = [&](int b) {
    return reinterpret_cast<T*>(smem + p.own + (size_t)b * p.stage);
  };

  zero_smem(smem, p.own + (size_t)p.nbuf * p.stage);
  auto stage = [&](int idx, int b) {
    const FlashTask tk = flash_task(idx, p.block, p.chunk);
    T* ks = kbuf(b);
    stage_rows(ks, p.rs, k + base + (int64_t)tk.key0 * p.ld, p.ld, tk.nkeys,
               p.d, p.piece);
    if (tk.exp_pass) {
      stage_rows(ks + p.chunk * p.rs, p.rs,
                 v + base + (int64_t)tk.key0 * p.ld, p.ld, tk.nkeys, p.d,
                 p.piece);
      if (kMask)
        stage_floats(reinterpret_cast<float*>(ks + 2 * p.chunk * p.rs),
                     mrow + tk.key0, tk.nkeys, 1);
    }
  };
  stage_rows(qs, p.rs, q + base + (int64_t)i0 * p.ld, p.ld, nq, p.d, p.piece);
  stage(0, 0);

  unsigned qa[KS][4];
  // per row of the lane (g and g + 8): the running max and sum, the
  // block's max, its m' and scale, its sum of e
  float m_run[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  float mx[2], m_new[2], scale[2], lsum[2];
  float o[ND][4] = {}, pv[ND][4];
  auto compute = [&](int idx, int b) {
    if (!active) return;
    if (idx == 0) load_a<KS>(qa, qs, p.rs, q0, nq, lane);
    const FlashTask tk = flash_task(idx, p.block, p.chunk);
    const T* ks = kbuf(b);
    const T* vs = ks + p.chunk * p.rs;
    const float* mk = reinterpret_cast<const float*>(vs + p.chunk * p.rs);
    const int nk = tk.nkeys;
    if (tk.first) mx[0] = mx[1] = -INFINITY;
    if (tk.max_pass) {
      // rows past nk are clamped to key nk - 1, a key of this block: they
      // leave the max as it is
      for (int key0 = 0; key0 < nk; key0 += 8) {
        float c[4];
        mma_rows<KS>(c, qa, ks, p.rs, key0, nk, p.inv, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], c[e]);
      }
    }
    if (tk.exp_first) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m_run[r], mx[r]);
        scale[r] = expf(m_run[r] - m_new[r]);
        lsum[r] = 0.f;
      }
#pragma unroll
      for (int dt = 0; dt < ND; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[dt][e] = 0.f;
    }
    if (tk.exp_pass)
      for_steps(nk, [&](int key0, auto edge) {
        float c[8];
        mma_rows<KS>(c, qa, ks, p.rs, key0, nk, p.inv, lane);
        mma_rows<KS>(c + 4, qa, ks, p.rs, key0 + 8, nk, p.inv, lane);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const int kk = key0 + 8 * (e / 4) + 2 * tq;  // keys kk, kk + 1
          float x0 = expf(c[e] - m_new[e % 4 / 2]);
          float x1 = expf(c[e + 1] - m_new[e % 4 / 2]);
          if (kMask) {
            const float2 mm = *reinterpret_cast<const float2*>(mk + kk);
            x0 = x0 * mm.x;
            x1 = x1 * mm.y;
          }
          if constexpr (decltype(edge)::value) {  // clamped rows: no key
            if (kk >= nk) x0 = 0.f;
            if (kk + 1 >= nk) x1 = 0.f;
          }
          lsum[e % 4 / 2] += x0 + x1;
          c[e] = x0;
          c[e + 1] = x1;
        }
        unsigned pa[4];
        pack_a(pa, c);  // e in v's dtype, as the A fragment of e@V
        mma_acc<ND>(pv, pa, vs, p.rs, key0, nk, lane);
      });
    if (tk.last) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
        lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
        l[r] = __fadd_rn(__fmul_rn(l[r], scale[r]), lsum[r]);
        m_run[r] = m_new[r];
      }
#pragma unroll
      for (int dt = 0; dt < ND; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[dt][e] = __fadd_rn(__fmul_rn(o[dt][e], scale[e / 2]), pv[dt][e]);
    }
  };
  walk_tasks(flash_walk_tasks(p.t, p.block, p.chunk), p.nbuf, stage,
             compute);
  if (!active) return;
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    den[r] = __fadd_rn(l[r], __fmul_rn(kEps, expf(-m_run[r])));
#pragma unroll
  for (int dt = 0; dt < ND; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[dt][e] = den[e / 2] > 0.f ? o[dt][e] / den[e / 2] : 0.f;
  const int hd = p.h * p.d;
  store_tiles<ND>(out + h * p.d, (int64_t)row * p.t + i0, hd, o, q0, nq, p.d,
                  lane);
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + lane / 4 + 8 * r;
      if (i < nq) {
        const int64_t at = ((int64_t)row * p.t + i0 + i) * p.h + h;
        m_out[at] = m_run[r];
        den_out[at] = den[r];
      }
    }
  }
}

template <typename T>
struct Launch {
  const void *q, *k, *v, *mask;
  void *out, *m, *den;
  int n, t_len, n_heads, d_head, ld, block_kv, tile, chunk, nbuf;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    const int64_t rows = (int64_t)n * n_heads;
    const int tiles = (t_len + tile - 1) / tile;
    if (rows > 0x7fffffff || tiles > 65535)
      return (int)cudaErrorInvalidConfiguration;
    // 1/sqrt(D) rounded once from double, as the plain version's scalar is
    const float inv = (float)(1.0 / sqrt((double)d_head));
    const int esize = (int)sizeof(T);
    const FlashLayout lay = flash_layout(kFlashFwd, d_head, esize, tile,
                                         chunk);
    const size_t smem = lay.own + nbuf * lay.stage;
    const dim3 grid((unsigned)rows, (unsigned)tiles);
    const void* ptrs[3] = {q, k, v};
    const int piece = flash_piece(d_head, esize, ld, ld, ptrs, 3);
    auto go = [&](auto kernel, int threads, const FlashParams& p) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<grid, threads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(mask),
          static_cast<T*>(out), static_cast<float*>(m),
          static_cast<float*>(den), p);
      return (int)cudaGetLastError();
    };
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // bf16 heads of up to 64 (every head the wrapper takes) are all on
      // tensor cores
      const FlashParams p{n_heads, t_len, d_head, ld, block_kv, tile, chunk,
                          nbuf, flash_row_elems(d_head), piece,
                          (int)lay.own, (int)lay.stage, inv};
      return mask ? go(flash_fwd_mma_kernel<DM, true>, 2 * tile, p)
                  : go(flash_fwd_mma_kernel<DM, false>, 2 * tile, p);
    } else {
      // f32 on CUDA cores at DM = core_dm(D): 16 query groups of
      // core_fwd_rows(DM) queries (flash_plan_ok took the tile)
      const FlashParams p{n_heads, t_len, d_head, ld, block_kv, tile, chunk,
                          nbuf, core_row_floats(DM), piece, (int)lay.own,
                          (int)lay.stage, inv};
      return go(flash_fwd_core_kernel<DM>, 16 * kCoreFwdGroups, p);
    }
  }
};

// The wide kernel's launch at the lane width DPL (flash_wide.cuh).
template <typename T>
struct WideFwd {
  const T *q, *k, *v;
  const float* mask;
  T* out;
  float *m, *den;
  int n_heads, t_len, d_head, ld, block_kv;
  float inv;
  dim3 grid;
  cudaStream_t stream;

  template <int DPL>
  int operator()() const {
    flash_fwd_wide_kernel<T, DPL><<<grid, 32 * kFlashWideWarps, 0, stream>>>(
        q, k, v, mask, out, m, den, n_heads, t_len, d_head, ld, block_kv,
        inv);
    return (int)cudaGetLastError();
  }
};

// One launch of the plan (tile, chunk, nbuf) the wrapper chose; refuses a
// plan the regime does not take, and a key block that does not divide T.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* m, void* den, int n, int t_len, int n_heads,
           int d_head, int ld, int block_kv, int tile, int chunk, int nbuf,
           void* stream) {
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  if (block_kv <= 0 || t_len % block_kv != 0 ||
      !flash_plan_ok(kFlashFwd, d_head, (int)sizeof(T), tile, chunk, nbuf))
    return (int)cudaErrorInvalidValue;
  if (flash_wide(d_head)) {
    const int64_t rows = (int64_t)n * n_heads;
    const int tiles = (t_len + kFlashWideWarps - 1) / kFlashWideWarps;
    if (rows > 0x7fffffff || tiles > 65535)
      return (int)cudaErrorInvalidConfiguration;
    const float inv = (float)(1.0 / sqrt((double)d_head));
    return with_wide_width(
        d_head, WideFwd<T>{static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v),
                           static_cast<const float*>(mask),
                           static_cast<T*>(out), static_cast<float*>(m),
                           static_cast<float*>(den), n_heads, t_len, d_head,
                           ld, block_kv, inv,
                           dim3((unsigned)rows, (unsigned)tiles),
                           (cudaStream_t)stream});
  }
  const Launch<T> body{q, k, v, mask, out, m, den, n, t_len, n_heads,
                       d_head, ld, block_kv, tile, chunk, nbuf,
                       (cudaStream_t)stream};
  if constexpr (std::is_same<T, float>::value)
    return with_core_width(d_head, body);
  else
    return with_head_width(d_head, body);
}

}  // namespace

extern "C" {

// mask may be null. (tile, chunk, nbuf) is the plan of ops/blockwise.py:
// launch_plan. Returns cudaGetLastError() after the launch: 0 when the
// kernel was queued; cudaErrorInvalidValue for a plan the kernel does not
// take.
int flash_fwd_f32(const void* q, const void* k, const void* v,
                  const void* mask, void* out, void* m, void* den, int n,
                  int t_len, int n_heads, int d_head, int ld, int block_kv,
                  int tile, int chunk, int nbuf, void* stream) {
  return launch<float>(q, k, v, mask, out, m, den, n, t_len, n_heads, d_head,
                       ld, block_kv, tile, chunk, nbuf, stream);
}

int flash_fwd_bf16(const void* q, const void* k, const void* v,
                   const void* mask, void* out, void* m, void* den, int n,
                   int t_len, int n_heads, int d_head, int ld, int block_kv,
                   int tile, int chunk, int nbuf, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, mask, out, m, den, n, t_len, n_heads,
                               d_head, ld, block_kv, tile, chunk, nbuf,
                               stream);
}

// Shared bytes of one block of `kind` (0 the forward, 1 the backward's key
// side, 2 its query side) under the plan (tile, chunk, nbuf), or -1 for a
// plan the kernels do not take: what launch_plan computes in Python, for a
// test to hold the two equal.
int flash_smem_bytes(int kind, int d_head, int esize, int tile, int chunk,
                     int nbuf) {
  if (!flash_plan_ok(kind, d_head, esize, tile, chunk, nbuf)) return -1;
  const FlashLayout lay = flash_layout(kind, d_head, esize, tile, chunk);
  return (int)(lay.own + nbuf * lay.stage);
}

// Tasks of the forward's walk over key blocks of `block` keys in chunks of
// `chunk` (flash_task), for a test to hold it to launch_plan's.
int flash_walk_task_count(int t_len, int block, int chunk) {
  return flash_walk_tasks(t_len, block, chunk);
}

}  // extern "C"
