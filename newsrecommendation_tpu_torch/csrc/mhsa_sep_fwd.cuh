// Kernel rows 5 and 7 (the forward of exp-MHSA on separate q, k, v,
// unmasked and key-masked) past T = 64, in the two regimes that carry them
// there on an H100; the contract, and the row-wise kernel that keeps
// T <= 64 and heads wider than 64, are in mhsa_sep.cu.
//
//   tensor cores (T > 64, bf16, both widths up to 64): row 9's forward
//     design (flash_fwd.cu) with rows 6 and 8's staging of three pointers
//     and two widths (mhsa_sep_bwd.cuh). A block takes one (row, head) and
//     a tile of 64 or 128 queries, a warp 16 of them, their A fragments
//     loaded once; K and the mask (and V in the second walk) are staged
//     in chunks by cp.async, in one or two buffers, every head
//     padded with zeros to the larger of d_k and d_v. Walks over all keys:
//     (m, den) first, then a = e * (1/den) (flash.cuh div_by: IEEE e / den)
//     rounded to bf16 straight into the A fragment of a@V, summed on
//     mma.sync over the chunk's V. No rescale of the output, no atomics,
//     no global scratch.
//   tiled (T > 64, f32, both widths up to 64): CUDA cores (TF32 would
//     change the result), row 9's f32 design: a thread owns one query of
//     one (row, head), holding q_i and the output row in registers at
//     compile-time widths (flash.cuh with_head_width, d_k and d_v apart);
//     the block stages kTiledChunk keys of K (and V, and the mask) as f32
//     in shared memory, read as broadcasts.
//
// The (m, den) walk is online: each lane keeps its own running (m, l) per
// row (two per row on tensor cores, one per n tile): per score the larger
// of m and s becomes m, x = exp(smaller - larger), and l becomes l * x +
// mask (s above m) or l + x * mask; one exp per score. The lanes' pairs of
// a row are then folded at the row's max. So m is the max over ALL keys
// (masked keys included) and den = sum e + 1e-8 exp(-m), an f32 sum in a
// fixed order. (A max walk then an exp walk, two queries a thread and
// other tiled chunks were slower on an H100: PERF.md, PR 14.)
//
// Rows 1-2 (qkv_fwd.cuh) launch the same two kernels past T = 64 on the
// views of a fused [q|k|v] (qkv_launch), with two flags: kProbs, row 2's
// f32 a, staged in shared memory kProbsKeys keys at a time and written a
// row a store; kBias on the tiled kernel, the projection's bias added as
// rows load (on tensor cores a pass of its own adds it first).
#pragma once

#include "mhsa_sep_bwd.cuh"  // sep::, flash.cuh, mma.cuh, quad_sum/max

namespace nrk {
namespace sepf {

enum Regime { kRowwise = 0, kMma = 1, kTiled = 2 };

constexpr int kTiledThreads = 128;  // the tiled block: one query a thread
constexpr int kTiledChunk = 128;    // keys the tiled block stages at once

// The forward's regime at (T, d_k, d_v) in a dtype of esize bytes.
__host__ __device__ inline int regime(int t_len, int dk, int dv, int esize) {
  const int dmax = dk > dv ? dk : dv;
  if (dmax > sep::kMaxHead || t_len <= sep::kShortT) return kRowwise;
  return esize == 2 ? kMma : kTiled;
}

// Row 2's probs leave a kernel through shared memory, kProbsKeys keys of
// a row at a time, so that a warp's store writes one row's 128 contiguous
// bytes: each tiled warp stages its 32 queries' a in rows of kProbsRow
// floats (odd: the threads writing one key hit 32 banks), each tensor-core
// warp
// its 16 queries' in rows of kMmaProbsRow (8-byte pairs from the C
// fragments hit 32 banks per half-warp).
constexpr int kProbsKeys = 32;
constexpr int kProbsRow = kProbsKeys + 1;
constexpr int kMmaProbsRow = kProbsKeys + 8;

// The compile-time widths of rows 1-2's tiled kernel: flash.cuh's, and 20
// (the NRMS head), whose K and V rows would otherwise be padded to 24.
inline int qkv_tiled_width(int d) {
  return d > 16 && d <= 20 ? 20 : flash_dm(d);
}

// Shared bytes of a tiled block: kTiledChunk keys of K and V (at widths wk
// and wv) and of the mask, as f32; with probs (row 2) also the staged a,
// kTiledThreads rows of kProbsRow.
inline size_t tiled_smem_at(int wk, int wv, bool probs) {
  return sizeof(float) * ((size_t)kTiledChunk * (wk + wv + 1) +
                          (probs ? (size_t)kTiledThreads * kProbsRow : 0));
}

// Rows 5 and 7's tiled block: widths flash_dm(d_k) and flash_dm(d_v).
inline size_t tiled_smem(int dk, int dv) {
  return tiled_smem_at(flash_dm(dk), flash_dm(dv), false);
}

// Bytes of the tensor-core kernel's probs tiles: one per warp of 16
// queries, 16 rows of kMmaProbsRow floats.
inline size_t mma_probs_smem(int tile) {
  return sizeof(float) * (size_t)tile * kMmaProbsRow;
}

// Whether a plan (tile, chunk, nbuf) is one the regime's kernel takes:
// tensor cores, flash.cuh's forward layout at the larger width; tiled,
// kTiledThreads queries and kTiledChunk keys, one buffer.
inline bool plan_ok(int reg, int dk, int dv, int tile, int chunk, int nbuf) {
  const int dmax = dk > dv ? dk : dv;
  if (reg == kMma) return flash_plan_ok(kFlashFwd, dmax, 2, tile, chunk, nbuf);
  return reg == kTiled && tile == kTiledThreads && chunk == kTiledChunk &&
         nbuf == 1 && tiled_smem(dk, dv) <= (size_t)sep::kMaxSmem;
}

struct Params {
  int h, t, dk, dv;     // heads, positions, widths of q/k and of v
  int ldq, ldk, ldv;    // row strides of q, k, v (elements)
  int tile, chunk;      // queries of a block; keys of one stage
  int nbuf;             // stage buffers
  int rs;               // staged row stride (elements, tensor cores)
  int pk, pv;           // bytes of one async copy of q/k rows, of v rows
  int own, stage;       // bytes of the block's own rows, of one buffer
  float inv;            // 1 / sqrt(d_k), as the row-wise kernel scales s
};

// One score into a lane's running (m, l) of the online walk: one exp.
__device__ __forceinline__ void online(float& m, float& l, float s,
                                       float mk) {
  const float hi = fmaxf(m, s);
  const float x = expf(fminf(m, s) - hi);
  l = s > m ? fmaf(l, x, mk) : fmaf(x, mk, l);
  m = hi;
}

// den as div_by takes it. A row whose max is below about -88.7 overflows
// 1e-8 exp(-m) to inf, where a = e / inf = 0, as the row-wise kernel and
// the plain version give; div_by(e, inf, 0) would be NaN (fmaf(-inf, 0,
// e)), so such a row takes den = 0, whose rcp_or_zero is 0 and whose a is
// div_by(e, 0, 0) = 0.
__device__ __forceinline__ float finite_den(float den) {
  return isinf(den) ? 0.f : den;
}

// ---- tensor cores (T > 64, bf16) -------------------------------------------

// A warp's 16 x 16 f32 a of one step (element e at query row lane / 4 +
// 8 (e % 4 / 2), key 8 (e / 4) + 2 tq + e % 2 of the step) into its probs
// tile at key column col0, pairs of neighbouring keys 8 bytes at once.
__device__ __forceinline__ void tile_probs(float* tile, const float* s,
                                           int col0, int lane) {
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const int row = lane / 4 + 8 * (e % 4 / 2);
    const int col = col0 + 8 * (e / 4) + 2 * (lane % 4);
    *reinterpret_cast<float2*>(tile + row * kMmaProbsRow + col) =
        make_float2(s[e], s[e + 1]);
  }
}

// Keys [0, nk) of staged probs rows [0, rows) (rows tld floats apart in
// the tile) to probs rows `ld` floats apart from dst: one row a store, the
// lanes over its keys; this warp takes rows r0, r0 + rstep, ...
__device__ __forceinline__ void flush_probs(float* dst, int64_t ld,
                                            const float* tile, int tld,
                                            int rows, int nk, int r0,
                                            int rstep, int lane) {
  if (lane >= nk) return;
  for (int r = r0; r < rows; r += rstep)
    dst[r * ld + lane] = tile[r * tld + lane];
}

// kProbs (rows 2 and 11): the second walk also writes each a in f32,
// before it is rounded, to probs[row, i, h*T + j], through a tile of the
// warp's rows after the stage buffers (flushed every kProbsKeys keys).
template <int DM, bool kMask, bool kProbs>
__global__ void __launch_bounds__(256, 3)
sep_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ mask,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ probs, Params p) {
  using T = __nv_bfloat16;
  constexpr int KS = (DM + 15) / 16;  // k-steps of QK^T
  constexpr int ND = (DM + 7) / 8;    // d tiles of a@V
  extern __shared__ __align__(16) unsigned char sep_fwd_smem[];
  unsigned char* smem = sep_fwd_smem;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tq = lane % 4;
  const int row = blockIdx.x / p.h;
  const int h = blockIdx.x - row * p.h;
  const int i0 = blockIdx.y * p.tile;  // the tile's first query
  const int nq = min(p.tile, p.t - i0);
  const int q0 = warp * 16;  // the warp's first query in the tile
  const bool active = q0 < nq;
  const int64_t first = (int64_t)row * p.t;  // the row's position 0
  const T* qh = q + first * p.ldq + h * p.dk;
  const T* kh = k + first * p.ldk + h * p.dk;
  const T* vh = v + first * p.ldv + h * p.dv;
  const float* mrow = kMask ? mask + first : nullptr;
  const int nc = (p.t + p.chunk - 1) / p.chunk;
  T* qs = reinterpret_cast<T*>(smem);
  auto kbuf = [&](int b) {
    return reinterpret_cast<T*>(smem + p.own + (size_t)b * p.stage);
  };
  float* ptile = reinterpret_cast<float*>(kbuf(p.nbuf)) +
                 warp * 16 * kMmaProbsRow;  // kProbs: the warp's probs tile

  zero_smem(smem, p.own + (size_t)p.nbuf * p.stage);
  // tasks [0, nc) the (m, den) walk over K (and the mask), [nc, 2 nc) the
  // a@V walk over K, V (and the mask)
  auto stage = [&](int task, int b) {
    const int j0 = task % nc * p.chunk;
    const int nj = min(p.chunk, p.t - j0);
    T* ks = kbuf(b);
    stage_rows(ks, p.rs, kh + (int64_t)j0 * p.ldk, p.ldk, nj, p.dk, p.pk);
    if (task >= nc)
      stage_rows(ks + p.chunk * p.rs, p.rs, vh + (int64_t)j0 * p.ldv, p.ldv,
                 nj, p.dv, p.pv);
    if (kMask)
      stage_floats(reinterpret_cast<float*>(ks + 2 * p.chunk * p.rs),
                   mrow + j0, nj, 1);
  };
  stage_rows(qs, p.rs, qh + (int64_t)i0 * p.ldq, p.ldq, nq, p.dk, p.pk);
  stage(0, 0);

  unsigned qa[KS][4];
  // the lane's rows are queries q0 + lane / 4 and q0 + lane / 4 + 8: per
  // row its m, den and 1/den, and the online walk's running (m, l) per
  // row and n tile
  float mi[2] = {0.f, 0.f}, deni[2] = {0.f, 0.f}, rcpi[2] = {0.f, 0.f};
  float om[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float ol[4] = {0.f, 0.f, 0.f, 0.f};
  float o[ND][4] = {};

  auto compute = [&](int task, int b) {
    if (!active) return;
    const bool av = task >= nc;  // the a@V walk
    const int c = task % nc;
    const int nj = min(p.chunk, p.t - c * p.chunk);
    const T* ks = kbuf(b);
    const T* vs = ks + p.chunk * p.rs;
    const float* mk = reinterpret_cast<const float*>(vs + p.chunk * p.rs);
    if (task == 0) load_a<KS>(qa, qs, p.rs, q0, nq, lane);
    if (task == nc) {  // m and den are complete: fold the lane's pairs
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mi[r] = quad_max(fmaxf(om[r], om[r + 2]));
        const float l =
            ol[r] * expf(om[r] - mi[r]) + ol[r + 2] * expf(om[r + 2] - mi[r]);
        deni[r] = finite_den(quad_sum(l) + kEps * expf(-mi[r]));
        rcpi[r] = rcp_or_zero(deni[r]);
      }
    }
    for_steps(nj, [&](int j, auto edge) {
      // element e: query row (e % 4) / 2, key j + 8 (e / 4) + 2 tq + e % 2
      float s[8];
      mma_rows<KS>(s, qa, ks, p.rs, j, nj, p.inv, lane);
      mma_rows<KS>(s + 4, qa, ks, p.rs, j + 8, nj, p.inv, lane);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = e % 4 / 2;
        const int kj = j + 8 * (e / 4) + 2 * tq + e % 2;  // in the chunk
        bool in = true;
        if constexpr (decltype(edge)::value) in = kj < nj;
        const float mk_j = kMask ? mk[min(kj, nj - 1)] : 1.f;
        if (!av) {
          if (in) online(om[r + 2 * (e / 4)], ol[r + 2 * (e / 4)], s[e], mk_j);
          continue;
        }
        const float x = expf(s[e] - mi[r]) * mk_j;
        s[e] = in ? div_by(x, deni[r], rcpi[r]) : 0.f;
      }
      if (av) {
        if constexpr (kProbs) {
          tile_probs(ptile, s, j % kProbsKeys, lane);
          if (j % kProbsKeys == kProbsKeys - 16 || j + 16 >= nj) {
            __syncwarp();
            const int kb = j - j % kProbsKeys;  // the tile's first key
            flush_probs(probs + ((first + i0 + q0) * p.h + h) * (int64_t)p.t +
                            c * p.chunk + kb,
                        (int64_t)p.h * p.t, ptile, kMmaProbsRow,
                        min(16, nq - q0), min(j + 16, nj) - kb, 0, 1, lane);
            __syncwarp();  // the next step overwrites the tile
          }
        }
        unsigned pa[4];
        pack_a(pa, s);  // a in v's dtype, as the A fragment of a@V
        mma_acc<ND>(o, pa, vs, p.rs, j, nj, lane);
      }
    });
  };
  walk_tasks(2 * nc, p.nbuf, stage, compute);
  if (!active) return;
  store_tiles<ND>(out + h * p.dv, first + i0, p.h * p.dv, o, q0, nq, p.dv,
                  lane);
}

// ---- CUDA cores (T > 64, f32) -----------------------------------------------

// Rows [t0, t1) of head h of x as load_rows (flash.cuh) stages them, with
// b[d] added to lane d (the bias of a fused projection, f32).
template <int DM>
__device__ __forceinline__ void load_biased_rows(float* dst,
                                                 const float* __restrict__ x,
                                                 int64_t base, int ld, int t0,
                                                 int t1, int d_head,
                                                 const float* b) {
  const int n = (t1 - t0) * DM;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / DM;
    const int d = idx - j * DM;
    dst[idx] = d < d_head ? x[base + (int64_t)(t0 + j) * ld + d] + b[d] : 0.f;
  }
}

// d_k and d_v held at DK and DV lanes (zero pads). kBias (rows 1-2): bias
// (3*H*d_k,) of the fused projection, whose q, k and v lanes of head h lie
// at h*d_k, H*d_k + h*d_k, 2*H*d_k + h*d_v, added to q, k and v as they
// are loaded. kProbs (row 2): the second walk writes each a, f32, to
// probs[row, i, h*T + j]; each warp stages its 32 queries' a of
// kProbsKeys keys and writes them by rows, with no block barrier.
template <int DK, int DV, bool kBias, bool kProbs>
__global__ void __launch_bounds__(kTiledThreads)
sep_fwd_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask, float* __restrict__ out,
                     float* __restrict__ probs, Params p) {
  extern __shared__ __align__(16) float sep_tiled_smem[];
  float* ks = sep_tiled_smem;         // (kTiledChunk, DK)
  float* vs = ks + kTiledChunk * DK;  // (kTiledChunk, DV)
  float* mk = vs + kTiledChunk * DV;  // (kTiledChunk)
  float* pt = mk + kTiledChunk;       // kProbs: (kTiledThreads, kProbsRow)
  const int row = blockIdx.x / p.h;
  const int h = blockIdx.x - row * p.h;
  const int64_t first = (int64_t)row * p.t;
  const int64_t kbase = first * p.ldk + h * p.dk;
  const int64_t vbase = first * p.ldv + h * p.dv;
  const float* mrow = mask ? mask + first : nullptr;
  const int i0 = blockIdx.y * kTiledThreads;  // the block's first query
  const int qi = i0 + threadIdx.x;
  const bool act = qi < p.t;
  const float* bq = kBias ? bias + h * p.dk : nullptr;
  const float* bk = kBias ? bq + p.h * p.dk : nullptr;
  const float* bv = kBias ? bias + 2 * p.h * p.dk + h * p.dv : nullptr;
  float qv[DK], o[DV];
  const float* qr = q + (first + (act ? qi : 0)) * p.ldq + h * p.dk;
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    if constexpr (kBias) qv[d] = act && d < p.dk ? qr[d] + bq[d] : 0.f;
    else qv[d] = act && d < p.dk ? qr[d] : 0.f;
  }
#pragma unroll
  for (int d = 0; d < DV; ++d) o[d] = 0.f;
  // the walks' max (m), the running sum (l), den and 1/den
  float m = -INFINITY, l = 0.f, den = 0.f, rcp = 0.f;
  for (int pass = 0; pass < 2; ++pass) {  // (m, den), then a@V
    if (pass == 1) {
      den = finite_den(l + kEps * expf(-m));
      rcp = rcp_or_zero(den);
    }
    for (int j0 = 0; j0 < p.t; j0 += kTiledChunk) {
      const int nj = min(kTiledChunk, p.t - j0);
      __syncthreads();  // the previous chunk is no longer read
      if constexpr (kBias) {
        load_biased_rows<DK>(ks, k, kbase, p.ldk, j0, j0 + nj, p.dk, bk);
        if (pass == 1)
          load_biased_rows<DV>(vs, v, vbase, p.ldv, j0, j0 + nj, p.dv, bv);
      } else {
        load_rows<float, DK>(ks, k, kbase, p.ldk, j0, j0 + nj, p.dk);
        if (pass == 1) load_rows<float, DV>(vs, v, vbase, p.ldv, j0, j0 + nj,
                                            p.dv);
      }
      for (int j = threadIdx.x; j < nj; j += blockDim.x)
        mk[j] = mrow ? mrow[j0 + j] : 1.f;
      __syncthreads();
      for (int j = 0; j < nj; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(ks + j * DK);
        float s = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DK / 4; ++d4) {
          const float4 kk = kr[d4];
          s = fmaf(qv[4 * d4], kk.x, s);
          s = fmaf(qv[4 * d4 + 1], kk.y, s);
          s = fmaf(qv[4 * d4 + 2], kk.z, s);
          s = fmaf(qv[4 * d4 + 3], kk.w, s);
        }
        s = __fmul_rn(s, p.inv);
        if (pass == 0) {
          online(m, l, s, mk[j]);
          continue;
        }
        const float a = div_by(expf(s - m) * mk[j], den, rcp);
        if constexpr (kProbs) {
          pt[threadIdx.x * kProbsRow + j % kProbsKeys] = a;
          if (j % kProbsKeys == kProbsKeys - 1 || j == nj - 1) {
            __syncwarp();  // the warp's rows of these keys are staged
            const int kb = j - j % kProbsKeys;
            const int w0 = threadIdx.x / 32 * 32;  // the warp's first row
            flush_probs(probs + ((first + i0 + w0) * p.h + h) * (int64_t)p.t +
                            j0 + kb,
                        (int64_t)p.h * p.t, pt + w0 * kProbsRow, kProbsRow,
                        min(32, p.t - i0 - w0), j - kb + 1, 0, 1,
                        threadIdx.x % 32);
            __syncwarp();  // the next keys overwrite the warp's rows
          }
        }
        const float4* vr = reinterpret_cast<const float4*>(vs + j * DV);
#pragma unroll
        for (int d4 = 0; d4 < DV / 4; ++d4) {
          const float4 vv = vr[d4];
          o[4 * d4] = fmaf(a, vv.x, o[4 * d4]);
          o[4 * d4 + 1] = fmaf(a, vv.y, o[4 * d4 + 1]);
          o[4 * d4 + 2] = fmaf(a, vv.z, o[4 * d4 + 2]);
          o[4 * d4 + 3] = fmaf(a, vv.w, o[4 * d4 + 3]);
        }
      }
    }
  }
  if (!act) return;
  float* dst = out + (first + qi) * (p.h * p.dv) + h * p.dv;
#pragma unroll
  for (int d = 0; d < DV; ++d)
    if (d < p.dv) dst[d] = o[d];
}

// ---- launches --------------------------------------------------------------

template <typename K, typename... A>
int go(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
       A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// kProbs: row 2's instance (probs written), else rows 1, 5 and 7's.
template <bool kProbs>
struct MmaLaunch {
  const __nv_bfloat16 *q, *k, *v;
  const float* mask;
  __nv_bfloat16* out;
  float* probs;
  Params p;
  dim3 grid;
  size_t smem;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    return mask ? go(sep_fwd_mma_kernel<DM, true, kProbs>, grid, 2 * p.tile,
                     smem, stream, q, k, v, mask, out, probs, p)
                : go(sep_fwd_mma_kernel<DM, false, kProbs>, grid, 2 * p.tile,
                     smem, stream, q, k, v, mask, out, probs, p);
  }
};

template <int DK>
struct TiledByDv;

struct TiledLaunch {
  const float *q, *k, *v, *mask;
  float* out;
  Params p;
  dim3 grid;
  size_t smem;
  cudaStream_t stream;

  template <int DK, int DV>
  int run() const {
    return go(sep_fwd_tiled_kernel<DK, DV, false, false>, grid, kTiledThreads,
              smem, stream, q, k, v, static_cast<const float*>(nullptr), mask,
              out, static_cast<float*>(nullptr), p);
  }

  // the key width, then the value width (TiledByDv)
  template <int DK>
  int operator()() const {
    return with_head_width(p.dv, TiledByDv<DK>{*this});
  }
};

template <int DK>
struct TiledByDv {
  const TiledLaunch& s;

  template <int DV>
  int operator()() const {
    return s.template run<DK, DV>();
  }
};

// Rows 1-2's tiled launch: one width (qkv_tiled_width), the bias added as
// rows are loaded.
template <bool kProbs>
struct TiledQkv {
  const float *qkv, *bias, *mask;
  float* out;
  float* probs;
  Params p;
  dim3 grid;
  size_t smem;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    const int hd = p.h * p.dk;
    return go(sep_fwd_tiled_kernel<DM, DM, true, kProbs>, grid,
              kTiledThreads, smem, stream, qkv, qkv + hd, qkv + 2 * hd, bias,
              mask, out, probs, p);
  }
};

// Calls body.template operator()<DM>() with DM = qkv_tiled_width(d_head);
// cudaErrorInvalidValue for d_head > 64.
template <typename Body>
int with_qkv_width(int d_head, Body body) {
  if (d_head > 16 && d_head <= 20) return body.template operator()<20>();
  return with_head_width(d_head, body);
}

// The Params of a launch past T = 64 in regime `reg` under the plan
// (tile, chunk, nbuf); q, k, v the base addresses the tensor-core
// kernel's copies read.
inline Params params_of(int reg, int t_len, int n_heads, int dk, int dv,
                        int ldq, int ldk, int ldv, int tile, int chunk,
                        int nbuf, const void* q, const void* k,
                        const void* v) {
  Params p{n_heads, t_len, dk, dv, ldq, ldk, ldv, tile, chunk, nbuf,
           0, 0, 0, 0, 0, 1.0f / sqrtf((float)dk)};
  if (reg == kMma) {
    const int dmax = dk > dv ? dk : dv;
    const FlashLayout l = flash_layout(kFlashFwd, dmax, 2, tile, chunk);
    const void* qk[2] = {q, k};
    p.rs = flash_row_elems(dmax);
    p.pk = flash_piece(dk, 2, ldq, ldk, qk, 2);
    p.pv = flash_piece(dv, 2, ldv, ldv, &v, 1);
    p.own = (int)l.own;
    p.stage = (int)l.stage;
  }
  return p;
}

// The grid of a launch past T = 64: a block per (row, head) and tile of
// queries; false past what a grid takes.
inline bool grid_of(int n, int t_len, int n_heads, int tile, dim3* grid) {
  const int64_t rows = (int64_t)n * n_heads;
  const int tiles = (t_len + tile - 1) / tile;
  if (rows > 0x7fffffff || tiles > 65535) return false;
  *grid = dim3((unsigned)rows, (unsigned)tiles);
  return true;
}

// One launch of rows 5 and 7 past T = 64 in regime `reg` (kMma or kTiled)
// under the plan (tile, chunk, nbuf); refuses a plan the regime's kernel
// does not take.
template <typename T>
int launch(int reg, const void* q, const void* k, const void* v,
           const void* mask, void* out, int n, int t_len, int n_heads,
           int dk, int dv, int ldq, int ldk, int ldv, int tile, int chunk,
           int nbuf, void* stream) {
  const int esize = (int)sizeof(T);
  if (regime(t_len, dk, dv, esize) != reg ||
      !plan_ok(reg, dk, dv, tile, chunk, nbuf))
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  if (!grid_of(n, t_len, n_heads, tile, &grid))
    return (int)cudaErrorInvalidConfiguration;
  const Params p = params_of(reg, t_len, n_heads, dk, dv, ldq, ldk, ldv,
                             tile, chunk, nbuf, q, k, v);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using B = __nv_bfloat16;
    const int dmax = dk > dv ? dk : dv;
    return with_head_width(
        dmax, MmaLaunch<false>{static_cast<const B*>(q),
                               static_cast<const B*>(k),
                               static_cast<const B*>(v),
                               static_cast<const float*>(mask),
                               static_cast<B*>(out), nullptr, p, grid,
                               (size_t)p.own + nbuf * (size_t)p.stage,
                               (cudaStream_t)stream});
  } else {
    return with_head_width(
        dk, TiledLaunch{static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<const float*>(mask),
                        static_cast<float*>(out), p, grid,
                        tiled_smem(dk, dv), (cudaStream_t)stream});
  }
}

// One launch of rows 1-2 past T = 64 (qkv_fwd.cuh) in regime `reg`, heads
// of d lanes: qkv (N, T, 3*H*D) and its bias (3*H*D,); probs (row 2) or
// null. In bf16 (kMma) the bias is added at the input dtype by a pass of
// its own into `biased` (N, T, 3*H*D), which the kernel then reads, as
// rows 3-4's tensor-core regime does (qkv_bias_kernel); in f32 (kTiled)
// the kernel adds it as it loads each row. Refuses a plan the regime's
// kernel does not take.
template <typename T>
int qkv_launch(int reg, const void* qkv, const void* bias, const void* mask,
               void* out, void* probs, void* biased, int n, int t_len,
               int n_heads, int d, int tile, int chunk, int nbuf,
               void* stream) {
  const int esize = (int)sizeof(T);
  const bool with_probs = probs != nullptr;
  if (regime(t_len, d, d, esize) != reg || reg == kRowwise ||
      !plan_ok(reg, d, d, tile, chunk, nbuf))
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  if (!grid_of(n, t_len, n_heads, tile, &grid))
    return (int)cudaErrorInvalidConfiguration;
  const int hd = n_heads * d;
  auto* cs = (cudaStream_t)stream;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using B = __nv_bfloat16;
    if (biased == nullptr) return (int)cudaErrorInvalidValue;
    const int64_t total = (int64_t)n * t_len * 3 * hd;
    const int64_t want = (total + 255) / 256;
    auto* x = static_cast<B*>(biased);
    qkv_bias_kernel<<<(unsigned)(want < 4096 ? want : 4096), 256, 0, cs>>>(
        static_cast<const B*>(qkv), static_cast<const B*>(bias), x, total,
        3 * hd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const Params p = params_of(reg, t_len, n_heads, d, d, 3 * hd, 3 * hd,
                               3 * hd, tile, chunk, nbuf, x, x + hd,
                               x + 2 * hd);
    const size_t smem = (size_t)p.own + nbuf * (size_t)p.stage +
                        (with_probs ? mma_probs_smem(tile) : 0);
    if (smem > (size_t)sep::kMaxSmem) return (int)cudaErrorInvalidValue;
    const auto* m = static_cast<const float*>(mask);
    auto* o = static_cast<B*>(out);
    auto* pr = static_cast<float*>(probs);
    return with_probs
               ? with_head_width(d, MmaLaunch<true>{x, x + hd, x + 2 * hd, m,
                                                    o, pr, p, grid, smem, cs})
               : with_head_width(d, MmaLaunch<false>{x, x + hd, x + 2 * hd,
                                                     m, o, pr, p, grid, smem,
                                                     cs});
  } else {
    const Params p = params_of(reg, t_len, n_heads, d, d, 3 * hd, 3 * hd,
                               3 * hd, tile, chunk, nbuf, qkv, qkv, qkv);
    const auto* x = static_cast<const float*>(qkv);
    const auto* b = static_cast<const float*>(bias);
    const auto* m = static_cast<const float*>(mask);
    auto* o = static_cast<float*>(out);
    auto* pr = static_cast<float*>(probs);
    const int w = qkv_tiled_width(d);
    const size_t smem = tiled_smem_at(w, w, with_probs);
    return with_probs ? with_qkv_width(d, TiledQkv<true>{x, b, m, o, pr, p,
                                                         grid, smem, cs})
                      : with_qkv_width(d, TiledQkv<false>{x, b, m, o, pr, p,
                                                          grid, smem, cs});
  }
}

}  // namespace sepf
}  // namespace nrk
