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

// Shared bytes of a tiled block: kTiledChunk keys of K at flash_dm(d_k),
// of V at flash_dm(d_v), and of the mask, as f32.
inline size_t tiled_smem(int dk, int dv) {
  return sizeof(float) * (size_t)kTiledChunk *
         (flash_dm(dk) + flash_dm(dv) + 1);
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

template <int DM, bool kMask>
__global__ void __launch_bounds__(256, 3)
sep_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ mask,
                   __nv_bfloat16* __restrict__ out, Params p) {
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

// d_k and d_v held at DK and DV lanes (zero pads).
template <int DK, int DV>
__global__ void __launch_bounds__(kTiledThreads)
sep_fwd_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ out,
                     Params p) {
  extern __shared__ __align__(16) float sep_tiled_smem[];
  float* ks = sep_tiled_smem;         // (kTiledChunk, DK)
  float* vs = ks + kTiledChunk * DK;  // (kTiledChunk, DV)
  float* mk = vs + kTiledChunk * DV;  // (kTiledChunk)
  const int row = blockIdx.x / p.h;
  const int h = blockIdx.x - row * p.h;
  const int64_t first = (int64_t)row * p.t;
  const int64_t kbase = first * p.ldk + h * p.dk;
  const int64_t vbase = first * p.ldv + h * p.dv;
  const float* mrow = mask ? mask + first : nullptr;
  const int qi = blockIdx.y * kTiledThreads + threadIdx.x;
  const bool act = qi < p.t;
  float qv[DK], o[DV];
  const float* qr = q + (first + (act ? qi : 0)) * p.ldq + h * p.dk;
#pragma unroll
  for (int d = 0; d < DK; ++d) qv[d] = act && d < p.dk ? qr[d] : 0.f;
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
      load_rows<float, DK>(ks, k, kbase, p.ldk, j0, j0 + nj, p.dk);
      if (pass == 1) load_rows<float, DV>(vs, v, vbase, p.ldv, j0, j0 + nj,
                                          p.dv);
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

struct MmaLaunch {
  const __nv_bfloat16 *q, *k, *v;
  const float* mask;
  __nv_bfloat16* out;
  Params p;
  dim3 grid;
  size_t smem;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    return mask ? go(sep_fwd_mma_kernel<DM, true>, grid, 2 * p.tile, smem,
                     stream, q, k, v, mask, out, p)
                : go(sep_fwd_mma_kernel<DM, false>, grid, 2 * p.tile, smem,
                     stream, q, k, v, mask, out, p);
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
    return go(sep_fwd_tiled_kernel<DK, DV>, grid, kTiledThreads, smem, stream,
              q, k, v, mask, out, p);
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

// One launch of the forward past T = 64 in regime `reg` (kMma or kTiled)
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
  const int64_t rows = (int64_t)n * n_heads;
  const int tiles = (t_len + tile - 1) / tile;
  if (rows > 0x7fffffff || tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)rows, (unsigned)tiles);
  Params p{n_heads, t_len, dk, dv, ldq, ldk, ldv, tile, chunk, nbuf,
           0, 0, 0, 0, 0, 1.0f / sqrtf((float)dk)};
  const int dmax = dk > dv ? dk : dv;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const FlashLayout l = flash_layout(kFlashFwd, dmax, 2, tile, chunk);
    const void* qk[2] = {q, k};
    p.rs = flash_row_elems(dmax);
    p.pk = flash_piece(dk, 2, ldq, ldk, qk, 2);
    p.pv = flash_piece(dv, 2, ldv, ldv, &v, 1);
    p.own = (int)l.own;
    p.stage = (int)l.stage;
    using B = __nv_bfloat16;
    return with_head_width(
        dmax, MmaLaunch{static_cast<const B*>(q), static_cast<const B*>(k),
                        static_cast<const B*>(v),
                        static_cast<const float*>(mask), static_cast<B*>(out),
                        p, grid, l.own + nbuf * l.stage,
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

}  // namespace sepf
}  // namespace nrk
