// Kernel row 14: the fused NRMS encoder tail backward. It recomputes the
// whole tail of each row from qkv (nothing is saved between the passes),
// then writes dqkv and sums the pooling parameters' gradients over every
// row and position.
//
// Replaces the TPU kernels newsrecommendation_tpu/ops/pallas/
// experimental_fused_encoder.py:_bwd_kernel and :_masked_bwd_kernel
// (called by _bwd_call). Contract of the forward: fused_tail.cuh. Inputs
// as the forward's, plus g (N, HD) in qkv's dtype; outputs dqkv (N, T, 3HD)
// in qkv's dtype and f32 dw1 (HD, Q), db1 (1, Q), dw2 (Q, 1), db2 (1, 1).
// Rounding points (the TPU kernel's): g in qkv's dtype, read as f32;
//   d_alpha = ctx . g,  d_ctx = alpha g,  r = sum(d_alpha alpha),
//   d_a = (d_alpha - r) alpha;  dw2 += e d_a,  d_z = d_a w2 (1 - e^2),
//   db1 += d_z;
//   dw1 += ctx^T d_z from the f32 ctx;  d_ctx += round(d_z) w1^T, d_z rounded
//   to w1's dtype;  d_ctx *= keep;  d_ctx rounded to qkv's dtype; then the
//   attention backward per head (row 16's or row 4's kernel) with a
//   recomputed as the forward computes it: dv = round(a)^T g,
//   ds = round((g v^T - rowsum) a / sqrt(D)), dq = ds k, dk = ds^T q.
// One departure: db2 is sum(d_a) = r (1 - sum(alpha)), which is 0 but for
// the 1e-8 term of the normalisation. The TPU kernel sums the f32 d_a,
// which leaves rounding noise (at chip_smoke.py's train-check, on an
// H100: -8.0e-9 from this kernel summing d_a, 7.7e-9 from the plain
// version on the CPU, against an exact -7.9e-12); here each row adds
// r * 1e-8 exp(-m) / den, the exact value of its sum, as the plain
// version does.
//
// Bound: at N = 7040, T = 20, H = D = 20, Q = 200 in bf16 the call reads qkv
// and g (344 MB) and writes dqkv (338 MB): 0.20 ms at 3.35 TB/s. Its
// products, 10*N*H*T*T*D + 6*N*T*HD*Q (11 + 68 GFLOP), take 0.08 ms at the
// bf16 tensor-core peak.
//
// Design, five launches, the first two in the regime of the launch plan
// (ops/experimental_fused_encoder.py:tail_launch_plan; the entry points
// refuse a regime that is not the shape's):
//   1. the per-row work: the forward again, the pooling backward and d_ctx.
//      It writes d_ctx (T, HD) in qkv's dtype, the row's sums of db1, dw2,
//      db2 (N, 2Q + 1), and, for dw1, the row's f32 ctx (T, HD) and d_z
//      (T, Q) to scratch. Resident (T <= 64, heads of up to 64):
//      fused_tail.cuh's tail_resident_bwd_kernel, row 13's resident code,
//      with d_z w1^T on tensor cores in bf16. Tiled (past it, T up to 1024
//      at D = 20; fused_tail.cuh's tiled regime): four launches, the
//      attention per (row, head) into ctx's scratch, the pooling per 40
//      positions (e into d_z's scratch, the scores and d_alpha into
//      `stage`), the per-row phase (tail_tiled_row_kernel: alpha, d_a, the
//      row sums, d_z over e), then d_ctx per 40 positions
//      (tail_tiled_dctx_kernel). Global (heads wider than 64, or longer
//      rows): one block of 8 warps per row (fused_tail.cuh's per-row
//      phases), ctx and d_z in their scratch below and q/k/v in its block
//      slot's part of `stage`, and past T = 5771 its row buffers there
//      too, `slots` blocks walking the rows;
//   2. the attention backward on the biased qkv with d_ctx as its g, the
//      probs recomputed as rows 1 and 15 compute them: resident, in bf16
//      row 16's resident kernel (blanes_resident.cuh) under row 16's plan,
//      in f32 row 4's (per_row_and_attention says why); past it row 4's
//      kernels (qkv_bwd.cuh), in row 4's regime for (T, D, dtype), with no
//      bias in its resident regime and a zero bias past it -- past T = 201
//      at D = 20 in bf16 its tensor-core
//      kernels with the plan `attn_plan` and the row stats in
//      `attn_stats`; in f32 past T = 599 its tiled kernel with its whole
//      working set in `attn_stage`, `attn_slots` blocks walking the items;
//   3. dw1 = ctx^T d_z over all N*T positions as a tiled product: blocks
//      of 40 x 200 outputs (8 x 8 per thread) times a split of the
//      positions (whole multiples of 32; as many splits as put about four
//      blocks of 64 x 128 outputs on an SM, which fixes the order of the
//      sums), staged 16 positions at a time in two shared buffers, the
//      next copied in while the current is summed; each block writes its
//      partial;
//   4. the partials of dw1 added in split order;
//   5. the row sums of db1, dw2, db2 added per column, each thread over a
//      fixed set of rows and then a fixed tree.
// Blocks run in parallel and in no order; every sum here has a fixed order
// and no atomics, so two runs give the same bits. The TPU kernel keeps
// ctx and d_z in VMEM and its sums in revisited output blocks; here ctx,
// d_z and d_ctx make one round trip through device memory
// (N*T*(HD*(4 + 2) + Q*4) bytes in bf16, 450 MB at the headline width):
// a persistent block per SM that kept its dw1 sum (HD*Q floats, 320 KB) in
// global memory and updated it per row took 25.6 ms on the card at the
// headline width in bf16.

#include "fused_tail.cuh"

namespace {

using namespace nrk;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the dw1 product: outputs per block (kDw1C x kDw1Q), positions staged
// per step
constexpr int kDw1C = 40;
constexpr int kDw1Q = 200;
constexpr int kDw1Threads = 128;  // 125 of them own outputs
constexpr int kDw1Rows = 32;   // the splits are whole multiples of these
constexpr int kDw1Stage = 16;  // positions staged at a time

// ctx and d_z in their scratch rows, q/k/v in this block's slot of stage;
// kSmallGlobal (past the small buffers' limit): the row buffers, alpha,
// d_alpha and g in that slot too
template <typename T, bool kSmallGlobal>
__global__ void __launch_bounds__(kThreads)
fused_tail_bwd_kernel(const T* __restrict__ qkv,
                      const float* __restrict__ mask,
                      const T* __restrict__ w1, const T* __restrict__ w1t,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2,
                      const int* __restrict__ seed, const T* __restrict__ g,
                      T* __restrict__ dctx, float* __restrict__ ctxs,
                      float* __restrict__ dzs,
                      float* __restrict__ rowpart, float* stage, int64_t n,
                      int n_heads, int t_len, int d_head, int q_dim,
                      float inv, int use_dropout, uint32_t thr, float scale) {
  extern __shared__ float smem[];
  const int hd = n_heads * d_head;
  const int w3 = 3 * hd;
  const int stride = d_head | 1;  // odd row stride: no bank conflicts
  // ctx and d_z (e, then d_z) in their scratch rows, q, k, v (3, T,
  // stride) in this block's slot of stage
  const size_t qkv_floats = 3 * (size_t)t_len * stride;
  const size_t slot =
      qkv_floats + (kSmallGlobal ? tail_bwd_small_floats(t_len, n_heads,
                                                         d_head, kWarps)
                                 : 0);
  float* qs = stage + (size_t)blockIdx.x * slot;
  float* small = kSmallGlobal ? qs + qkv_floats : smem;
  float* rows = small;                    // (kWarps, T) row buffers
  float* alpha = rows + kWarps * t_len;   // (T)
  float* dal = alpha + t_len;             // (T) d_alpha, then d_a
  float* gv = dal + t_len;                // (HD) this row's g
  float* rest = gv + hd;                  // 1 - sum(alpha), exactly

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const TailDropout drop{use_dropout != 0,
                         use_dropout ? (uint32_t)seed[0] : 0u, thr, scale};
  auto body = [&](int64_t row) {
    float* ctx = ctxs + row * t_len * hd;
    float* e = dzs + row * t_len * q_dim;  // e, then d_z
    const T* src = qkv + row * t_len * w3;
    const float* mrow = mask ? mask + row * t_len : nullptr;
    for (int c = threadIdx.x; c < hd; c += kThreads)
      gv[c] = to_f32(g[row * hd + c]);

    // ---- the forward again, up to the pooling weights --------------------
    tail_context<T, kThreads>(ctx, qs, rows, src, mrow, row, n_heads, t_len,
                              d_head, stride, inv, drop);
    tail_pool_scores<T, kThreads>(e, alpha, ctx, w1, b1, w2, b2, mrow, t_len,
                                  hd, q_dim, rest);

    // ---- pooling backward --------------------------------------------------
    for (int i = warp; i < t_len; i += kWarps) {
      float s = 0.f;
      for (int c = lane; c < hd; c += 32) s = fmaf(ctx[i * hd + c], gv[c], s);
      s = warp_sum(s);
      if (lane == 0) dal[i] = s;
    }
    __syncthreads();
    float* part = rowpart + row * (2 * q_dim + 1);
    if (warp == 0) {
      float s = 0.f;
      for (int i = lane; i < t_len; i += 32) s = fmaf(dal[i], alpha[i], s);
      const float r = warp_sum(s);
      for (int i = lane; i < t_len; i += 32) dal[i] = (dal[i] - r) * alpha[i];
      // this row's db2 = sum_i d_a_i = r (1 - sum(alpha)), 0 analytically up
      // to the 1e-8 term: summed from the f32 d_a it is rounding noise
      if (lane == 0) part[2 * q_dim] = r * *rest;
    }
    __syncthreads();
    // this row's sums of db1 and dw2 per column q, and d_z over e
    for (int q = threadIdx.x; q < q_dim; q += kThreads) {
      const float w2q = to_f32(w2[q]);
      float s2 = 0.f, s1 = 0.f;
      for (int i = 0; i < t_len; ++i) {
        const float ei = e[i * q_dim + q];
        s2 = fmaf(ei, dal[i], s2);
        const float dz = __fmul_rn(__fmul_rn(dal[i], w2q),
                                   __fsub_rn(1.f, __fmul_rn(ei, ei)));
        e[i * q_dim + q] = dz;
        s1 += dz;
      }
      part[q] = s1;
      part[q_dim + q] = s2;
    }
    __syncthreads();
    // d_ctx = (alpha g + round(d_z) w1^T) * keep, rounded to T, for row 4
    T* dctx_out = dctx + row * t_len * hd;
    tile_product<kThreads>(
        t_len, hd, q_dim,
        [&](int i, int q) { return round_to<T>(e[i * q_dim + q]); },
        [&](int q, int c) { return to_f32(w1t[(int64_t)q * hd + c]); },
        [&](int i, int c, float x) {
          float d = __fadd_rn(__fmul_rn(alpha[i], gv[c]), x);
          if (drop.on) d *= drop.keep(row, i, c, t_len, hd);
          dctx_out[i * hd + c] = from_f32<T>(d);
        });
  };
  for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
    body(row);
    __syncthreads();  // the next row overwrites the buffers
  }
}

// part[split] (HD, Q) = sum over this split's positions r of
// ctx[r, c] * dz[r, q], positions in order, for the block's kDw1C x kDw1Q
// outputs (at the NRMS width HD = 400 and Q = 200 a whole number of
// tiles): thread (tc, tq), tq < 25, owns c = c0 + 8tc .. +7 and q = q0 +
// 4tq .. +3 and q0 + 100 + 4tq .. +3, read from the staged rows as
// 16-byte vectors (a quarter warp's eight vectors of q on 32 banks). The
// positions come in steps of kDw1Stage, the next step's rows copied in by
// cp.async (16 bytes where HD and Q allow) while the current one is
// summed; rows past the split and columns past HD or Q are zeros.
__global__ void __launch_bounds__(kDw1Threads)
fused_tail_dw1_kernel(const float* __restrict__ ctxs,
                      const float* __restrict__ dzs, float* __restrict__ part,
                      int64_t n_pos, int hd, int q_dim, int64_t per_split) {
  __shared__ __align__(16) float as[2][kDw1Stage][kDw1C];
  __shared__ __align__(16) float bs[2][kDw1Stage][kDw1Q];
  const int c0 = blockIdx.x * kDw1C;
  const int q0 = blockIdx.y * kDw1Q;
  const int64_t r0 = blockIdx.z * per_split;
  const int64_t r1 = min(n_pos, r0 + per_split);
  const int tc = threadIdx.x / 25;
  const int tq = threadIdx.x % 25;
  const bool mine = threadIdx.x < 125;
  const bool vec = hd % 4 == 0 && q_dim % 4 == 0;
  // rows [rb, rb + kDw1Stage) of x (w floats a row) from column col0, W
  // of them, into dst (W floats a row)
  auto stage_rows = [&](float* dst, const float* x, int w, int col0, int W,
                        int64_t rb) {
    if (vec) {
      for (int idx = threadIdx.x; idx < kDw1Stage * W / 4;
           idx += kDw1Threads) {
        const int r = idx / (W / 4);
        const int c = (idx - r * (W / 4)) * 4;
        float* d = dst + r * W + c;
        if (rb + r < r1 && col0 + c < w)
          cp_async<16>(d, x + (rb + r) * w + col0 + c);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int idx = threadIdx.x; idx < kDw1Stage * W; idx += kDw1Threads) {
        const int r = idx / W;
        const int c = idx - r * W;
        dst[idx] = rb + r < r1 && col0 + c < w ? x[(rb + r) * w + col0 + c]
                                               : 0.f;
      }
    }
  };
  auto stage = [&](int b, int64_t rb) {
    stage_rows(&as[b][0][0], ctxs, hd, c0, kDw1C, rb);
    stage_rows(&bs[b][0][0], dzs, q_dim, q0, kDw1Q, rb);
    cp_commit();
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int b = 0;
  if (r0 < r1) stage(0, r0);
  for (int64_t rb = r0; rb < r1; rb += kDw1Stage) {
    if (rb + kDw1Stage < r1) {
      stage(b ^ 1, rb + kDw1Stage);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this step's rows are in
    if (mine) {
#pragma unroll 4
      for (int r = 0; r < kDw1Stage; ++r) {
        float x[8], y[8];
        bl::load_chunk(&as[b][r][8 * tc], x);
        bl::load_chunk(&as[b][r][8 * tc + 4], x + 4);
        bl::load_chunk(&bs[b][r][4 * tq], y);
        bl::load_chunk(&bs[b][r][100 + 4 * tq], y + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      }
    }
    __syncthreads();  // its buffer is free for the step after next
    b ^= 1;
  }
  if (!mine) return;
  float* out = part + (int64_t)blockIdx.z * hd * q_dim;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 8 * tc + i;
      const int q = q0 + 4 * tq + j % 4 + 100 * (j / 4);
      if (c < hd && q < q_dim) out[(int64_t)c * q_dim + q] = acc[i][j];
    }
}

// dw1[j] = sum over splits s, in order, of part[s, j].
__global__ void __launch_bounds__(kThreads)
fused_tail_sum_splits_kernel(const float* __restrict__ part, int n_splits,
                             int len, float* __restrict__ dw1) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= len) return;
  float s = 0.f;
  for (int p = 0; p < n_splits; ++p) s += part[(int64_t)p * len + j];
  dw1[j] = s;
}

// Column sums of rowpart (N, 2Q + 1) into db1 | dw2 | db2, one block per
// column: each thread adds rows tid, tid + kThreads, ... in order, then a
// fixed tree over the threads.
__global__ void __launch_bounds__(kThreads)
fused_tail_sum_rows_kernel(const float* __restrict__ rowpart, int n,
                           int q_dim, float* __restrict__ db1,
                           float* __restrict__ dw2, float* __restrict__ db2) {
  __shared__ float red[kThreads];
  const int col = blockIdx.x;
  const int width = 2 * q_dim + 1;
  float s = 0.f;
  for (int r = threadIdx.x; r < n; r += kThreads)
    s += rowpart[(int64_t)r * width + col];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (col < q_dim)
      db1[col] = red[0];
    else if (col < 2 * q_dim)
      dw2[col - q_dim] = red[0];
    else
      db2[0] = red[0];
  }
}

// The tiled regime's per-row phase (fused_tail.cuh): alpha and 1 -
// sum(alpha) from the row's scores (sa, overwritten by alpha), d_a from
// d_alpha (dal), this row's db2, then one thread a column q: the sums of
// db1 and dw2 over the positions in order, and d_z over e (e_dz, (N, T,
// Q): e in, d_z out) -- the per-row kernel's arithmetic. Shared: alpha,
// d_a (T each) and 1 - sum(alpha).
template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_tiled_row_kernel(float* __restrict__ sa, const float* __restrict__ dal,
                      const float* __restrict__ mask,
                      const T* __restrict__ w2, float* __restrict__ e_dz,
                      float* __restrict__ rowpart, int t_len, int q_dim) {
  extern __shared__ float row_smem[];
  float* alpha = row_smem;
  float* da = alpha + t_len;
  float* rest = da + t_len;
  const int64_t row = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < t_len; i += kThreads) {
    alpha[i] = sa[row * t_len + i];
    da[i] = dal[row * t_len + i];
  }
  __syncthreads();
  float* part = rowpart + row * (2 * q_dim + 1);
  if (warp == 0) {
    tail_alpha(alpha, mask ? mask + row * t_len : nullptr, t_len, lane, rest);
    __syncwarp();
    float s = 0.f;
    for (int i = lane; i < t_len; i += 32) s = fmaf(da[i], alpha[i], s);
    const float r = warp_sum(s);
    for (int i = lane; i < t_len; i += 32) da[i] = (da[i] - r) * alpha[i];
    if (lane == 0) part[2 * q_dim] = r * *rest;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < t_len; i += kThreads)
    sa[row * t_len + i] = alpha[i];
  float* e = e_dz + row * t_len * q_dim;
  for (int q = threadIdx.x; q < q_dim; q += kThreads) {
    const float w2q = to_f32(w2[q]);
    float s2 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int i = 0; i < t_len; ++i) {
      const float ei = e[(int64_t)i * q_dim + q];
      s2 = fmaf(ei, da[i], s2);
      const float dz = __fmul_rn(__fmul_rn(da[i], w2q),
                                 __fsub_rn(1.f, __fmul_rn(ei, ei)));
      e[(int64_t)i * q_dim + q] = dz;
      s1 += dz;
    }
    part[q] = s1;
    part[q_dim + q] = s2;
  }
}

// The tiled regime's d_ctx for kPoolRows positions (flat over N*T):
// (alpha g + round(d_z) w1^T) * keep, rounded to T, d_z w1^T in k order
// (tail_fma: the per-row kernel's tile_product sums). Shared: the
// positions' d_z rows (tail_es(Q) floats each) and alpha.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_tiled_dctx_kernel(const float* __restrict__ dzs,
                       const float* __restrict__ alpha,
                       const T* __restrict__ g, const T* __restrict__ w1t,
                       const int* __restrict__ seed, T* __restrict__ dctx,
                       int64_t n_pos, int t_len, int hd, int q_dim,
                       int use_dropout, uint32_t thr, float scale) {
  extern __shared__ __align__(16) float dctx_smem[];
  const int es = tail_es(q_dim);
  float* zb = dctx_smem;
  float* al = zb + kPoolRows * es;
  const TailDropout drop{use_dropout != 0,
                         use_dropout ? (uint32_t)seed[0] : 0u, thr, scale};
  const int64_t p0 = (int64_t)blockIdx.x * kPoolRows;
  const int rows = (int)min((int64_t)kPoolRows, n_pos - p0);
  for (int idx = threadIdx.x; idx < rows * q_dim; idx += kThreads) {
    const int i = idx / q_dim;
    zb[i * es + idx - i * q_dim] = dzs[p0 * q_dim + idx];
  }
  for (int i = threadIdx.x; i < rows; i += kThreads) al[i] = alpha[p0 + i];
  __syncthreads();
  tail_fma<T>(rows, hd, q_dim, zb, es, w1t, hd, [&](int i, int c, float x) {
    const int64_t p = p0 + i;
    const int64_t row = p / t_len;
    const int t = (int)(p - row * t_len);
    float d = __fadd_rn(__fmul_rn(al[i], to_f32(g[row * hd + c])), x);
    if (drop.on) d *= drop.keep(row, t, c, t_len, hd);
    dctx[p * hd + c] = from_f32<T>(d);
  });
}

// Row 14's first launches in the tiled regime: the attention into ctxs,
// the pooling blocks (e into dzs, the scores and d_alpha into rows), the
// per-row phase, the d_ctx blocks. rows: 2*N*T floats, the scores (then
// alpha) and d_alpha.
template <typename T>
int tiled_first(const T* qkv, const float* mask, const T* w1, const T* w1t,
                const float* b1, const T* w2, const float* b2,
                const int* seed, const T* g, T* dctx, float* ctxs,
                float* dzs, float* rowpart, float* rows, int n, int t_len,
                int n_heads, int d_head, int q_dim, int tile, int use_dropout,
                uint32_t thr, float scale, cudaStream_t stream) {
  const TileLay l = tile_lay(t_len, d_head, tile);
  if ((tile != 16 && tile != 32 && tile != 64) ||
      l.bytes > (size_t)bl::kMaxSmem || rows == nullptr)
    return (int)cudaErrorInvalidValue;
  const int hd = n_heads * d_head;
  const int64_t n_pos = (int64_t)n * t_len;
  const unsigned pool_grid = (unsigned)((n_pos + kPoolRows - 1) / kPoolRows);
  float* sa = rows;
  float* dal = rows + n_pos;
  auto* attn = tail_tiled_attn_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      attn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.bytes);
  if (err != cudaSuccess) return (int)err;
  attn<<<(unsigned)(n * n_heads), kTileThreads, l.bytes, stream>>>(
      qkv, mask, seed, ctxs, n_heads, t_len, d_head,
      (float)(1.0 / sqrt((double)d_head)), l, use_dropout, thr, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto* pool = tail_tiled_pool_kernel<T, true>;
  const size_t pool_bytes = tail_pool_bytes(hd, q_dim);
  err = cudaFuncSetAttribute(
      pool, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pool_bytes);
  if (err != cudaSuccess) return (int)err;
  pool<<<pool_grid, bl::kThreads, pool_bytes, stream>>>(
      ctxs, w1, b1, w2, b2, g, sa, dzs, dal, n_pos, t_len, hd, q_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tail_tiled_row_kernel<T><<<(unsigned)n, kThreads,
                             4 * (2 * (size_t)t_len + 1), stream>>>(
      sa, dal, mask, w2, dzs, rowpart, t_len, q_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto* dk = tail_tiled_dctx_kernel<T>;
  const size_t dctx_bytes = 4 * (size_t)kPoolRows * (tail_es(q_dim) + 1);
  err = cudaFuncSetAttribute(
      dk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dctx_bytes);
  if (err != cudaSuccess) return (int)err;
  dk<<<pool_grid, kThreads, dctx_bytes, stream>>>(
      dzs, sa, g, w1t, seed, dctx, n_pos, t_len, hd, q_dim, use_dropout, thr,
      scale);
  return (int)cudaGetLastError();
}

// shared bytes of the per-row kernel: its small buffers, 0 past their
// limit
size_t row_smem_bytes(int t_len, int n_heads, int d_head) {
  if (tail_bwd_small_global(t_len, n_heads, d_head, kWarps)) return 0;
  return sizeof(float) *
         tail_bwd_small_floats(t_len, n_heads, d_head, kWarps);
}

// Row 14's first kernel at T <= 64 under the resident plan.
template <typename T>
struct ResidentBwd {
  const T *qkv, *w1, *w1t, *w2, *g;
  const float *mask, *b1, *b2;
  const int* seed;
  T* dctx;
  float *ctxs, *dzs, *rowpart;
  bl::Params p;
  TailRes r;
  unsigned blocks;
  int use_dropout;
  uint32_t thr;
  float scale;
  cudaStream_t stream;

  template <int DM>
  int operator()() const {
    auto* kernel = tail_resident_bwd_kernel<T, DM>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)r.bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, bl::kThreads, r.bytes, stream>>>(
        qkv, mask, w1, w1t, b1, w2, b2, seed, g, dctx, ctxs, dzs, rowpart, p,
        r, use_dropout, thr, scale);
    return (int)cudaGetLastError();
  }
};

// The first two launches: the per-row work, then the attention backward on
// d_ctx. Resident (T <= 64): tail_resident_bwd_kernel, then in bf16 row
// 16's resident kernel on the biased qkv (blanes_resident.cuh) under its
// plan (a_heads, a_nbuf, a_blocks), in f32 row 4's resident kernel (no
// bias): row 16 sums each query's r (and den's 1e-8 term) with the product
// rounded before the add, row 4 in one fma, so past T = 32 (two keys a
// lane) their f32 dqkv differ in 8-18% of the elements (PERF.md), where
// bf16's rounding of ds hides all but a few. Past the resident regime:
// the per-row kernel, then row 4's kernel in row 4's regime (no bias in
// its resident regime, a zero bias past it).
template <typename T>
int per_row_and_attention(
    const void* qkv, const void* mask, const void* w1, const void* w1t,
    const void* b1, const void* w2, const void* b2, const void* seed,
    const void* g, const void* zero_bias, void* dqkv, void* dctx, void* ctxs,
    void* dzs, void* rowpart, void* stage, void* attn_stage, void* attn_stats,
    int n, int t_len, int n_heads, int d_head, int q_dim, int slots,
    int attn_slots, const int* attn_plan, int regime, int heads, int nbuf,
    int blocks, int tile, int a_heads, int a_nbuf, int a_blocks,
    int use_dropout, unsigned thr, float scale, void* stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int esize = (int)sizeof(T);
  auto* cs = (cudaStream_t)stream;
  // row 4's kernel on the biased qkv (zero_bias: null, or zeros past row
  // 4's resident regime) and d_ctx, the probs recomputed as the forward
  // computes them
  auto row4 = [&]() {
    return qkv_bwd_launch<T, true>(
        qkv, zero_bias, nullptr, mask, dctx, dqkv, n, t_len, n_heads, d_head,
        stream,
        {attn_plan, nullptr, static_cast<float*>(attn_stats),
         static_cast<float*>(attn_stage), attn_slots, true});
  };
  if (regime == kTailResident) {
    const TailRes r = tail_res(1, t_len, n_heads, d_head, q_dim, esize,
                               heads, nbuf);
    if (!tail_res_ok(r, n_heads, heads, nbuf, blocks) ||
        (!kBf16 && (a_heads || a_nbuf || a_blocks)))
      return (int)cudaErrorInvalidValue;
    const bl::Params p = bl::params_of(bl::kFwd, n, t_len, n_heads, d_head,
                                       esize, heads, t_len, nbuf, qkv, qkv);
    if (p.items == 0) return (int)cudaErrorInvalidConfiguration;
    const int err = with_head_width(
        d_head,
        ResidentBwd<T>{static_cast<const T*>(qkv), static_cast<const T*>(w1),
                       static_cast<const T*>(w1t), static_cast<const T*>(w2),
                       static_cast<const T*>(g),
                       static_cast<const float*>(mask),
                       static_cast<const float*>(b1),
                       static_cast<const float*>(b2),
                       static_cast<const int*>(seed), static_cast<T*>(dctx),
                       static_cast<float*>(ctxs), static_cast<float*>(dzs),
                       static_cast<float*>(rowpart), p, r,
                       (unsigned)(blocks < n ? blocks : n), use_dropout, thr,
                       scale, cs});
    if (err != (int)cudaSuccess) return err;
    if constexpr (kBf16)
      return bl::bwd_short_launch<T>(qkv, mask, dctx, dqkv, n, t_len,
                                     n_heads, d_head, a_heads, a_nbuf,
                                     a_blocks, stream);
    return row4();
  }
  if (heads || nbuf || blocks || a_heads || a_nbuf || a_blocks)
    return (int)cudaErrorInvalidValue;
  if (regime == kTailTiled) {
    if (slots) return (int)cudaErrorInvalidValue;
    const int err = tiled_first<T>(
        static_cast<const T*>(qkv), static_cast<const float*>(mask),
        static_cast<const T*>(w1), static_cast<const T*>(w1t),
        static_cast<const float*>(b1), static_cast<const T*>(w2),
        static_cast<const float*>(b2), static_cast<const int*>(seed),
        static_cast<const T*>(g), static_cast<T*>(dctx),
        static_cast<float*>(ctxs), static_cast<float*>(dzs),
        static_cast<float*>(rowpart), static_cast<float*>(stage), n, t_len,
        n_heads, d_head, q_dim, tile, use_dropout, thr, scale, cs);
    if (err != (int)cudaSuccess) return err;
    return row4();
  }
  if (stage == nullptr || slots <= 0) return (int)cudaErrorInvalidValue;
  const int row_grid = slots < n ? slots : n;
  const size_t smem = row_smem_bytes(t_len, n_heads, d_head);
  auto* kernel = tail_bwd_small_global(t_len, n_heads, d_head, kWarps)
                     ? fused_tail_bwd_kernel<T, true>
                     : fused_tail_bwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float inv = (float)(1.0 / sqrt((double)d_head));
  kernel<<<(unsigned)row_grid, kThreads, smem, cs>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<const T*>(w1), static_cast<const T*>(w1t),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const int*>(seed),
      static_cast<const T*>(g), static_cast<T*>(dctx),
      static_cast<float*>(ctxs), static_cast<float*>(dzs),
      static_cast<float*>(rowpart), static_cast<float*>(stage), n, n_heads,
      t_len, d_head, q_dim, inv, use_dropout, thr, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return row4();
}

template <typename T>
int launch(const void* qkv, const void* mask, const void* w1, const void* w1t,
           const void* b1, const void* w2, const void* b2, const void* seed,
           const void* g, const void* zero_bias, void* dqkv, void* dctx,
           void* ctxs, void* dzs, void* rowpart, void* part, void* dw1,
           void* db1, void* dw2, void* db2, void* stage, void* attn_stage,
           void* attn_stats, int n, int t_len, int n_heads, int d_head,
           int q_dim, int n_splits, int slots, int attn_slots,
           const int* attn_plan, int regime, int heads, int nbuf, int blocks,
           int tile, int a_heads, int a_nbuf, int a_blocks, int use_dropout,
           unsigned thr, float scale, void* stream) {
  if (n <= 0 || n_splits <= 0 ||
      regime != tail_regime(1, t_len, n_heads, d_head, q_dim, (int)sizeof(T)) ||
      (tile != 0) != (regime == kTailTiled))
    return (int)cudaErrorInvalidValue;
  const int first = per_row_and_attention<T>(
      qkv, mask, w1, w1t, b1, w2, b2, seed, g, zero_bias, dqkv, dctx, ctxs,
      dzs, rowpart, stage, attn_stage, attn_stats, n, t_len, n_heads, d_head,
      q_dim, slots, attn_slots, attn_plan, regime, heads, nbuf, blocks, tile,
      a_heads, a_nbuf, a_blocks, use_dropout, thr, scale, stream);
  if (first != (int)cudaSuccess) return first;

  auto* cs = (cudaStream_t)stream;
  const int hd = n_heads * d_head;
  const int64_t n_pos = (int64_t)n * t_len;
  // positions per split, a whole number of staging steps
  int64_t per_split = (n_pos + n_splits - 1) / n_splits;
  per_split = (per_split + kDw1Rows - 1) / kDw1Rows * kDw1Rows;
  const dim3 grid((hd + kDw1C - 1) / kDw1C, (q_dim + kDw1Q - 1) / kDw1Q,
                  n_splits);
  fused_tail_dw1_kernel<<<grid, kDw1Threads, 0, cs>>>(
      static_cast<const float*>(ctxs), static_cast<const float*>(dzs),
      static_cast<float*>(part), n_pos, hd, q_dim, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = hd * q_dim;
  fused_tail_sum_splits_kernel<<<(len + kThreads - 1) / kThreads, kThreads, 0,
                                 cs>>>(static_cast<const float*>(part),
                                       n_splits, len,
                                       static_cast<float*>(dw1));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_tail_sum_rows_kernel<<<2 * q_dim + 1, kThreads, 0, cs>>>(
      static_cast<const float*>(rowpart), n, q_dim, static_cast<float*>(db1),
      static_cast<float*>(dw2), static_cast<float*>(db2));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w1t: w1 transposed, (Q, HD) contiguous. Scratch: dctx (N, T, HD) in
// qkv's dtype, ctxs (N, T, HD) f32, dzs (N, T, Q) f32, rowpart (N, 2Q + 1)
// f32, part (n_splits, HD, Q) f32. regime: the shape's
// (fused_tail_bwd_regime: 0 resident, 1 global, the per-row kernel with
// its working set in global memory, 2 tiled, whose sub-tile `tile` is the
// plan's; 0 in the other regimes). Resident: the plan
// (heads, nbuf, blocks) of ops/experimental_fused_encoder.py:
// tail_launch_plan; in bf16 row 16's (a_heads, a_nbuf, a_blocks), and
// zero_bias, stage, attn_stage, attn_stats and row 4's plan are not read;
// in f32 row 16's plan is zeros and row 4 takes its resident plan and a
// null zero_bias. Past it the resident plans are zeros; row 4 takes
// zero_bias (null in row 4's resident regime, else 3HD zeros in qkv's
// dtype); stage (tiled: N rows of fused_tail_bwd_row_floats, slots 0;
// global: `slots` slots of fused_tail_bwd_stage_floats) and attn_stage
// (`attn_slots` slots of fused_tail_bwd_attn_stage_floats) are read only
// when those are not 0; attn_stats (3, N*H, T) f32 and the tensor-core plan
// of row 4's two sides (q_tile, q_chunk, q_nbuf, k_tile, k_chunk, k_nbuf)
// only in that regime of row 4. mask may be null (the unmasked variant).
// Launches the kernels on the stream; returns cudaGetLastError() after
// them: 0 when all were queued; cudaErrorInvalidValue for a regime that is
// not the shape's or a plan its kernels do not take.
#define NRK_TAIL_BWD(SUFFIX, T)                                              \
  int fused_tail_bwd_##SUFFIX(                                               \
      const void* qkv, const void* mask, const void* w1, const void* w1t,    \
      const void* b1, const void* w2, const void* b2, const void* seed,      \
      const void* g, const void* zero_bias, void* dqkv, void* dctx,          \
      void* ctxs, void* dzs, void* rowpart, void* part, void* dw1,           \
      void* db1, void* dw2, void* db2, void* stage, void* attn_stage,        \
      void* attn_stats, int n, int t_len, int n_heads, int d_head,           \
      int q_dim, int n_splits, int slots, int attn_slots, int q_tile,        \
      int q_chunk, int q_nbuf, int k_tile, int k_chunk, int k_nbuf,          \
      int regime, int heads, int nbuf, int blocks, int tile, int a_heads,    \
      int a_nbuf, int a_blocks, int use_dropout, unsigned thr, float scale,  \
      void* stream) {                                                        \
    const int plan[6] = {q_tile, q_chunk, q_nbuf, k_tile, k_chunk, k_nbuf};  \
    return launch<T>(qkv, mask, w1, w1t, b1, w2, b2, seed, g, zero_bias,     \
                     dqkv, dctx, ctxs, dzs, rowpart, part, dw1, db1, dw2,    \
                     db2, stage, attn_stage, attn_stats, n, t_len, n_heads,  \
                     d_head, q_dim, n_splits, slots, attn_slots, plan,       \
                     regime, heads, nbuf, blocks, tile, a_heads, a_nbuf,     \
                     a_blocks, use_dropout, thr, scale, stream);             \
  }
NRK_TAIL_BWD(f32, float)
NRK_TAIL_BWD(bf16, __nv_bfloat16)
#undef NRK_TAIL_BWD

// The backward's regime at (T, H, D, Q) in a dtype of esize bytes, and the
// shared bytes of its resident per-row block under (heads, nbuf): what
// tail_launch_plan computes in Python.
int fused_tail_bwd_regime(int t_len, int n_heads, int d_head, int q_dim,
                          int esize) {
  return tail_regime(1, t_len, n_heads, d_head, q_dim, esize);
}

int fused_tail_bwd_smem_bytes(int t_len, int n_heads, int d_head, int q_dim,
                              int esize, int heads, int nbuf) {
  return (int)tail_res(1, t_len, n_heads, d_head, q_dim, esize, heads, nbuf)
      .bytes;
}

// Floats of `stage` a batch row takes in the tiled regime (its scores,
// then alpha, and d_alpha; 0 in the other regimes).
int fused_tail_bwd_row_floats(int t_len, int n_heads, int d_head, int q_dim,
                              int esize) {
  if (tail_regime(1, t_len, n_heads, d_head, q_dim, esize) != kTailTiled)
    return 0;
  return 2 * t_len;
}

// Floats of one slot of `stage` for the per-row kernel (the global
// regime).
int fused_tail_bwd_stage_floats(int t_len, int n_heads, int d_head,
                                int q_dim) {
  return (int)(3 * (size_t)t_len * (d_head | 1) +
               (tail_bwd_small_global(t_len, n_heads, d_head, kWarps)
                    ? tail_bwd_small_floats(t_len, n_heads, d_head, kWarps)
                    : 0));
}

// Floats of one slot of `attn_stage`: 0 unless row 4's regime at (T, D) in
// a dtype of esize bytes is its tiled kernel in global memory.
int fused_tail_bwd_attn_stage_floats(int t_len, int d_head, int esize) {
  return (int)qkv_bwd_slot_floats_for(t_len, d_head, esize);
}

}  // extern "C"
