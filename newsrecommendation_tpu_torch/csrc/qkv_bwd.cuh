// Backward of the exp-normalised multi-head self-attention over a fused
// [q|k|v] projection: one kernel template for two TPU kernels of
// newsrecommendation_tpu/ops/pallas/fused_attention.py,
//   _qkv_bwd_probs_kernel (row 3, _qkv_bwd_probs_call): a read from the f32
//       probs the forward saved (qkv_bwd_probs.cu, kRecompute = false);
//   _qkv_bwd_kernel (row 4, _qkv_bwd_call): a recomputed from qkv, bias
//       and the key mask as the forward computes it (qkv_bwd.cu,
//       kRecompute = true).
//
// Contract (same as the TPU kernels):
//   qkv   (N, T, 3*H*D) un-biased projection; bias (3*H*D,) added at the
//         input dtype, as in the forward
//   probs (N, T, H*T) f32 (row 3): a of head h at lanes [h*T, (h+1)*T); it
//         carries the mask (a masked key's a is 0)
//   mask  (N, T) f32 over keys, or null (row 4)
//   g     (N, T, H*D) incoming gradient of the context, in qkv's dtype
//   dqkv  (N, T, 3*H*D) in qkv's dtype: dq, dk, dv of head h at lanes h*D,
//         H*D + h*D, 2*H*D + h*D
// Per head, with f32 accumulation everywhere:
//   a  = exp(s - m) * mask / (sum_j exp(s - m) * mask + 1e-8 exp(-m))
//        (row 4: s = (q.k) / sqrt(D), m over ALL keys, as the forward)
//   dv = round(a)^T g                 a rounded to g's dtype first
//   da = g v^T
//   ds = (da - rowsum(da * a)) * a * (1/sqrt(D))    with the f32 a
//   dq = round(ds) k,  dk = round(ds)^T q           ds rounded to k's dtype
// d(bias) is the sum of dqkv over (N, T), a plain reduce left to the caller.
//
// Bound: memory. Row 3 reads qkv, probs and g once and writes dqkv once:
// at N=7040, T=20, H=20, D=20 in bf16 that is 338 + 225 + 113 + 338 MB,
// 1,014 MB, about 0.30 ms at 3.35 TB/s, against 8*N*H*T*T*D = 9.0 GFLOP.
// Row 4 moves no probs (789 MB, 0.24 ms) and does 10*N*H*T*T*D flops.
//
// Four regimes, chosen by T, D and the dtype (qkv_bwd_regime; the plan in
// Python is ops/fused_attention.py:bwd_launch_plan), the first on two
// kernels:
//   Resident (the T x T block of a fits: T up to 201 at D = 20; both
//     dtypes):
//     - the short kernel (qb::, T <= 64 and heads of up to 32: the news and
//       L = 50 user encoders). An item is one batch row and up to four
//       heads; the grid holds as many blocks as the card does (three an SM
//       for row 3, two for row 4, whose registers it needs), each walking
//       items, the next item's q, k, v, g rows (one 16-byte-aligned run of
//       the item's heads), row 3's probs rows and the heads' bias copied in
//       by cp.async while it computes (two buffers where three blocks still
//       fit, else one). The rows are made f32 once an item (bf16: widened,
//       the bias added as round(x + b) at the input dtype; f32: the bias
//       added in place). Phase A: each warp takes an even run of the
//       item's (head, row) pairs in batches of 5 rows (3 where a lane holds
//       two keys); key j sits in lane j mod 32, its K (row 4) and V rows in
//       registers; the batch's dots (g_i v_j, and row 4's q_i k_j) read
//       float4 broadcasts, and its xor trees (m, den, r) run interleaved,
//       each in warp_sum's order; round(a), ds and ds^T go to (T, T) arrays.
//       Phase B: threads by (product, head, 4 rows, 4 lanes) sum dq = ds k,
//       dk = ds^T q and dv = round(a)^T g, each sum in index order, from a
//       float4 of the (T, T) array and one of the f32 rows; four outputs a
//       store. Every sum keeps the first design's order and every rounding
//       its place, so dqkv keeps its bits in both dtypes. A null bias: qkv
//       carries its bias (rows 14 and 16), none is added.
//     - the first design's kernel (the rest of the range): one block of 4
//       warps per (row n, head h) stages q_h, k_h, v_h and g_h (T x D each,
//       rounded to the input dtype and held as f32, odd row stride) and a
//       (T x T f32, odd stride; staged from probs, or recomputed one warp
//       per row exactly as the forward's warp computes it) in shared
//       memory. Threads over (j, d) write dv; one warp per row computes da
//       (in its own row buffer), the row sum r by warp shuffles and ds over
//       a in place; then threads over (x, d) write dq and dk.
//   Tensor cores (bf16, D <= 64, past the resident kernel): qkv_bwd_mma.cuh,
//     a query-side and a key-side kernel on mma.sync with every operand
//     staged in chunks, so any T runs.
//   Tiled (f32, or D > 64; 8 warps, one block per (row, head)): the same
//     q, k, v, g and a tile of R rows of T floats, R as large as the rest
//     of the 227 KB allows (18 at T = 511, D = 20). Query tiles of R rows:
//     one warp per query makes a's row in its buffer and ds's row in the
//     tile, then threads over (i, d) write dq; then key tiles of R/2 keys:
//     threads over (key j, query i) pairs compute a_ij (probs read with a
//     stride, L1/L2 resident; or recomputed from the row's m_i and den_i),
//     da_ij and ds_ij into two tiles, and threads over (j, d) write dv and
//     dk. ds is computed twice there, by the same expression on the same
//     operands. At D = 20 every T up to 599 fits.
//   Tiled in global memory (the same, past what shared memory holds): q,
//     k, v, g, the row buffers, the row stats and a tile of 16 rows in one
//     global slot per block (qkv_bwd_global_floats), a grid of `slots`
//     blocks walking the (row, head) items. Any T runs.
// The first resident and the tiled kernels are two, not one with two
// paths: in one kernel with the tiled path (more registers, a run-time
// block size) the resident path ran 1.5-11% slower on the card. Every dot
// runs in index order, so all give the same values, and on them row 3 and
// row 4 give the same dqkv bit for bit when row 4's recomputed a equals
// the probs row 2 wrote. Where the short kernel's time goes on an H100
// (scripts/qkv_bwd_variants.py, PERF.md): its phases run one after another
// in each block, each below its instruction rate; the FMAs (0.13 ms at
// (7040, 20)) are not the limit. Left on the table: phase A's lanes past
// T (12 of 32 at T = 20), the bf16 rows widened to f32 once an item, and
// tensor cores (TF32 in f32, and their own order of sums in bf16, would
// change the result).
#pragma once

#include "blanes_resident.cuh"  // walk_items
#include "common.cuh"
#include "qkv_bwd_mma.cuh"

#include <initializer_list>
#include <type_traits>

namespace nrk {

constexpr int kMaxSmemFloats = 232448 / 4;  // what a block may use
constexpr int kResidentWarps = 4;
constexpr int kTiledWarps = 8;
constexpr int kGlobalTileRows = 16;  // the tile of the tiled kernel in a slot

// shared floats of the resident kernel: q, k, v, g, the T x T block of a,
// one row buffer per warp
inline size_t qkv_bwd_resident_floats(int t_len, int d_head) {
  return 4 * (size_t)t_len * (d_head | 1) + (size_t)t_len * (t_len | 1) +
         (size_t)kResidentWarps * t_len;
}

inline bool qkv_bwd_resident(int t_len, int d_head) {
  return qkv_bwd_resident_floats(t_len, d_head) <= (size_t)kMaxSmemFloats;
}

// q, k, v and g of one (row, head), each (T, D|1) f32: the tiled kernel's
// stage, in shared memory or in one global slot
__host__ __device__ inline size_t qkv_bwd_stage_floats(int t_len,
                                                       int d_head) {
  return 4 * (size_t)t_len * (d_head | 1);
}

// one global slot of the tiled kernel past shared memory: the stage, the
// row buffers, the row stats (r, m, den) and a tile of kGlobalTileRows
__host__ __device__ inline size_t qkv_bwd_global_floats(int t_len,
                                                        int d_head) {
  return qkv_bwd_stage_floats(t_len, d_head) +
         (size_t)(kTiledWarps + 3) * t_len +
         (size_t)kGlobalTileRows * (t_len | 1);
}

// rows of the tiled kernel's tile: as many as fit beside `staged` floats
// (the stage when it is in shared memory, else 0), the row buffers and
// the row stats (r, m, den: 3T floats); 2 at the least (a launch that
// needs more shared memory than a block has is refused)
inline int qkv_bwd_tile_rows(int t_len, size_t staged) {
  const size_t used = staged + (size_t)(kTiledWarps + 3) * t_len;
  const size_t rows = used < (size_t)kMaxSmemFloats
                          ? (kMaxSmemFloats - used) / (size_t)(t_len | 1)
                          : 0;
  return (int)(rows < 2 ? 2 : rows);
}

// whether the tiled kernel's stage fits in shared memory beside 2 tile rows
inline bool qkv_bwd_tiled_in_smem(int t_len, int d_head) {
  return qkv_bwd_stage_floats(t_len, d_head) +
             (size_t)(kTiledWarps + 3) * t_len + 2 * (size_t)(t_len | 1) <=
         (size_t)kMaxSmemFloats;
}

// shared bytes of the tiled kernel, its stage in shared memory (`staged`)
// or in global memory
inline size_t qkv_bwd_tiled_smem_bytes(int t_len, size_t staged) {
  return sizeof(float) *
         (staged + (size_t)(kTiledWarps + 3) * t_len +
          (size_t)qkv_bwd_tile_rows(t_len, staged) * (t_len | 1));
}

enum QkvBwdRegime {
  kQkvResident = 0,
  kQkvMma = 1,
  kQkvTiled = 2,
  kQkvTiledGlobal = 3
};

// the regime of a (T, D) in a dtype of esize bytes
inline int qkv_bwd_regime(int t_len, int d_head, int esize) {
  if (qkv_bwd_resident(t_len, d_head)) return kQkvResident;
  if (flash_mma(d_head, esize)) return kQkvMma;
  return qkv_bwd_tiled_in_smem(t_len, d_head) ? kQkvTiled : kQkvTiledGlobal;
}

// floats of one global slot of the regime: 0 unless it is the tiled kernel
// in global memory
inline size_t qkv_bwd_slot_floats_for(int t_len, int d_head, int esize) {
  return qkv_bwd_regime(t_len, d_head, esize) == kQkvTiledGlobal
             ? qkv_bwd_global_floats(t_len, d_head)
             : 0;
}

// One warp: a's row i into `a` (f32), as the forward's warp computes it
// (qkv_fwd.cu, step for step), with the row's m and den kept (unless
// m_out is null).
__device__ __forceinline__ void recompute_a_row(
    float* a, const float* qi, const float* k, const float* mrow, int t_len,
    int d_head, int stride, float inv_s, float* m_out, float* den_out,
    int lane) {
  float mx = -INFINITY;
  for (int j = lane; j < t_len; j += 32) {
    const float* kj = k + j * stride;
    float acc = 0.f;
    for (int d = 0; d < d_head; ++d) acc = fmaf(qi[d], kj[d], acc);
    const float s = __fmul_rn(acc, inv_s);
    a[j] = s;
    mx = fmaxf(mx, s);
  }
  const float m = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < t_len; j += 32) {
    float e = expf(a[j] - m);
    if (mrow) e *= mrow[j];
    a[j] = e;
    sum += e;
  }
  const float den = warp_sum(sum) + kEps * expf(-m);
  for (int j = lane; j < t_len; j += 32) a[j] = den > 0.f ? a[j] / den : 0.f;
  if (lane == 0 && m_out) {
    *m_out = m;
    *den_out = den;
  }
}

// One warp: da's row i into `da`, r_i = rowsum(da * a) into *r_out (unless
// it is null), then
// ds's row, rounded to T, into `out` (which may be `a` or `da`: each lane
// rewrites only the entries it read).
template <typename T>
__device__ __forceinline__ void ds_row(float* out, const float* a, float* da,
                                       const float* gi, const float* v,
                                       int t_len, int d_head, int stride,
                                       float inv, float* r_out, int lane) {
  float part = 0.f;
  for (int j = lane; j < t_len; j += 32) {
    const float* vj = v + j * stride;
    float acc = 0.f;
    for (int d = 0; d < d_head; ++d) acc = fmaf(gi[d], vj[d], acc);
    da[j] = acc;
    part += acc * a[j];
  }
  const float r = warp_sum(part);
  if (lane == 0 && r_out) *r_out = r;
  for (int j = lane; j < t_len; j += 32)
    out[j] = round_to<T>((da[j] - r) * a[j] * inv);
}

// The resident kernel (row 4 recomputes a where row 3 stages it).
template <typename T, bool kRecompute>
__global__ void __launch_bounds__(32 * kResidentWarps)
qkv_bwd_resident_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                        const float* __restrict__ probs,
                        const float* __restrict__ mask,
                        const T* __restrict__ g, T* __restrict__ dqkv,
                        int n_heads, int t_len, int d_head, float inv) {
  constexpr int kThreads = 32 * kResidentWarps;
  extern __shared__ float smem[];
  const int row = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int hd = n_heads * d_head;
  const int w3 = 3 * hd;
  const int stride = d_head | 1;  // odd row strides: no bank conflicts
  const int astride = t_len | 1;

  float* q = smem;                   // (T, stride), then k, v, g
  float* k = q + t_len * stride;
  float* v = k + t_len * stride;
  float* gs = v + t_len * stride;
  float* a = gs + t_len * stride;    // (T, astride): a, then ds
  float* darow = a + t_len * astride;  // (kResidentWarps, T) da rows

  const T* src = qkv + (int64_t)row * t_len * w3;
  const int per_part = t_len * d_head;
  for (int idx = threadIdx.x; idx < 3 * per_part; idx += kThreads) {
    const int part = idx / per_part;
    const int rem = idx - part * per_part;
    const int t = rem / d_head;
    const int d = rem - t * d_head;
    const int lane = part * hd + h * d_head + d;
    // the bias add happens at the input dtype, as in the forward; a null
    // bias: qkv carries it
    const float x = to_f32(src[(int64_t)t * w3 + lane]);
    smem[part * t_len * stride + t * stride + d] =
        bias ? round_to<T>(x + to_f32(bias[lane])) : x;
  }
  const T* gsrc = g + (int64_t)row * t_len * hd + h * d_head;
  for (int idx = threadIdx.x; idx < per_part; idx += kThreads) {
    const int t = idx / d_head;
    const int d = idx - t * d_head;
    gs[t * stride + d] = to_f32(gsrc[(int64_t)t * hd + d]);
  }
  if constexpr (kRecompute) {
    __syncthreads();
    const float* mrow = mask ? mask + (int64_t)row * t_len : nullptr;
    // the forward's scale of the scores, computed as the forward does
    const float inv_s = 1.0f / sqrtf((float)d_head);
    for (int i = threadIdx.x / 32; i < t_len; i += kResidentWarps)
      recompute_a_row(a + i * astride, q + i * stride, k, mrow, t_len,
                      d_head, stride, inv_s, nullptr, nullptr,
                      threadIdx.x % 32);
  } else {
    // probs[row, i, h*T + j] = a[i, j]
    const float* psrc = probs + (int64_t)row * t_len * n_heads * t_len +
                        h * t_len;
    for (int idx = threadIdx.x; idx < t_len * t_len; idx += kThreads) {
      const int i = idx / t_len;
      const int j = idx - i * t_len;
      a[i * astride + j] = psrc[(int64_t)i * n_heads * t_len + j];
    }
  }
  __syncthreads();

  T* dst = dqkv + (int64_t)row * t_len * w3 + h * d_head;
  // dv[j, d] = sum_i round(a[i, j]) * g[i, d]
  for (int idx = threadIdx.x; idx < per_part; idx += kThreads) {
    const int j = idx / d_head;
    const int d = idx - j * d_head;
    float acc = 0.f;
    for (int i = 0; i < t_len; ++i)
      acc = fmaf(round_to<T>(a[i * astride + j]), gs[i * stride + d], acc);
    dst[(int64_t)j * w3 + 2 * hd + d] = from_f32<T>(acc);
  }
  __syncthreads();  // a is overwritten with ds below

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* da = darow + warp * t_len;
  for (int i = warp; i < t_len; i += kResidentWarps) {
    // ds_row's arithmetic, written out: through the helper this kernel
    // ran slower on the card at the NRMS shapes
    const float* gi = gs + i * stride;
    float* ai = a + i * astride;
    float part = 0.f;
    for (int j = lane; j < t_len; j += 32) {
      const float* vj = v + j * stride;
      float acc = 0.f;
      for (int d = 0; d < d_head; ++d) acc = fmaf(gi[d], vj[d], acc);
      da[j] = acc;
      part += acc * ai[j];
    }
    const float r = warp_sum(part);
    // each lane rewrites only the entries it read: no sync within the warp
    for (int j = lane; j < t_len; j += 32)
      ai[j] = round_to<T>((da[j] - r) * ai[j] * inv);
  }
  __syncthreads();

  // dq[i, d] = sum_j ds[i, j] k[j, d];  dk[i, d] = sum_j ds[j, i] q[j, d]
  for (int idx = threadIdx.x; idx < per_part; idx += kThreads) {
    const int i = idx / d_head;
    const int d = idx - i * d_head;
    float dq = 0.f, dk = 0.f;
    for (int j = 0; j < t_len; ++j) {
      dq = fmaf(a[i * astride + j], k[j * stride + d], dq);
      dk = fmaf(a[j * astride + i], q[j * stride + d], dk);
    }
    dst[(int64_t)i * w3 + d] = from_f32<T>(dq);
    dst[(int64_t)i * w3 + hd + d] = from_f32<T>(dk);
  }
}

// ---- the short resident kernel (T <= 64, heads of up to 32) ---------------

namespace qb {

constexpr int kShortT = 64;  // longest T of the short kernel
constexpr int kShortD = 32;  // widest head of the short kernel
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 232448;  // what a block may use

// Whether the short kernel takes (T, D); the resident regime's other
// shapes keep qkv_bwd_resident_kernel.
inline bool short_shape(int t_len, int d_head) {
  return t_len <= kShortT && d_head <= kShortD;
}

// 16-byte units of `bytes`, made odd: rows that many units apart put a
// float4 of eight neighbouring rows on 32 banks.
inline int odd_units(int bytes) {
  const int u = (bytes + 15) / 16;
  return u % 2 ? u : u + 1;
}

// The block's layout at (T, D) in a dtype of esize bytes, `heads` heads an
// item: nbuf stage buffers (q, k, v, g rows in the input dtype, row 3's
// probs rows, then the item's three runs of the bias), the f32 rows of q,
// k, v, g (bf16; an f32 stage is its own), then round(a), ds and ds^T,
// each (heads, T, ts) f32.
struct Shape {
  int dm;         // head pitch of an f32 row: core_dm(D)
  int rsf;        // floats between two f32 rows
  int rsr;        // elements between two staged rows of q, k, v, g
  int prs;        // floats between two staged probs rows
  int ts;         // floats between two rows of a (T, T) array
  int brs;        // elements between two staged runs of the bias
  size_t stage;   // bytes of one stage buffer
  size_t work;    // bytes of the f32 rows (bf16 only)
  size_t arrays;  // bytes of round(a), ds, ds^T
};

inline Shape shape_of(int t_len, int d_head, int esize, int heads,
                      bool probs) {
  Shape s;
  s.dm = core_dm(d_head);
  s.rsf = odd_units(heads * s.dm * 4) * 4;
  s.rsr = esize == 4 ? s.rsf
                     : odd_units(heads * d_head * esize) * 16 / esize;
  s.prs = (heads * t_len + 3) / 4 * 4;
  s.ts = (t_len + 3) / 4 * 4;
  s.brs = (heads * d_head * esize + 15) / 16 * 16 / esize;
  s.stage = (size_t)4 * t_len * s.rsr * esize +
            (probs ? (size_t)t_len * s.prs * 4 : 0) +
            (size_t)3 * s.brs * esize;
  s.work = esize == 2 ? (size_t)4 * t_len * s.rsf * 4 : 0;
  s.arrays = (size_t)3 * heads * t_len * s.ts * 4;
  return s;
}

inline size_t smem_bytes(const Shape& s, int nbuf) {
  return nbuf * s.stage + s.work + s.arrays;
}

struct Params {
  int n, t, h, d;       // batch rows, positions, heads, head width
  int heads, groups;    // heads of an item; items of a batch row
  int items, nbuf;      // n * groups; stage buffers
  int dm, rsf, rsr;     // Shape's
  int prs, ts, brs;
  int chunk, pchunk;    // bytes of one cp.async of q/k/v/g, of probs rows
  int bchunk;           // of the bias runs; -1: no bias
  int vec;              // four outputs a store (D % 4 == 0, aligned dqkv)
  size_t stage, work;   // Shape's
  float inv;            // 1/sqrt(D) for ds, rounded once from double
};

struct Item {
  int64_t n;
  int h0, gn;  // first head, heads
};

__device__ __forceinline__ Item item_of(const Params& p, int item) {
  Item it;
  it.n = item / p.groups;
  it.h0 = (item - (int)it.n * p.groups) * p.heads;
  it.gn = min(p.heads, p.h - it.h0);
  return it;
}

// x and y rounded to T (bf16: one packed conversion).
template <typename T>
__device__ __forceinline__ void round_two(float& x, float& y) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    const unsigned u = *reinterpret_cast<const unsigned*>(&v);
    x = __uint_as_float(u << 16);
    y = __uint_as_float(u & 0xffff0000u);
  }
}

// One piece of each staged row: `rows` rows from src (rows srs elements
// apart) to dst (rows drs apart), a cp.async of `chunk` bytes (an element
// copy when 0).
template <typename T>
__device__ __forceinline__ void copy_piece(T* dst, int drs,
                                           const T* __restrict__ src,
                                           int64_t srs, int r0, int rows,
                                           int rstep, int chunk) {
  for (int r = r0; r < rows; r += rstep) {
    if (chunk == 16) cp_async<16>(dst + r * drs, src + r * srs);
    else if (chunk == 8) cp_async<8>(dst + r * drs, src + r * srs);
    else if (chunk == 4) cp_async<4>(dst + r * drs, src + r * srs);
    else dst[r * drs] = src[r * srs];
  }
}

// The stage buffer's probs rows and bias runs.
template <typename T>
__device__ __forceinline__ float* probs_of(unsigned char* buf,
                                           const Params& p) {
  return reinterpret_cast<float*>(buf + (size_t)4 * p.t * p.rsr * sizeof(T));
}

template <typename T, bool kProbs>
__device__ __forceinline__ T* bias_of(unsigned char* buf, const Params& p) {
  return reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(
      probs_of<T>(buf, p) + (kProbs ? p.t * p.prs : 0)));
}

// Item `it`'s q, k, v and g rows (f32: each head's D floats at dm floats
// of the row, which is then the f32 row the products read; bf16: one run
// of the item's heads, widened later), row 3's probs rows (the heads' run
// of T-float rows) and, unless there is none, the bias of its heads (three
// runs, q's, k's, v's, as rows) into the stage buffer at buf. The pieces
// of a row are columns: each thread keeps one column and walks the rows
// (or, past kThreads columns, takes every kThreads-th column and all
// rows).
template <typename T, bool kProbs>
__device__ __forceinline__ void stage_item(unsigned char* buf, const Item& it,
                                           const T* __restrict__ qkv,
                                           const T* __restrict__ bias,
                                           const T* __restrict__ g,
                                           const float* __restrict__ probs,
                                           const Params& p) {
  constexpr bool kRun = sizeof(T) == 2;
  T* s = reinterpret_cast<T*>(buf);
  float* ps = probs_of<T>(buf, p);
  const int hd = p.h * p.d;
  const int64_t row0 = it.n * p.t;
  const int step = p.chunk ? p.chunk / (int)sizeof(T) : 1;
  const int per = (kRun ? it.gn * p.d : p.d) / step;  // pieces of a run
  const int qcols = (kRun ? 1 : it.gn) * per;         // of a q/k/v/g row
  const int pstep = p.pchunk ? p.pchunk / 4 : 1;
  const int pcols = kProbs ? it.gn * p.t / pstep : 0;
  const int bstep = p.bchunk > 0 ? p.bchunk / (int)sizeof(T) : 1;
  const int bcols = p.bchunk < 0 ? 0 : it.gn * p.d / bstep;
  // the bias runs take the first columns: three rows each
  if (threadIdx.x < bcols) {
    const int e = threadIdx.x * bstep;
    copy_piece(bias_of<T, kProbs>(buf, p) + e, p.brs,
               bias + it.h0 * p.d + e, hd, 0, 3, 1,
               p.bchunk > 0 ? p.bchunk : 0);
  }
  const int cols = 4 * qcols + pcols;
  int c0 = threadIdx.x, cstep = kThreads, r0 = 0, rstep = 1;
  if (cols <= kThreads) {
    rstep = kThreads / cols;
    r0 = threadIdx.x / cols;
    if (r0 >= rstep) return;
    c0 = threadIdx.x - r0 * cols;
    cstep = cols;
  }
  for (int c = c0; c < cols; c += cstep) {
    if (c >= 4 * qcols) {  // probs[n, i, h*T + j] = a[i, j] of head h
      const int e = (c - 4 * qcols) * pstep;
      copy_piece(ps + e, p.prs, probs + row0 * p.h * p.t + it.h0 * p.t + e,
                 (int64_t)p.h * p.t, r0, p.t, rstep, p.pchunk);
      continue;
    }
    const int part = c / qcols;  // q, k, v, then g
    const int rest = c - part * qcols;
    const int u = rest / per;  // f32: the head
    const int e = (rest - u * per) * step;
    const T* src = part < 3 ? qkv + row0 * 3 * hd + part * hd
                            : g + row0 * hd;
    copy_piece(s + part * p.t * p.rsr + u * p.dm + e, p.rsr,
               src + (it.h0 + u) * p.d + e, part < 3 ? 3 * hd : hd, r0, p.t,
               rstep, p.chunk);
  }
}

// bf16: the f32 rows of q, k, v (with the bias `bs`, the staged runs, or
// none when null: round(x + b) at the input dtype, as the forward adds it)
// and g from the staged run, pads 0. Each thread keeps one (part, head,
// four lanes) column, its bias in registers, and walks the rows.
template <typename T>
__device__ __forceinline__ void widen_item(float* w, const T* s,
                                           const T* bs, const Item& it,
                                           const Params& p) {
  const int quads = p.dm / 4;
  const int cols = 4 * it.gn * quads;
  const int rstep = kThreads / cols;
  const int r0 = threadIdx.x / cols;
  if (r0 >= rstep) return;
  const int col = threadIdx.x - r0 * cols;
  const int part = col / (it.gn * quads);
  const int rest = col - part * it.gn * quads;
  const int hl = rest / quads;
  const int d0 = (rest - hl * quads) * 4;
  const bool add = bs != nullptr && part < 3;
  float b[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    b[e] = add && d0 + e < p.d ? to_f32(bs[part * p.brs + hl * p.d + d0 + e])
                               : 0.f;
  const T* src = s + part * p.t * p.rsr + hl * p.d + d0;
  float* dst = w + part * p.t * p.rsf + hl * p.dm + d0;
  // four elements in one 8-byte load where D % 4 == 0 (bf16 rows are
  // 16-byte aligned, a head's four lanes then 8)
  const bool vec = sizeof(T) == 2 && p.d % 4 == 0 && d0 + 4 <= p.d;
#pragma unroll 4
  for (int r = r0; r < p.t; r += rstep) {
    float f[4];
    if (vec) {
      const uint2 u = *reinterpret_cast<const uint2*>(src + r * p.rsr);
      f[0] = __uint_as_float(u.x << 16);
      f[1] = __uint_as_float(u.x & 0xffff0000u);
      f[2] = __uint_as_float(u.y << 16);
      f[3] = __uint_as_float(u.y & 0xffff0000u);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = d0 + e < p.d ? to_f32(src[r * p.rsr + e]) : 0.f;
    }
    if (add) {  // the pads add 0 and stay 0
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] += b[e];
      round_two<T>(f[0], f[1]);
      round_two<T>(f[2], f[3]);
    }
    *reinterpret_cast<float4*>(dst + r * p.rsf) =
        make_float4(f[0], f[1], f[2], f[3]);
  }
}

// f32: the bias (the staged runs bs) added in place to the staged q, k, v
// (pads add 0).
__device__ __forceinline__ void bias_in_place(float* s, const float* bs,
                                              const Item& it,
                                              const Params& p) {
  const int quads = p.dm / 4;
  const int cols = 3 * it.gn * quads;
  const int rstep = kThreads / cols;
  const int r0 = threadIdx.x / cols;
  if (r0 >= rstep) return;
  const int col = threadIdx.x - r0 * cols;
  const int part = col / (it.gn * quads);
  const int rest = col - part * it.gn * quads;
  const int hl = rest / quads;
  const int d0 = (rest - hl * quads) * 4;
  float b[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    b[e] = d0 + e < p.d ? bs[part * p.brs + hl * p.d + d0 + e] : 0.f;
  float* x = s + part * p.t * p.rsr + hl * p.dm + d0;
#pragma unroll 4
  for (int r = r0; r < p.t; r += rstep) {
    float4 v = *reinterpret_cast<float4*>(x + r * p.rsr);
    v.x += b[0];
    v.y += b[1];
    v.z += b[2];
    v.w += b[3];
    *reinterpret_cast<float4*>(x + r * p.rsr) = v;
  }
}

// A lane's keys j = lane + 32k (k < NS) of one head: their f32 rows (DM
// floats, from `rows` at head offset 0) in registers, 0 past T.
template <int DM, int NS>
__device__ __forceinline__ void load_keys(float (&x)[NS][DM],
                                          const float* rows, int rsf, int t,
                                          int lane) {
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int j = lane + 32 * k;
#pragma unroll
    for (int c = 0; c < DM / 4; ++c) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < t) v = *reinterpret_cast<const float4*>(rows + j * rsf + 4 * c);
      x[k][4 * c] = v.x;
      x[k][4 * c + 1] = v.y;
      x[k][4 * c + 2] = v.z;
      x[k][4 * c + 3] = v.w;
    }
  }
}

// acc[r][k] = row_r . key_k for R rows (rows[r], broadcast to the warp)
// and the lane's NS keys, each sum in d order from 0 (the pads add exact
// zeros).
template <int DM, int NS, int R>
__device__ __forceinline__ void dots(float (&acc)[R][NS],
                                     const float* const (&rows)[R],
                                     const float (&keys)[NS][DM]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[r][k] = 0.f;
#pragma unroll
  for (int c = 0; c < DM / 4; ++c) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(rows[r] + 4 * c);
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int k = 0; k < NS; ++k)
          acc[r][k] = fmaf(x[e], keys[k][4 * c + e], acc[r][k]);
    }
  }
}

// Rows a warp takes at once in phase A: their dots, and the xor trees of
// their warp sums and maxes, are interleaved (each tree in warp_sum's
// order), so one row's chain of shuffles waits on no other's.
template <int NS>
__host__ __device__ constexpr int batch_rows() {
  return NS == 1 ? 5 : 3;
}

// Phase A's split: the item's (head, row) pairs, head by head, each warp a
// run of them as even as the count allows, cut into batches of at most RB
// rows of one head. for_batches calls head(hl) when a warp's run enters
// head hl, then batch(hl, i, n) for rows i .. i + n - 1 of it.
template <int RB, typename Head, typename Batch>
__device__ __forceinline__ void for_batches(int gn, const Params& p,
                                            int warp, Head head,
                                            Batch batch) {
  const int rows = gn * p.t;
  int lo = warp * rows / kWarps;
  const int hi = (warp + 1) * rows / kWarps;
  int hl = -1;
  while (lo < hi) {
    const int h = lo / p.t;
    const int i = lo - h * p.t;
    const int n = min(RB, min(hi - lo, p.t - i));
    if (h != hl) head(hl = h);
    batch(h, i, n);
    lo += n;
  }
}

// The xor trees of warp_sum (or warp_max with kMax) over R values at once.
template <int R, bool kMax>
__device__ __forceinline__ void warp_trees(float (&v)[R]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = __shfl_xor_sync(0xffffffffu, v[r], o);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = kMax ? fmaxf(v[r], x[r]) : v[r] + x[r];
  }
}

// Row 4, one warp: a's rows i .. i + n - 1 (n <= RB) of one head, the
// lane's keys of each into av, each as recompute_a_row computes it (s
// summed in d order and scaled, m over ALL keys, e = exp(s - m) times the
// mask, den summed by lane then the xor tree, plus 1e-8 exp(-m); a = e /
// den), from q's rows and the lane's key rows of K in registers (kr).
template <int DM, int NS, int RB>
__device__ __forceinline__ void recompute_rows(float (&av)[RB][NS],
                                               const float* q,
                                               const float (&kr)[NS][DM],
                                               const float (&mk)[NS],
                                               bool masked, int i, int n,
                                               float inv_s, const Params& p,
                                               int lane) {
  const float* rows[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) rows[r] = q + (i + min(r, n - 1)) * p.rsf;
  float s[RB][NS];
  dots<DM, NS, RB>(s, rows, kr);
  float mx[RB], sum[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    mx[r] = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      if (lane + 32 * kk < p.t) {
        s[r][kk] = __fmul_rn(s[r][kk], inv_s);
        mx[r] = fmaxf(mx[r], s[r][kk]);
      }
  }
  warp_trees<RB, true>(mx);
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    sum[r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      if (lane + 32 * kk < p.t) {
        float e = expf(s[r][kk] - mx[r]);
        if (masked) e = __fmul_rn(e, mk[kk]);
        s[r][kk] = e;
        sum[r] += e;
      }
  }
  warp_trees<RB, false>(sum);
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const float den = sum[r] + kEps * expf(-mx[r]);
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      av[r][kk] = lane + 32 * kk < p.t && r < n && den > 0.f
                      ? s[r][kk] / den
                      : 0.f;
  }
}

// Row 3, one warp: the lane's keys of a's rows i .. i + n - 1 (n <= RB)
// of one head into av, from the staged probs (rows `as` apart), 0 past T.
template <int NS, int RB>
__device__ __forceinline__ void probs_rows(float (&av)[RB][NS],
                                           const float* a, int as, int i,
                                           int n, const Params& p,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const int j = lane + 32 * kk;
      av[r][kk] = j < p.t && r < n ? a[(i + r) * as + j] : 0.f;
    }
}

// One warp: for rows i .. i + n - 1 (n <= RB) of one head and the lane's
// keys of their a (av), da = g_i v^T (the lane's key rows of V in
// registers, vr), r = rowsum(da * a) (each lane's keys in order, then the
// xor tree), ds = round((da - r) * a / sqrt(D)) into ds (rows ts apart)
// and ds^T, and round(a) into ra.
template <typename T, int DM, int NS, int RB>
__device__ __forceinline__ void ds_rows(float* ra, float* ds, float* dst,
                                        const float (&av)[RB][NS],
                                        const float* g,
                                        const float (&vr)[NS][DM], int i,
                                        int n, const Params& p, int lane) {
  const float* rows[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) rows[r] = g + (i + min(r, n - 1)) * p.rsf;
  float da[RB][NS];
  dots<DM, NS, RB>(da, rows, vr);
  float part[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    part[r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      if (lane + 32 * kk < p.t) part[r] = fmaf(da[r][kk], av[r][kk], part[r]);
  }
  warp_trees<RB, false>(part);
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const int j = lane + 32 * kk;
      float x = (da[r][kk] - part[r]) * av[r][kk] * p.inv;
      float y = av[r][kk];
      round_two<T>(x, y);
      if (j < p.t && r < n) {
        ds[(i + r) * p.ts + j] = x;
        dst[j * p.ts + i + r] = x;
        ra[(i + r) * p.ts + j] = y;
      }
    }
}

// Four outputs of one row at o (lanes d0 .. d0 + 3 of a head of D).
__device__ __forceinline__ void store4(float* o, const float* x, int d0,
                                       const Params& p) {
  if (p.vec) {
    *reinterpret_cast<float4*>(o) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (d0 + e < p.d) o[e] = x[e];
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, const float* x,
                                       int d0, const Params& p) {
  if (p.vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(o) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (d0 + e < p.d) o[e] = __float2bfloat16_rn(x[e]);
}

// Phase B: dq = ds k, dk = ds^T q and dv = round(a)^T g of the item's
// heads, threads by (product, head, four rows, four lanes), each of the 16
// sums in index order over T, from a float4 of the (T, T) array (ds^T, ds
// or round(a): the rows a sum runs over) and one of the f32 rows (k, q or
// g); four outputs a store.
template <typename T>
__device__ __forceinline__ void sum_products(T* __restrict__ dqkv,
                                             const float* arr,
                                             const float* w, const Item& it,
                                             const Params& p) {
  const int ndt = (p.d + 3) / 4;
  const int per_head = (p.t + 3) / 4 * ndt;
  const int per_prod = it.gn * per_head;
  const int tt = p.t * p.ts;
  const int hd = p.h * p.d;
  for (int task = threadIdx.x; task < 3 * per_prod; task += kThreads) {
    const int prod = task / per_prod;  // 0 dq, 1 dk, 2 dv: dqkv's parts
    int rest = task - prod * per_prod;
    const int hl = rest / per_head;
    rest -= hl * per_head;
    const int rt = rest / ndt;
    const int dt = rest - rt * ndt;
    const int which = prod == 0 ? 2 : prod == 1 ? 1 : 0;
    const int part = prod == 0 ? 1 : prod == 1 ? 0 : 3;
    const float* A = arr + (which * p.heads + hl) * tt + 4 * rt;
    const float* B = w + part * p.t * p.rsf + hl * p.dm + 4 * dt;
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
#pragma unroll 4
    for (int u = 0; u < p.t; ++u) {
      const float4 a4 = *reinterpret_cast<const float4*>(A + u * p.ts);
      const float4 b4 = *reinterpret_cast<const float4*>(B + u * p.rsf);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
    }
    const int d0 = 4 * dt;
    T* o = dqkv + (it.n * p.t + 4 * rt) * 3 * hd + prod * hd +
           (it.h0 + hl) * p.d + d0;
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (4 * rt + x < p.t) store4(o + (int64_t)x * 3 * hd, acc[x], d0, p);
  }
}

// Blocks an SM the short kernel is built for: three for row 3; two for
// row 4, whose second pass over the rows (a, then ds) needs the registers
// (held to three, it spilled and ran slower on an H100).
__host__ __device__ constexpr int blocks_per_sm(bool recompute) {
  return recompute ? 2 : 3;
}

// The short kernel (row 4 recomputes a where row 3 stages it); bias may be
// null (qkv carries its bias).
template <typename T, int DM, int NS, bool kRecompute>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kRecompute))
qkv_bwd_short_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                     const float* __restrict__ probs,
                     const float* __restrict__ mask,
                     const T* __restrict__ g, T* __restrict__ dqkv,
                     Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kWiden = sizeof(T) == 2;
  const size_t staged = p.nbuf * p.stage;
  float* arr = reinterpret_cast<float*>(smem + staged + p.work);
  const int tt = p.t * p.ts;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  auto stage = [&](int item, int b) {
    stage_item<T, !kRecompute>(smem + b * p.stage, item_of(p, item), qkv,
                               bias, g, probs, p);
  };
  auto compute = [&](int item, int b) {
    const Item it = item_of(p, item);
    unsigned char* buf = smem + b * p.stage;
    float* w;
    const T* bs = bias ? bias_of<T, !kRecompute>(buf, p) : nullptr;
    if constexpr (kWiden) {
      w = reinterpret_cast<float*>(smem + staged);
      widen_item(w, reinterpret_cast<const T*>(buf), bs, it, p);
    } else {
      w = reinterpret_cast<float*>(buf);
      if (bias) bias_in_place(w, bs, it, p);
    }
    __syncthreads();  // the f32 rows are in
    // phase A: round(a), ds and ds^T of every (head, row), a warp a run of
    // rows in batches (for_batches), its key rows in registers: row 3
    // reads a from the staged probs, row 4 recomputes it (K's key rows too)
    constexpr int RB = batch_rows<NS>();
    float* ra = arr;
    float* ds = ra + p.heads * tt;
    float* dst = ds + p.heads * tt;
    float vr[NS][DM];
    if constexpr (kRecompute) {
      float mk[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int j = lane + 32 * k;
        mk[k] = mask && j < p.t ? mask[it.n * p.t + j] : 1.f;
      }
      // the forward's scale of the scores, computed as the forward does
      const float inv_s = 1.0f / sqrtf((float)p.d);
      float kr[NS][DM];
      for_batches<RB>(
          it.gn, p, warp,
          [&](int hl) {
            load_keys<DM, NS>(kr, w + p.t * p.rsf + hl * p.dm, p.rsf, p.t,
                              lane);
            load_keys<DM, NS>(vr, w + 2 * p.t * p.rsf + hl * p.dm, p.rsf,
                              p.t, lane);
          },
          [&](int hl, int i, int n) {
            float av[RB][NS];
            recompute_rows<DM, NS, RB>(av, w + hl * p.dm, kr, mk,
                                       mask != nullptr, i, n, inv_s, p,
                                       lane);
            ds_rows<T, DM, NS, RB>(ra + hl * tt, ds + hl * tt, dst + hl * tt,
                                   av, w + 3 * p.t * p.rsf + hl * p.dm, vr,
                                   i, n, p, lane);
          });
    } else {
      const float* a = probs_of<T>(buf, p);
      for_batches<RB>(
          it.gn, p, warp,
          [&](int hl) {
            load_keys<DM, NS>(vr, w + 2 * p.t * p.rsf + hl * p.dm, p.rsf,
                              p.t, lane);
          },
          [&](int hl, int i, int n) {
            float av[RB][NS];
            probs_rows<NS, RB>(av, a + hl * p.t, p.prs, i, n, p, lane);
            ds_rows<T, DM, NS, RB>(ra + hl * tt, ds + hl * tt, dst + hl * tt,
                                   av, w + 3 * p.t * p.rsf + hl * p.dm, vr,
                                   i, n, p, lane);
          });
    }
    __syncthreads();  // every row of round(a), ds and ds^T is written
    sum_products<T>(dqkv, arr, w, it, p);
  };
  // block b takes items b, b + gridDim.x, ...; past T the (T, T) arrays'
  // rows and columns are never written, and only sums whose outputs are
  // dropped read them
  bl::walk_items(p, smem, (int)blockIdx.x,
                 [](int item) { return item + (int)gridDim.x; }, stage,
                 compute);
}

// The largest of 16, 8, 4 bytes that divides every size and base address
// (0: element copies).
inline int copy_bytes(std::initializer_list<int64_t> sizes,
                      std::initializer_list<const void*> bases) {
  for (int c = 16; c >= 4; c /= 2) {
    bool ok = true;
    for (int64_t s : sizes) ok = ok && s % c == 0;
    for (const void* b : bases) ok = ok && (uintptr_t)b % c == 0;
    if (ok) return c;
  }
  return 0;
}

template <typename T, bool kRecompute>
struct ShortLaunch {
  const T *qkv, *bias;
  const float *probs, *mask;
  const T* g;
  T* dqkv;
  Params p;
  size_t smem;
  unsigned blocks;
  cudaStream_t stream;

  template <int DM, int NS>
  int go() const {
    auto* kernel = qkv_bwd_short_kernel<T, DM, NS, kRecompute>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kThreads, smem, stream>>>(qkv, bias, probs, mask, g,
                                               dqkv, p);
    return (int)cudaGetLastError();
  }

  template <int DM>
  int at_width() const {
    return p.t <= 32 ? go<DM, 1>() : go<DM, 2>();
  }

  int operator()() const {
    switch (p.dm) {
      case 8: return at_width<8>();
      case 16: return at_width<16>();
      case 20: return at_width<20>();
      case 24: return at_width<24>();
      case 32: return at_width<32>();
      default: return (int)cudaErrorInvalidValue;
    }
  }
};

// The short kernel under the plan (heads, nbuf, blocks, threads, shared
// bytes, 0) of ops/fused_attention.py:bwd_launch_plan; refuses a plan it
// does not take. bias may be null.
template <typename T, bool kRecompute>
int short_launch(const void* qkv, const void* bias, const void* probs,
                 const void* mask, const void* g, void* dqkv, int n,
                 int t_len, int n_heads, int d_head, const int* pl,
                 void* stream) {
  const int esize = (int)sizeof(T);
  if (pl == nullptr) return (int)cudaErrorInvalidValue;
  const int heads = pl[0], nbuf = pl[1], blocks = pl[2];
  if (heads < 1 || heads > 8 || heads > n_heads || nbuf < 1 ||
      nbuf > 2 || blocks < 1 || pl[3] != kThreads || pl[5] != 0)
    return (int)cudaErrorInvalidValue;
  const Shape s = shape_of(t_len, d_head, esize, heads, !kRecompute);
  const size_t smem = smem_bytes(s, nbuf);
  if (smem > (size_t)kMaxSmem || (size_t)pl[4] != smem)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.n = n;
  p.t = t_len;
  p.h = n_heads;
  p.d = d_head;
  p.heads = heads;
  p.groups = (n_heads + heads - 1) / heads;
  const int64_t items = (int64_t)n * p.groups;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  p.items = (int)items;
  p.nbuf = nbuf;
  p.dm = s.dm;
  p.rsf = s.rsf;
  p.rsr = s.rsr;
  p.prs = s.prs;
  p.ts = s.ts;
  p.brs = s.brs;
  p.stage = s.stage;
  p.work = s.work;
  const int64_t hd = (int64_t)n_heads * d_head;
  const int64_t last = n_heads % heads;  // heads of a short last item
  // f32 copies each head (D floats) to its dm-float slot; bf16 one run of
  // the item's heads
  p.chunk = esize == 4
                ? copy_bytes({d_head * 4, hd * 4}, {qkv, g})
                : copy_bytes({heads * d_head * 2, last * d_head * 2, hd * 2},
                             {qkv, g});
  p.pchunk = kRecompute ? 0
                        : copy_bytes({(int64_t)heads * t_len * 4,
                                      last * t_len * 4,
                                      (int64_t)n_heads * t_len * 4},
                                     {probs});
  p.bchunk = bias == nullptr
                ? -1
                : copy_bytes({(int64_t)heads * d_head * esize,
                              last * d_head * esize, hd * esize},
                             {bias});
  p.vec = d_head % 4 == 0 && (uintptr_t)dqkv % 16 == 0;
  // 1/sqrt(D) for ds, rounded once from double, as the plain version's
  // scalar is
  p.inv = (float)(1.0 / sqrt((double)d_head));
  return ShortLaunch<T, kRecompute>{
      static_cast<const T*>(qkv),   static_cast<const T*>(bias),
      static_cast<const float*>(probs), static_cast<const float*>(mask),
      static_cast<const T*>(g),     static_cast<T*>(dqkv),
      p,                            smem,
      (unsigned)(blocks < p.items ? blocks : p.items),
      (cudaStream_t)stream}();
}

}  // namespace qb

// The tiled kernel: T past what the resident kernel holds in f32 or at
// D > 64 (kGlobal: its whole working set in gstage, none in shared memory).
template <typename T, bool kRecompute, bool kGlobal>
__global__ void __launch_bounds__(32 * kTiledWarps)
qkv_bwd_tiled_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                     const float* __restrict__ probs,
                     const float* __restrict__ mask, const T* __restrict__ g,
                     T* __restrict__ dqkv, int n_heads, int t_len,
                     int d_head, int tile_rows, float inv, int64_t n_items,
                     float* gstage) {
  constexpr int warps = kTiledWarps;
  constexpr int kThreads = 32 * kTiledWarps;
  extern __shared__ float smem[];
  const int hd = n_heads * d_head;
  const int w3 = 3 * hd;
  const int stride = d_head | 1;  // odd row strides: no bank conflicts
  const int tstride = t_len | 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // q, k, v and g, then the rest, in shared memory or in this block's slot
  // of gstage
  float* q = kGlobal ? gstage + (int64_t)blockIdx.x *
                                    qkv_bwd_global_floats(t_len, d_head)
                     : smem;  // (T, stride), then k, v, g
  float* k = q + t_len * stride;
  float* v = k + t_len * stride;
  float* gs = v + t_len * stride;
  float* rest = gs + t_len * stride;
  float* wrow = rest + warp * t_len;   // this warp's buffer
  float* tile = rest + warps * t_len;  // (tile_rows, tstride)
  // the row stats, after the tile: rowsum(da * a), and (row 4) the row's
  // max and denominator
  float* rs = tile + tile_rows * tstride;
  float* ms = rs + t_len;
  float* dens = ms + t_len;

  // one (row, head) item per block, or, staged in global memory, a grid of
  // slots walking the items
  auto body = [&](int64_t item) {
    const int64_t row = item / n_heads;
    const int h = (int)(item % n_heads);

    // staging: all threads over (t, d) of each operand, loads unrolled so
    // that several are in flight at once
    const T* src = qkv + (int64_t)row * t_len * w3 + h * d_head;
    const T* gsrc = g + (int64_t)row * t_len * hd + h * d_head;
    const int per_part = t_len * d_head;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < 4 * per_part; idx += kThreads) {
      const int part = idx / per_part;  // q, k, v, then g
      const int rem = idx - part * per_part;
      const int t = rem / d_head;
      const int d = rem - t * d_head;
      // the bias add happens at the input dtype, as in the forward
      q[(part * t_len + t) * stride + d] =
          part < 3 ? round_to<T>(to_f32(src[(int64_t)t * w3 + part * hd + d]) +
                                 to_f32(bias[part * hd + h * d_head + d]))
                   : to_f32(gsrc[(int64_t)t * hd + d]);
    }
    // probs[row, i, h*T + j] = a[i, j]
    const int64_t pstride = (int64_t)n_heads * t_len;
    const float* prow0 = kRecompute ? nullptr
                                    : probs + (int64_t)row * t_len * pstride +
                                          h * t_len;
    __syncthreads();

    const float* mrow = mask ? mask + (int64_t)row * t_len : nullptr;
    // the forward's scale of the scores, computed as the forward does
    const float inv_s = 1.0f / sqrtf((float)d_head);
    T* dst = dqkv + (int64_t)row * t_len * w3 + h * d_head;

    // ---- query tiles: ds's rows, then dq --------------------------------
    for (int i0 = 0; i0 < t_len; i0 += tile_rows) {
      const int nq = min(tile_rows, t_len - i0);
      for (int ii = warp; ii < nq; ii += warps) {
        const int i = i0 + ii;
        if constexpr (kRecompute) {
          recompute_a_row(wrow, q + i * stride, k, mrow, t_len, d_head, stride,
                          inv_s, ms + i, dens + i, lane);
        } else {
          for (int j = lane; j < t_len; j += 32) wrow[j] = prow0[i * pstride + j];
        }
        float* dsi = tile + ii * tstride;  // da's row, then ds's
        ds_row<T>(dsi, wrow, dsi, gs + i * stride, v, t_len, d_head, stride,
                  inv, rs + i, lane);
        __syncwarp();  // the next query overwrites wrow
      }
      __syncthreads();
      // dq[i, d] = sum_j ds[i, j] k[j, d]
      for (int idx = threadIdx.x; idx < nq * d_head; idx += kThreads) {
        const int ii = idx / d_head;
        const int d = idx - ii * d_head;
        const float* dsi = tile + ii * tstride;
        float acc = 0.f;
        for (int j = 0; j < t_len; ++j) acc = fmaf(dsi[j], k[j * stride + d], acc);
        dst[(int64_t)(i0 + ii) * w3 + d] = from_f32<T>(acc);
      }
      __syncthreads();  // the next tile overwrites this one
    }

    // ---- key tiles: a's and ds's columns, then dv and dk -----------------
    const int tk = tile_rows / 2;
    float* a_cols = tile;                  // (tk, tstride) round(a)
    float* ds_cols = tile + tk * tstride;  // (tk, tstride) ds
    for (int j0 = 0; j0 < t_len; j0 += tk) {
      const int nk = min(tk, t_len - j0);
      for (int idx = threadIdx.x; idx < nk * t_len; idx += kThreads) {
        const int jj = idx / t_len;
        const int i = idx - jj * t_len;
        const int j = j0 + jj;
        float a;
        if constexpr (kRecompute) {
          const float* qi = q + i * stride;
          const float* kj = k + j * stride;
          float acc = 0.f;
          for (int d = 0; d < d_head; ++d) acc = fmaf(qi[d], kj[d], acc);
          float e = expf(__fmul_rn(acc, inv_s) - ms[i]);
          if (mrow) e *= mrow[j];
          a = dens[i] > 0.f ? e / dens[i] : 0.f;
        } else {
          a = prow0[i * pstride + j];
        }
        const float* gi = gs + i * stride;
        const float* vj = v + j * stride;
        float da = 0.f;
        for (int d = 0; d < d_head; ++d) da = fmaf(gi[d], vj[d], da);
        a_cols[jj * tstride + i] = round_to<T>(a);  // a in g's dtype, for dv
        ds_cols[jj * tstride + i] = round_to<T>((da - rs[i]) * a * inv);
      }
      __syncthreads();
      // dv[j, d] = sum_i round(a[i, j]) g[i, d];  dk[j, d] = sum_i ds[i, j] q[i, d]
      for (int idx = threadIdx.x; idx < nk * d_head; idx += kThreads) {
        const int jj = idx / d_head;
        const int d = idx - jj * d_head;
        const float* aj = a_cols + jj * tstride;
        const float* dsj = ds_cols + jj * tstride;
        float dv = 0.f, dk = 0.f;
        for (int i = 0; i < t_len; ++i) {
          dv = fmaf(aj[i], gs[i * stride + d], dv);
          dk = fmaf(dsj[i], q[i * stride + d], dk);
        }
        const int64_t o = (int64_t)(j0 + jj) * w3 + d;
        dst[o + hd] = from_f32<T>(dk);
        dst[o + 2 * hd] = from_f32<T>(dv);
      }
      __syncthreads();
    }
  };
  if constexpr (kGlobal) {
    for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x)
      body(item);  // ends with a __syncthreads
  } else {
    body(blockIdx.x);
  }
}

// What a launch of rows 3-4 is given beside its operands: the plan
// (ops/fused_attention.py:bwd_launch_plan): resident (heads an item,
// buffers, blocks, threads, shared bytes, 0), on tensor cores the tile,
// chunk and buffers of the query side, then of the key side; the scratch
// of the regime: `biased` (N, T, 3HD) bf16 for the biased qkv and `stats`
// (3, N*H, T) f32 (tensor cores; biased unused when qkv_biased, the
// caller's qkv carrying its bias already), `gstage` with `slots` slots of
// qkv_bwd_global_floats (the tiled kernel in global memory). A plan or
// scratch the regime needs and does not get is refused
// (cudaErrorInvalidValue).
struct QkvBwdWork {
  const int* plan;  // 6 ints
  void* biased;
  float* stats;
  float* gstage;
  int slots;
  bool qkv_biased;
};

template <typename T, bool kRecompute>
int qkv_bwd_launch(const void* qkv, const void* bias, const void* probs,
                   const void* mask, const void* g, void* dqkv, int n,
                   int t_len, int n_heads, int d_head, void* stream,
                   const QkvBwdWork& w) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (int64_t)n * n_heads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const int regime = qkv_bwd_regime(t_len, d_head, (int)sizeof(T));
  // 1/sqrt(D) for ds, rounded once from double, as the plain version's
  // scalar is
  const float inv = (float)(1.0 / sqrt((double)d_head));
  const auto* x = static_cast<const T*>(qkv);
  const auto* b = static_cast<const T*>(bias);
  const auto* p = static_cast<const float*>(probs);
  const auto* m = static_cast<const float*>(mask);
  const auto* gg = static_cast<const T*>(g);
  auto* out = static_cast<T*>(dqkv);
  auto* cs = (cudaStream_t)stream;
  cudaError_t err;
  if (regime == kQkvMma) {
    if constexpr (!std::is_same<T, __nv_bfloat16>::value) {
      return (int)cudaErrorInvalidValue;
    } else {
      const int* pl = w.plan;
      if (pl == nullptr || w.stats == nullptr ||
          (!w.qkv_biased && (w.biased == nullptr || b == nullptr)) ||
          !qkv_bwd_mma_plan_ok(kRecompute, d_head, pl[0], pl[1], pl[2],
                               pl[3], pl[4], pl[5]))
        return (int)cudaErrorInvalidValue;
      const T* src = x;
      if (!w.qkv_biased) {
        const int64_t total = (int64_t)n * t_len * 3 * n_heads * d_head;
        const int64_t want = (total + 255) / 256;
        auto* biased = static_cast<T*>(w.biased);
        qkv_bias_kernel<<<(unsigned)(want < 4096 ? want : 4096), 256, 0,
                          cs>>>(x, b, biased, total, 3 * n_heads * d_head);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        src = biased;
      }
      return with_head_width(
          d_head, QkvBwdMmaLaunch{src, p, m, gg, out, w.stats, n, t_len,
                                  n_heads, d_head, pl[0], pl[1], pl[2], pl[3],
                                  pl[4], pl[5], kRecompute, cs});
    }
  }
  if (regime == kQkvResident) {
    if (qb::short_shape(t_len, d_head))
      return qb::short_launch<T, kRecompute>(qkv, bias, probs, mask, g, dqkv,
                                             n, t_len, n_heads, d_head,
                                             w.plan, stream);
    // the first design's kernel: its plan is one block of kResidentWarps
    // warps per (row, head)
    const size_t smem = sizeof(float) * qkv_bwd_resident_floats(t_len, d_head);
    const int* pl = w.plan;
    if (pl == nullptr || pl[0] != 1 || pl[1] != 1 || pl[2] != blocks ||
        pl[3] != 32 * kResidentWarps || (size_t)pl[4] != smem || pl[5] != 0)
      return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(qkv_bwd_resident_kernel<T, kRecompute>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    qkv_bwd_resident_kernel<T, kRecompute>
        <<<(unsigned)blocks, 32 * kResidentWarps, smem, cs>>>(
            x, b, p, m, gg, out, n_heads, t_len, d_head, inv);
  } else if (bias == nullptr) {
    return (int)cudaErrorInvalidValue;  // the tiled kernels add a bias
  } else if (regime == kQkvTiledGlobal) {
    if (w.gstage == nullptr || w.slots <= 0) return (int)cudaErrorInvalidValue;
    qkv_bwd_tiled_kernel<T, kRecompute, true>
        <<<(unsigned)(w.slots < blocks ? w.slots : blocks), 32 * kTiledWarps,
           0, cs>>>(x, b, p, m, gg, out, n_heads, t_len, d_head,
                    kGlobalTileRows, inv, blocks, w.gstage);
  } else {
    const size_t staged = qkv_bwd_stage_floats(t_len, d_head);
    const size_t smem = qkv_bwd_tiled_smem_bytes(t_len, staged);
    err = cudaFuncSetAttribute(qkv_bwd_tiled_kernel<T, kRecompute, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    qkv_bwd_tiled_kernel<T, kRecompute, false>
        <<<(unsigned)blocks, 32 * kTiledWarps, smem, cs>>>(
            x, b, p, m, gg, out, n_heads, t_len, d_head,
            qkv_bwd_tile_rows(t_len, staged), inv, blocks, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // namespace nrk
