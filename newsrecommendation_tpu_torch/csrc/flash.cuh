// What the key-blocked ("flash") exp-MHSA kernels share (flash_fwd.cu,
// flash_bwd.cu): the launch plan's layout, the walk over key blocks, the
// staging of head rows, and the CUDA-core kernels' dispatch on the head
// width and their 16-lane sum.
//
// Layout: q, k, v are (N, T, H*D) with head h at lanes [h*D, (h+1)*D); rows
// of (n, t) lie `ld` elements apart (ld = H*D when contiguous, 3*H*D when
// they are slices of one fused projection), lanes are contiguous. Every
// other operand is contiguous: mask (N, T) f32 or null; o, g, dq, dk, dv
// (N, T, H*D); m, den, delta (N, T, H) f32.
//
// Two regimes up to D = 64, chosen from the dtype (the launch plan is
// ops/blockwise.py:launch_plan, which this file's layout mirrors):
//   tensor cores (bf16): a block takes one (row, head) and a tile of 64 or
//     128 of its own rows (queries; keys in the backward's key side), a
//     warp 16 of them, its A fragments loaded once; the other side's rows
//     are staged in chunks of up to 256 by cp.async in their own dtype,
//     one or two buffers, heads padded with zeros to whole k-steps of 16
//     and rows an odd number of 16-byte units apart;
//   CUDA cores (f32): the other side's rows are staged in chunks of 256 by
//     16-byte cp.async as f32 rows of core_row_floats, one or two buffers,
//     and read as float4, so each shared-memory load feeds four or more
//     FMAs; the head is summed over core_dm lanes (D itself at 8, 16, 20,
//     24, 32 and 64; zeros pad the rest, adding exact zeros). The forward
//     holds a tile of queries' scores for a whole chunk of keys in
//     registers, split over 16 lanes; the backward's two sides (128
//     threads) hold one own row a thread and walk the other side in
//     order.
#pragma once

#include "common.cuh"
#include "mma.cuh"

#include <type_traits>

namespace nrk {

constexpr float kNegBig = -1e30f;  // the running max before any key

// rows [t0, t1) of head h of x (row `row`), as f32 padded to DM lanes
template <typename T, int DM>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ x,
                                          int64_t base, int ld, int t0,
                                          int t1, int d_head) {
  const int n = (t1 - t0) * DM;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / DM;
    const int d = idx - j * DM;
    dst[idx] = d < d_head ? to_f32(x[base + (int64_t)(t0 + j) * ld + d]) : 0.f;
  }
}

// ---- the launch plan's layout ----------------------------------------------

// The sides of rows 3-4's tensor-core backward (qkv_bwd_mma.cuh) stage the
// same operands as the flash backward's; row 3's add a tile of its f32
// probs (kQkvProbsKey, kQkvProbsQuery).
enum FlashKind {
  kFlashFwd = 0,
  kFlashBwdKey = 1,
  kFlashBwdQuery = 2,
  kQkvProbsKey = 3,
  kQkvProbsQuery = 4
};

// Floats between two rows of a staged probs tile of `cols` columns: room
// for a 16-byte copy's shift of up to 3 floats, a multiple of 4.
__host__ __device__ inline int qkv_probs_stride(int cols) { return cols + 4; }

constexpr int kFlashMmaMaxHead = 64;  // widest head on tensor cores
// past 64 (flash_wide.cuh): a warp per row, 8 rows a block, any head
constexpr int kFlashWideWarps = 8;
constexpr int kFlashMaxChunk = 256;   // rows of one stage of the other side
constexpr int kFlashMaxSmem = 232448;  // what a block may use

// Whether the tensor-core kernels take (dtype, D): bf16 heads of up to 64.
__host__ __device__ inline bool flash_mma(int d_head, int esize) {
  return esize == 2 && d_head <= kFlashMmaMaxHead;
}

// Whether (D) takes the wide kernels (flash_wide.cuh): heads past 64.
__host__ __device__ inline bool flash_wide(int d_head) {
  return d_head > kFlashMmaMaxHead;
}

// The kernels' compile-time width DM (with_head_width): the least of 8,
// 16, 24, 32, 64 that holds D.
inline int flash_dm(int d_head) {
  return d_head <= 8 ? 8 : d_head <= 16 ? 16 : d_head <= 24 ? 24
         : d_head <= 32 ? 32 : 64;
}

// Elements of a staged head row on tensor cores: DM padded to whole
// k-steps of 16 (the KS k-steps and ND d tiles of a DM kernel read zeros
// past D, never the next row), the row to an odd number of 16-byte units
// (ldmatrix's eight rows of 16 bytes then hit 32 banks).
inline int flash_row_elems(int d_head) {
  int rb = (flash_dm(d_head) + 15) / 16 * 32;
  if ((rb / 16) % 2 == 0) rb += 16;
  return rb / 2;
}

// ---- the CUDA-core (f32) kernels' shapes ------------------------------------

constexpr int kCoreChunk = 256;       // rows of the other side staged at once
constexpr int kCoreKeys = kCoreChunk / 16;  // keys of a chunk per key lane
constexpr int kCoreBwdThreads = 128;  // a backward side: one own row each

// The f32 kernels' compile-time width DM (with_core_width): D itself at 8,
// 16, 20, 24, 32 and 64, else the next of those.
__host__ __device__ constexpr int core_dm(int d_head) {
  return d_head <= 8 ? 8 : d_head <= 16 ? 16 : d_head <= 20 ? 20
         : d_head <= 24 ? 24 : d_head <= 32 ? 32 : 64;
}

// Floats between two staged f32 rows: DM, or DM + 4 where DM / 4 is even,
// so that the float4 reads of eight neighbouring rows (the forward's key
// lanes) fall on 32 different banks.
__host__ __device__ constexpr int core_row_floats(int dm) {
  return dm / 4 % 2 ? dm : dm + 4;
}

// Queries a forward thread holds: 4 up to DM = 24, 2 past it (their scores
// and o share the registers).
__host__ __device__ constexpr int core_fwd_rows(int dm) {
  return dm <= 24 ? 4 : 2;
}

constexpr int kCoreFwdGroups = 16;  // forward query groups: 256 threads

// The tiles the CUDA-core kernels take: the forward 16 query groups of
// core_fwd_rows queries (16 key lanes a group), a backward side 128 own
// rows, one a thread.
__host__ __device__ constexpr bool core_tile_ok(int kind, int dm, int tile) {
  return tile == (kind == kFlashFwd ? kCoreFwdGroups * core_fwd_rows(dm)
                                    : kCoreBwdThreads);
}

// Bytes of a block's own rows and of one stage buffer of the other side's
// rows, on tensor cores (bf16 rows of flash_row_elems):
//   fwd:        own Q [tile];      stage K, V [chunk], mask [chunk]
//   bwd key:    own K, V [tile];   stage Q, g [chunk], m, den, 1/den,
//                                  delta [chunk]
//   bwd query:  own Q, g [tile];   stage K, V [chunk], mask [chunk]
// (f32 arrays each padded to 16 bytes); row 3's key side also stages the
// probs of [chunk] queries over its [tile] keys and its query side those
// of its [tile] queries over [chunk] keys, f32 rows qkv_probs_stride
// apart. On CUDA cores, f32 rows of core_row_floats:
//   fwd:        own Q [tile];      stage K, V [chunk], mask [chunk]
//   bwd key:    nothing own;       stage Q, g [chunk], (m, den, 1/den,
//                                  delta) as one float4 [chunk]
//   bwd query:  nothing own;       stage K, V [chunk], mask [chunk]
// (the backward's own rows live in registers).
struct FlashLayout {
  size_t own, stage;
};

inline FlashLayout flash_layout(int kind, int d_head, int esize, int tile,
                                int chunk) {
  if (flash_wide(d_head)) return {0, 0};  // nothing staged
  if (!flash_mma(d_head, esize)) {
    const size_t rs = core_row_floats(core_dm(d_head));
    const size_t per_row = kind == kFlashBwdKey ? 4 : 1;
    return {kind == kFlashFwd ? sizeof(float) * tile * rs : 0,
            sizeof(float) * (2 * (size_t)chunk * rs + per_row * chunk)};
  }
  const size_t rb = 2 * (size_t)flash_row_elems(d_head);
  const bool key = kind == kFlashBwdKey || kind == kQkvProbsKey;
  const size_t floats = key ? 4 : 1;
  const size_t own = (kind == kFlashFwd ? 1 : 2) * (size_t)tile * rb;
  size_t stage = 2 * (size_t)chunk * rb + (4 * floats * chunk + 15) / 16 * 16;
  if (kind == kQkvProbsKey)
    stage += 4 * (size_t)chunk * qkv_probs_stride(tile);
  if (kind == kQkvProbsQuery)
    stage += 4 * (size_t)tile * qkv_probs_stride(chunk);
  return {own, stage};
}

// Whether a plan (tile, chunk, nbuf) is one the kernels take: on tensor
// cores tiles of 64 or 128 rows, chunks of 16 to 256 rows in steps of 16;
// on CUDA cores core_tile_ok's tiles and chunks of kCoreChunk rows; one or
// two buffers, within a block's shared memory; past D = 64 a tile of
// kFlashWideWarps rows, nothing staged.
inline bool flash_plan_ok(int kind, int d_head, int esize, int tile,
                          int chunk, int nbuf) {
  if (flash_wide(d_head))
    return tile == kFlashWideWarps && chunk == 0 && nbuf == 0;
  if (!flash_mma(d_head, esize)) {
    if (kind > kFlashBwdQuery || !core_tile_ok(kind, core_dm(d_head), tile) ||
        chunk != kCoreChunk || nbuf < 1 || nbuf > 2)
      return false;
  } else if ((tile != 64 && tile != 128) || chunk < 16 ||
             chunk > kFlashMaxChunk || chunk % 16 != 0 || nbuf < 1 ||
             nbuf > 2) {
    return false;
  }
  const FlashLayout lay = flash_layout(kind, d_head, esize, tile, chunk);
  return lay.own + nbuf * lay.stage <= (size_t)kFlashMaxSmem;
}

// What a tensor-core kernel is launched with.
struct FlashParams {
  int h, t, d, ld;      // heads, positions, head width, row stride of q, k, v
  int block;            // keys of a key block (the forward)
  int tile, chunk;      // own rows of a block; rows of one stage
  int nbuf;             // stage buffers: 2 copies the next task in early
  int rs;               // staged row stride (elements)
  int piece;            // bytes of one async copy; 0: element copies
  int own, stage;       // bytes of the block's own rows, of one buffer
  float inv;            // 1/sqrt(D)
};

// x / den rounded as the plain version's IEEE division e / den, from
// rcp = 1 / den (IEEE, once per row) and one fma correction: with rcp the
// correctly rounded reciprocal and q = x * rcp within an ulp of x / den,
// q + (x - den q) rcp rounds to the correctly rounded quotient (Markstein;
// exact for normal x and den). rcp = 0 where den is not > 0 gives 0, as
// the contract has it. A division per element cost a dozen instructions
// and more again under a key mask: on an H100 at (128, 512) the backward
// took 3.09 ms unmasked and 5.25 with 30% of keys masked at random with
// it, 2.16 both ways without (scripts/flash_variants.py division).
__device__ __forceinline__ float div_by(float x, float den, float rcp) {
  const float q = __fmul_rn(x, rcp);
  return fmaf(fmaf(-den, q, x), rcp, q);
}

__device__ __forceinline__ float rcp_or_zero(float den) {
  return den > 0.f ? 1.f / den : 0.f;
}

// Walks rows [0, n) of a stage in steps of 16, body(row0, edge): the steps
// that lie inside n with edge false, a last partial one with edge true
// (std::true_type), so only that one checks its rows against n.
template <typename Body>
__device__ __forceinline__ void for_steps(int n, Body body) {
  int r0 = 0;
  for (; r0 + 16 <= n; r0 += 16) body(r0, std::false_type{});
  if (r0 < n) body(r0, std::true_type{});
}

// ---- the forward's walk over key blocks ------------------------------------
//
// Key block b holds keys [b*block, (b+1)*block) (block divides T: JAX's
// _block_rows). Its max must be complete before any of its e is formed, so
// a block that fits one stage (block <= chunk) is one task that takes the
// max walk and then the exp walk over the staged keys; a longer block is
// ceil(block / chunk) max tasks (K staged) then as many exp tasks (K and V
// staged again). A task never crosses a block edge.

struct FlashTask {
  int key0, nkeys;     // the staged keys
  bool max_pass;       // the walk that takes the block's max of s
  bool exp_pass;       // the walk that forms e and e @ v
  bool first;          // the block's first task: its max starts afresh
  bool exp_first;      // the block's first exp task: m' and the scale
  bool last;           // the block's last task: fold into the running sums
};

__host__ __device__ inline int flash_tasks_per_block(int block, int chunk) {
  const int nc = (block + chunk - 1) / chunk;
  return nc == 1 ? 1 : 2 * nc;
}

__host__ __device__ inline int flash_walk_tasks(int t_len, int block,
                                                int chunk) {
  return t_len / block * flash_tasks_per_block(block, chunk);
}

__host__ __device__ inline FlashTask flash_task(int idx, int block,
                                                int chunk) {
  const int nc = (block + chunk - 1) / chunk;
  const int per = nc == 1 ? 1 : 2 * nc;
  const int b = idx / per;
  const int r = idx - b * per;
  const int c = nc == 1 ? 0 : (r < nc ? r : r - nc);
  FlashTask tk;
  tk.key0 = b * block + c * chunk;
  tk.nkeys = block - c * chunk < chunk ? block - c * chunk : chunk;
  tk.max_pass = nc == 1 || r < nc;
  tk.exp_pass = nc == 1 || r >= nc;
  tk.first = r == 0;
  tk.exp_first = nc == 1 || r == nc;
  tk.last = r == per - 1;
  return tk;
}

// ---- staging on tensor cores -----------------------------------------------

// Bytes of one async copy: the largest of 16, 8, 4 that divides a head
// row's bytes, each row stride's and every base address (so every row and
// head offset too); 0 for element copies.
inline int flash_piece(int d_head, int esize, int ld, int ld2,
                       const void* const* ptrs, int n_ptrs) {
  for (int c = 16; c >= 4; c /= 2) {
    bool ok = (d_head * esize) % c == 0 && (ld * esize) % c == 0 &&
              (ld2 * esize) % c == 0;
    for (int i = 0; i < n_ptrs; ++i) ok = ok && (uintptr_t)ptrs[i] % c == 0;
    if (ok) return c;
  }
  return 0;
}

// Rows [0, rows) of x (rows ld elements apart, the D lanes of one head)
// into dst, rows rs elements apart, by cp.async pieces of `piece` bytes
// (element stores when 0). Each thread keeps one piece of a row and walks
// the rows; the pads past D are never written.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int rs,
                                           const T* __restrict__ x,
                                           int64_t ld, int rows, int d_head,
                                           int piece) {
  const int step = piece ? piece / (int)sizeof(T) : 1;  // elements
  const int per = d_head / step;  // pieces of a row
  const int rstep = blockDim.x / per;
  const int r0 = threadIdx.x / per;
  if (r0 >= rstep) return;
  const int e = (threadIdx.x - r0 * per) * step;
  for (int r = r0; r < rows; r += rstep) {
    T* to = dst + r * rs + e;
    const T* from = x + r * ld + e;
    if (piece == 16) cp_async<16>(to, from);
    else if (piece == 8) cp_async<8>(to, from);
    else if (piece == 4) cp_async<4>(to, from);
    else *to = *from;
  }
}

// n floats from src, `stride` apart, into dst (4-byte cp.async each).
__device__ __forceinline__ void stage_floats(float* dst,
                                             const float* __restrict__ src,
                                             int n, int stride) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    cp_async<4>(dst + i, src + (int64_t)i * stride);
}

// Zeroes `bytes` (a multiple of 16) of shared memory from p, then waits
// for the block: the pads of staged rows are never copied.
__device__ __forceinline__ void zero_smem(unsigned char* p, size_t bytes) {
  const uint4 zero = {0u, 0u, 0u, 0u};
  for (size_t i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(p + i) = zero;
  __syncthreads();
}

// Walks tasks 0 .. n - 1 of a block; the caller has issued task 0's copies
// (and its own rows') into buffer 0. With two buffers task i + 1 is copied
// in while task i is computed; with one, after it.
template <typename Stage, typename Compute>
__device__ __forceinline__ void walk_tasks(int n, int nbuf, Stage stage,
                                           Compute compute) {
  cp_commit();
  for (int i = 0; i < n; ++i) {
    const int b = nbuf == 2 ? i & 1 : 0;
    if (nbuf == 2) {
      if (i + 1 < n) stage(i + 1, b ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // task i's rows are in
    compute(i, b);
    __syncthreads();  // its buffer is free again
    if (nbuf == 1 && i + 1 < n) {
      stage(i + 1, 0);
      cp_commit();
    }
  }
  cp_wait<0>();
}

// ---- CUDA-core helpers ------------------------------------------------------

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One halving step of reduce_scatter16 over v[0, 2 HALF): the lane whose
// bit `bit` is set keeps the upper half, the other the lower, each adding
// the partner lane's copy of it; then the next step on v[0, HALF). Each
// step a template of its own, so every index is a constant and v stays in
// registers.
template <int HALF, int N>
__device__ __forceinline__ void reduce_half(float (&v)[N], int kg) {
  constexpr int bit = HALF * 16 / N;
  const bool up = kg & bit;
#pragma unroll
  for (int x = 0; x < HALF; ++x) {
    const float send = up ? v[x] : v[x + HALF];
    const float keep = up ? v[x + HALF] : v[x];
    v[x] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
  if constexpr (bit > 1) reduce_half<HALF / 2>(v, kg);
}

// Sums v over the 16 lanes of a half-warp (lanes that differ in bits 0-3,
// kg = lane % 16) and leaves lane kg the sums of v[kg * N / 16, (kg + 1) *
// N / 16) in v[0, N / 16): four halving steps (reduce_half), so every sum
// is taken in one fixed tree, the same on every run.
template <int N>
__device__ __forceinline__ void reduce_scatter16(float (&v)[N], int kg) {
  static_assert(N % 16 == 0, "16 lanes share the sums");
  reduce_half<N / 2>(v, kg);
}

// The sum (max) of x over the 16 lanes of a half-warp, on every one of them.
__device__ __forceinline__ float sum16(float x) {
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float max16(float x) {
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Calls body.template operator()<DM>() with DM = core_dm(d_head); returns
// cudaErrorInvalidValue for d_head > 64.
template <typename Body>
int with_core_width(int d_head, Body body) {
  if (d_head <= 8) return body.template operator()<8>();
  if (d_head <= 16) return body.template operator()<16>();
  if (d_head <= 20) return body.template operator()<20>();
  if (d_head <= 24) return body.template operator()<24>();
  if (d_head <= 32) return body.template operator()<32>();
  if (d_head <= 64) return body.template operator()<64>();
  return (int)cudaErrorInvalidValue;
}

// Calls body.template operator()<DM>() with the least DM >= d_head; returns
// cudaErrorInvalidValue for d_head > 64.
template <typename Body>
int with_head_width(int d_head, Body body) {
  if (d_head <= 8) return body.template operator()<8>();
  if (d_head <= 16) return body.template operator()<16>();
  if (d_head <= 24) return body.template operator()<24>();
  if (d_head <= 32) return body.template operator()<32>();
  if (d_head <= 64) return body.template operator()<64>();
  return (int)cudaErrorInvalidValue;
}

}  // namespace nrk
