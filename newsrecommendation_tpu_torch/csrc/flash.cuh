// What the key-blocked ("flash") exp-MHSA kernels share (flash_fwd.cu,
// flash_bwd.cu): the block shape, the tile loader and the dispatch on the
// head width.
//
// Layout: q, k, v are (N, T, H*D) with head h at lanes [h*D, (h+1)*D); rows
// of (n, t) lie `ld` elements apart (ld = H*D when contiguous, 3*H*D when
// they are slices of one fused projection), lanes are contiguous. Every
// other operand is contiguous: mask (N, T) f32 or null; o, g, dq, dk, dv
// (N, T, H*D); m, den, delta (N, T, H) f32.
//
// One thread owns one query (or one key) of one (row, head), holding its
// D-vectors in registers, padded with zeros to DM, a compile-time width
// (8, 16, 24, 32 or 64): the padded terms add exact zeros, so every dot is
// the sequential f32 sum over the D real lanes.
#pragma once

#include "common.cuh"

namespace nrk {

constexpr int kFlashThreads = 128;
// Keys (or queries) staged in shared memory at once: JAX's default key
// block, so a key block of up to 256 is loaded once per block.
constexpr int kFlashTile = 256;
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

template <int DM>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DM; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
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
