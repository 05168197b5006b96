// Kernel rows 11 and 12: the exp-normalised multi-head self-attention over
// a fused [q|k|v] projection with 2-D I/O -- qkv and dqkv as the (N*T, 3HD)
// product of the projection -- and the forward always writing the f32
// probs, which the backward reads.
//
// Replaces the TPU kernels newsrecommendation_tpu/ops/pallas/
// experimental_qkv2d.py:_fwd2d_kernel (called by _fwd2d_call) and
// :_bwd2d_probs_kernel (called by _bwd2d_call). On the TPU the (N*T, 3HD)
// and (N, T, 3HD) forms tile differently, so those kernels regroup rows in
// VMEM. On this card a row-major (N*T, 3HD) tensor is the (N, T, 3HD)
// tensor byte for byte, so row 11 is row 2's launch on that view (its
// wrapper, ops/experimental_qkv2d.py, calls qkv_fwd.cu's qkv_fwd_probs in
// the regime and plan row 2's launch plan gives it), and the entry point
// below launches row 3's kernels (qkv_bwd.cuh) on it unchanged, in row
// 3's plan: out, probs and dqkv equal rows 2-3's in every element.
// Unmasked only, as on the TPU. Bound and design: qkv_fwd.cuh and
// qkv_bwd.cuh (at N = 7040, T = 20 in bf16 the forward moves 676 MB,
// about 0.20 ms at 3.35 TB/s, and the backward 1,014 MB, 0.30 ms).

#include "qkv_bwd.cuh"

namespace {

// rows of the 3-D view; a partial row set is refused
inline int rows_of(int nt, int t_len) {
  return (t_len > 0 && nt % t_len == 0) ? nt / t_len : -1;
}

}  // namespace

extern "C" {

// probs from the forward, g (N, T, HD), dqkv2d (N*T, 3HD); plan, biased,
// stats, stage, slots as qkv_bwd.cu's entry points.
#define NRK_QKV2D_BWD(SUFFIX, T)                                             \
  int qkv2d_bwd_##SUFFIX(                                                    \
      const void* qkv2d, const void* bias, const void* probs, const void* g, \
      void* dqkv2d, void* biased, void* stats, void* stage, int nt,          \
      int t_len, int n_heads, int d_head, int q_tile, int q_chunk,           \
      int q_nbuf, int k_tile, int k_chunk, int k_nbuf, int slots,            \
      void* stream) {                                                        \
    const int n = rows_of(nt, t_len);                                        \
    if (n < 0) return (int)cudaErrorInvalidValue;                            \
    const int plan[6] = {q_tile, q_chunk, q_nbuf, k_tile, k_chunk, k_nbuf};  \
    return nrk::qkv_bwd_launch<T, false>(                                    \
        qkv2d, bias, probs, nullptr, g, dqkv2d, n, t_len, n_heads, d_head,   \
        stream,                                                              \
        {plan, biased, static_cast<float*>(stats),                           \
         static_cast<float*>(stage), slots, false});                         \
  }
NRK_QKV2D_BWD(f32, float)
NRK_QKV2D_BWD(bf16, __nv_bfloat16)
#undef NRK_QKV2D_BWD

int qkv2d_bwd_slot_floats(int t_len, int d_head, int esize) {
  return (int)nrk::qkv_bwd_slot_floats_for(t_len, d_head, esize);
}

}  // extern "C"
