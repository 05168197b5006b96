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
// tensor byte for byte, so the entry points below launch the kernels of
// rows 2 and 3 (qkv_fwd.cuh, qkv_bwd.cuh) on it unchanged: out, probs and
// dqkv equal rows 2-3's in every element. Unmasked only, as on the TPU.
// Bound and design: those headers (at N = 7040, T = 20 in bf16 the
// forward moves 676 MB, about 0.20 ms at 3.35 TB/s, and the backward
// 1,014 MB, 0.30 ms; both run on the CUDA cores, well above that).

#include "qkv_fwd.cuh"
#include "qkv_bwd.cuh"

namespace {

// rows of the 3-D view; a partial row set is refused
inline int rows_of(int nt, int t_len) {
  return (t_len > 0 && nt % t_len == 0) ? nt / t_len : -1;
}

}  // namespace

extern "C" {

// qkv2d (N*T, 3HD), bias (3HD,), out (N, T, HD), probs (N, T, H*T) f32;
// stage (`slots` slots of qkv2d_fwd_slot_floats) read only past shared
// memory. Returns cudaGetLastError() after the launch: 0 when it was
// queued.
#define NRK_QKV2D_FWD(SUFFIX, T)                                             \
  int qkv2d_fwd_##SUFFIX(const void* qkv2d, const void* bias, void* out,     \
                         void* probs, void* stage, int nt, int t_len,        \
                         int n_heads, int d_head, int slots, void* stream) { \
    const int n = rows_of(nt, t_len);                                        \
    if (n < 0) return (int)cudaErrorInvalidValue;                            \
    return nrk::qkv_fwd_launch<T>(qkv2d, bias, nullptr, out, probs, n,       \
                                  t_len, n_heads, d_head, stream,            \
                                  static_cast<float*>(stage), slots);        \
  }
NRK_QKV2D_FWD(f32, float)
NRK_QKV2D_FWD(bf16, __nv_bfloat16)
#undef NRK_QKV2D_FWD

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

int qkv2d_fwd_slot_floats(int t_len, int d_head) {
  return (int)nrk::qkv_fwd_slot_floats_for(t_len, d_head);
}

}  // extern "C"
