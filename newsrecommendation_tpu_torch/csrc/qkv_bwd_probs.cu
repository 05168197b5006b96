// Kernel row 3: the backward of the exp-normalised multi-head
// self-attention over a fused [q|k|v] projection, from the f32 probs its
// forward saved (qkv_fwd.cu with a probs output).
//
// Replaces the TPU kernel newsrecommendation_tpu/ops/pallas/fused_attention.py
// :_qkv_bwd_probs_kernel (called by _qkv_bwd_probs_call, bias variant).
// Contract, bound and design: qkv_bwd.cuh, which row 4 (qkv_bwd.cu) shares.
// Row 12 (experimental_qkv2d.py:_bwd2d_call) is this launch on the
// (N, T, 3HD) view of its (N*T, 3HD) operands (ops/experimental_qkv2d.py):
// a row-major (N*T, 3HD) tensor is that view byte for byte.

#include "qkv_bwd.cuh"

extern "C" {

// plan, biased, stats, stage, slots: as qkv_bwd.cu's entry points. Returns
// cudaGetLastError() after the launches: 0 when they were queued.
#define NRK_QKV_BWD_PROBS(SUFFIX, T)                                         \
  int qkv_bwd_probs_##SUFFIX(                                                \
      const void* qkv, const void* bias, const void* probs, const void* g,   \
      void* dqkv, void* biased, void* stats, void* stage, int n, int t_len,  \
      int n_heads, int d_head, int q_tile, int q_chunk, int q_nbuf,          \
      int k_tile, int k_chunk, int k_nbuf, int slots, void* stream) {        \
    const int plan[6] = {q_tile, q_chunk, q_nbuf, k_tile, k_chunk, k_nbuf};  \
    return nrk::qkv_bwd_launch<T, false>(                                    \
        qkv, bias, probs, nullptr, g, dqkv, n, t_len, n_heads, d_head,       \
        stream,                                                              \
        {plan, biased, static_cast<float*>(stats),                           \
         static_cast<float*>(stage), slots, false});                         \
  }
NRK_QKV_BWD_PROBS(f32, float)
NRK_QKV_BWD_PROBS(bf16, __nv_bfloat16)
#undef NRK_QKV_BWD_PROBS

int qkv_bwd_probs_slot_floats(int t_len, int d_head, int esize) {
  return (int)nrk::qkv_bwd_slot_floats_for(t_len, d_head, esize);
}

}  // extern "C"
