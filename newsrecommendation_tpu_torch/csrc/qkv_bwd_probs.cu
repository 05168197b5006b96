// Kernel row 3: the backward of the exp-normalised multi-head
// self-attention over a fused [q|k|v] projection, from the f32 probs its
// forward saved (qkv_fwd.cu with a probs output).
//
// Replaces the TPU kernel newsrecommendation_tpu/ops/pallas/fused_attention.py
// :_qkv_bwd_probs_kernel (called by _qkv_bwd_probs_call, bias variant).
// Contract, bound and design: qkv_bwd.cuh, which row 4 (qkv_bwd.cu) shares.

#include "qkv_bwd.cuh"

extern "C" {

// Returns cudaGetLastError() after the launch: 0 when the kernel was queued.
int qkv_bwd_probs_f32(const void* qkv, const void* bias, const void* probs,
                      const void* g, void* dqkv, int n, int t_len,
                      int n_heads, int d_head, void* stream) {
  return nrk::qkv_bwd_launch<float, false>(qkv, bias, probs, nullptr, g, dqkv,
                                           n, t_len, n_heads, d_head, stream);
}

int qkv_bwd_probs_bf16(const void* qkv, const void* bias, const void* probs,
                       const void* g, void* dqkv, int n, int t_len,
                       int n_heads, int d_head, void* stream) {
  return nrk::qkv_bwd_launch<__nv_bfloat16, false>(
      qkv, bias, probs, nullptr, g, dqkv, n, t_len, n_heads, d_head, stream);
}

int qkv_bwd_probs_smem_bytes(int t_len, int d_head) {
  return (int)nrk::qkv_bwd_smem_bytes_for(t_len, d_head);
}

}  // extern "C"
