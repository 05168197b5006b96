// Kernel row 4: the backward of the exp-normalised multi-head
// self-attention over a fused [q|k|v] projection that saves no probs: it
// recomputes s, m and a from qkv, bias and the key mask, as the forward
// (qkv_fwd.cu, row 1) computes them.
//
// Replaces the TPU kernel newsrecommendation_tpu/ops/pallas/fused_attention.py
// :_qkv_bwd_kernel (called by _qkv_bwd_call, bias and bias+mask variants;
// reached by bwd_residuals="recompute"). Contract, bound and design:
// qkv_bwd.cuh, which row 3 (qkv_bwd_probs.cu) shares.

#include "qkv_bwd.cuh"

extern "C" {

// mask may be null. Returns cudaGetLastError() after the launch: 0 when
// the kernel was queued.
int qkv_bwd_f32(const void* qkv, const void* bias, const void* mask,
                const void* g, void* dqkv, int n, int t_len, int n_heads,
                int d_head, void* stream) {
  return nrk::qkv_bwd_launch<float, true>(qkv, bias, nullptr, mask, g, dqkv,
                                          n, t_len, n_heads, d_head, stream);
}

int qkv_bwd_bf16(const void* qkv, const void* bias, const void* mask,
                 const void* g, void* dqkv, int n, int t_len, int n_heads,
                 int d_head, void* stream) {
  return nrk::qkv_bwd_launch<__nv_bfloat16, true>(
      qkv, bias, nullptr, mask, g, dqkv, n, t_len, n_heads, d_head, stream);
}

int qkv_bwd_smem_bytes(int t_len, int d_head) {
  return (int)nrk::qkv_bwd_smem_bytes_for(t_len, d_head);
}

}  // extern "C"
