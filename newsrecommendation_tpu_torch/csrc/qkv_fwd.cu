// Kernel rows 1 and 2: the exp-normalised multi-head self-attention
// forward over a fused [q|k|v] projection, without and with the f32 probs
// output.
//
// Replaces the TPU kernel newsrecommendation_tpu/ops/pallas/fused_attention.py
// :_qkv_fwd_kernel (called by _qkv_fwd_call and _qkv_fwd_probs_call).
// Contract, bound and design: qkv_fwd.cuh, which row 11 (qkv2d.cu) shares.

#include "qkv_fwd.cuh"

extern "C" {

// mask may be null (the bias variant); stage (`slots` slots of
// qkv_fwd_slot_floats) is read only past shared memory. Returns
// cudaGetLastError() after the launch: 0 when the kernel was queued.
int qkv_fwd_f32(const void* qkv, const void* bias, const void* mask,
                void* out, void* stage, int n, int t_len, int n_heads,
                int d_head, int slots, void* stream) {
  return nrk::qkv_fwd_launch<float>(qkv, bias, mask, out, nullptr, n, t_len,
                                    n_heads, d_head, stream,
                                    static_cast<float*>(stage), slots);
}

int qkv_fwd_bf16(const void* qkv, const void* bias, const void* mask,
                 void* out, void* stage, int n, int t_len, int n_heads,
                 int d_head, int slots, void* stream) {
  return nrk::qkv_fwd_launch<__nv_bfloat16>(
      qkv, bias, mask, out, nullptr, n, t_len, n_heads, d_head, stream,
      static_cast<float*>(stage), slots);
}

// The same forward that also writes the f32 probs (N, T, H*T).
int qkv_fwd_probs_f32(const void* qkv, const void* bias, const void* mask,
                      void* out, void* probs, void* stage, int n, int t_len,
                      int n_heads, int d_head, int slots, void* stream) {
  return nrk::qkv_fwd_launch<float>(qkv, bias, mask, out, probs, n, t_len,
                                    n_heads, d_head, stream,
                                    static_cast<float*>(stage), slots);
}

int qkv_fwd_probs_bf16(const void* qkv, const void* bias, const void* mask,
                       void* out, void* probs, void* stage, int n, int t_len,
                       int n_heads, int d_head, int slots, void* stream) {
  return nrk::qkv_fwd_launch<__nv_bfloat16>(
      qkv, bias, mask, out, probs, n, t_len, n_heads, d_head, stream,
      static_cast<float*>(stage), slots);
}

int qkv_fwd_slot_floats(int t_len, int d_head) {
  return (int)nrk::qkv_fwd_slot_floats_for(t_len, d_head);
}

}  // extern "C"
