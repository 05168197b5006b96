// Kernel rows 1 and 2: the exp-normalised multi-head self-attention
// forward over a fused [q|k|v] projection, without and with the f32 probs
// output.
//
// Replaces the TPU kernel newsrecommendation_tpu/ops/pallas/fused_attention.py
// :_qkv_fwd_kernel (called by _qkv_fwd_call and _qkv_fwd_probs_call).
// Contract, bound and the four regimes: qkv_fwd.cuh, which row 11
// (qkv2d.cu) shares.

#include "qkv_fwd.cuh"

extern "C" {

// mask may be null (the bias variant). regime: 0 resident, 1 tensor cores,
// 2 tiled, 3 row-wise (qkv_fwd_regime); p0..p2 its plan (resident: heads,
// nbuf, blocks; tensor cores and tiled: tile, chunk, nbuf; row-wise
// unused); biased, an (N, T, 3*H*D) scratch of qkv's dtype, is written and
// read on tensor cores only; stage (`slots` slots of qkv_fwd_slot_floats)
// is read row-wise past shared memory only. Row 11
// (ops/experimental_qkv2d.py) calls qkv_fwd_probs on the (N, T, 3*H*D)
// view of its (N*T, 3*H*D) input. Returns cudaGetLastError()
// after the launch: 0 when the kernel was queued; cudaErrorInvalidValue
// for a regime that is not the shape's or a plan its kernel does not take.
#define NRK_QKV_FWD(SUFFIX, T)                                                \
  int qkv_fwd_##SUFFIX(const void* qkv, const void* bias, const void* mask,   \
                       void* out, void* biased, void* stage, int n,           \
                       int t_len, int n_heads, int d_head, int regime,        \
                       int p0, int p1, int p2, int slots, void* stream) {     \
    const int plan[3] = {p0, p1, p2};                                         \
    return nrk::qkv_fwd_run<T>(qkv, bias, mask, out, nullptr, biased,         \
                               static_cast<float*>(stage), n, t_len,          \
                               n_heads, d_head, regime, plan, slots, stream); \
  }                                                                           \
  /* the same forward that also writes the f32 probs (N, T, H*T) */          \
  int qkv_fwd_probs_##SUFFIX(const void* qkv, const void* bias,               \
                             const void* mask, void* out, void* probs,        \
                             void* biased, void* stage, int n, int t_len,     \
                             int n_heads, int d_head, int regime, int p0,     \
                             int p1, int p2, int slots, void* stream) {       \
    const int plan[3] = {p0, p1, p2};                                         \
    return nrk::qkv_fwd_run<T>(qkv, bias, mask, out, probs, biased,           \
                               static_cast<float*>(stage), n, t_len,          \
                               n_heads, d_head, regime, plan, slots, stream); \
  }
NRK_QKV_FWD(f32, float)
NRK_QKV_FWD(bf16, __nv_bfloat16)
#undef NRK_QKV_FWD

int qkv_fwd_slot_floats(int t_len, int d_head) {
  return (int)nrk::qkv_fwd_slot_floats_for(t_len, d_head);
}

// The regime at (T, D) in a dtype of esize bytes: 0 resident, 1 tensor
// cores, 2 tiled, 3 row-wise.
int qkv_fwd_regime(int t_len, int d_head, int esize) {
  return nrk::qf::regime(t_len, d_head, esize);
}

// Shared bytes of one block in `regime` under the plan (p0, p1, p2), with
// probs or not: what the launch plan computes in Python, for a test to
// hold the two equal; 0 for a plan the kernels refuse (and row-wise past
// shared memory).
int qkv_fwd_smem_bytes(int regime, int t_len, int d_head, int esize,
                       int probs, int p0, int p1, int p2) {
  const int plan[3] = {p0, p1, p2};
  return nrk::qf::smem_bytes(regime, t_len, d_head, esize, probs != 0, plan);
}

}  // extern "C"
