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

// mask may be null; bias may be null in the resident regime (qkv carries
// it). plan: the resident plan (heads, nbuf, blocks, threads, shared
// bytes, 0) or the tensor-core plan of each side (q_tile, q_chunk, q_nbuf,
// k_tile, k_chunk, k_nbuf); biased, stats: the tensor-core regime's
// scratch; stage, slots: the tiled kernel's global slots (qkv_bwd.cuh
// QkvBwdWork). Returns cudaGetLastError() after the launches: 0 when they
// were queued; cudaErrorInvalidValue for a plan or scratch the regime does
// not get.
#define NRK_QKV_BWD(SUFFIX, T)                                               \
  int qkv_bwd_##SUFFIX(const void* qkv, const void* bias, const void* mask, \
                       const void* g, void* dqkv, void* biased, void* stats, \
                       void* stage, int n, int t_len, int n_heads,           \
                       int d_head, int q_tile, int q_chunk, int q_nbuf,      \
                       int k_tile, int k_chunk, int k_nbuf, int slots,       \
                       void* stream) {                                       \
    const int plan[6] = {q_tile, q_chunk, q_nbuf, k_tile, k_chunk, k_nbuf};  \
    return nrk::qkv_bwd_launch<T, true>(                                     \
        qkv, bias, nullptr, mask, g, dqkv, n, t_len, n_heads, d_head,        \
        stream,                                                              \
        {plan, biased, static_cast<float*>(stats),                           \
         static_cast<float*>(stage), slots, false});                         \
  }
NRK_QKV_BWD(f32, float)
NRK_QKV_BWD(bf16, __nv_bfloat16)
#undef NRK_QKV_BWD

// 0 resident, 1 tensor cores, 2 tiled, 3 tiled in global memory
int qkv_bwd_regime(int t_len, int d_head, int esize) {
  return nrk::qkv_bwd_regime(t_len, d_head, esize);
}

// floats of one global slot (0 unless the tiled kernel runs there)
int qkv_bwd_slot_floats(int t_len, int d_head, int esize) {
  return (int)nrk::qkv_bwd_slot_floats_for(t_len, d_head, esize);
}

// shared bytes of the short resident kernel (T <= 64, D <= 32) at `heads`
// heads an item and `nbuf` stage buffers, row 3's (probs) or row 4's; 0
// for a shape it does not take
int qkv_bwd_resident_smem_bytes(int t_len, int d_head, int esize, int heads,
                                int nbuf, int probs) {
  if (!nrk::qb::short_shape(t_len, d_head)) return 0;
  return (int)nrk::qb::smem_bytes(
      nrk::qb::shape_of(t_len, d_head, esize, heads, probs != 0), nbuf);
}

// shared bytes of a tensor-core side (kind 1 key, 2 query), as flash.cuh
// lays it out; 0 for a plan the kernels refuse
int qkv_bwd_mma_smem_bytes(int kind, int d_head, int tile, int chunk,
                           int nbuf) {
  if (!nrk::flash_plan_ok(kind, d_head, 2, tile, chunk, nbuf)) return 0;
  const nrk::FlashLayout l = nrk::flash_layout(kind, d_head, 2, tile, chunk);
  return (int)(l.own + nbuf * l.stage);
}

}  // extern "C"
