// Tensor-core and async-copy building blocks shared by the kernels that run
// their bf16 products on mma.sync.m16n8k16 (blanes.cu past T = 64, and
// flash_fwd.cu / flash_bwd.cu): cp.async staging, ldmatrix fragment loads,
// the mma itself, and the repack of f32 C fragments into a bf16 A fragment.
//
// Fragment layout (PTX ISA, mma.m16n8k16 with .bf16): lane l of a warp is
// g = l / 4 (the row group) and tq = l % 4. A C (or D) tile of 16 x 8 f32
// holds c[0], c[1] at (row g, cols 2tq, 2tq + 1) and c[2], c[3] at (row
// g + 8, the same cols). An A fragment of 16 x 16 bf16 holds, two to a
// register, (g, 2tq..), (g + 8, 2tq..), (g, 2tq + 8..), (g + 8, 2tq + 8..):
// two neighbouring C tiles (cols 0-7, then 8-15) repack into it in
// registers (pack_a), which is how a product's f32 result, rounded to
// bf16, becomes the left operand of the next product.
#pragma once

#include "common.cuh"

namespace nrk {

// ---- async copies ----------------------------------------------------------

template <int C>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(C)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- tensor cores (mma.sync.m16n8k16, bf16 in, f32 sums) --------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8x8 bf16 matrices from shared memory (lane i gives row i % 8 of
// matrix i / 8), transposed with kTrans.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x2(unsigned* r, const void* p) {
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The C->A repack: x[0..3] a C tile of 16 rows x cols 0-7, x[4..7] the
// tile of cols 8-15, each rounded to bf16, as the A fragment of the 16 x 16
// product that takes them as its left operand.
__device__ __forceinline__ void pack_a(unsigned* pa, const float* x) {
  pa[0] = pack_bf16(x[0], x[1]);
  pa[1] = pack_bf16(x[2], x[3]);
  pa[2] = pack_bf16(x[4], x[5]);
  pa[3] = pack_bf16(x[6], x[7]);
}

// A fragments of the 16 staged rows row0 .. row0 + 15 (rows rs apart,
// clamped below nrows: a tile's last rows past the item are not read), KS
// k-steps of 16 elements.
template <int KS>
__device__ __forceinline__ void load_a(unsigned (*a)[4],
                                       const __nv_bfloat16* base, int rs,
                                       int row0, int nrows, int lane) {
  const __nv_bfloat16* row =
      base + min(row0 + lane % 8 + 8 * (lane / 8 % 2), nrows - 1) * rs;
#pragma unroll
  for (int k = 0; k < KS; ++k)
    ldsm_x4<false>(a[k], row + 16 * k + 8 * (lane / 16));
}

// c (16 x 8 f32) = a (16 rows, KS k-steps) times the staged rows row0 ..
// row0 + 7 as B's columns (row clamped below nrows), scaled by `scale`
// (one rounded product after the sum). The k-steps are summed in order.
template <int KS>
__device__ __forceinline__ void mma_rows(float* c, const unsigned (*a)[4],
                                         const __nv_bfloat16* base, int rs,
                                         int row0, int nrows, float scale,
                                         int lane) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  const __nv_bfloat16* br = base + min(row0 + lane % 8, nrows - 1) * rs;
#pragma unroll
  for (int k = 0; k + 1 < KS; k += 2) {
    unsigned b[4];
    ldsm_x4<false>(b, br + 16 * k + 8 * (lane / 8));
    mma_bf16(c, a[k], b);
    mma_bf16(c, a[k + 1], b + 2);
  }
  if constexpr (KS % 2 == 1) {
    unsigned b[2];
    ldsm_x2<false>(b, br + 16 * (KS - 1) + 8 * (lane / 8 % 2));
    mma_bf16(c, a[KS - 1], b);
  }
  if (scale != 1.f)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = __fmul_rn(c[e], scale);
}

// o[dt] (16 x 8 f32, ND d tiles) += pa (16 x 16 bf16) times the staged
// rows row0 .. row0 + 15 as B (k = rows, n = d; rows clamped below nrows).
template <int ND>
__device__ __forceinline__ void mma_acc(float (*o)[4], const unsigned* pa,
                                        const __nv_bfloat16* base, int rs,
                                        int row0, int nrows, int lane) {
  const __nv_bfloat16* vr =
      base + min(row0 + lane % 8 + 8 * (lane / 8 % 2), nrows - 1) * rs;
#pragma unroll
  for (int dt = 0; dt < ND; dt += 2) {
    if (dt + 1 < ND) {
      unsigned vb[4];
      ldsm_x4<true>(vb, vr + 8 * dt + 8 * (lane / 16));
      mma_bf16(o[dt], pa, vb);
      mma_bf16(o[dt + 1], pa, vb + 2);
    } else {
      unsigned vb[2];
      ldsm_x2<true>(vb, vr + 8 * dt);
      mma_bf16(o[dt], pa, vb);
    }
  }
}

// o (16 rows x ND d tiles) of rows row0 + q, q < nrows, to x at
// (first + q) * ld + d, d < D.
template <int ND>
__device__ __forceinline__ void store_tiles(__nv_bfloat16* x, int64_t first,
                                            int ld, const float (*o)[4],
                                            int row0, int nrows, int d_head,
                                            int lane) {
#pragma unroll
  for (int dt = 0; dt < ND; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = row0 + lane / 4 + 8 * (e / 2);
      const int d = 8 * dt + 2 * (lane % 4) + e % 2;
      if (q < nrows && d < d_head)
        x[(first + q) * ld + d] = __float2bfloat16_rn(o[dt][e]);
    }
}

}  // namespace nrk
