#!/usr/bin/env python3
"""Least time one NVIDIA H100 SXM could take for each Pallas kernel of the
JAX package, from the bytes and flops of the kernel's own
pl.CostEstimate, at the shape NRMS at its published width would give it
(20 heads x 20, titles of 20 tokens, a 50-news history, batch 128 with
1+4 candidates: the news encoder sees N = 128 * 55 = 7040 rows of T = 20).

    python3 scripts/port_kernel_bounds.py

Prints one markdown row per kernel: bytes, flops, and the bound, the
larger of bytes over 3.35 TB/s and flops over the dtype's peak (989
TFLOP/s bf16, 67 TFLOP/s f32, NVIDIA's data sheet). Pure arithmetic: it
imports neither JAX nor PyTorch.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ITEM = {"float32": 4, "bfloat16": 2}
H, D = 20, 20
HD = H * D
POOL_Q = 200  # news_query_vector_dim: the fused encoder's pooling width


def fused_qkv(n, t, item):
    """Sizes the fused-qkv kernels' estimates use: qkv.size, n*t*w1, n*t*wp."""
    return n * t * 3 * HD, n * t * HD, n * t * H * t


def costs(row, n, t, dtype):
    """(bytes, flops) of row `row`'s CostEstimate at (n, t)."""
    item = ITEM[dtype]
    qkv, o, p = fused_qkv(n, t, item)
    q = n * t * HD  # one of separate q, k, v
    att = n * H * t * t * D
    return {
        1: ((qkv + o) * item, 4 * att),
        2: ((qkv + o) * item + 4 * p, 4 * att),
        3: ((2 * qkv + 2 * o) * item + 4 * p, 8 * att),
        4: ((2 * qkv + 2 * o) * item, 10 * att),
        5: (4 * q * item, 4 * att),
        6: (7 * q * item, 10 * att),
        7: (4 * q * item, 4 * att),
        8: (7 * q * item, 10 * att),
        9: ((3 * q + q) * item, 4 * att),
        10: (6 * q * item, 10 * att),
        11: ((qkv + o) * item + 4 * p, 4 * att),
        12: ((2 * qkv + 2 * o) * item + 4 * p, 8 * att),
        13: ((qkv + n * HD) * item, 4 * att + 4 * n * t * HD * POOL_Q),
        14: ((2 * qkv + n * HD) * item, 10 * att + 12 * n * t * HD * POOL_Q),
        15: ((qkv + o) * item, 4 * att),
        16: ((2 * qkv + 2 * o) * item, 10 * att),
    }[row]


# (row, call site under newsrecommendation_tpu/ops/pallas/, N, T, dtype):
# rows 1-3 at the shapes the port's main paths give them; the others at
# the news encoder's shape (rows 13-14 also at their other shapes), except the flash pair (T >= 512 only), taken
# at a user encoder over a 512-news history.
ROWS = [
    (1, "fused_attention.py:680 _qkv_fwd_call", 1024, 20, "float32"),
    (1, "fused_attention.py:680 _qkv_fwd_call", 64, 50, "float32"),
    (2, "fused_attention.py:601 _qkv_fwd_probs_call", 7040, 20, "bfloat16"),
    (2, "fused_attention.py:601 _qkv_fwd_probs_call", 128, 50, "bfloat16"),
    (3, "fused_attention.py:642 _qkv_bwd_probs_call", 7040, 20, "bfloat16"),
    (3, "fused_attention.py:642 _qkv_bwd_probs_call", 128, 50, "bfloat16"),
    (4, "fused_attention.py:712 _qkv_bwd_call", 7040, 20, "bfloat16"),
    (5, "fused_attention.py:391 _fwd_call", 7040, 20, "bfloat16"),
    (6, "fused_attention.py:415 _bwd_call", 7040, 20, "bfloat16"),
    (7, "fused_attention.py:443 _masked_fwd_call", 7040, 20, "bfloat16"),
    (8, "fused_attention.py:468 _masked_bwd_call", 7040, 20, "bfloat16"),
    (9, "blockwise.py:156 _fwd_call", 128, 512, "bfloat16"),
    (10, "blockwise.py:215 _bwd_call", 128, 512, "bfloat16"),
    (11, "experimental_qkv2d.py:145 _fwd2d_call", 7040, 20, "bfloat16"),
    (12, "experimental_qkv2d.py:193 _bwd2d_call", 7040, 20, "bfloat16"),
    (13, "experimental_fused_encoder.py:257 _fwd_call", 7040, 20,
     "bfloat16"),
    (14, "experimental_fused_encoder.py:309 _bwd_call", 7040, 20,
     "bfloat16"),
    # rows 13-14 at every other shape of their table rows: the user
    # encoder in training (128, 50), the served corpus chunk (1024, 20)
    # and user encoder (64, 50) in f32, and a 512-news history (128, 512)
    # (masked or not: the mask's bytes are no part of the estimate)
    *[(row, site, n, t, dtype)
      for row, site in ((13, "experimental_fused_encoder.py:257 _fwd_call"),
                        (14, "experimental_fused_encoder.py:309 _bwd_call"))
      for n, t, dtype in ((128, 50, "bfloat16"), (1024, 20, "float32"),
                          (64, 50, "float32"), (128, 512, "bfloat16"))],
    (15, "experimental_blanes.py:143 _blanes_fwd_call", 7040, 20,
     "bfloat16"),
    (16, "experimental_blanes.py:171 _blanes_bwd_call", 7040, 20,
     "bfloat16"),
]


def main() -> None:
    print("| # | call site | N | T | dtype | MB | GFLOP | bound ms | by |")
    print("|---|---|---|---|---|---|---|---|---|")
    for row, site, n, t, dtype in ROWS:
        n_bytes, flops = costs(row, n, t, dtype)
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"| {row} | `{site}` | {n} | {t} | {dtype} | "
              f"{n_bytes / 1e6:.1f} | {flops / 1e9:.2f} | "
              f"{max(t_bytes, t_ops):.4f} | {by} |")


if __name__ == "__main__":
    main()
