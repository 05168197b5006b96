"""1-D convolution over token sequences (NAML's title CNN).

The data stays in (B, T, C), as in the JAX package (``ops/conv.py`` there,
whose two lowerings, a conv op and per-tap products with shift-adds,
compute the same function). Here it is one lowering: the input padded by
k // 2 zero rows on each side, its k shifted (B, T, Cin) views side by
side as one (B*T, k*Cin) operand, times the weight (k, Cin, Cout) read as
(k*Cin, Cout): one matrix product, no layout copy of the output.

Precision: a matrix product, so cuBLAS computes it in f32 on f32 inputs
under torch's default ``torch.backends.cuda.matmul.allow_tf32 = False``,
like every other product of the port. ``F.conv1d`` would go to cuDNN,
whose ``torch.backends.cudnn.allow_tf32`` is True by default and rounds
f32 operands to TF32 (about 1e-3 off). No global flag is set here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from newsrecommendation_tpu_torch.utils import init as pinit


def init_conv1d(gen, in_channels: int, out_channels: int,
                kernel_size: int = 3, dtype=torch.float32):
    return pinit.torch_conv1d(gen, in_channels, out_channels, kernel_size,
                              dtype)


def conv1d_same(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, Cin) -> (B, T, Cout), SAME padding (torch padding=k//2
    for odd k); the weight and bias cast to x's dtype.

    out[t] = sum_j x[t + j - k//2] @ w[j] + b, rows outside [0, T) zero.
    """
    w = params["w"].to(x.dtype)  # (k, Cin, Cout)
    k, cin, cout = w.shape
    pad = k // 2
    b, t, _ = x.shape
    xp = F.pad(x, (0, 0, pad, k - 1 - pad))  # (B, T + k - 1, Cin)
    cols = torch.cat([xp[:, j:j + t] for j in range(k)], dim=-1)
    out = torch.matmul(cols.reshape(b * t, k * cin), w.reshape(k * cin, cout))
    return out.reshape(b, t, cout) + params["b"].to(x.dtype)
