"""Parameter initializers with the JAX package's init laws, drawn from an
explicit ``torch.Generator``.

  - torch nn.Linear default: weight and bias ~ U(-1/sqrt(fan_in),
    1/sqrt(fan_in)); nn.Conv1d the same with fan_in = in_channels *
    kernel_size.
  - the MHSA projections: xavier_uniform weight (gain 1), default bias.
  - embeddings: N(0, 1) with row 0 zeroed (padding_idx 0).
  - the user encoder's pad_doc: U(-1, 1).

Weights are stored input-major, (in, out), as in the JAX package, so the
same param tree moves between the two without transposes (bridge.py).
The two frameworks draw different numbers from the same seed: tests feed
both sides the same numpy-made params instead.
"""

from __future__ import annotations

import math

import torch


def uniform(gen: torch.Generator, shape, bound: float,
            dtype=torch.float32) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=dtype)
    return u * (2.0 * bound) - bound


def torch_linear(gen, fan_in: int, fan_out: int, dtype=torch.float32):
    """{'w': (fan_in, fan_out), 'b': (fan_out,)} with torch Linear defaults."""
    bound = 1.0 / math.sqrt(fan_in)
    return {
        "w": uniform(gen, (fan_in, fan_out), bound, dtype),
        "b": uniform(gen, (fan_out,), bound, dtype),
    }


def xavier_linear(gen, fan_in: int, fan_out: int, dtype=torch.float32):
    """Linear with xavier_uniform weight (gain 1) + torch-default bias."""
    return {
        "w": uniform(gen, (fan_in, fan_out),
                     math.sqrt(6.0 / (fan_in + fan_out)), dtype),
        "b": uniform(gen, (fan_out,), 1.0 / math.sqrt(fan_in), dtype),
    }


def torch_conv1d(gen, in_channels: int, out_channels: int,
                 kernel_size: int, dtype=torch.float32):
    """Conv1d params with torch defaults: {'w': (kernel_size, in_channels,
    out_channels), 'b': (out_channels,)}, the JAX package's (width, in,
    out) layout, both ~ U(+-1/sqrt(in_channels * kernel_size))."""
    bound = 1.0 / math.sqrt(in_channels * kernel_size)
    return {
        "w": uniform(gen, (kernel_size, in_channels, out_channels), bound,
                     dtype),
        "b": uniform(gen, (out_channels,), bound, dtype),
    }


def embedding(gen, num_embeddings: int, dim: int, dtype=torch.float32,
              padding_idx0: bool = True) -> torch.Tensor:
    """nn.Embedding default init N(0,1); row 0 zeroed when padding_idx0."""
    table = torch.randn((num_embeddings, dim), generator=gen, dtype=dtype)
    if padding_idx0:
        table[0] = 0.0
    return table
