"""Elementwise building blocks shared across ops."""

from __future__ import annotations

import torch


def linear(params, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b with params {'w': (in, out), 'b': (out,)}.

    Weights are kept input-major, as in the JAX package (not nn.Linear's
    (out, in)), and cast to x's dtype, so bf16 activations run the product
    in bf16 over f32 params exactly as the JAX package does.
    """
    w = params["w"].to(x.dtype)
    b = params["b"].to(x.dtype)
    return torch.matmul(x, w) + b


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout (scale kept values by 1/keep); identity when
    ``deterministic`` (serving, eval) or ``rate == 0``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
