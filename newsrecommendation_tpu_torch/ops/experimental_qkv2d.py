"""Exp-MHSA with 2-D I/O: the fused-qkv attention fed the projection's
(N*T, 3HD) product as it is, with the backward's dqkv in the same layout.

Replaces, in ``newsrecommendation_tpu/ops/pallas/experimental_qkv2d.py``:
  - ``_fwd2d_call`` (``_fwd2d_kernel``): the forward, which always writes
    the f32 probs -> row 2's launch (``csrc/qkv_fwd.cu``
    ``qkv_fwd_probs``) on the (N, T, 3HD) view, kernel "qkv2d_fwd"
    (row 11);
  - ``_bwd2d_call`` (``_bwd2d_probs_kernel``): the backward from those
    probs -> row 3's launch (``csrc/qkv_bwd_probs.cu``) on the same view,
    kernel "qkv2d_bwd" (row 12).
On the TPU the 2-D and 3-D forms tile differently, and these kernels
regroup the rows in VMEM. On the card a contiguous (N*T, 3HD) tensor and
its (N, T, 3HD) view are the same bytes, so rows 11-12 are the launches
of rows 2-3, in their plans, and give their results bit for bit. The JAX package's contract stays: unmasked
only (a mask raises), the forward always writes probs and the backward
always reads them, whatever ``bwd_residuals`` says, and d(bias) is the sum
of dqkv over its rows.

A CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises. Builds and launch counts: ``ops/kernels.py``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernels


def _check(qkv2d, bias, n_heads, t, key_mask=None):
    if key_mask is not None:
        raise NotImplementedError(
            "the 2-D-I/O attention is unmasked only, as the JAX package's "
            "_fwd2d_call")
    if qkv2d.dim() != 2:
        raise ValueError(f"qkv2d must be (N*T, 3*H*D), got "
                         f"{tuple(qkv2d.shape)}")
    nt, w3 = qkv2d.shape
    if t < 1 or nt % t != 0:
        raise ValueError(f"{nt} rows are not a multiple of T={t}")
    n, _, d = fa._check(qkv2d.view(nt // t, t, w3), bias, None, n_heads)
    return n, d


def _check_launch(*operands):
    kernels.check_operands(*operands)
    qkv2d, bias = operands[:2]
    if bias.dtype != qkv2d.dtype:
        raise TypeError(f"bias dtype {bias.dtype} != qkv dtype {qkv2d.dtype}")


def qkv2d_fwd(qkv2d, bias, n_heads: int, t: int, key_mask=None):
    """Kernel row 11 on CUDA tensors: (ctx (N, T, HD), probs (N, T, H*T)
    f32) from the un-biased (N*T, 3HD) projection and its bias, each equal
    to row 2's on the (N, T, 3HD) view. A key mask raises. Raises for other
    devices."""
    n, d = _check(qkv2d, bias, n_heads, t, key_mask)
    _check_launch(qkv2d, bias)
    out = torch.empty((n, t, n_heads * d), dtype=qkv2d.dtype,
                      device=qkv2d.device)
    probs = torch.empty((n, t, n_heads * t), dtype=torch.float32,
                        device=qkv2d.device)
    # row 2's launch on the (N, T, 3HD) view: its regime, plan and bits
    fa.fwd_call("fwd2d", qkv2d, bias, None, out, probs, n, t, n_heads, d)
    return out, probs


def qkv2d_bwd(qkv2d, bias, probs, g, n_heads: int, t: int):
    """Kernel row 12 on CUDA tensors: dqkv (N*T, 3HD) in qkv's dtype from
    the probs row 11 wrote and the context's gradient g (N, T, HD), equal
    to row 3's on the 3-D views. Raises for other devices."""
    n, d = _check(qkv2d, bias, n_heads, t)
    fa._check_bwd(qkv2d.view(n, t, -1), bias, probs, g, n_heads)
    _check_launch(qkv2d, bias, probs, g)
    dqkv = torch.empty_like(qkv2d)
    # row 3's launch on the (N, T, 3HD) views: its regime, plan and bits
    fa._bwd_call("bwd2d", "qkv_bwd_probs", "qkv_bwd_probs",
                 qkv2d.view(n, t, -1), bias, probs, g, dqkv, n, t, n_heads, d)
    return dqkv


def qkv2d_fwd_reference(qkv2d, bias, n_heads: int, t: int, key_mask=None):
    """Plain PyTorch version of row 11: rows 1-2's plain version on the
    (N, T, 3HD) view. Returns (ctx, probs)."""
    n, _ = _check(qkv2d, bias, n_heads, t, key_mask)
    return fa.exp_mhsa_qkv_bias_probs_reference(qkv2d.view(n, t, -1), bias,
                                                None, n_heads)


def qkv2d_bwd_reference(qkv2d, bias, probs, g, n_heads: int, t: int):
    """Plain PyTorch version of row 12: row 3's plain version on the 3-D
    view, dqkv returned as (N*T, 3HD)."""
    n, _ = _check(qkv2d, bias, n_heads, t)
    return fa.qkv_bwd_probs_reference(qkv2d.view(n, t, -1), bias, probs, g,
                                      n_heads).view(qkv2d.shape)


class _ExpMhsaQkvBias2d(torch.autograd.Function):
    """Row 11 forward (saves qkv, bias and the probs), row 12 backward;
    their plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, qkv2d, bias, n_heads, t):
        fwd = (qkv2d_fwd_reference if qkv2d.device.type == "cpu"
               else qkv2d_fwd)
        out, probs = fwd(qkv2d, bias, n_heads, t)
        ctx.n_heads, ctx.t = n_heads, t
        ctx.save_for_backward(qkv2d, bias, probs)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv2d, bias, probs = ctx.saved_tensors
        g = g.to(qkv2d.dtype).contiguous()
        bwd = (qkv2d_bwd_reference if qkv2d.device.type == "cpu"
               else qkv2d_bwd)
        dqkv = bwd(qkv2d, bias, probs, g, ctx.n_heads, ctx.t)
        dbias = (dqkv.sum(0).to(bias.dtype) if ctx.needs_input_grad[1]
                 else None)
        return dqkv, dbias, None, None


def exp_mhsa_qkv_bias_2d(qkv2d, bias, n_heads: int, t: int):
    """Exp-MHSA over the un-biased projection (N*T, 3HD) in its 2-D layout
    plus its bias (3HD,). Returns the context (N, T, HD); the gradient of
    qkv2d comes back (N*T, 3HD). Unmasked only."""
    if torch.is_grad_enabled() and (qkv2d.requires_grad or bias.requires_grad):
        return _ExpMhsaQkvBias2d.apply(qkv2d, bias, n_heads, t)
    if qkv2d.device.type == "cpu":
        return qkv2d_fwd_reference(qkv2d, bias, n_heads, t)[0]
    return qkv2d_fwd(qkv2d, bias, n_heads, t)[0]
