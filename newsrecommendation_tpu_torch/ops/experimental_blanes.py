"""Batch-in-lanes ("blanes") exp-MHSA over a biased fused [q|k|v]
projection: a CUDA kernel pair behind an autograd Function, and their
plain PyTorch versions.

Replaces, in ``newsrecommendation_tpu/ops/pallas/experimental_blanes.py``:
  - ``_blanes_fwd_call`` (``_blanes_fwd_kernel``): the forward, unmasked
    and key-masked -> ``csrc/blanes.cu``, kernel "blanes_fwd" (row 15);
  - ``_blanes_bwd_call`` (``_blanes_bwd_kernel``): the backward, which
    recomputes the probs and writes the fused dqkv -> ``csrc/blanes.cu``,
    kernel "blanes_bwd" (row 16).
``ops/attention.py`` routes here under ``set_attention_layout("blanes")``
(the Config field ``attention_layout``), as the JAX package's dispatch
does: after the flash check, before the 2-D-I/O one, masked and unmasked.

The function is rows 1 and 4's on qkv with the bias already added (max over
all keys, mask after the exp, the 1e-8 exp(-m) term, a rounded to v's
dtype before a@v, ds to k's before the dq and dk dots, f32 sums), so the
plain versions are rows 1 and 4's with a zero bias. The kernels are their
own: the TPU kernel puts the batch in the vector lanes, and these put it in
a warp's lanes (``csrc/blanes.cu``). The backward always recomputes,
whatever ``bwd_residuals`` says, as the JAX package's custom VJPs do.

A CPU tensor takes the plain versions, a CUDA tensor launches the kernels
or raises. Builds and launch counts: ``ops/kernels.py``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernels

MAX_HEAD = 64  # widest head the kernels take


def _check(qkv, key_mask, n_heads):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (N, T, 3*H*D), got {tuple(qkv.shape)}")
    n, t, w3 = qkv.shape
    if n_heads < 1 or w3 % (3 * n_heads) != 0:
        raise ValueError(f"qkv width {w3} is not 3 * n_heads({n_heads}) * D")
    if key_mask is not None and key_mask.shape != (n, t):
        raise ValueError(f"key_mask must be ({n}, {t}), "
                         f"got {tuple(key_mask.shape)}")
    return n, t, w3 // (3 * n_heads)


def blanes_fwd_reference(qkv, key_mask, n_heads: int):
    """Plain PyTorch version of row 15: the context (N, T, HD) in qkv's
    dtype from the biased qkv and the key mask (N, T) f32 or None."""
    _check(qkv, key_mask, n_heads)
    return fa.exp_mhsa_qkv_bias_reference(qkv, qkv.new_zeros(qkv.shape[-1]),
                                          key_mask, n_heads)


def blanes_bwd_reference(qkv, key_mask, g, n_heads: int):
    """Plain PyTorch version of row 16: dqkv (N, T, 3HD) in qkv's dtype
    from the biased qkv, the key mask or None and the context's gradient g
    (N, T, HD) in qkv's dtype, the probs recomputed."""
    _check(qkv, key_mask, n_heads)
    return fa.qkv_bwd_reference(qkv, qkv.new_zeros(qkv.shape[-1]), key_mask,
                                g, n_heads)


def _check_launch(qkv, key_mask, d, *more):
    kernels.check_operands(qkv, key_mask, *more)
    if key_mask is not None and key_mask.dtype != torch.float32:
        raise TypeError(f"key_mask must be float32, got {key_mask.dtype}")
    if d > MAX_HEAD:
        raise NotImplementedError(f"D={d}: the blanes kernels take heads of "
                                  f"at most {MAX_HEAD}")


def blanes_fwd(qkv, key_mask, n_heads: int):
    """Kernel row 15 on CUDA tensors, with the plain version's contract.
    Raises for other devices."""
    n, t, d = _check(qkv, key_mask, n_heads)
    _check_launch(qkv, key_mask, d)
    out = torch.empty((n, t, n_heads * d), dtype=qkv.dtype,
                      device=qkv.device)
    kernels.call("blanes" if key_mask is None else "blanes_masked",
                 kernels.entry("blanes", "blanes_fwd", qkv.dtype),
                 qkv.device, qkv.data_ptr(), kernels.ptr(key_mask),
                 out.data_ptr(), n, t, n_heads, d)
    return out


def blanes_bwd(qkv, key_mask, g, n_heads: int):
    """Kernel row 16 on CUDA tensors, with the plain version's contract.
    Raises for other devices."""
    n, t, d = _check(qkv, key_mask, n_heads)
    if g.shape != (n, t, n_heads * d) or g.dtype != qkv.dtype:
        raise ValueError(f"g must be {qkv.dtype} ({n}, {t}, {n_heads * d}), "
                         f"got {g.dtype} {tuple(g.shape)}")
    _check_launch(qkv, key_mask, d, g)
    dqkv = torch.empty_like(qkv)
    # each (row, head, query)'s m, den and r, from the kernel's first phase
    # to its second
    stats = torch.empty(
        (kernels.size_of("blanes", "blanes_bwd_stats_floats", n, t,
                         n_heads),), dtype=torch.float32, device=qkv.device)
    kernels.call("blanes_bwd" if key_mask is None else "blanes_bwd_masked",
                 kernels.entry("blanes", "blanes_bwd", qkv.dtype), qkv.device,
                 qkv.data_ptr(), kernels.ptr(key_mask), g.data_ptr(),
                 dqkv.data_ptr(), stats.data_ptr(), n, t, n_heads, d)
    return dqkv


class _ExpMhsaQkvBlanes(torch.autograd.Function):
    """Row 15 forward (saves qkv and the mask), row 16 backward; their plain
    versions for CPU tensors. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, key_mask, n_heads):
        ctx.n_heads = n_heads
        ctx.save_for_backward(qkv, key_mask)
        fwd = blanes_fwd_reference if qkv.device.type == "cpu" else blanes_fwd
        return fwd(qkv, key_mask, n_heads)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv, key_mask = ctx.saved_tensors
        # the gradient arrives in any layout and float type: the kernel
        # takes it contiguous in qkv's dtype
        g = g.to(qkv.dtype).contiguous()
        bwd = blanes_bwd_reference if qkv.device.type == "cpu" else blanes_bwd
        return bwd(qkv, key_mask, g, ctx.n_heads), None, None


def _attend(qkv, key_mask, n_heads):
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _ExpMhsaQkvBlanes.apply(qkv, key_mask, n_heads)
    if qkv.device.type == "cpu":
        return blanes_fwd_reference(qkv, key_mask, n_heads)
    return blanes_fwd(qkv, key_mask, n_heads)


def exp_mhsa_qkv_blanes(qkv, n_heads: int):
    """Exp-MHSA over a biased fused projection (N, T, 3HD), batch-in-lanes
    kernels. Returns the context (N, T, HD), differentiable in qkv."""
    return _attend(qkv, None, n_heads)


def exp_mhsa_qkv_blanes_masked(qkv, key_mask, n_heads: int):
    """Key-masked exp_mhsa_qkv_blanes; key_mask (N, T) float32 0/1 over
    keys. A row whose keys are all masked gives 0."""
    return _attend(qkv, key_mask, n_heads)
