"""Attention blocks: additive attention pooling and exp-normalised
multi-head self attention.

The normalisation is NOT a masked softmax: scores are exponentiated, the
0/1 mask multiplies in AFTER the exp, and the sum gets 1e-8 added
(reference model_utils.py:21-29, 47-53). A fully masked row gives an
all-zero distribution (output 0), not uniform attention.

``masked_exp_normalize`` computes that stably: it shifts by the row max m
(over all keys, masked ones included) and scales the epsilon by exp(-m),
which is algebraically the same expression for any m.
"""

from __future__ import annotations

import torch

from newsrecommendation_tpu_torch.ops.common import dropout as _dropout
from newsrecommendation_tpu_torch.ops.common import linear
from newsrecommendation_tpu_torch.utils import init as pinit

_EPS = 1e-8


def masked_exp_normalize(scores, mask=None, dim: int = -1,
                         eps: float = _EPS):
    """exp(scores)*mask / (sum(exp(scores)*mask) + eps), stably, in f32.

    mask: broadcastable 0/1 float or None.
    """
    scores = scores.float()
    # m only shifts the exponent and cancels in the quotient: no gradient
    # flows through it (with ties, amax would split one between the tied
    # entries and leave rounding residue where the true term is 0)
    m = torch.amax(scores, dim=dim, keepdim=True).detach()
    num = torch.exp(scores - m)
    if mask is not None:
        num = num * mask.to(num.dtype)
    den = torch.sum(num, dim=dim, keepdim=True) + eps * torch.exp(-m)
    # den can be +inf (all scores deeply negative) but never 0: guard anyway
    return torch.where(den > 0, num / den, torch.zeros_like(num))


# --------------------------------------------------------------------------
# Additive attention pooling (reference model_utils.py:7-31)
# --------------------------------------------------------------------------


def init_attention_pooling(gen, emb_size: int, hidden_size: int):
    return {
        "fc1": pinit.torch_linear(gen, emb_size, hidden_size),
        "fc2": pinit.torch_linear(gen, hidden_size, 1),
    }


def attention_pooling(params, x, mask=None):
    """Weighted pooling over dim -2.

    x: (..., S, D); mask: (..., S) or None. Returns (..., D).
    alpha = exp_normalize(fc2(tanh(fc1(x)))), out = sum_s alpha_s * x_s.
    """
    e = torch.tanh(linear(params["fc1"], x))
    a = linear(params["fc2"], e)[..., 0]  # (..., S)
    alpha = masked_exp_normalize(a, mask, dim=-1)
    return torch.einsum("...sd,...s->...d", x, alpha.to(x.dtype))


# --------------------------------------------------------------------------
# Multi-head self attention (reference model_utils.py:58-95)
# --------------------------------------------------------------------------


def init_multi_head_self_attention(gen, d_model: int, n_heads: int,
                                   d_k: int, d_v: int | None = None):
    """Q/K/V projections only: the reference has no output projection."""
    d_v = d_k if d_v is None else d_v
    return {
        "wq": pinit.xavier_linear(gen, d_model, n_heads * d_k),
        "wk": pinit.xavier_linear(gen, d_model, n_heads * d_k),
        "wv": pinit.xavier_linear(gen, d_model, n_heads * d_v),
    }


def _fused_qkv(params, x):
    """One (d_model, nq+nk+nv) projection instead of three.

    Returns (qkv_2d, (n, s), bias, nq, nk, nv) with the bias NOT yet added:
    the kernel adds it as it loads qkv, saving a pass over the (N, S, 3HD)
    tensor.
    """
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    w = torch.cat([wq["w"], wk["w"], wv["w"]], dim=1).to(x.dtype)
    bias = torch.cat([wq["b"], wk["b"], wv["b"]]).to(x.dtype)
    n, s, dm = x.shape
    qkv_2d = torch.matmul(x.reshape(n * s, dm), w)
    return (qkv_2d, (n, s), bias,
            wq["w"].shape[1], wk["w"].shape[1], wv["w"].shape[1])


def mhsa_dropout_pool(mhsa_params, pool_params, x, mask=None, *,
                      n_heads: int, drop_rate: float = 0.0,
                      generator: torch.Generator | None = None,
                      deterministic: bool = True):
    """The NRMS encoder tail: MHSA -> dropout -> additive attention pooling.

    x: (B, S, d_model); mask: (B, S) over keys/positions or None.
    Returns (B, n_heads*d_v). With ``kernel_config.fused_tail_enabled()``
    and equal q/k/v widths the tail is one kernel per direction
    (``_fused_tail``); otherwise it is composed of the attention kernels,
    dropout and the pooling's products.
    """
    from newsrecommendation_tpu_torch.ops import kernel_config

    qkv_2d, bs, bias, nq, nk, nv = _fused_qkv(mhsa_params, x)
    if (nq == nk == nv and nq % n_heads == 0
            and kernel_config.fused_tail_enabled(n_heads)):
        return _fused_tail(qkv_2d, bs, bias, pool_params, x, mask, n_heads,
                           drop_rate, generator, deterministic)
    ctx = _mhsa_from_qkv(qkv_2d, bs, bias, nq, nk, nv, mask, n_heads=n_heads)
    ctx = _dropout(ctx, drop_rate, deterministic, generator)
    return attention_pooling(pool_params, ctx, mask)


def _fused_tail(qkv_2d, bs, bias, pool_params, x, mask, n_heads, drop_rate,
                generator, deterministic):
    """The whole tail as one kernel per direction (rows 13-14), whatever
    flash_min_seq and attention_io say, fed as the JAX package feeds it:
    qkv biased in the input dtype, w1 and w2 cast to it, b1 and b2 in f32,
    and a seed in [0, 2**31 - 1) drawn on the device from the step's
    generator when dropout is on (zeros otherwise)."""
    from newsrecommendation_tpu_torch.ops import experimental_fused_encoder

    qkv = qkv_2d.reshape(*bs, qkv_2d.shape[-1]) + bias
    use_dropout = not deterministic and drop_rate > 0.0
    if use_dropout:
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=x.device, dtype=torch.int32)
    else:
        seed = torch.zeros((1,), dtype=torch.int32, device=x.device)
    w1 = pool_params["fc1"]["w"].to(x.dtype)
    b1 = pool_params["fc1"]["b"][None, :].float()
    w2 = pool_params["fc2"]["w"].to(x.dtype)
    b2 = pool_params["fc2"]["b"][None, :].float()
    args = (w1, b1, w2, b2, seed, n_heads, float(drop_rate), not use_dropout)
    if mask is None:
        return experimental_fused_encoder.exp_mhsa_pool(qkv, *args)
    return experimental_fused_encoder.exp_mhsa_pool_masked(
        qkv, mask.float().contiguous(), *args)


def multi_head_self_attention(params, x, mask=None, *, n_heads: int):
    """Self-attention over x (B, S, d_model); mask (B, S) over keys or
    None. Returns (B, S, n_heads*d_v)."""
    qkv_2d, bs, bias, nq, nk, nv = _fused_qkv(params, x)
    return _mhsa_from_qkv(qkv_2d, bs, bias, nq, nk, nv, mask,
                          n_heads=n_heads)


def _mhsa_from_qkv(qkv_2d, bs, bias, nq, nk, nv, mask=None, *, n_heads: int):
    """MHSA over the un-biased fused projection output (B*S, nq+nk+nv),
    routed as the JAX package routes it. With unequal widths (d_v != d_k),
    the separate-q/k/v kernels (rows 5-8) on q, k, v cut from the biased
    projection. With equal widths, a sequence of at least
    ``kernel_config.flash_min_seq()`` keys goes to the key-blocked flash
    kernels on the same cuts; a shorter one, under
    ``attention_layout() == "blanes"``, to the batch-in-lanes kernels (rows
    15-16) on the biased (B, S, 3HD) view; else to the fused-qkv kernels,
    which add the bias themselves: unmasked with ``attention_io() == "2d"``
    to rows 11-12 on the 2-D product, otherwise to rows 1-4 on its
    (B, S, 3HD) view. The route is the same on every device; the device
    picks kernel (CUDA) or plain version (CPU).
    """
    if nq != nk:
        raise ValueError(f"q and k widths differ ({nq}, {nk})")
    b, s = bs
    qkv_raw = qkv_2d.reshape(b, s, qkv_2d.shape[-1])
    from newsrecommendation_tpu_torch.ops import blockwise, kernel_config
    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    if mask is not None:
        mask = mask.float().contiguous()
    if nv != nq:
        q, k, v = torch.split(qkv_raw + bias, [nq, nk, nv], dim=-1)
        if mask is None:
            return fa.exp_mhsa(q, k, v, n_heads)
        return fa.exp_mhsa_masked(q, k, v, mask, n_heads)
    if s >= kernel_config.flash_min_seq():
        q, k, v = torch.split(qkv_raw + bias, [nq, nk, nv], dim=-1)
        if mask is None:
            return blockwise.flash_exp_mhsa(q, k, v, n_heads)
        return blockwise.flash_exp_mhsa_masked(q, k, v, mask, n_heads)
    if kernel_config.attention_layout() == "blanes":
        from newsrecommendation_tpu_torch.ops import experimental_blanes

        qkv = qkv_raw + bias
        if mask is None:
            return experimental_blanes.exp_mhsa_qkv_blanes(qkv, n_heads)
        return experimental_blanes.exp_mhsa_qkv_blanes_masked(qkv, mask,
                                                              n_heads)
    if mask is None:
        if kernel_config.attention_io() == "2d":
            # the (B*S, 3HD) product as it is: rows 11-12
            from newsrecommendation_tpu_torch.ops import experimental_qkv2d

            return experimental_qkv2d.exp_mhsa_qkv_bias_2d(qkv_2d, bias,
                                                           n_heads, s)
        return fa.exp_mhsa_qkv_bias(qkv_raw, bias, n_heads)
    return fa.exp_mhsa_qkv_bias_masked(qkv_raw, bias, mask, n_heads)
