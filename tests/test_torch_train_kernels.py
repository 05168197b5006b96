"""The port's training kernels on the CPU: the plain versions of kernel rows
2 (the probs-saving forward) and 3 (the backward from probs) against the
JAX package's Pallas kernels, the autograd Function against jax.grad and
against torch autograd through the plain forward, and the row max that
takes no gradient.

The JAX kernels run in Pallas interpret mode with the fused encoder-tail
kernel off (interpret mode alone turns it on) and bwd_residuals "probs",
all restored afterwards. The CUDA kernels themselves are held to these
plain versions on the card by tests/test_torch_kernel_gpu.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.ops import attention as jax_attention
from newsrecommendation_tpu.ops.pallas import fused_attention as jfa
from newsrecommendation_tpu.ops.pallas import set_fused_tail, set_pallas_mode
from newsrecommendation_tpu.ops.pallas.config import set_bwd_residuals
from newsrecommendation_tpu_torch.ops import attention as torch_attention
from newsrecommendation_tpu_torch.ops import fused_attention as fa
from tests.test_torch_fused_attention import make_case

HEADS, D = 3, 4  # make_case's heads and head width
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture
def jax_kernels():
    set_pallas_mode("interpret")
    set_fused_tail("off")
    set_bwd_residuals("probs")
    try:
        yield
    finally:
        set_pallas_mode("auto")
        set_fused_tail("auto")
        set_bwd_residuals("probs")


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch,
                                                                   dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _grad_out(seed=5):
    return np.random.default_rng(seed).normal(
        size=(6, 5, HEADS * D)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_fwd_probs_plain_matches_jax_kernel(jax_kernels, dtype, masked):
    qkv, bias, mask = make_case()
    key_mask = mask if masked else None
    jctx, jprobs = jfa._qkv_fwd_probs_call(
        _j(qkv, dtype), None if key_mask is None else jnp.asarray(key_mask),
        HEADS, D, 128, bias=_j(bias, dtype))
    ctx, probs = fa.exp_mhsa_qkv_bias_probs_reference(
        _t(qkv, dtype), _t(bias, dtype),
        None if key_mask is None else _t(key_mask), HEADS)
    assert ctx.dtype == getattr(torch, dtype)
    assert probs.dtype == torch.float32 and probs.shape == (6, 5, HEADS * 5)
    np.testing.assert_allclose(_np(ctx), _np(jctx), **FWD_TOL[dtype])
    np.testing.assert_allclose(_np(probs), _np(jprobs), **FWD_TOL[dtype])
    # the context is row 1's, bit for bit
    assert torch.equal(ctx, fa.exp_mhsa_qkv_bias_reference(
        _t(qkv, dtype), _t(bias, dtype),
        None if key_mask is None else _t(key_mask), HEADS))
    if masked:
        # fully masked row, and the row whose keys left underflow: 0
        assert (probs[2] == 0).all() and (probs[4] == 0).all()
        assert (np.asarray(jprobs)[2] == 0).all()
        # a masked key has probability 0 for every query of every head
        keys = np.tile(mask, (1, HEADS))[:, None, :]
        assert (_np(probs) * (1 - keys) == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_probs_plain_matches_jax_kernel(jax_kernels, dtype, masked):
    qkv, bias, mask = make_case()
    _, probs = fa.exp_mhsa_qkv_bias_probs_reference(
        _t(qkv, dtype), _t(bias, dtype), _t(mask) if masked else None, HEADS)
    g = _grad_out()
    ref = jfa._qkv_bwd_probs_call(_j(qkv, dtype), jnp.asarray(probs.numpy()),
                                  _j(g, dtype), HEADS, D, 128,
                                  bias=_j(bias, dtype))
    out = fa.qkv_bwd_probs_reference(_t(qkv, dtype), _t(bias, dtype), probs,
                                     _t(g, dtype), HEADS)
    assert out.dtype == getattr(torch, dtype) and out.shape == qkv.shape
    np.testing.assert_allclose(_np(out), _np(ref), **BWD_TOL[dtype])
    if masked:
        # a row whose probs are all 0 passes no gradient to its q, k, v
        assert (out[2] == 0).all()


def _jax_grads(qkv, bias, mask, g, dtype):
    def loss(q, b):
        if mask is None:
            out = jfa.exp_mhsa_qkv_bias(q, b, HEADS)
        else:
            out = jfa.exp_mhsa_qkv_bias_masked(q, b, jnp.asarray(mask), HEADS)
        return jnp.sum(out.astype(jnp.float32) * g)

    return jax.grad(loss, argnums=(0, 1))(_j(qkv, dtype), _j(bias, dtype))


def _torch_grads(fn, qkv, bias, mask, g, dtype):
    q = _t(qkv, dtype).requires_grad_()
    b = _t(bias, dtype).requires_grad_()
    out = fn(q, b, None if mask is None else _t(mask))
    (out.float() * _t(g)).sum().backward()
    return q.grad, b.grad


def _function(q, b, m):
    if m is None:
        return fa.exp_mhsa_qkv_bias(q, b, HEADS)
    return fa.exp_mhsa_qkv_bias_masked(q, b, m, HEADS)


def _plain(q, b, m):
    return fa.exp_mhsa_qkv_bias_reference(q, b, m, HEADS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_autograd_matches_jax_grad(jax_kernels, dtype, masked):
    qkv, bias, mask = make_case()
    mask = mask if masked else None
    g = _grad_out()
    jq, jb = _jax_grads(qkv, bias, mask, g, dtype)
    tq, tb = _torch_grads(_function, qkv, bias, mask, g, dtype)
    assert tq.dtype == getattr(torch, dtype) and tb.dtype == tq.dtype
    np.testing.assert_allclose(_np(tq), _np(jq), **BWD_TOL[dtype])
    np.testing.assert_allclose(_np(tb), _np(jb), **BWD_TOL[dtype])


@pytest.mark.parametrize("masked", [False, True])
def test_autograd_matches_autograd_through_plain(masked):
    """Row 3's plain version is the derivative of rows 1-2's: torch's own
    autograd through the plain forward gives the same grads."""
    qkv, bias, mask = make_case(seed=3)
    mask = mask if masked else None
    g = _grad_out(seed=6)
    tq, tb = _torch_grads(_function, qkv, bias, mask, g, "float32")
    pq, pb = _torch_grads(_plain, qkv, bias, mask, g, "float32")
    np.testing.assert_allclose(tq.numpy(), pq.numpy(), **BWD_TOL["float32"])
    np.testing.assert_allclose(tb.numpy(), pb.numpy(), **BWD_TOL["float32"])


def test_grad_mode_picks_the_probs_forward():
    """Under differentiation the forward saves probs for row 3; without it
    (no_grad, inference_mode, nothing requiring grad) it is row 1. Both
    give the same context."""
    qkv, bias, mask = make_case()
    q, b, m = _t(qkv).requires_grad_(), _t(bias), _t(mask)
    out = fa.exp_mhsa_qkv_bias_masked(q, b, m, HEADS)
    assert type(out.grad_fn).__name__ == "_ExpMhsaQkvBiasBackward"
    with torch.no_grad():
        plain = fa.exp_mhsa_qkv_bias_masked(q, b, m, HEADS)
    with torch.inference_mode():
        served = fa.exp_mhsa_qkv_bias_masked(q, b, m, HEADS)
    frozen = fa.exp_mhsa_qkv_bias_masked(q.detach(), b, m, HEADS)
    for x in (plain, served, frozen):
        assert x.grad_fn is None and torch.equal(x, out.detach())
    fa.reset_launch_counts()
    out.sum().backward()  # CPU: the plain versions, no launch counted
    assert all(not any(fa.launch_counts(k).values()) for k in fa.KERNELS)


def test_backward_takes_any_gradient_layout_and_dtype():
    """The incoming gradient may be strided and f32 for a bf16 forward; it
    is made contiguous in qkv's dtype, as JAX's g.astype(qkv.dtype)."""
    qkv, bias, _ = make_case()
    q = _t(qkv, "bfloat16").requires_grad_()
    b = _t(bias, "bfloat16").requires_grad_()
    out = fa.exp_mhsa_qkv_bias(q, b, HEADS)
    g = _t(_grad_out()).transpose(0, 1).contiguous().transpose(0, 1)
    assert not g.is_contiguous()
    out.float().backward(g)
    ref = fa.qkv_bwd_probs_reference(
        q.detach(), b.detach(), fa.exp_mhsa_qkv_bias_probs_reference(
            q.detach(), b.detach(), None, HEADS)[1],
        g.to(torch.bfloat16).contiguous(), HEADS)
    assert torch.equal(q.grad, ref)
    assert torch.equal(b.grad, ref.sum((0, 1)).to(torch.bfloat16))


def test_other_devices_raise_under_grad():
    """Off the CPU there is no plain stand-in, with or without grad: a meta
    tensor (standing in for a CUDA one) raises in the forward."""
    qkv = torch.empty((2, 5, 24), device="meta", requires_grad=True)
    bias = torch.empty(24, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="no kernel"):
        fa.exp_mhsa_qkv_bias(qkv, bias, 2)
    with pytest.raises(ValueError, match="probs"):
        fa.qkv_bwd_probs_reference(torch.zeros(2, 5, 24), torch.zeros(24),
                                   torch.zeros(2, 5, 9), torch.zeros(2, 5, 8),
                                   2)


def test_masked_exp_normalize_grad_with_tied_max_matches_jax():
    """m = max over the row takes no gradient (JAX: stop_gradient). Two
    masked keys tie for the row max: their gradient is exactly 0, as in
    JAX. With a max that takes gradient, amax would route the rounding
    residue of the (analytically 0) d/dm term to them."""
    rng = np.random.default_rng(0)
    s = rng.normal(scale=2.0, size=(8, 9)).astype(np.float32)
    s[:, 2] = s[:, 5] = s.max(-1) + 0.5
    mask = (rng.random((8, 9)) > 0.3).astype(np.float32)
    mask[:, [2, 5]] = 0.0
    mask[:, 0] = 1.0
    w = rng.normal(size=(8, 9)).astype(np.float32)
    for m in (None, mask):
        jg = jax.grad(lambda x: jnp.sum(jax_attention.masked_exp_normalize(
            x, None if m is None else jnp.asarray(m)) * w))(jnp.asarray(s))
        x = torch.from_numpy(s).requires_grad_()
        (torch_attention.masked_exp_normalize(
            x, None if m is None else torch.from_numpy(m))
         * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg),
                                   rtol=1e-6, atol=1e-7)
        if m is not None:
            np.testing.assert_array_equal(x.grad.numpy()[:, [2, 5]], 0.0)
            np.testing.assert_array_equal(np.asarray(jg)[:, [2, 5]], 0.0)
