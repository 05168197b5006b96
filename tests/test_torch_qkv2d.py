"""The port's 2-D-I/O attention (kernel rows 11-12) on the CPU: its plain
versions against the JAX package's _fwd2d_call and _bwd2d_call, equal in
every element to rows 2-3's plain versions, the autograd Function against
jax.grad, and ``set_attention_io("2d")`` routing of
``multi_head_self_attention`` against JAX's with the same switch.

The JAX kernels run in Pallas interpret mode with the fused encoder-tail
kernel off, every switch restored afterwards. The CUDA kernels are held to
rows 2-3's on the card by tests/test_torch_kernel_gpu.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.ops import attention as jax_attention
from newsrecommendation_tpu.ops.pallas import config as jax_config
from newsrecommendation_tpu.ops.pallas import experimental_qkv2d as jq2
from newsrecommendation_tpu.ops.pallas import set_fused_tail, set_pallas_mode
from newsrecommendation_tpu_torch.ops import attention
from newsrecommendation_tpu_torch.ops import experimental_qkv2d as q2
from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernel_config, kernels
from tests.test_torch_fused_attention import make_case

HEADS, D = 3, 4  # make_case's heads and head width
N, T = 6, 5
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture
def io2d():
    """attention_io "2d" in both packages, JAX's kernels interpreted."""
    set_pallas_mode("interpret")
    set_fused_tail("off")
    jax_config.set_attention_io("2d")
    kernel_config.set_attention_io("2d")
    try:
        yield
    finally:
        set_pallas_mode("auto")
        set_fused_tail("auto")
        jax_config.set_attention_io("3d")
        kernel_config.set_attention_io("3d")


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch,
                                                                   dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _case(seed=0):
    qkv, bias, _ = make_case(seed=seed)
    g = np.random.default_rng(seed + 10).normal(
        size=(N, T, HEADS * D)).astype(np.float32)
    return qkv.reshape(N * T, -1), bias, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_kernels(dtype):
    qkv2d, bias, g = _case()
    set_pallas_mode("interpret")
    try:
        jout, jprobs = jq2._fwd2d_call(_j(qkv2d, dtype), _j(bias, dtype),
                                       None, HEADS, D, T, 128)
        jdq = jq2._bwd2d_call(_j(qkv2d, dtype), _j(bias, dtype), jprobs,
                              _j(g, dtype), HEADS, D, T, 128)
    finally:
        set_pallas_mode("auto")
    tq, tb = _t(qkv2d, dtype), _t(bias, dtype)
    out, probs = q2.qkv2d_fwd_reference(tq, tb, HEADS, T)
    assert out.shape == (N, T, HEADS * D) and out.dtype == tq.dtype
    assert probs.shape == (N, T, HEADS * T) and probs.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(jout), **FWD_TOL[dtype])
    np.testing.assert_allclose(_np(probs), _np(jprobs), **FWD_TOL["float32"])
    dq = q2.qkv2d_bwd_reference(tq, tb, probs, _t(g, dtype), HEADS, T)
    assert dq.shape == tq.shape and dq.dtype == tq.dtype
    np.testing.assert_allclose(_np(dq), _np(jdq), **BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_equal_rows_2_3(dtype):
    """Rows 11-12 are rows 2-3 on the (N, T, 3HD) view, element for
    element."""
    qkv2d, bias, g = _case(seed=1)
    tq, tb, tg = _t(qkv2d, dtype), _t(bias, dtype), _t(g, dtype)
    out, probs = q2.qkv2d_fwd_reference(tq, tb, HEADS, T)
    out3, probs3 = fa.exp_mhsa_qkv_bias_probs_reference(tq.view(N, T, -1),
                                                        tb, None, HEADS)
    assert torch.equal(out, out3) and torch.equal(probs, probs3)
    dq = q2.qkv2d_bwd_reference(tq, tb, probs, tg, HEADS, T)
    dq3 = fa.qkv_bwd_probs_reference(tq.view(N, T, -1), tb, probs3, tg,
                                     HEADS)
    assert torch.equal(dq.view(N, T, -1), dq3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_matches_jax_grad(dtype):
    """exp_mhsa_qkv_bias_2d under autograd against jax.grad of JAX's: the
    (N*T, 3HD) gradient and d(bias) = its sum over rows (f32 at rtol 1e-5,
    as JAX sums it)."""
    qkv2d, bias, g = _case(seed=2)

    def loss(q, b):
        out = jq2.exp_mhsa_qkv_bias_2d(q, b, HEADS, T)
        return jnp.sum(out.astype(jnp.float32) * g)

    set_pallas_mode("interpret")
    try:
        jq, jb = jax.grad(loss, argnums=(0, 1))(_j(qkv2d, dtype),
                                                _j(bias, dtype))
    finally:
        set_pallas_mode("auto")
    q = _t(qkv2d, dtype).requires_grad_()
    b = _t(bias, dtype).requires_grad_()
    out = q2.exp_mhsa_qkv_bias_2d(q, b, HEADS, T)
    assert type(out.grad_fn).__name__ == "_ExpMhsaQkvBias2dBackward"
    (out.float() * _t(g)).sum().backward()
    assert q.grad.shape == (N * T, 3 * HEADS * D)
    np.testing.assert_allclose(_np(q.grad), _np(jq), **BWD_TOL[dtype])
    bias_tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else (
        BWD_TOL[dtype])
    np.testing.assert_allclose(_np(b.grad), _np(jb), **bias_tol)
    assert torch.equal(b.grad, q.grad.sum(0).to(b.dtype))


def test_probs_backward_whatever_bwd_residuals_says():
    """The backward reads the forward's probs in "recompute" mode too, as
    JAX's does; a mask raises, as _fwd2d_call does."""
    qkv2d, bias, g = _case(seed=3)
    grads = {}
    try:
        for mode in ("probs", "recompute"):
            kernel_config.set_bwd_residuals(mode)
            q = _t(qkv2d).requires_grad_()
            out = q2.exp_mhsa_qkv_bias_2d(q, _t(bias), HEADS, T)
            (out * _t(g)).sum().backward()
            grads[mode] = q.grad
    finally:
        kernel_config.set_bwd_residuals("probs")
    assert torch.equal(grads["probs"], grads["recompute"])
    with pytest.raises(NotImplementedError, match="unmasked only"):
        q2.qkv2d_fwd_reference(_t(qkv2d), _t(bias), HEADS, T,
                               key_mask=torch.ones(N, T))
    with pytest.raises(NotImplementedError):
        jq2._fwd2d_call(_j(qkv2d), _j(bias), jnp.ones((N, T)), HEADS, D, T,
                        128)
    with pytest.raises(ValueError, match="multiple of T"):
        q2.exp_mhsa_qkv_bias_2d(_t(qkv2d), _t(bias), HEADS, 7)
    meta = torch.empty((N * T, 3 * HEADS * D), device="meta")
    with pytest.raises(kernels.NoKernelError, match="no kernel"):
        q2.qkv2d_fwd(meta, torch.empty(3 * HEADS * D, device="meta"), HEADS,
                     T)


def _mhsa_params(seed=4, d_model=10):
    rng = np.random.default_rng(seed)
    return {k: {"w": rng.normal(scale=0.4, size=(d_model, HEADS * D)).astype(
                    np.float32),
                "b": rng.normal(scale=0.1, size=(HEADS * D,)).astype(
                    np.float32)}
            for k in ("wq", "wk", "wv")}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_io_2d_routes_as_jax(io2d, dtype, masked):
    """multi_head_self_attention with attention_io "2d": the unmasked input
    takes rows 11-12, the masked one goes on through rows 2-4; output and
    gradients against JAX's with the same switch."""
    params = _mhsa_params()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, T, 10)).astype(np.float32)
    mask = (rng.random((N, T)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    km = mask if masked else None
    g = rng.normal(size=(N, T, HEADS * D)).astype(np.float32)

    def jloss(p, xx):
        out = jax_attention.multi_head_self_attention(
            p, xx, None if km is None else jnp.asarray(km), n_heads=HEADS)
        return jnp.sum(out.astype(jnp.float32) * g), out

    jp = {k: {n: jnp.asarray(a) for n, a in v.items()}
          for k, v in params.items()}
    (_, jout), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(jp, _j(x, dtype))
    tp = {k: {n: torch.from_numpy(a).requires_grad_() for n, a in v.items()}
          for k, v in params.items()}
    tx = _t(x, dtype).requires_grad_()
    out = attention.multi_head_self_attention(
        tp, tx, None if km is None else _t(km), n_heads=HEADS)
    want_fn = "_ExpMhsaQkvBiasBackward" if masked else (
        "_ExpMhsaQkvBias2dBackward")
    assert type(out.grad_fn).__name__ == want_fn
    np.testing.assert_allclose(_np(out), _np(jout), **FWD_TOL[dtype])
    (out.float() * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jgx), **BWD_TOL[dtype])
    for k, v in tp.items():
        for n, p in v.items():
            np.testing.assert_allclose(_np(p.grad), _np(jg[k][n]),
                                       **BWD_TOL[dtype], err_msg=f"{k}.{n}")


def test_attention_io_3d_keeps_rows_1_to_4():
    params = {k: {n: torch.from_numpy(a) for n, a in v.items()}
              for k, v in _mhsa_params().items()}
    x = torch.randn(N, T, 10)
    out3 = attention.multi_head_self_attention(params, x, n_heads=HEADS)
    try:
        kernel_config.set_attention_io("2d")
        out2 = attention.multi_head_self_attention(params, x, n_heads=HEADS)
    finally:
        kernel_config.set_attention_io("3d")
    assert kernel_config.attention_io() == "3d"
    assert torch.equal(out2, out3)
