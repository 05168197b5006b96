"""The port's exp-MHSA on separate q, k and v (kernel rows 5-8) on the CPU:
its plain versions against the JAX package's _fwd_call, _bwd_call,
_masked_fwd_call and _masked_bwd_call at equal widths, the autograd
Functions against jax.grad of exp_mhsa and exp_mhsa_masked, and
``multi_head_self_attention`` at unequal q/k/v widths against the JAX
package with Pallas off.

Why Pallas off at unequal widths: the JAX package's rows 5-8 size their
output and every block by q's width and slice v with q's per-head slice
(ops/pallas/fused_attention.py, _fwd_call and _fwd_kernel), so with
d_v != d_k they return a context of the wrong width (H * d_k) and values
from the wrong lanes; ``test_jax_kernels_take_q_width_for_v`` pins that
fault. With Pallas off the JAX package computes the reference's math,
which the port's rows 5-8 compute at every width.

The CUDA kernels are held to their plain versions on the card by
tests/test_torch_kernel_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.ops import attention as jax_attention
from newsrecommendation_tpu.ops.pallas import fused_attention as jfa
from newsrecommendation_tpu.ops.pallas import set_pallas_mode
from newsrecommendation_tpu_torch.ops import attention
from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernel_config, kernels
from tests.test_torch_fused_attention import make_case

HEADS, D = 3, 4  # make_case's heads and head width
N, T = 6, 5
# the JAX suite's tolerances (tests/test_pallas.py)
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture
def interpret():
    set_pallas_mode("interpret")
    try:
        yield
    finally:
        set_pallas_mode("auto")


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
    """q, k, v cut from make_case's biased qkv (row 2 fully masked), its
    key mask and the context's gradient, numpy f32."""
    qkv, bias, mask = make_case(seed=seed)
    x = qkv + bias
    hd = HEADS * D
    g = np.random.default_rng(seed + 10).normal(size=(N, T, hd)).astype(
        np.float32)
    return x[..., :hd], x[..., hd:2 * hd], x[..., 2 * hd:], mask, g


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_kernels(interpret, dtype, masked):
    q, k, v, mask, g = _case()
    jq, jk, jv, jg = (_j(x, dtype) for x in (q, k, v, g))
    if masked:
        want = jfa._masked_fwd_call(jq, jk, jv, _j(mask), HEADS, D, 128)
        wants = jfa._masked_bwd_call(jq, jk, jv, _j(mask), jg, HEADS, D, 128)
    else:
        want = jfa._fwd_call(jq, jk, jv, HEADS, D, 128)
        wants = jfa._bwd_call(jq, jk, jv, jg, HEADS, D, 128)
    tq, tk, tv = (_t(x, dtype) for x in (q, k, v))
    tm = _t(mask) if masked else None
    out = fa.exp_mhsa_reference(tq, tk, tv, tm, HEADS)
    assert out.dtype == tq.dtype and out.shape == (N, T, HEADS * D)
    np.testing.assert_allclose(_np(out), _np(want), **FWD_TOL[dtype])
    grads = fa.exp_mhsa_bwd_reference(tq, tk, tv, tm, _t(g, dtype), HEADS)
    for name, got, w in zip(("dq", "dk", "dv"), grads, wants):
        assert got.dtype == tq.dtype and got.shape == tq.shape, name
        np.testing.assert_allclose(_np(got), _np(w), **BWD_TOL[dtype],
                                   err_msg=name)
    if masked:  # the fully masked row attends to nothing
        assert (out[2] == 0).all() and all((x[2] == 0).all() for x in grads)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_functions_match_jax_grad(interpret, dtype, masked):
    q, k, v, mask, g = _case(seed=1)

    def loss(a, b, c):
        out = (jfa.exp_mhsa(a, b, c, HEADS) if not masked else
               jfa.exp_mhsa_masked(a, b, c, _j(mask), HEADS))
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, jout), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(_j(x, dtype) for x in (q, k, v)))
    xs = [_t(x, dtype).requires_grad_() for x in (q, k, v)]
    out = (fa.exp_mhsa(*xs, HEADS) if not masked else
           fa.exp_mhsa_masked(*xs, _t(mask), HEADS))
    assert type(out.grad_fn).__name__ == "_ExpMhsaBackward"
    np.testing.assert_allclose(_np(out), _np(jout), **FWD_TOL[dtype])
    (out.float() * _t(g)).sum().backward()
    for name, x, w in zip(("dq", "dk", "dv"), xs, jgrads):
        assert x.grad.dtype == x.dtype, name
        np.testing.assert_allclose(_np(x.grad), _np(w), **BWD_TOL[dtype],
                                   err_msg=name)


def _mhsa_params(d_v, seed=4, d_model=10):
    rng = np.random.default_rng(seed)
    width = {"wq": HEADS * D, "wk": HEADS * D, "wv": HEADS * d_v}
    return {k: {"w": rng.normal(scale=0.4, size=(d_model, w)).astype(
                    np.float32),
                "b": rng.normal(scale=0.1, size=(w,)).astype(np.float32)}
            for k, w in width.items()}


@pytest.mark.parametrize("d_v, masked, t", [
    pytest.param(6, False, T, id="6-False"),
    pytest.param(6, True, T, id="6-True"),
    pytest.param(2, False, T, id="2-False"),
    pytest.param(2, True, T, id="2-True"),
    pytest.param(6, False, 80, id="6-False-T80"),
    pytest.param(6, True, 80, id="6-True-T80")])
def test_unequal_widths_match_jax_with_pallas_off(d_v, masked, t):
    """multi_head_self_attention with d_v > d_k and d_v < d_k: the port
    routes to rows 5-8 (their plain versions on the CPU); output and the
    gradients of x and every projection leaf against the JAX package with
    Pallas off (its default on the CPU), which computes the reference's
    math. JAX's Pallas route is not the yardstick here: see the module
    docstring. T = 80 is past the resident regime of rows 6 and 8: the
    card takes their tensor-core kernels there in bf16."""
    params = _mhsa_params(d_v)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, t, 10)).astype(np.float32)
    mask = (rng.random((N, t)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[1] = 0.0
    km = mask if masked else None
    g = rng.normal(size=(N, t, HEADS * d_v)).astype(np.float32)

    def jloss(p, xx):
        out = jax_attention.multi_head_self_attention(
            p, xx, None if km is None else jnp.asarray(km), n_heads=HEADS)
        return jnp.sum(out * g), out

    set_pallas_mode("off")
    try:
        jp = {k: {n: jnp.asarray(a) for n, a in v.items()}
              for k, v in params.items()}
        (_, jout), (jg, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    finally:
        set_pallas_mode("auto")
    assert jout.shape == (N, t, HEADS * d_v)
    tp = {k: {n: torch.from_numpy(a).requires_grad_() for n, a in v.items()}
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = attention.multi_head_self_attention(
        tp, tx, None if km is None else _t(km), n_heads=HEADS)
    assert type(out.grad_fn).__name__ == "_ExpMhsaBackward"
    assert out.shape == (N, t, HEADS * d_v)
    np.testing.assert_allclose(_np(out), _np(jout), **FWD_TOL["float32"])
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jgx), **BWD_TOL["float32"])
    for k, v in tp.items():
        for n, p in v.items():
            np.testing.assert_allclose(_np(p.grad), _np(jg[k][n]),
                                       **BWD_TOL["float32"],
                                       err_msg=f"{k}.{n}")


def test_jax_kernels_take_q_width_for_v():
    """The fault of the reference that the port does not copy: JAX's
    multi_head_self_attention at d_k = 4, d_v = 6 gives (N, T, H * d_v)
    with Pallas off and (N, T, H * d_k) through its rows 5-8 in interpret
    mode. The port gives H * d_v on its one route."""
    params = {k: {n: jnp.asarray(a) for n, a in v.items()}
              for k, v in _mhsa_params(6).items()}
    x = jnp.asarray(np.random.default_rng(8).normal(size=(N, T, 10)),
                    jnp.float32)
    shapes = {}
    for mode in ("off", "interpret"):
        set_pallas_mode(mode)
        try:
            shapes[mode] = jax_attention.multi_head_self_attention(
                params, x, n_heads=HEADS).shape
        finally:
            set_pallas_mode("auto")
    assert shapes == {"off": (N, T, HEADS * 6), "interpret": (N, T, HEADS * D)}
    tparams = {k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
               for k, v in params.items()}
    assert attention.multi_head_self_attention(
        tparams, torch.from_numpy(np.array(x)), n_heads=HEADS).shape == (
        N, T, HEADS * 6)


def test_unequal_widths_take_rows_5_8_past_flash_min_seq():
    """Unequal widths go to rows 5-8 at any length: the flash kernels, like
    JAX's, take equal widths only."""
    params = {k: {n: torch.from_numpy(a).requires_grad_()
                  for n, a in v.items()} for k, v in _mhsa_params(6).items()}
    x = torch.randn(2, T, 10)
    kernel_config.set_flash_min_seq(T)
    try:
        out = attention.multi_head_self_attention(params, x, n_heads=HEADS)
    finally:
        kernel_config.set_flash_min_seq(512)
    assert type(out.grad_fn).__name__ == "_ExpMhsaBackward"


def test_wrappers_reject_other_devices_and_bad_shapes():
    meta = [torch.empty((N, T, HEADS * w), device="meta") for w in (D, D, 6)]
    with pytest.raises(kernels.NoKernelError, match="no kernel"):
        fa.mhsa_sep_fwd(*meta, None, HEADS)
    with pytest.raises(kernels.NoKernelError, match="no kernel"):
        fa.mhsa_sep_bwd(*meta, None, torch.empty((N, T, HEADS * 6),
                                                 device="meta"), HEADS)
    q, k, v = (torch.zeros((N, T, HEADS * w)) for w in (D, D, 6))
    with pytest.raises(ValueError, match="q, k must be"):
        fa.exp_mhsa(q, k[:, :, :-1], v, HEADS)
    with pytest.raises(ValueError, match="n_heads"):
        fa.exp_mhsa(q, k, v, 5)
    with pytest.raises(ValueError, match="key_mask"):
        fa.exp_mhsa_masked(q, k, v, torch.ones(N, T + 1), HEADS)
    with pytest.raises(ValueError, match="g must be"):
        fa.exp_mhsa_bwd_reference(q, k, v, None, torch.zeros((N, T, 12)),
                                  HEADS)
    kernels.reset_launch_counts()
    out = fa.exp_mhsa(q, k, v, HEADS)  # the CPU counts no launch
    assert out.shape == (N, T, HEADS * 6)
    assert not any(kernels.launch_counts("mhsa_fwd").values())
