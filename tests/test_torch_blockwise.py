"""The port's key-blocked ("flash") attention on the CPU: the plain versions
of kernel rows 9 (forward) and 10 (backward) and the autograd Function
against the JAX package's blockwise Pallas kernels, and the routing of
long sequences by flash_min_seq against JAX's multi_head_self_attention.

The JAX kernels run in Pallas interpret mode, with block_rows 8 and
block_kv 8, so a 24-key sequence spans three key blocks and the running
max is rescaled between them. The CUDA kernels themselves are held to
these plain versions on the card by tests/test_torch_kernel_gpu.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.ops import attention as jax_attention
from newsrecommendation_tpu.ops.pallas import blockwise as jbw
from newsrecommendation_tpu.ops.pallas import set_fused_tail, set_pallas_mode
from newsrecommendation_tpu.ops.pallas import config as jax_config
from newsrecommendation_tpu_torch.ops import attention as torch_attention
from newsrecommendation_tpu_torch.ops import blockwise as bw
from newsrecommendation_tpu_torch.ops import kernel_config, kernels

N, T, HEADS, D = 6, 24, 3, 8
BLOCK = 8  # key block: three blocks of 24 keys
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture
def jax_kernels():
    set_pallas_mode("interpret")
    set_fused_tail("off")
    try:
        yield
    finally:
        set_pallas_mode("auto")
        set_fused_tail("auto")


def make_case(seed=0):
    """q, k, v (N, T, H*D) and a key mask with a fully masked row (2) and
    rows whose largest scores sit in the last key block (the first two
    blocks' accumulators must be rescaled)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(N, T, HEADS * D)).astype(np.float32)
               for _ in range(3))
    k[:, 2 * BLOCK:] *= 2.5
    mask = (rng.random((N, T)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[2] = 0.0
    g = rng.normal(size=(N, T, HEADS * D)).astype(np.float32)
    return q, k, v, mask, g


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch,
                                                                   dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("t", [24, 512, 513, 600, 1000, 2048])
def test_key_block_is_jax_s(t):
    assert bw.kv_block(t, 256) == jbw._kv_blocks(t, 256)
    assert bw.kv_block(t, BLOCK) == jbw._kv_blocks(t, BLOCK)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_fwd_plain_matches_jax_kernel(jax_kernels, dtype, masked):
    q, k, v, mask, _ = make_case()
    km = mask if masked else None
    jo, jm, jden = jbw._fwd_call(
        _j(q, dtype), _j(k, dtype), _j(v, dtype),
        None if km is None else jnp.asarray(km), HEADS, BLOCK, BLOCK)
    o, m, den = bw.flash_fwd_reference(
        _t(q, dtype), _t(k, dtype), _t(v, dtype),
        None if km is None else _t(km), HEADS, BLOCK)
    assert o.dtype == getattr(torch, dtype) and o.shape == (N, T, HEADS * D)
    assert m.shape == den.shape == (N, T, HEADS)
    assert m.dtype == den.dtype == torch.float32
    np.testing.assert_allclose(_np(o), _np(jo), **FWD_TOL[dtype])
    np.testing.assert_allclose(_np(m), _np(jm), **FWD_TOL["float32"])
    np.testing.assert_allclose(_np(den), _np(jden), **FWD_TOL["float32"])
    if masked:
        assert (o[2] == 0).all() and (np.asarray(jo, np.float32)[2] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_plain_matches_jax_kernel(jax_kernels, dtype, masked):
    q, k, v, mask, g = make_case(seed=1)
    km = mask if masked else None
    tq, tk, tv = _t(q, dtype), _t(k, dtype), _t(v, dtype)
    tm = None if km is None else _t(km)
    o, m, den = bw.flash_fwd_reference(tq, tk, tv, tm, HEADS, BLOCK)
    tg = _t(g, dtype)
    delta = bw.delta_of(tg, o, HEADS)
    got = bw.flash_bwd_reference(tq, tk, tv, tm, tg, m, den, delta, HEADS,
                                 BLOCK)
    want = jbw._bwd_call(
        _j(q, dtype), _j(k, dtype), _j(v, dtype),
        None if km is None else jnp.asarray(km), _j(g, dtype),
        jnp.asarray(m.numpy()), jnp.asarray(den.numpy()),
        jnp.asarray(delta.numpy()), HEADS, BLOCK, BLOCK)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == getattr(torch, dtype) and a.shape == q.shape
        np.testing.assert_allclose(_np(a), _np(b), **BWD_TOL[dtype],
                                   err_msg=f"d{name}")
    if masked:  # a fully masked row passes no gradient
        assert all((x[2] == 0).all() for x in got)


def _jax_grads(q, k, v, mask, g, dtype):
    def loss(q, k, v):
        if mask is None:
            out = jbw.flash_exp_mhsa(q, k, v, HEADS, BLOCK, BLOCK)
        else:
            out = jbw.flash_exp_mhsa_masked(q, k, v, jnp.asarray(mask),
                                            HEADS, BLOCK, BLOCK)
        return jnp.sum(out.astype(jnp.float32) * g)

    return jax.grad(loss, argnums=(0, 1, 2))(_j(q, dtype), _j(k, dtype),
                                             _j(v, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_function_matches_jax_grad(jax_kernels, dtype, masked):
    q, k, v, mask, g = make_case(seed=2)
    km = mask if masked else None
    want = _jax_grads(q, k, v, km, g, dtype)
    xs = [_t(x, dtype).requires_grad_() for x in (q, k, v)]
    out = (bw.flash_exp_mhsa(*xs, HEADS, BLOCK) if km is None
           else bw.flash_exp_mhsa_masked(*xs, _t(km), HEADS, BLOCK))
    assert type(out.grad_fn).__name__ == "_FlashExpMhsaBackward"
    (out.float() * _t(g)).sum().backward()
    for name, x, w in zip("qkv", xs, want):
        assert x.grad.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(x.grad), _np(w), **BWD_TOL[dtype],
                                   err_msg=f"d{name}")


def test_function_matches_autograd_through_full_attention():
    """The flash Function's gradients are those of the full-T plain version
    (rows 1-2), which torch differentiates itself."""
    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    q, k, v, mask, g = make_case(seed=3)
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    out = bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS, BLOCK)
    (out * _t(g)).sum().backward()
    ys = [_t(x).requires_grad_() for x in (q, k, v)]
    qkv = torch.cat(ys, -1)
    ref = fa.exp_mhsa_qkv_bias_reference(qkv, torch.zeros(qkv.shape[-1]),
                                         _t(mask), HEADS)
    np.testing.assert_allclose(_np(out), _np(ref), **FWD_TOL["float32"])
    (ref * _t(g)).sum().backward()
    for x, y in zip(xs, ys):
        np.testing.assert_allclose(_np(x.grad), _np(y.grad),
                                   **BWD_TOL["float32"])


def test_views_of_one_projection_need_no_copy():
    """q, k, v cut from one fused (N, T, 3HD) tensor give what contiguous
    copies give, forward and backward."""
    q, k, v, mask, g = make_case(seed=4)
    fused = _t(np.concatenate([q, k, v], -1)).requires_grad_()
    views = torch.split(fused, HEADS * D, dim=-1)
    out = bw.flash_exp_mhsa_masked(*views, _t(mask), HEADS, BLOCK)
    (out * _t(g)).sum().backward()
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    ref = bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS, BLOCK)
    (ref * _t(g)).sum().backward()
    assert torch.equal(out, ref)
    assert torch.equal(fused.grad, torch.cat([x.grad for x in xs], -1))


def test_without_grad_the_forward_saves_nothing():
    q, k, v, mask, _ = make_case()
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        plain = bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS, BLOCK)
    with torch.inference_mode():
        served = bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS, BLOCK)
    graded = bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS, BLOCK)
    assert plain.grad_fn is None and served.grad_fn is None
    assert torch.equal(plain, graded.detach()) and torch.equal(served, plain)


def test_other_devices_raise():
    """Off the CPU there is no plain stand-in, with or without grad: a meta
    tensor (standing in for a CUDA one) raises."""
    q = torch.empty((2, 16, 8), device="meta", requires_grad=True)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            with pytest.raises(kernels.NoKernelError, match="no kernel"):
                bw.flash_exp_mhsa(q, q, q, 2)
    with pytest.raises(ValueError, match="one \\(N, T, H\\*D\\) shape"):
        bw.flash_fwd_reference(torch.zeros(2, 16, 8), torch.zeros(2, 15, 8),
                               torch.zeros(2, 16, 8), None, 2)


def test_cpu_calls_do_not_count_as_launches():
    q, k, v, mask, g = make_case()
    kernels.reset_launch_counts()
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    (bw.flash_exp_mhsa_masked(*xs, _t(mask), HEADS) * _t(g)).sum().backward()
    assert all(not any(kernels.launch_counts(kern).values())
               for kern in kernels.KERNELS)


@pytest.fixture
def flash_from(jax_kernels):
    """Set both packages' flash_min_seq for a test, restoring 512."""
    def set_both(t):
        jax_config.set_flash_min_seq(t)
        kernel_config.set_flash_min_seq(t)

    try:
        yield set_both
    finally:
        set_both(512)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_min_seq_routes_as_jax(flash_from, masked):
    """multi_head_self_attention with flash_min_seq forced down to the
    sequence length takes the flash route in both packages, and the two
    agree, output and gradients; one key more and both take the fused
    route."""
    rng = np.random.default_rng(5)
    params = jax_attention.init_multi_head_self_attention(
        jax.random.PRNGKey(0), HEADS * D, HEADS, D)
    tparams = {name: {leaf: torch.tensor(np.asarray(w)).requires_grad_()
                      for leaf, w in p.items()}
               for name, p in params.items()}
    x = rng.normal(size=(N, T, HEADS * D)).astype(np.float32)
    mask = (rng.random((N, T)) > 0.3).astype(np.float32) if masked else None
    g = rng.normal(size=(N, T, HEADS * D)).astype(np.float32)
    for flash_min, route in ((T, "_FlashExpMhsaBackward"),
                             (T + 1, "_ExpMhsaQkvBiasBackward")):
        flash_from(flash_min)

        def jloss(p, x):
            out = jax_attention.multi_head_self_attention(
                p, x, None if mask is None else jnp.asarray(mask),
                n_heads=HEADS)
            return jnp.sum(out * g), out

        (_, jout), (jgp, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        tx = _t(x).requires_grad_()
        out = torch_attention.multi_head_self_attention(
            tparams, tx, None if mask is None else _t(mask), n_heads=HEADS)
        assert type(out.grad_fn).__name__ == route
        (out * _t(g)).sum().backward()
        np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(tx.grad), _np(jgx), **BWD_TOL["float32"])
        for name in ("wq", "wk", "wv"):
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    _np(tparams[name][leaf].grad), _np(jgp[name][leaf]),
                    **BWD_TOL["float32"], err_msg=f"{name}/{leaf}")
                tparams[name][leaf].grad = None
