"""The port's fused-qkv exp-MHSA forward against the JAX package's.

The JAX kernel runs in Pallas interpret mode on the CPU, as
tests/test_pallas.py runs it; the port's wrappers take their plain version
for CPU tensors. The CUDA kernel itself is held to the plain version on
the card by tests/test_torch_kernel_gpu.py and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.ops import attention as jax_attention
from newsrecommendation_tpu.ops.pallas import (
    exp_mhsa_qkv_bias as jax_qkv_bias,
    exp_mhsa_qkv_bias_masked as jax_qkv_bias_masked,
    set_pallas_mode,
)
from newsrecommendation_tpu_torch.ops import attention as torch_attention
from newsrecommendation_tpu_torch.ops import fused_attention as fa

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture
def interpret_mode():
    set_pallas_mode("interpret")
    try:
        yield
    finally:
        set_pallas_mode("auto")


def make_case(seed=0, n=6, t=5, heads=3, d=4):
    """qkv (N, T, 3HD), bias, and a key mask with: partly masked rows, a
    fully masked row (2), a row (3) whose masked key 0 holds the max score
    of every query, and a row (4) whose masked key 0 beats every other key
    by more than exp can span, so exp(s - m) underflows on the keys left:
    with m taken over ALL keys that row comes out exactly 0."""
    rng = np.random.default_rng(seed)
    hd = heads * d
    qkv = rng.normal(size=(n, t, 3 * hd)).astype(np.float32)
    bias = rng.normal(scale=0.5, size=(3 * hd,)).astype(np.float32)
    u = rng.normal(size=(hd,)).astype(np.float32)
    qkv[3, :, :hd] = u + 0.05 * rng.normal(size=(t, hd)) - bias[:hd]
    qkv[3, 0, hd:2 * hd] = 4.0 * u - bias[hd:2 * hd]
    # row 4: q = 2 everywhere, so with d=4 a key c*2 scores 8c: key 0
    # scores 60, the others about -50 (eps * exp(-60) stays a normal f32)
    qkv[4, :, :hd] = 2.0 - bias[:hd]
    qkv[4, 0, hd:2 * hd] = 15.0 - bias[hd:2 * hd]
    qkv[4, 1:, hd:2 * hd] = (-12.5 + 0.01 * rng.normal(size=(t - 1, hd))
                             - bias[hd:2 * hd])
    mask = (rng.random((n, t)) > 0.3).astype(np.float32)
    mask[:, 1] = 1.0  # every row but row 2 keeps a key
    mask[2] = 0.0
    mask[3:5, 0] = 0.0
    return qkv, bias, mask


def _scores(qkv, bias, heads, d):
    x = (qkv + bias).reshape(qkv.shape[0], qkv.shape[1], 3, heads, d)
    return np.einsum("nqhd,nkhd->nhqk", x[:, :, 0], x[:, :, 1]) / np.sqrt(d)


def test_case_masks_the_row_max():
    qkv, bias, mask = make_case()
    s = _scores(qkv, bias, 3, 4)  # (N, H, T, T)
    assert (s[3:5].argmax(-1) == 0).all() and (mask[3:5, 0] == 0).all()
    assert (s[4, ..., 0] - s[4, ..., 1:].max(-1) > 105).all()
    assert (s[4, ..., 0] < 80).all()


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _to_jax(x, dtype):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_jax_kernel(interpret_mode, dtype, masked):
    heads = 3
    qkv, bias, mask = make_case()
    if masked:
        ref = jax_qkv_bias_masked(_to_jax(qkv, dtype), _to_jax(bias, dtype),
                                  jnp.asarray(mask), heads)
        out = fa.exp_mhsa_qkv_bias_masked(_to_torch(qkv, dtype),
                                          _to_torch(bias, dtype),
                                          torch.from_numpy(mask), heads)
    else:
        ref = jax_qkv_bias(_to_jax(qkv, dtype), _to_jax(bias, dtype), heads)
        out = fa.exp_mhsa_qkv_bias(_to_torch(qkv, dtype),
                                   _to_torch(bias, dtype), heads)
    assert out.dtype == getattr(torch, dtype)
    out = out.float().numpy()
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), **TOL[dtype])
    if masked:
        assert (out[2] == 0).all()  # fully masked row -> 0, not uniform
        # the masked max makes the other keys underflow: exactly 0, as in
        # the JAX kernel (a max over unmasked keys only would not give 0)
        assert (np.asarray(ref[4]) == 0).all() and (out[4] == 0).all()


def test_masked_exp_normalize_matches_jax():
    rng = np.random.default_rng(1)
    s = rng.normal(scale=3.0, size=(4, 7)).astype(np.float32)
    s[3] -= 200.0  # deeply negative row: eps * exp(-m) dominates
    mask = (rng.random((4, 7)) > 0.4).astype(np.float32)
    mask[1] = 0.0
    for m in (None, mask):
        ref = jax_attention.masked_exp_normalize(
            jnp.asarray(s), None if m is None else jnp.asarray(m))
        out = torch_attention.masked_exp_normalize(
            torch.from_numpy(s), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture
def pallas_off():
    set_pallas_mode("off")
    try:
        yield
    finally:
        set_pallas_mode("auto")


@pytest.mark.parametrize("masked", [False, True])
def test_long_sequence_matches_jax_on_cpu(pallas_off, masked):
    """S = 512 has no kernel on the card yet; on the CPU the wrappers take
    the plain version, which agrees with the JAX package's plain MHSA."""
    rng = np.random.default_rng(2)
    heads, d, s = 2, 4, 512
    hd = heads * d
    qkv = rng.normal(size=(s, 3 * hd)).astype(np.float32)
    bias = rng.normal(size=(3 * hd,)).astype(np.float32)
    mask = (rng.random((1, s)) > 0.5).astype(np.float32) if masked else None
    out = torch_attention._mhsa_from_qkv(
        torch.from_numpy(qkv), (1, s), torch.from_numpy(bias), hd, hd, hd,
        None if mask is None else torch.from_numpy(mask), n_heads=heads)
    ref = jax_attention._mhsa_from_qkv(
        jnp.asarray(qkv), (1, s), jnp.asarray(bias), hd, hd, hd,
        None if mask is None else jnp.asarray(mask), n_heads=heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_unequal_widths_raise_on_cpu():
    """Unequal widths (8, 8, 16) no longer raise on the CPU: the route takes
    rows 5-8's plain versions and computes the JAX package's answer with
    Pallas off (its default on the CPU). JAX's own rows 5-8 size the
    output by q's width, so they are not the yardstick here
    (tests/test_torch_exp_mhsa.py)."""
    rng = np.random.default_rng(3)
    qkv = rng.normal(size=(2 * 5, 8 + 8 + 16)).astype(np.float32)
    bias = rng.normal(scale=0.5, size=(32,)).astype(np.float32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    for km in (None, mask):
        out = torch_attention._mhsa_from_qkv(
            torch.from_numpy(qkv), (2, 5), torch.from_numpy(bias), 8, 8, 16,
            None if km is None else torch.from_numpy(km), n_heads=2)
        set_pallas_mode("off")
        try:
            ref = jax_attention._mhsa_from_qkv(
                jnp.asarray(qkv), (2, 5), jnp.asarray(bias), 8, 8, 16,
                None if km is None else jnp.asarray(km), n_heads=2)
        finally:
            set_pallas_mode("auto")
        assert out.shape == ref.shape == (2, 5, 16)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("s, widths", [(512, (8, 8, 8)), (600, (8, 8, 8)),
                                       (20, (8, 8, 16))])
def test_device_dispatch_raises_without_kernel(s, widths):
    """Off the CPU, shapes with no ported kernel raise instead of falling
    back (a meta tensor stands in for a CUDA one: no data is touched)."""
    nq, nk, nv = widths
    qkv = torch.empty((2 * s, nq + nk + nv), device="meta")
    bias = torch.empty((nq + nk + nv,), device="meta")
    with pytest.raises(NotImplementedError):
        torch_attention._mhsa_from_qkv(qkv, (2, s), bias, nq, nk, nv,
                                       n_heads=2)


def test_wrapper_rejects_other_devices_and_bad_shapes():
    meta = torch.empty((2, 5, 24), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.exp_mhsa_qkv_bias(meta, torch.empty(24, device="meta"), 2)
    qkv = torch.zeros((2, 5, 24))
    with pytest.raises(ValueError):
        fa.exp_mhsa_qkv_bias(qkv, torch.zeros(23), 2)
    with pytest.raises(ValueError):
        fa.exp_mhsa_qkv_bias(qkv, torch.zeros(24), 5)
    with pytest.raises(ValueError):
        fa.exp_mhsa_qkv_bias_masked(qkv, torch.zeros(24), torch.ones(2, 4), 2)


def test_cpu_calls_do_not_count_as_launches():
    fa.reset_launch_counts()
    qkv, bias, mask = make_case()
    fa.exp_mhsa_qkv_bias_masked(torch.from_numpy(qkv), torch.from_numpy(bias),
                                torch.from_numpy(mask), 3)
    assert fa.launch_counts() == {"bias": 0, "bias_masked": 0}
