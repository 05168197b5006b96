"""The port's recompute backward (kernel row 4) and its switches on the CPU:
row 4's plain version against the JAX package's Pallas kernel, equal to row
3's; the autograd Function in "recompute" mode against jax.grad in the same
mode; the kernel_config switches; and one fit step with bwd_residuals
"recompute" and a user history routed to the flash kernels, against JAX's
make_train_step.

The JAX kernels run in Pallas interpret mode with the fused encoder-tail
kernel off (interpret mode alone turns it on), every switch restored
afterwards. The CUDA kernel itself is held to the plain version on the
card by tests/test_torch_kernel_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu.ops.pallas import config as jax_config
from newsrecommendation_tpu.ops.pallas import fused_attention as jfa
from newsrecommendation_tpu.ops.pallas import set_fused_tail, set_pallas_mode
from newsrecommendation_tpu.train import create_train_state as jax_state
from newsrecommendation_tpu.train.step import make_train_step as jax_step
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.data.loader import TrainSamples
from newsrecommendation_tpu_torch.models import get_model
from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernel_config, kernels
from newsrecommendation_tpu_torch.train import create_train_state, fit
from newsrecommendation_tpu_torch.train.step import (
    make_multi_step,
    make_train_step,
)
from tests.test_torch_fused_attention import make_case
from tests.test_torch_train_loop import jax_params, port_cfg, tiny_samples
from tests.test_torch_train_step import (
    STEP_TOL,
    ZERO_GRAD_LEAVES,
    get,
    leaves,
    to_port,
)

HEADS, D = 3, 4  # make_case's heads and head width
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture
def recompute():
    """Both packages in recompute mode, the JAX kernels interpreted."""
    set_pallas_mode("interpret")
    set_fused_tail("off")
    jax_config.set_bwd_residuals("recompute")
    kernel_config.set_bwd_residuals("recompute")
    try:
        yield
    finally:
        set_pallas_mode("auto")
        set_fused_tail("auto")
        jax_config.set_bwd_residuals("probs")
        kernel_config.set_bwd_residuals("probs")


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
def test_recompute_plain_matches_jax_kernel(recompute, dtype, masked):
    qkv, bias, mask = make_case()
    km = mask if masked else None
    g = _grad_out()
    ref = jfa._qkv_bwd_call(_j(qkv, dtype),
                            None if km is None else jnp.asarray(km),
                            _j(g, dtype), HEADS, D, 128, bias=_j(bias, dtype))
    out = fa.qkv_bwd_reference(_t(qkv, dtype), _t(bias, dtype),
                               None if km is None else _t(km), _t(g, dtype),
                               HEADS)
    assert out.dtype == getattr(torch, dtype) and out.shape == qkv.shape
    np.testing.assert_allclose(_np(out), _np(ref), **BWD_TOL[dtype])
    if masked:  # the fully masked row passes no gradient
        assert (out[2] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_recompute_plain_equals_row_3(dtype, masked):
    """Rows 3 and 4 give the same gradients bit for bit, as the JAX package
    states for its kernels: row 4 recomputes exactly the probs row 3
    reads."""
    qkv, bias, mask = make_case(seed=1)
    km = None if not masked else _t(mask)
    tq, tb, tg = _t(qkv, dtype), _t(bias, dtype), _t(_grad_out(), dtype)
    _, probs = fa.exp_mhsa_qkv_bias_probs_reference(tq, tb, km, HEADS)
    assert torch.equal(fa.qkv_bwd_reference(tq, tb, km, tg, HEADS),
                       fa.qkv_bwd_probs_reference(tq, tb, probs, tg, HEADS))


def _jax_grads(qkv, bias, mask, g, dtype):
    def loss(q, b):
        if mask is None:
            out = jfa.exp_mhsa_qkv_bias(q, b, HEADS)
        else:
            out = jfa.exp_mhsa_qkv_bias_masked(q, b, jnp.asarray(mask), HEADS)
        return jnp.sum(out.astype(jnp.float32) * g)

    return jax.grad(loss, argnums=(0, 1))(_j(qkv, dtype), _j(bias, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_recompute_function_matches_jax_grad(recompute, dtype, masked):
    qkv, bias, mask = make_case(seed=2)
    km = mask if masked else None
    g = _grad_out(seed=6)
    jq, jb = _jax_grads(qkv, bias, km, g, dtype)
    q = _t(qkv, dtype).requires_grad_()
    b = _t(bias, dtype).requires_grad_()
    out = (fa.exp_mhsa_qkv_bias(q, b, HEADS) if km is None
           else fa.exp_mhsa_qkv_bias_masked(q, b, _t(km), HEADS))
    assert type(out.grad_fn).__name__ == "_ExpMhsaQkvBiasBackward"
    (out.float() * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(q.grad), _np(jq), **BWD_TOL[dtype])
    np.testing.assert_allclose(_np(b.grad), _np(jb), **BWD_TOL[dtype])


@pytest.mark.parametrize("masked", [False, True])
def test_both_residual_modes_give_the_same_grads(masked):
    qkv, bias, mask = make_case(seed=3)
    km = _t(mask) if masked else None
    g = _t(_grad_out(seed=7))
    grads = {}
    try:
        for mode in ("probs", "recompute"):
            kernel_config.set_bwd_residuals(mode)
            q, b = _t(qkv).requires_grad_(), _t(bias).requires_grad_()
            out = (fa.exp_mhsa_qkv_bias(q, b, HEADS) if km is None
                   else fa.exp_mhsa_qkv_bias_masked(q, b, km, HEADS))
            (out * g).sum().backward()
            grads[mode] = (q.grad, b.grad)
    finally:
        kernel_config.set_bwd_residuals("probs")
    for a, b in zip(grads["probs"], grads["recompute"]):
        assert torch.equal(a, b)
    assert not any(any(kernels.launch_counts(k).values())
                   for k in kernels.KERNELS)


def test_recompute_kernel_raises_off_the_card():
    meta = torch.empty((2, 5, 24), device="meta")
    with pytest.raises(kernels.NoKernelError, match="no kernel"):
        fa.qkv_bwd(meta, torch.empty(24, device="meta"), None,
                   torch.empty((2, 5, 8), device="meta"), 2)
    with pytest.raises(ValueError, match="g must be"):
        fa.qkv_bwd(torch.zeros(2, 5, 24), torch.zeros(24), None,
                   torch.zeros(2, 5, 9), 2)


def test_switch_defaults_are_jax_s():
    assert kernel_config.bwd_residuals() == jax_config.bwd_residuals()
    assert kernel_config.flash_min_seq() == jax_config.flash_min_seq() == 512


@pytest.mark.parametrize("setter, value, getter, want, default", [
    ("set_fused_tail", "on", "fused_tail_enabled", True, "auto"),
    ("set_fused_tail", True, "fused_tail_enabled", True, "auto"),
    ("set_attention_io", "2d", "attention_io", "2d", "3d"),
    ("set_attention_layout", "blanes", "attention_layout", "blanes",
     "headloop")])
def test_ported_values_set_their_switch(setter, value, getter, want,
                                        default):
    """The values whose kernels are now ported (rows 11-16) set their
    switch, which its getter reads; the default is restored after."""
    try:
        getattr(kernel_config, setter)(value)
        assert getattr(kernel_config, getter)() == want
    finally:
        getattr(kernel_config, setter)(default)
    assert getattr(kernel_config, getter)() != want


@pytest.mark.parametrize("setter, value", [
    ("set_bwd_residuals", "saved"), ("set_flash_min_seq", 0),
    ("set_fused_tail", "maybe"), ("set_attention_layout", "lanes"),
    ("set_attention_io", "1d")])
def test_unknown_values_raise_as_in_jax(setter, value):
    with pytest.raises(ValueError):
        getattr(kernel_config, setter)(value)
    with pytest.raises(ValueError):
        getattr(jax_config, setter)(value)


def test_ported_values_are_taken():
    try:
        kernel_config.set_fused_tail("off")
        kernel_config.set_fused_tail(False)
        kernel_config.set_fused_tail("auto")
        kernel_config.set_attention_layout("headloop")
        kernel_config.set_attention_io("3d")
        kernel_config.set_flash_min_seq(64)
        assert kernel_config.flash_min_seq() == 64
        kernel_config.apply(Config(bwd_residuals="recompute"))
        assert kernel_config.bwd_residuals() == "recompute"
        kernel_config.apply(Config(fused_tail="on"))
        assert kernel_config.fused_tail_enabled()
        kernel_config.apply(Config())
        assert kernel_config.bwd_residuals() == "probs"
        assert not kernel_config.fused_tail_enabled()
    finally:
        kernel_config.set_flash_min_seq(512)
        kernel_config.set_bwd_residuals("probs")
        kernel_config.set_fused_tail("auto")
    with pytest.raises(ValueError, match="bwd_residuals"):
        Config(bwd_residuals="saved")


def test_step_builder_applies_the_config():
    """make_train_step sets the switches its Config carries when it builds
    the step; running a step does not set them again."""
    try:
        step = make_train_step(Config(bwd_residuals="recompute"),
                               get_model("NRMS"))
        assert kernel_config.bwd_residuals() == "recompute"
        kernel_config.set_bwd_residuals("probs")
        make_multi_step(Config(bwd_residuals="recompute"), get_model("NRMS"),
                        2)
        assert kernel_config.bwd_residuals() == "recompute"
        assert callable(step)
    finally:
        kernel_config.set_bwd_residuals("probs")


@pytest.fixture
def recompute_long(recompute):
    """Recompute mode with flash_min_seq at tiny_cfg's history length in
    both packages: the user encoder takes the flash kernels, the news
    encoder (6-word titles) the fused-qkv ones."""
    jax_config.set_flash_min_seq(8)
    kernel_config.set_flash_min_seq(8)
    try:
        yield
    finally:
        jax_config.set_flash_min_seq(512)
        kernel_config.set_flash_min_seq(512)


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_fit_step_recompute_long_history_matches_jax(tiny_cfg, recompute_long,
                                                     user_log_mask):
    """One fit step with bwd_residuals "recompute" and the history at
    flash_min_seq: loss and params after the Adam step against JAX's
    make_train_step on the same batch."""
    jcfg = tiny_cfg.replace(deterministic=True, lr=3e-4, donate_state=False,
                            user_log_mask=user_log_mask,
                            freeze_embedding=True, bwd_residuals="recompute")
    cfg = port_cfg(jcfg, epochs=1, log_steps=1, device_gather=False)
    assert cfg.bwd_residuals == "recompute"
    assert cfg.user_log_length >= kernel_config.flash_min_seq()
    arrays, feats = tiny_samples(cfg, n=cfg.batch_size)
    jparams = jax_params(jcfg)
    kernel_config.set_bwd_residuals("probs")  # fit must set it from cfg
    state, stats = fit(cfg, get_model("NRMS"),
                       create_train_state(cfg, to_port(jparams)),
                       TrainSamples(**arrays), feats)
    assert kernel_config.bwd_residuals() == "recompute"
    assert stats["steps"] == 1
    batch = next(TrainSamples(**arrays).iter_batches(
        feats, cfg.batch_size, epoch=0, seed=cfg.seed))
    jst, jmetrics = jax_step(jcfg, jax_get_model("NRMS"))(
        jax_state(jcfg, jparams), {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jax.random.PRNGKey(0))
    np.testing.assert_allclose(stats["final_loss"], float(jmetrics["loss"]),
                               rtol=1e-5)
    for path, p in leaves(state.params):
        want = np.asarray(get(jst.params, path))
        if path in ZERO_GRAD_LEAVES:
            assert np.abs(_np(p) - want).max() < 4 * cfg.lr, path
            continue
        np.testing.assert_allclose(_np(p), want, **STEP_TOL,
                                   err_msg=str(path))
