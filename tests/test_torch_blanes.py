"""The port's batch-in-lanes attention (kernel rows 15-16,
``attention_layout="blanes"``) on the CPU: its plain versions against the
JAX package's _blanes_fwd_call and _blanes_bwd_call, the autograd
Functions against jax.grad, and the routing of
``multi_head_self_attention`` and of one ``fit`` step under the switch
against JAX's with the same switch.

The JAX kernels run in Pallas interpret mode with the fused encoder-tail
kernel off, every switch restored afterwards. The CUDA kernels are held to
their plain versions on the card by tests/test_torch_kernel_gpu.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu.ops import attention as jax_attention
from newsrecommendation_tpu.ops.pallas import config as jax_config
from newsrecommendation_tpu.ops.pallas import experimental_blanes as jbl
from newsrecommendation_tpu.ops.pallas import set_fused_tail, set_pallas_mode
from newsrecommendation_tpu.train import create_train_state as jax_state
from newsrecommendation_tpu.train.step import make_train_step as jax_step
from newsrecommendation_tpu_torch.data.loader import TrainSamples
from newsrecommendation_tpu_torch.models import get_model
from newsrecommendation_tpu_torch.ops import attention
from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
from newsrecommendation_tpu_torch.ops import kernel_config, kernels
from newsrecommendation_tpu_torch.train import create_train_state, fit
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
N, T = 6, 5
# the JAX suite's tolerances (tests/test_pallas.py)
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture
def blanes():
    """attention_layout "blanes" in both packages, JAX's kernels
    interpreted, its fused tail off."""
    set_pallas_mode("interpret")
    set_fused_tail("off")
    jax_config.set_attention_layout("blanes")
    kernel_config.set_attention_layout("blanes")
    try:
        yield
    finally:
        set_pallas_mode("auto")
        set_fused_tail("auto")
        jax_config.set_attention_layout("headloop")
        kernel_config.set_attention_layout("headloop")


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
    """Biased qkv, make_case's key mask (row 2 fully masked, rows 3-4 with
    the max on a masked key) and the context's gradient."""
    qkv, bias, mask = make_case(seed=seed)
    g = np.random.default_rng(seed + 10).normal(
        size=(N, T, HEADS * D)).astype(np.float32)
    return qkv + bias, mask, g


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_kernels(dtype, masked):
    qkv, mask, g = _case()
    km = mask if masked else None
    set_pallas_mode("interpret")
    try:
        jm = None if km is None else _j(km)
        want = jbl._blanes_fwd_call(_j(qkv, dtype), jm, HEADS, 128)
        wantg = jbl._blanes_bwd_call(_j(qkv, dtype), jm, _j(g, dtype), HEADS,
                                     128)
    finally:
        set_pallas_mode("auto")
    tq, tm = _t(qkv, dtype), None if km is None else _t(km)
    out = bl.blanes_fwd_reference(tq, tm, HEADS)
    assert out.dtype == tq.dtype and out.shape == (N, T, HEADS * D)
    np.testing.assert_allclose(_np(out), _np(want), **FWD_TOL[dtype])
    dqkv = bl.blanes_bwd_reference(tq, tm, _t(g, dtype), HEADS)
    assert dqkv.dtype == tq.dtype and dqkv.shape == tq.shape
    np.testing.assert_allclose(_np(dqkv), _np(wantg), **BWD_TOL[dtype])
    if masked:  # the fully masked row attends to nothing
        assert (out[2] == 0).all() and (dqkv[2] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_kernels_at_d80(dtype, masked):
    """Rows 15-16's plain versions against JAX's batch-in-lanes kernels at
    a head of 80, past the card's own blanes layouts (it runs rows 1 and
    4's kernels there)."""
    heads = 2
    rng = np.random.default_rng(14)
    qkv = rng.normal(size=(N, T, 3 * heads * 80)).astype(np.float32)
    g = rng.normal(size=(N, T, heads * 80)).astype(np.float32)
    mask = (rng.random((N, T)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[2] = 0.0  # a fully masked row
    km = mask if masked else None
    set_pallas_mode("interpret")
    try:
        jm = None if km is None else _j(km)
        want = jbl._blanes_fwd_call(_j(qkv, dtype), jm, heads, 128)
        wantg = jbl._blanes_bwd_call(_j(qkv, dtype), jm, _j(g, dtype), heads,
                                     128)
    finally:
        set_pallas_mode("auto")
    tq, tm = _t(qkv, dtype), None if km is None else _t(km)
    np.testing.assert_allclose(_np(bl.blanes_fwd_reference(tq, tm, heads)),
                               _np(want), **FWD_TOL[dtype])
    np.testing.assert_allclose(
        _np(bl.blanes_bwd_reference(tq, tm, _t(g, dtype), heads)),
        _np(wantg), **BWD_TOL[dtype])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_functions_match_jax_grad(dtype, masked):
    qkv, mask, g = _case(seed=1)
    km = mask if masked else None

    def loss(x):
        out = (jbl.exp_mhsa_qkv_blanes(x, HEADS) if km is None else
               jbl.exp_mhsa_qkv_blanes_masked(x, _j(km), HEADS))
        return jnp.sum(out.astype(jnp.float32) * g), out

    set_pallas_mode("interpret")
    try:
        (_, jout), jg = jax.value_and_grad(loss, has_aux=True)(
            _j(qkv, dtype))
    finally:
        set_pallas_mode("auto")
    x = _t(qkv, dtype).requires_grad_()
    out = (bl.exp_mhsa_qkv_blanes(x, HEADS) if km is None else
           bl.exp_mhsa_qkv_blanes_masked(x, _t(km), HEADS))
    assert type(out.grad_fn).__name__ == "_ExpMhsaQkvBlanesBackward"
    np.testing.assert_allclose(_np(out), _np(jout), **FWD_TOL[dtype])
    (out.float() * _t(g)).sum().backward()
    assert x.grad.dtype == x.dtype
    np.testing.assert_allclose(_np(x.grad), _np(jg), **BWD_TOL[dtype])


def _mhsa_params(seed=4, d_model=10):
    rng = np.random.default_rng(seed)
    return {k: {"w": rng.normal(scale=0.4, size=(d_model, HEADS * D)).astype(
                    np.float32),
                "b": rng.normal(scale=0.1, size=(HEADS * D,)).astype(
                    np.float32)}
            for k in ("wq", "wk", "wv")}


def _mhsa_vs_jax(dtype, masked, seed=5):
    """multi_head_self_attention in both packages on one input: (port
    output, JAX output, port grads, JAX grads) with grads of x and of each
    projection leaf."""
    params = _mhsa_params()
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, T, 10)).astype(np.float32)
    mask = (rng.random((N, T)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[1] = 0.0
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
    fn = type(out.grad_fn).__name__
    (out.float() * _t(g)).sum().backward()
    grads = {("x",): tx.grad, **{(k, n): p.grad for k, v in tp.items()
                                 for n, p in v.items()}}
    jgrads = {("x",): jgx, **{(k, n): jg[k][n] for k, v in tp.items()
                              for n in v}}
    return out, jout, grads, jgrads, fn


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_blanes_routes_as_jax(blanes, dtype, masked):
    """multi_head_self_attention under attention_layout "blanes" takes rows
    15-16, masked or not; output and gradients against JAX's with the same
    switch."""
    out, jout, grads, jgrads, fn = _mhsa_vs_jax(dtype, masked)
    assert fn == "_ExpMhsaQkvBlanesBackward"
    np.testing.assert_allclose(_np(out), _np(jout), **FWD_TOL[dtype])
    for key, got in grads.items():
        np.testing.assert_allclose(_np(got), _np(jgrads[key]),
                                   **BWD_TOL[dtype], err_msg=str(key))


def test_blanes_overrides_2d_and_flash_wins(blanes):
    """blanes takes the unmasked attention whatever attention_io says (as
    in JAX, where the layout check comes first); a sequence of
    flash_min_seq keys still takes the flash kernels."""
    kernel_config.set_attention_io("2d")
    try:
        out, jout, _, _, fn = _mhsa_vs_jax("float32", False)
        assert fn == "_ExpMhsaQkvBlanesBackward"
        np.testing.assert_allclose(_np(out), _np(jout), **FWD_TOL["float32"])
        kernel_config.set_flash_min_seq(T)
        jax_config.set_flash_min_seq(T)
        out, jout, _, _, fn = _mhsa_vs_jax("float32", True)
        assert fn == "_FlashExpMhsaBackward"
        np.testing.assert_allclose(_np(out), _np(jout), **FWD_TOL["float32"])
    finally:
        kernel_config.set_attention_io("3d")
        kernel_config.set_flash_min_seq(512)
        jax_config.set_flash_min_seq(512)


def test_backward_recomputes_whatever_bwd_residuals_says():
    qkv, mask, g = _case(seed=2)
    grads = {}
    try:
        for mode in ("probs", "recompute"):
            kernel_config.set_bwd_residuals(mode)
            x = _t(qkv).requires_grad_()
            out = bl.exp_mhsa_qkv_blanes_masked(x, _t(mask), HEADS)
            (out * _t(g)).sum().backward()
            grads[mode] = x.grad
    finally:
        kernel_config.set_bwd_residuals("probs")
    assert torch.equal(grads["probs"], grads["recompute"])


def test_wrappers_reject_other_devices_and_bad_shapes():
    meta = torch.empty((N, T, 3 * HEADS * D), device="meta")
    with pytest.raises(kernels.NoKernelError, match="no kernel"):
        bl.blanes_fwd(meta, None, HEADS)
    with pytest.raises(kernels.NoKernelError, match="no kernel"):
        bl.blanes_bwd(meta, None, torch.empty((N, T, HEADS * D),
                                              device="meta"), HEADS)
    qkv = torch.zeros((N, T, 3 * HEADS * D))
    with pytest.raises(ValueError, match="n_heads"):
        bl.exp_mhsa_qkv_blanes(qkv, 5)
    with pytest.raises(ValueError, match="key_mask"):
        bl.exp_mhsa_qkv_blanes_masked(qkv, torch.ones(N, T + 1), HEADS)
    with pytest.raises(ValueError, match="g must be"):
        bl.blanes_bwd(qkv, None, torch.zeros((N, T, 5)), HEADS)
    kernels.reset_launch_counts()
    bl.exp_mhsa_qkv_blanes(qkv, HEADS)  # the CPU counts no launch
    assert not any(kernels.launch_counts("blanes_fwd").values())


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_fit_step_blanes_matches_jax(tiny_cfg, blanes, user_log_mask):
    """One fit step with Config(attention_layout="blanes"): both encoders
    take rows 15-16; loss and params after the Adam step against JAX's
    make_train_step with the same layout, dropout off."""
    jcfg = tiny_cfg.replace(deterministic=True, lr=3e-4, donate_state=False,
                            user_log_mask=user_log_mask,
                            freeze_embedding=True, attention_layout="blanes")
    cfg = port_cfg(jcfg, epochs=1, log_steps=1, device_gather=False)
    assert cfg.attention_layout == "blanes"
    arrays, feats = tiny_samples(cfg, n=cfg.batch_size)
    jparams = jax_params(jcfg)
    kernel_config.set_attention_layout("headloop")  # fit sets it from cfg
    state, stats = fit(cfg, get_model("NRMS"),
                       create_train_state(cfg, to_port(jparams)),
                       TrainSamples(**arrays), feats)
    assert kernel_config.attention_layout() == "blanes"
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


# ---- the launch plan of rows 15-16 (csrc/blanes.cu) --------------------------

SMS = 132  # an H100's SMs
# (N, T, H, D): the main paths' shapes (the news encoder, the user encoder,
# a history of 511 news), both sides of the regime switch, T = 128 and
# 200, odd and widest heads
PLAN_SHAPES = [(7040, 20, 20, 20), (128, 50, 20, 20), (64, 511, 20, 20),
               (128, 64, 20, 20), (128, 65, 20, 20), (64, 128, 20, 20),
               (64, 200, 20, 20), (33, 50, 20, 33), (6, 65, 2, 33),
               (5, 37, 2, 64), (5, 128, 2, 64)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n, t, heads, d", PLAN_SHAPES)
def test_launch_plan_fills_the_card(n, t, heads, d, itemsize):
    """Every launch gets at least two blocks per SM or one block per work
    item, within a block's shared memory; the items cover every (row,
    head, row tile) once; the regime follows T."""
    plans = bl.launch_plans(n, t, heads, d, itemsize, SMS)
    kinds = ["bwd"] if t <= bl.SHORT_T else ["bwd_query", "bwd_key"]
    assert [p.kind for p in plans["bwd"]] == kinds
    for p in [plans["fwd"], *plans["bwd"]]:
        assert p.smem <= kernels.MAX_SMEM
        assert p.smem == bl.smem_bytes(p.kind, t, d, itemsize, p.heads,
                                       p.rows, p.nbuf)
        assert p.blocks >= 2 * SMS or p.blocks == p.items
        assert p.blocks <= p.items
        assert p.items == n * -(-heads // p.heads) * -(-t // p.rows)
        assert p.nbuf in (1, 2)
        if t <= bl.SHORT_T:
            assert p.rows == t and p.heads in (min(heads, 4), min(heads, 2),
                                               1)
        else:
            tile = (bl.MMA_TILE if bl.long_mma(t, d, itemsize)
                    else bl.TILE)
            assert (p.heads, p.rows) == (1, min(tile, t))


@pytest.mark.parametrize("n, t", [(7040, 20), (128, 50), (64, 511)])
def test_launch_plan_two_blocks_per_sm_at_main_path_shapes(n, t):
    """At the shapes of the main paths in bf16 two blocks fit on an SM
    (its 228 KB, 1 KB more per block) and the grid has at least 264."""
    plans = bl.launch_plans(n, t, 20, 20, 2, SMS)
    for p in [plans["fwd"], *plans["bwd"]]:
        assert bl.SM_SMEM // (p.smem + 1024) >= 2, p
        assert p.blocks >= 2 * SMS, p


@pytest.mark.parametrize("t, d, itemsize, regime", [
    (318, 64, 4, "blanes"), (319, 64, 4, "qkv"), (941, 20, 4, "blanes"),
    (942, 20, 4, "qkv"), (1232, 20, 2, "blanes"), (1233, 20, 2, "qkv"),
    (511, 64, 2, "blanes"), (20, 65, 2, "qkv"), (512, 80, 4, "qkv"),
    (512, 400, 2, "qkv")])
def test_launch_plan_refuses_rows_past_shared_memory(t, d, itemsize, regime):
    """f32 heads of 64 at T = 511: one head's K and V alone (262 KB) do
    not fit in a block, so rows 15-16's own plan raises rather than
    launch. Past the last T their layouts hold (318 at f32 D = 64, 941 at
    f32 D = 20, 1,232 in bf16 at D = 20) and at every head past 64 the
    entry points take the fused-qkv kernels' templates instead
    (``regime`` "qkv"), which take any T and D."""
    with pytest.raises(NotImplementedError, match="shared memory"):
        bl.launch_plan("fwd", 2, 511, 1, 64, 4, SMS)
    assert bl.launch_plan("fwd", 2, 511, 1, 64, 2, SMS).smem <= (
        kernels.MAX_SMEM)
    assert bl.regime(t, d, itemsize) == regime
    if regime == "blanes":
        plans = bl.launch_plans(2, t, 1, d, itemsize, SMS)
        assert all(p.smem <= kernels.MAX_SMEM
                   for p in [plans["fwd"], *plans["bwd"]])
