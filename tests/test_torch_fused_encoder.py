"""The port's fused encoder tail (kernel rows 13-14) on the CPU against the
JAX package's: the dropout keep mask bit for bit, the plain forward and
backward against the Pallas kernels, the autograd Functions against
jax.grad, ``mhsa_dropout_pool`` with ``fused_tail`` on, and one fit step
with ``Config(fused_tail="on")`` against JAX's make_train_step.

The JAX kernels run in Pallas interpret mode, every switch restored
afterwards. The CUDA kernels are held to the plain versions on the card by
tests/test_torch_kernel_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu.ops import attention as jax_attention
from newsrecommendation_tpu.ops.pallas import experimental_fused_encoder as jfe
from newsrecommendation_tpu.ops.pallas import set_fused_tail, set_pallas_mode
from newsrecommendation_tpu.train import create_train_state as jax_state
from newsrecommendation_tpu.train.step import make_train_step as jax_step
from newsrecommendation_tpu_torch.data.loader import TrainSamples
from newsrecommendation_tpu_torch.models import get_model
from newsrecommendation_tpu_torch.ops import attention
from newsrecommendation_tpu_torch.ops import experimental_fused_encoder as fe
from newsrecommendation_tpu_torch.ops import kernel_config, kernels
from newsrecommendation_tpu_torch.train import create_train_state, fit
from newsrecommendation_tpu_torch.train.step import make_train_step
from tests.test_torch_train_loop import jax_params, port_cfg, tiny_samples
from tests.test_torch_train_step import (
    STEP_TOL,
    ZERO_GRAD_LEAVES,
    get,
    leaves,
    to_port,
)

# the JAX suite's tolerances (tests/test_pallas.py)
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
BWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
N, T, HEADS, D, Q = 16, 5, 3, 4, 7
RATE, SEED = 0.35, 13


@pytest.fixture
def fused():
    """The fused tail on in both packages, JAX's kernels interpreted."""
    set_pallas_mode("interpret")
    set_fused_tail("on")
    kernel_config.set_fused_tail("on")
    try:
        yield
    finally:
        set_pallas_mode("auto")
        set_fused_tail("auto")
        kernel_config.set_fused_tail("auto")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch,
                                                                   dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def make_tail(seed=0, n=N, t=T, heads=HEADS, d=D, q=Q):
    """Biased qkv, a key mask with a fully masked row (2), the pooling
    params (w1, b1, w2, b2) and the output's gradient, all numpy f32."""
    rng = np.random.default_rng(seed)
    hd = heads * d
    qkv = rng.normal(size=(n, t, 3 * hd)).astype(np.float32)
    mask = (rng.random((n, t)) > 0.3).astype(np.float32)
    mask[:, 1] = 1.0
    mask[2] = 0.0
    pool = (rng.normal(scale=0.4, size=(hd, q)).astype(np.float32),
            rng.normal(scale=0.5, size=(1, q)).astype(np.float32),
            rng.normal(size=(q, 1)).astype(np.float32),
            rng.normal(size=(1, 1)).astype(np.float32))
    g = rng.normal(size=(n, hd)).astype(np.float32)
    return qkv, mask, pool, g


def _port_args(qkv, mask, pool, dtype):
    w1, b1, w2, b2 = pool
    return (_t(qkv, dtype), None if mask is None else _t(mask),
            _t(w1, dtype), _t(b1), _t(w2, dtype), _t(b2))


def _jax_args(qkv, mask, pool, dtype):
    w1, b1, w2, b2 = pool
    return (_j(qkv, dtype), None if mask is None else _j(mask),
            _j(w1, dtype), _j(b1), _j(w2, dtype), _j(b2))


def _np_keep_mask(shape, rate, seed):
    """tests/test_pallas.py's numpy oracle of _keep_mask."""
    bn, t, hd = shape
    idx = np.arange(bn * t * hd, dtype=np.uint64).reshape(shape)
    x = (idx + np.uint64(seed) * 0x9E3779B9) & 0xFFFFFFFF
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(16)))
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x = (x ^ (x >> np.uint64(15)))
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        x = (x ^ (x >> np.uint64(16)))
    thr = min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)
    return (x >= thr).astype(np.float32) / (1.0 - rate)


@pytest.mark.parametrize("seed", [0, 13, 2 ** 31 - 5])
@pytest.mark.parametrize("block", [0, 3])
@pytest.mark.parametrize("rate", [0.2, 0.35])
def test_keep_mask_equals_jax_and_numpy(seed, block, rate):
    """The same bits as JAX's _keep_mask for block ``block`` of 8 rows (its
    global rows start at 8 * block) and as the numpy oracle over all rows,
    seed near 2**31 included."""
    bn, t, hd = 8, T, HEADS * D
    want = jfe._keep_mask((bn, t, hd), rate, jnp.asarray(seed, jnp.int32),
                          jnp.asarray(block, jnp.int32))
    got = fe.keep_mask((bn, t, hd), rate,
                       torch.tensor([seed], dtype=torch.int32),
                       row0=bn * block)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    oracle = _np_keep_mask((bn * (block + 1), t, hd), rate, seed)
    np.testing.assert_array_equal(got.numpy(), oracle[bn * block:])


@pytest.mark.parametrize("block_rows", [8, 16])
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_kernels(dtype, masked, dropout, block_rows):
    """Rows 13-14's plain versions against _fwd_call and _bwd_call. At
    N = 16, block_rows 8 gives the JAX forward two grid blocks and 16 its
    backward two (it takes half the rows per block), so the keep mask's
    block offset and the grid's accumulation of the param grads are both
    exercised."""
    set_pallas_mode("interpret")
    try:
        qkv, mask, pool, g = make_tail()
        km = mask if masked else None
        jargs = _jax_args(qkv, km, pool, dtype)
        targs = _port_args(qkv, km, pool, dtype)
        seed = np.array([SEED], np.int32)
        kw = dict(drop_rate=RATE, deterministic=not dropout)
        want = jfe._fwd_call(*jargs, jnp.asarray(seed), HEADS, D,
                             block_rows=block_rows, **kw)
        wants = jfe._bwd_call(*jargs, jnp.asarray(seed), _j(g, dtype), HEADS,
                              D, block_rows=block_rows, **kw)
    finally:
        set_pallas_mode("auto")
    out = fe.fused_tail_fwd_reference(*targs, torch.from_numpy(seed), HEADS,
                                      **kw)
    assert out.dtype == getattr(torch, dtype) and out.shape == (N, HEADS * D)
    np.testing.assert_allclose(_np(out), _np(want), **FWD_TOL[dtype])
    got = fe.fused_tail_bwd_reference(*targs, torch.from_numpy(seed),
                                      _t(g, dtype), HEADS, **kw)
    assert got[0].dtype == getattr(torch, dtype)
    assert all(x.dtype == torch.float32 for x in got[1:])
    for name, x, y in zip(("dqkv", "dw1", "db1", "dw2", "db2"), got, wants):
        assert x.shape == y.shape, name
        np.testing.assert_allclose(_np(x), _np(y), **BWD_TOL[dtype],
                                   err_msg=name)
    if masked:  # the fully masked row pools nothing and passes no gradient
        assert (out[2] == 0).all() and (got[0][2] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_kernels_long_rows(dtype, masked):
    """Rows 13-14's plain versions against _fwd_call and _bwd_call at
    T = 100, a row longer than the kernels keep in shared memory at the
    NRMS width (they then work from a global scratch; the JAX tail takes
    any T), dropout on, two grid blocks each."""
    n, t = 16, 100
    set_pallas_mode("interpret")
    try:
        qkv, mask, pool, g = make_tail(seed=5, n=n, t=t)
        km = mask if masked else None
        jargs = _jax_args(qkv, km, pool, dtype)
        seed = np.array([SEED], np.int32)
        kw = dict(drop_rate=RATE, deterministic=False)
        want = jfe._fwd_call(*jargs, jnp.asarray(seed), HEADS, D,
                             block_rows=8, **kw)
        wants = jfe._bwd_call(*jargs, jnp.asarray(seed), _j(g, dtype), HEADS,
                              D, block_rows=16, **kw)
    finally:
        set_pallas_mode("auto")
    targs = _port_args(qkv, km, pool, dtype)
    out = fe.fused_tail_fwd_reference(*targs, torch.from_numpy(seed), HEADS,
                                      **kw)
    assert out.shape == (n, HEADS * D)
    np.testing.assert_allclose(_np(out), _np(want), **FWD_TOL[dtype])
    got = fe.fused_tail_bwd_reference(*targs, torch.from_numpy(seed),
                                      _t(g, dtype), HEADS, **kw)
    for name, x, y in zip(("dqkv", "dw1", "db1", "dw2", "db2"), got, wants):
        assert x.shape == y.shape, name
        np.testing.assert_allclose(_np(x), _np(y), **BWD_TOL[dtype],
                                   err_msg=name)


def _jax_grads(qkv, mask, pool, g, dtype, dropout):
    seed = jnp.asarray([SEED], jnp.int32)

    def loss(q, w1, b1, w2, b2):
        if mask is None:
            out = jfe.exp_mhsa_pool(q, w1, b1, w2, b2, seed, HEADS, RATE,
                                    not dropout, 8)
        else:
            out = jfe.exp_mhsa_pool_masked(q, jnp.asarray(mask), w1, b1, w2,
                                           b2, seed, HEADS, RATE, not dropout,
                                           8)
        return jnp.sum(out.astype(jnp.float32) * g)

    args = _jax_args(qkv, None, pool, dtype)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(args[0], *args[2:])


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_functions_match_jax_grad(fused, dtype, masked, dropout):
    """exp_mhsa_pool(_masked) under autograd against jax.grad of JAX's: dqkv
    and the four pooling gradients, each in its param's dtype."""
    qkv, mask, pool, g = make_tail(seed=1)
    km = mask if masked else None
    want = _jax_grads(qkv, km, pool, g, dtype, dropout)
    args = [x if x is None else x.requires_grad_()
            for x in _port_args(qkv, km, pool, dtype)]
    seed = torch.tensor([SEED], dtype=torch.int32)
    if masked:
        out = fe.exp_mhsa_pool_masked(*args, seed, HEADS, RATE, not dropout)
    else:
        out = fe.exp_mhsa_pool(args[0], *args[2:], seed, HEADS, RATE,
                               not dropout)
    assert type(out.grad_fn).__name__ == "_ExpMhsaPoolBackward"
    (out.float() * _t(g)).sum().backward()
    grads = [args[0].grad] + [x.grad for x in args[2:]]
    for name, x, y in zip(("dqkv", "dw1", "db1", "dw2", "db2"), grads, want):
        assert str(x.dtype).split(".")[-1] == str(y.dtype), name
        np.testing.assert_allclose(_np(x), _np(y), **BWD_TOL[dtype],
                                   err_msg=name)
    assert not any(any(kernels.launch_counts(k).values())
                   for k in kernels.KERNELS)


def _tail_params(seed=3, d_model=10, heads=HEADS, d=D, q=Q):
    rng = np.random.default_rng(seed)
    hd = heads * d

    def lin(i, o, scale):
        return {"w": rng.normal(scale=scale, size=(i, o)).astype(np.float32),
                "b": rng.normal(scale=0.1, size=(o,)).astype(np.float32)}

    mhsa = {k: lin(d_model, hd, 0.4) for k in ("wq", "wk", "wv")}
    pool = {"fc1": lin(hd, q, 0.3), "fc2": lin(q, 1, 0.5)}
    x = rng.normal(size=(8, 6, d_model)).astype(np.float32)
    mask = (rng.random((8, 6)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[3] = 0.0
    return mhsa, pool, x, mask


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mhsa_dropout_pool_fused_matches_jax(fused, dtype, masked):
    """The encoder tail with fused_tail on, in both packages, from the same
    f32 params and bf16 or f32 activations: output and the gradients of x
    and every param. In bf16 the pooling weights' gradients come back
    rounded to bf16 (the cast weights' dtype) before the f32 params take
    them, as in JAX."""
    mhsa, pool, x, mask = _tail_params()
    km = mask if masked else None
    g = np.random.default_rng(4).normal(size=(8, HEADS * D)).astype(
        np.float32)

    def jloss(mp, pp, xx):
        out = jax_attention.mhsa_dropout_pool(
            mp, pp, xx, None if km is None else jnp.asarray(km),
            n_heads=HEADS)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        _to(mhsa, jnp.asarray), _to(pool, jnp.asarray), _j(x, dtype))
    tm = _to(mhsa, lambda a: torch.from_numpy(a).requires_grad_())
    tp = _to(pool, lambda a: torch.from_numpy(a).requires_grad_())
    tx = _t(x, dtype).requires_grad_()
    out = attention.mhsa_dropout_pool(tm, tp, tx,
                                      None if km is None else _t(km),
                                      n_heads=HEADS)
    assert type(out.grad_fn).__name__ == "_ExpMhsaPoolBackward"
    np.testing.assert_allclose(_np(out), _np(jout), **FWD_TOL[dtype])
    (out.float() * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jgrads[2]),
                               **BWD_TOL[dtype])
    for tree, jtree in ((tm, jgrads[0]), (tp, jgrads[1])):
        for path, p in leaves(tree):
            np.testing.assert_allclose(_np(p.grad), _np(get(jtree, path)),
                                       **BWD_TOL[dtype], err_msg=str(path))
    if dtype == "bfloat16":
        for key in ("fc1", "fc2"):
            grad = tp[key]["w"].grad
            assert grad.dtype == torch.float32
            assert torch.equal(grad, grad.to(torch.bfloat16).float()), key


def test_fused_tail_off_composes_the_tail():
    """"auto" and "off" keep the composed tail (attention kernels, dropout,
    pooling), whose output the fused one equals."""
    mhsa, pool, x, mask = _tail_params(seed=5)
    tm, tp = _to(mhsa, torch.from_numpy), _to(pool, torch.from_numpy)
    outs = {}
    try:
        for mode in ("auto", "off", "on"):
            kernel_config.set_fused_tail(mode)
            outs[mode] = attention.mhsa_dropout_pool(tm, tp, _t(x),
                                                     _t(mask), n_heads=HEADS)
    finally:
        kernel_config.set_fused_tail("auto")
    assert torch.equal(outs["auto"], outs["off"])
    np.testing.assert_allclose(_np(outs["on"]), _np(outs["off"]),
                               **FWD_TOL["float32"])


def test_dropout_seed_comes_from_the_generator(fused):
    """With dropout on, the tail draws its seed in [0, 2**31 - 1) from the
    step's generator: the same generator state gives the same output, the
    seed drawn gives JAX's output, and another seed another output."""
    mhsa, pool, x, mask = _tail_params(seed=6)
    tm, tp = _to(mhsa, torch.from_numpy), _to(pool, torch.from_numpy)

    def run(gen_seed):
        return attention.mhsa_dropout_pool(
            tm, tp, _t(x), _t(mask), n_heads=HEADS, drop_rate=RATE,
            generator=torch.Generator().manual_seed(gen_seed),
            deterministic=False)

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5))
    jm = _to(mhsa, jnp.asarray)
    w = jnp.concatenate([jm[k]["w"] for k in ("wq", "wk", "wv")], axis=1)
    bias = jnp.concatenate([jm[k]["b"] for k in ("wq", "wk", "wv")])
    qkv = jnp.asarray(x) @ w + bias
    want = jfe.exp_mhsa_pool_masked(
        qkv, jnp.asarray(mask), jnp.asarray(pool["fc1"]["w"]),
        jnp.asarray(pool["fc1"]["b"])[None], jnp.asarray(pool["fc2"]["w"]),
        jnp.asarray(pool["fc2"]["b"])[None], jnp.asarray(seed.numpy()),
        HEADS, RATE, False)
    np.testing.assert_allclose(_np(a), _np(want), **FWD_TOL["float32"])


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_fit_step_fused_tail_matches_jax(tiny_cfg, fused, user_log_mask):
    """One fit step with Config(fused_tail="on"): both encoders take the
    fused tail; loss and params after the Adam step against JAX's
    make_train_step with the fused tail on, dropout off."""
    jcfg = tiny_cfg.replace(deterministic=True, lr=3e-4, donate_state=False,
                            user_log_mask=user_log_mask,
                            freeze_embedding=True, fused_tail="on")
    cfg = port_cfg(jcfg, epochs=1, log_steps=1, device_gather=False)
    assert cfg.fused_tail == "on"
    arrays, feats = tiny_samples(cfg, n=cfg.batch_size)
    jparams = jax_params(jcfg)
    kernel_config.set_fused_tail("off")  # fit must set it from cfg
    state, stats = fit(cfg, get_model("NRMS"),
                       create_train_state(cfg, to_port(jparams)),
                       TrainSamples(**arrays), feats)
    assert kernel_config.fused_tail_enabled()
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


def test_step_seed_fixes_the_fused_dropout(tiny_cfg, fused):
    """With dropout on, the same step seed gives the same loss twice and
    another seed another loss: the tail's seed comes from the step's
    generator."""
    jcfg = tiny_cfg.replace(drop_rate=0.2, fused_tail="on")
    cfg = port_cfg(jcfg, deterministic=False)
    arrays, feats = tiny_samples(cfg, n=cfg.batch_size)
    batch = {k: torch.from_numpy(v) for k, v in next(
        TrainSamples(**arrays).iter_batches(feats, cfg.batch_size, epoch=0,
                                            seed=0)).items()}
    model, jparams = get_model("NRMS"), jax_params(jcfg)
    step = make_train_step(cfg, model)
    losses = [float(step(create_train_state(cfg, to_port(jparams)), batch,
                         base)[1]["loss"]) for base in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
