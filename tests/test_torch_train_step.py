"""The port's train step against the JAX package's, on the CPU, at the tiny
widths of tests/conftest.py:tiny_cfg: loss, per-leaf gradients and params
after one and two Adam steps, dropout off, with the same numpy-made params
and batches on both sides; then the port's own guarantees (k steps per
call equal k single calls, the seed fixes the dropout draws, padding does
not change gradients).

Post-Adam params are compared leaf by leaf at rtol 5e-4 / atol 2e-6, but
four leaves have a gradient that is 0 analytically: the key bias of each
MHSA (it shifts every score of a query by the same amount) and the score
bias of each attention pooling (the same). Their computed gradients are
rounding noise of about 1e-9 that two frameworks sum differently, and
Adam's first step, about lr * sign(g), turns that noise into updates of
either sign. Those leaves are held to |g| below 1e-6 on both sides and to a
difference within the update scale (4 lr), as in
tests/test_reference_train_oracle.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.models import common as jax_common
from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu.train import create_train_state as jax_state
from newsrecommendation_tpu.train.step import make_train_step as jax_step
from newsrecommendation_tpu.train.step import weighted_accuracy as jax_acc
from newsrecommendation_tpu_torch.bridge import params_from_jax
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.models import common, get_model, nrms
from newsrecommendation_tpu_torch.train import (
    create_train_state,
    make_multi_step,
    make_train_step,
    trainable_mask,
    weighted_accuracy,
)

GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
STEP_TOL = dict(rtol=5e-4, atol=2e-6)
VOCAB = 30
ZERO_GRAD_LEAVES = {("news_encoder", "mhsa", "wk", "b"),
                    ("user_encoder", "mhsa", "wk", "b"),
                    ("news_encoder", "attn", "fc2", "b"),
                    ("user_encoder", "attn", "fc2", "b")}


def port_cfg(jcfg, **kw):
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{n: getattr(jcfg, n) for n in names}).replace(**kw)


def make_params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(VOCAB, jcfg.word_embedding_dim)).astype(
        np.float32)
    table[0] = 0.0
    jparams = jax_get_model("NRMS").init(jax.random.PRNGKey(seed), jcfg,
                                         table)
    return jparams


def to_port(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def make_batch(cfg, seed, n_real=None):
    """A batch of cfg.batch_size samples; with n_real, the rows from n_real
    on are padding (weight 0, zero features), as the loader pads."""
    rng = np.random.default_rng(seed)
    b, L, k, T = (cfg.batch_size, cfg.user_log_length, cfg.npratio,
                  cfg.num_words_title)
    batch = {
        "history": rng.integers(0, VOCAB, size=(b, L, T)).astype(np.int32),
        "history_mask": (rng.random((b, L)) > 0.3).astype(np.float32),
        "candidate": rng.integers(0, VOCAB, size=(b, 1 + k, T)).astype(
            np.int32),
        "label": rng.integers(0, k + 1, size=(b,)).astype(np.int32),
        "weight": np.ones(b, np.float32),
    }
    batch["history_mask"][0] = 0.0  # an empty history
    if n_real is not None:
        for key in batch:
            batch[key][n_real:] = 0
    return batch


def t_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def j_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


@pytest.mark.parametrize("user_log_mask", [False, True])
@pytest.mark.parametrize("freeze", [True, False])
def test_train_steps_match_jax(tiny_cfg, user_log_mask, freeze):
    jcfg = tiny_cfg.replace(deterministic=True, lr=3e-4, donate_state=False,
                            user_log_mask=user_log_mask,
                            freeze_embedding=freeze)
    cfg = port_cfg(jcfg)
    jparams = make_params(jcfg)
    model, jmodel = get_model("NRMS"), jax_get_model("NRMS")
    state = create_train_state(cfg, to_port(jparams))
    table0 = state.params["embedding_table"].clone()
    jst = jax_state(jcfg, jparams)
    step, jstep = make_train_step(cfg, model), jax_step(jcfg, jmodel)
    for i, seed in enumerate((1, 2)):
        batch = make_batch(cfg, seed)
        jbatch = j_batch(batch)
        jloss, jgrads = jax.value_and_grad(lambda p: jmodel.forward(
            p, jcfg, jbatch, deterministic=True)[0])(jst.params)
        jst, jmetrics = jstep(jst, jbatch, jax.random.PRNGKey(0))
        state, metrics = step(state, t_batch(batch), 0)
        assert state.step == i + 1
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["acc"]),
                                   float(jmetrics["acc"]), rtol=1e-6)
        for path, p in leaves(state.params):
            jg = np.asarray(get(jgrads, path))
            if freeze and path == ("embedding_table",):
                assert p.grad is None and not p.requires_grad
                assert torch.equal(p, table0)  # bitwise unchanged
                continue
            # a leaf off this config's path (pad_doc when user_log_mask)
            # has grad None here and zeros in JAX
            g = np.zeros_like(jg) if p.grad is None else _np(p.grad)
            np.testing.assert_allclose(g, jg, **GRAD_TOL, err_msg=str(path))
            got, want = _np(p), _np(get(jst.params, path))
            if path in ZERO_GRAD_LEAVES:
                assert np.abs(g).max() < 1e-6, path
                assert np.abs(jg).max() < 1e-6, path
                assert np.abs(got - want).max() < 4 * cfg.lr, path
                continue
            np.testing.assert_allclose(got, want, **STEP_TOL,
                                       err_msg=f"{path} after step {i + 1}")
    if not freeze:  # the trainable table moved, as in JAX
        assert not torch.equal(state.params["embedding_table"], table0)


def test_trainable_mask_and_optimizer(tiny_cfg):
    cfg = port_cfg(tiny_cfg, freeze_embedding=True)
    params = to_port(make_params(tiny_cfg))
    mask = trainable_mask(params, cfg)
    assert mask["embedding_table"] is False
    assert all(v for p, v in leaves(mask) if p != ("embedding_table",))
    state = create_train_state(cfg, params)
    group = state.optimizer.param_groups[0]
    assert group["lr"] == cfg.lr and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8
    ids = {id(p) for p in group["params"]}
    assert id(params["embedding_table"]) not in ids
    assert len(ids) == sum(1 for _ in leaves(params)) - 1
    unfrozen = create_train_state(port_cfg(tiny_cfg, freeze_embedding=False),
                                  to_port(make_params(tiny_cfg)))
    assert len(unfrozen.optimizer.param_groups[0]["params"]) == len(ids) + 1


def _run(cfg, params, batches, seed, k=1):
    state = create_train_state(cfg, params)
    model = get_model("NRMS")
    if k == 1:
        step = make_train_step(cfg, model)
        for b in batches:
            state, metrics = step(state, t_batch(b), seed)
        return state, metrics
    multi = make_multi_step(cfg, model, k)
    stacked = {key: torch.from_numpy(np.stack([b[key] for b in batches]))
               for key in batches[0]}
    return multi(state, stacked, seed)


def test_multi_step_equals_single_steps(tiny_cfg):
    """Dropout on: k steps in one call draw the same masks as k calls."""
    cfg = port_cfg(tiny_cfg, drop_rate=0.2, deterministic=False)
    jparams = make_params(tiny_cfg)
    batches = [make_batch(cfg, s) for s in (1, 2)]
    single, m1 = _run(cfg, to_port(jparams), batches, seed=4)
    multi, ms = _run(cfg, to_port(jparams), batches, seed=4, k=2)
    assert single.step == multi.step == 2
    assert ms["loss"].shape == (2,) and torch.equal(ms["loss"][-1],
                                                    m1["loss"])
    for (path, a), (_, b) in zip(leaves(single.params),
                                 leaves(multi.params)):
        assert torch.equal(a, b), path


def test_seed_fixes_the_dropout_draws(tiny_cfg):
    cfg = port_cfg(tiny_cfg, drop_rate=0.2, deterministic=False)
    jparams = make_params(tiny_cfg)
    batches = [make_batch(cfg, 1)]
    a, _ = _run(cfg, to_port(jparams), batches, seed=4)
    b, _ = _run(cfg, to_port(jparams), batches, seed=4)
    c, _ = _run(cfg, to_port(jparams), batches, seed=5)
    off, _ = _run(cfg.replace(deterministic=True), to_port(jparams), batches,
                  seed=4)
    wq = ("news_encoder", "mhsa", "wq", "w")
    assert torch.equal(get(a.params, wq), get(b.params, wq))
    assert not torch.equal(get(a.params, wq), get(c.params, wq))
    assert not torch.equal(get(a.params, wq), get(off.params, wq))


def test_padded_final_batch_gives_the_same_grads(tiny_cfg):
    """Rows with weight 0 add nothing: the gradients of 3 real samples
    padded to a batch of 4 equal those of the 3 alone."""
    cfg = port_cfg(tiny_cfg, deterministic=True)
    params = to_port(make_params(tiny_cfg))
    padded = make_batch(cfg, 3, n_real=3)
    real = {k: v[:3] for k, v in padded.items()}
    grads = []
    for batch in (padded, real):
        for _, p in leaves(params):
            p.grad = None
            p.requires_grad_(True)
        loss, _ = nrms.forward(params, cfg, t_batch(batch))
        loss.backward()
        grads.append({path: p.grad.clone() for path, p in leaves(params)})
    for path, g in grads[0].items():
        np.testing.assert_allclose(g.numpy(), grads[1][path].numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=str(path))


def test_forward_dropout_follows_the_flags(tiny_cfg):
    cfg = port_cfg(tiny_cfg, drop_rate=0.5)
    params = to_port(make_params(tiny_cfg))
    batch = t_batch(make_batch(cfg, 1))
    with torch.no_grad():
        plain, _ = nrms.forward(params, cfg, batch)
        det, _ = nrms.forward(params, cfg, batch,
                              generator=torch.Generator().manual_seed(0))
        d1, _ = nrms.forward(params, cfg, batch, deterministic=False,
                             generator=torch.Generator().manual_seed(0))
        d2, _ = nrms.forward(params, cfg, batch, deterministic=False,
                             generator=torch.Generator().manual_seed(0))
        d3, _ = nrms.forward(params, cfg, batch, deterministic=False,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(plain, det) and torch.equal(d1, d2)
    assert not torch.equal(d1, plain) and not torch.equal(d1, d3)


@pytest.mark.parametrize("weights", ["none", "padded", "all_zero"])
def test_slot_cross_entropy_matches_jax(weights):
    rng = np.random.default_rng(0)
    scores = rng.normal(scale=3.0, size=(6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=(6,)).astype(np.int32)
    w = {"none": None, "padded": np.array([1, 1, 1, 1, 0, 0], np.float32),
         "all_zero": np.zeros(6, np.float32)}[weights]
    ref = jax_common.slot_cross_entropy(
        jnp.asarray(scores), jnp.asarray(labels),
        None if w is None else jnp.asarray(w))
    out = common.slot_cross_entropy(
        torch.from_numpy(scores), torch.from_numpy(labels),
        None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6, atol=1e-7)
    acc = weighted_accuracy(torch.from_numpy(labels),
                            torch.from_numpy(scores),
                            torch.ones(6) if w is None
                            else torch.from_numpy(w))
    jacc = jax_acc(jnp.asarray(labels), jnp.asarray(scores),
                   jnp.ones(6) if w is None else jnp.asarray(w))
    assert float(acc) == pytest.approx(float(jacc), abs=1e-7)


def test_init_copies_the_table(tiny_cfg):
    """Training updates params in place: nrms.init must not alias the
    caller's table."""
    cfg = port_cfg(tiny_cfg)
    table = np.zeros((VOCAB, cfg.word_embedding_dim), np.float32)
    params = nrms.init(cfg, table, device="cpu")
    params["embedding_table"] += 1.0
    assert (table == 0).all()
