"""NAML training and evaluation in the port against the JAX package's, on
the CPU, at tiny widths, both category views on: one and two Adam steps
of ``make_train_step`` (the word table trained or frozen, and the frozen
doc_table), one bf16 step, the corpus cache and phase-2 metrics, and the
bridge's train-state round trip with Adam's moments.

As in tests/test_torch_train_step.py, post-Adam params are held at rtol
5e-4 / atol 2e-6, except the leaves whose gradient is 0 analytically: the
score bias of each attention pooling (it shifts every score of a row
alike). Their computed gradients are f32 noise, which Adam's first step
turns into updates of either sign; they are held to |g| below 1e-6 and to
a difference within the update scale (4 lr).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from newsrecommendation_tpu.data import read_news as jax_read_news
from newsrecommendation_tpu.data.loader import EvalSamples as JaxSamples
from newsrecommendation_tpu.eval import compute_news_scoring as jax_scoring
from newsrecommendation_tpu.eval import evaluate_impressions as jax_evaluate
from newsrecommendation_tpu.models import naml as jax_naml
from newsrecommendation_tpu.train import create_train_state as jax_state
from newsrecommendation_tpu.train.step import make_train_step as jax_step
from newsrecommendation_tpu_torch.bridge import state_from_jax, state_to_jax
from newsrecommendation_tpu_torch.data import build_news_features, read_news
from newsrecommendation_tpu_torch.data.loader import EvalSamples
from newsrecommendation_tpu_torch.data.prepare import prepare_testing_data
from newsrecommendation_tpu_torch.eval import (
    compute_news_scoring,
    evaluate_impressions,
)
from newsrecommendation_tpu_torch.models import get_model
from newsrecommendation_tpu_torch.train import (
    create_train_state,
    make_train_step,
)
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_naml import (
    cfgs,
    get,
    leaves,
    make_batch,
    make_params,
)

GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
STEP_TOL = dict(rtol=5e-4, atol=2e-6)
ZERO_GRAD_LEAVES = {("news_encoder", "attn", "fc2", "b"),
                    ("news_encoder", "final_attn", "fc2", "b"),
                    ("user_encoder", "attn", "fc2", "b")}
METRICS = ("auc", "mrr", "ndcg5", "ndcg10")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def step_cfgs(title_source, freeze, user_log_mask, **kw):
    jcfg, cfg = cfgs(title_source, "both", deterministic=True, lr=3e-4,
                     user_log_mask=user_log_mask, freeze_embedding=freeze,
                     batch_size=5, **kw)
    return jcfg.replace(donate_state=False), cfg


@pytest.mark.parametrize("user_log_mask", [False, True])
@pytest.mark.parametrize("title_source, freeze", [
    ("word_ids", False), ("word_ids", True), ("doc_table", True)])
def test_train_steps_match_jax(title_source, freeze, user_log_mask):
    jcfg, cfg = step_cfgs(title_source, freeze, user_log_mask)
    jparams, params = make_params(jcfg)
    model = get_model("NAML")
    state = create_train_state(cfg, params)
    table0 = state.params["embedding_table"].clone()
    jst = jax_state(jcfg, jparams)
    step = make_train_step(cfg, model)
    jstep = jax_step(jcfg, jax_naml)
    for i, seed in enumerate((3, 4)):
        batch = make_batch(jcfg, seed)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jloss, jgrads = jax.value_and_grad(lambda p: jax_naml.forward(
            p, jcfg, jbatch, deterministic=True)[0])(jst.params)
        jst, jmetrics = jstep(jst, jbatch, jax.random.PRNGKey(0))
        state, metrics = step(
            state, {k: torch.from_numpy(v.copy()) for k, v in batch.items()},
            0)
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
    if not freeze:
        assert not torch.equal(state.params["embedding_table"], table0)


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_bf16_step_matches_jax(user_log_mask):
    """bf16 activations over f32 params, the table frozen: the loss at
    rtol 1e-5 and each leaf's gradient within 5e-2 of the largest."""
    jcfg, cfg = step_cfgs("word_ids", True, user_log_mask,
                          compute_dtype="bfloat16")
    jparams, params = make_params(jcfg)
    batch = make_batch(jcfg)
    jloss, jgrads = jax.value_and_grad(lambda p: jax_naml.forward(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        deterministic=True)[0])(jparams)
    state = create_train_state(cfg, params)
    state, metrics = make_train_step(cfg, get_model("NAML"))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    assert torch.isfinite(metrics["loss"])
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    pairs = {path: (np.zeros(p.shape, np.float32) if p.grad is None
                    else p.grad.numpy(), np.asarray(get(jgrads, path)))
             for path, p in leaves(state.params)
             if path != ("embedding_table",)}
    largest = max(np.abs(jg).max() for _, jg in pairs.values())
    for path, (g, jg) in pairs.items():
        assert np.abs(g - jg).max() <= 5e-2 * largest, path


@pytest.fixture
def dev(synthetic_dirs):
    """The dev corpus with both category views, its shard prepared, and
    bridged params whose tables fit its vocabularies."""
    _, dev_dir = synthetic_dirs
    jcfg, cfg = cfgs("word_ids", "both", filter_num=0, eval_batch_size=8,
                     max_candidates=16)
    corpus = read_news(os.path.join(dev_dir, "news.tsv"), cfg, "train")
    jcorpus = jax_read_news(os.path.join(dev_dir, "news.tsv"), jcfg,
                            "train")
    assert corpus.category_dict == jcorpus.category_dict
    prepare_testing_data(dev_dir, 1)
    rng = np.random.default_rng(0)
    table = rng.normal(size=(len(corpus.word_dict) + 1, 16)).astype(
        np.float32)
    table[0] = 0.0
    jparams = jax_naml.init(jax.random.PRNGKey(0), jcfg, table,
                            len(corpus.category_dict),
                            len(corpus.subcategory_dict))
    from newsrecommendation_tpu_torch.bridge import params_from_jax

    return dict(jcfg=jcfg, cfg=cfg, corpus=corpus, jparams=jparams,
                params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                       device="cpu"),
                feats=build_news_features(corpus, cfg),
                path=os.path.join(dev_dir, "behaviors_0.tsv"))


def test_compute_news_scoring_matches_jax(dev):
    cfg = dev["cfg"].replace(eval_news_chunk=16)  # several chunks
    got = compute_news_scoring(get_model("NAML"), dev["params"], cfg,
                               dev["feats"])
    want = jax_scoring(jax_naml, dev["jparams"], dev["jcfg"], dev["feats"])
    assert got.shape == (dev["corpus"].num_news + 1, cfg.news_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_evaluate_impressions_matches_jax(dev, user_log_mask):
    jcfg = dev["jcfg"].replace(user_log_mask=user_log_mask)
    cfg = dev["cfg"].replace(user_log_mask=user_log_mask)
    scoring = compute_news_scoring(get_model("NAML"), dev["params"], cfg,
                                   dev["feats"])
    index = dev["corpus"].news_index
    got = evaluate_impressions(
        get_model("NAML"), dev["params"], cfg,
        EvalSamples.from_file(dev["path"], index, cfg,
                              max_candidates=cfg.max_candidates), scoring)
    want = jax_evaluate(
        jax_naml, dev["jparams"], jcfg,
        JaxSamples.from_file(dev["path"], index, jcfg,
                             max_candidates=jcfg.max_candidates),
        jax_scoring(jax_naml, dev["jparams"], jcfg, dev["feats"]))
    assert got["count"] == want["count"] and got["count"] > 0
    for key in METRICS:
        assert got[key] == pytest.approx(want[key], abs=1e-5), key


def test_state_round_trips_through_the_bridge():
    """A JAX NAML train state after two steps (a trained word table, both
    views, non-zero Adam moments) -> the port -> back: every param and
    moment and the count equal, and one more step on each side agrees."""
    jcfg, cfg = step_cfgs("word_ids", False, False)
    jparams, _ = make_params(jcfg)
    jst = jax_state(jcfg, jparams)
    jstep = jax_step(jcfg, jax_naml)
    for seed in (3, 4):
        jst, _ = jstep(jst, {k: jnp.asarray(v) for k, v in make_batch(
            jcfg, seed).items()}, jax.random.PRNGKey(0))
    state = state_from_jax(jax.tree.map(np.asarray, jst.params),
                           jst.opt_state, cfg, device="cpu")
    assert state.step == 2
    moments = [st for st in state.optimizer.state.values() if st]
    assert len(moments) == sum(1 for _ in leaves(state.params))
    assert all(st["exp_avg"].abs().sum() > 0 for st in moments)
    step, params, opt = state_to_jax(state, cfg)
    assert step == 2
    for path, leaf in leaves(params):
        np.testing.assert_array_equal(leaf, np.asarray(get(jst.params,
                                                           path)))
    want = serialization.to_state_dict(jst.opt_state)
    flat, tree = jax.tree.flatten(jax.tree.map(np.asarray, want))
    gflat, gtree = jax.tree.flatten(opt)
    assert tree == gtree
    for a, b in zip(flat, gflat):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    restored = serialization.from_state_dict(jst.opt_state, opt)
    assert jax.tree.structure(restored) == jax.tree.structure(jst.opt_state)
    batch = make_batch(jcfg, 5)
    jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(0))
    state, m = make_train_step(cfg, get_model("NAML"))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    ne = ("news_encoder", "subcategory_emb")
    np.testing.assert_allclose(_np(get(state.params, ne)),
                               np.asarray(get(jst.params, ne)), **STEP_TOL)
