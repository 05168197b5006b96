"""Training dynamics of the port against the JAX package's, dropout on.

The two frameworks draw different dropout masks, so training cannot
match step for step; it is held to the seed-spread bands of
tests/test_training_dynamics.py: NRMS (word ids, a trained table) 2.5
AUC points and 0.06 epoch loss, NAML (the frozen doc_table, both category
views, as tools/dynamics_parity.make_cfg sets it) 0.75 and 0.005. Both
sides train from the same numpy-made data and the same initial weights
(the JAX package's init, bridged) with seeds 3, 5 and 7, at tiny widths
on the synthetic corpus (tools/dynamics_parity.build_data), for four
epochs: the port through fit, the JAX package through
tools/dynamics_parity.run_jax's explicit epoch loop. Compared: the mean
over seeds of the final eval AUC (user_log_mask on, as the reference's
test run) and of the last epoch's mean loss. Deterministic given the
seeds.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.config import Config as JaxConfig
from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu_torch.bridge import params_from_jax
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.data.loader import (
    EvalSamples,
    TrainSamples,
)
from newsrecommendation_tpu_torch.eval import (
    compute_news_scoring,
    evaluate_impressions,
)
from newsrecommendation_tpu_torch.models import get_model
from newsrecommendation_tpu_torch.train import (
    create_train_state,
    fit,
    make_train_step,
)
from tools.dynamics_parity import build_data, run_jax

SEEDS = (3, 5, 7)
AUC_BAND, LOSS_BAND = 2.5, 0.06  # tests/test_training_dynamics.py:44
NAML_AUC_BAND, NAML_LOSS_BAND = 0.75, 0.005  # :46


def jax_cfg(seed, model="NRMS"):
    cfg = JaxConfig(
        model="NRMS", title_source="word_ids", num_words_title=8,
        user_log_length=10, word_embedding_dim=32, news_dim=32,
        num_attention_heads=4, news_query_vector_dim=16,
        user_query_vector_dim=16, batch_size=32, npratio=4, drop_rate=0.2,
        lr=3e-3, epochs=4, user_log_mask=False, deterministic=False,
        seed=seed, max_candidates=32, filter_num=0, donate_state=False)
    if model == "NAML":
        cfg = cfg.replace(model="NAML", title_source="doc_table",
                          use_category=True, use_subcategory=True,
                          category_emb_dim=16, freeze_embedding=True)
    return cfg


def run_port(jcfg, data, jparams, dev_dir):
    """fit over the epochs with the per-step losses recorded, then the
    eval of run_jax: per-epoch mean losses and the final AUC (percent)."""
    cfg = Config(**{f.name: getattr(jcfg, f.name)
                    for f in dataclasses.fields(Config)})
    model = get_model(cfg.model)
    state = create_train_state(cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    samples = TrainSamples.from_file(data["train_shard"],
                                     data["corpus"].news_index, cfg)
    step = make_train_step(cfg, model, device_gather=True)
    record = []

    def recorded(st, batch, seed, feats):
        st, m = step(st, batch, seed, feats)
        record.append((float(m["loss"]), float(batch["weight"].sum())))
        return st, m

    state, _ = fit(cfg, model, state, samples, data["feats"],
                   train_step=recorded, device_gather=True)
    per = -(-samples.num_samples // cfg.batch_size)
    losses = []
    for ep in range(cfg.epochs):
        rows = record[ep * per:(ep + 1) * per]
        losses.append(sum(l * w for l, w in rows) / sum(w for _, w in rows))
    ecfg = cfg.replace(user_log_mask=True, deterministic=True)
    eparams = dict(state.params)
    if cfg.title_source == "doc_table":  # the dev corpus's own titles
        eparams["embedding_table"] = torch.from_numpy(
            np.asarray(data["table_dev"], np.float32))
    scoring = compute_news_scoring(model, eparams, ecfg, data["feats_dev"])
    es = EvalSamples.from_file(os.path.join(dev_dir, "behaviors_0.tsv"),
                               data["corpus_dev"].news_index, ecfg,
                               max_candidates=ecfg.max_candidates)
    metrics = evaluate_impressions(model, eparams, ecfg, es, scoring)
    return losses, 100 * metrics["auc"]


def all_seeds(tmp_path_factory, model):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops; parallel test workers share cores
    try:
        return [run_seed(seed, tmp_path_factory, model) for seed in SEEDS]
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return all_seeds(tmp_path_factory, "NRMS")


@pytest.fixture(scope="module")
def naml_runs(tmp_path_factory):
    return all_seeds(tmp_path_factory, "NAML")


def run_seed(seed, tmp_path_factory, model="NRMS"):
    """Both sides on one seed's data and initial weights."""
    jcfg = jax_cfg(seed, model)
    root = str(tmp_path_factory.mktemp(f"{model}{seed}"))
    data = build_data(root, jcfg, num_news=150, num_users=40,
                      num_impressions=500, dev_impressions=200, seed=7)
    jparams = jax_get_model(model).init(
        jax.random.PRNGKey(seed), jcfg, np.asarray(data["table"], np.float32),
        len(data["corpus"].category_dict),
        len(data["corpus"].subcategory_dict))
    jrec = run_jax(jcfg, data, jparams)
    losses, auc = run_port(jcfg, data, jparams, os.path.join(root, "dev"))
    return {"jax": (jrec["epoch_losses"], jrec["metrics"]["auc"]),
            "port": (losses, auc)}


def test_both_sides_learn(runs):
    for run in runs:
        for side in ("jax", "port"):
            losses, auc = run[side]
            assert losses[-1] < losses[0] - 0.2, (side, losses)
            assert auc > 60, (side, auc)


def test_mean_auc_and_last_epoch_loss_within_the_nrms_bands(runs):
    def mean(side, pick):
        return float(np.mean([pick(r[side]) for r in runs]))

    auc = {s: mean(s, lambda r: r[1]) for s in ("jax", "port")}
    loss = {s: mean(s, lambda r: r[0][-1]) for s in ("jax", "port")}
    assert abs(auc["port"] - auc["jax"]) <= AUC_BAND, auc
    assert abs(loss["port"] - loss["jax"]) <= LOSS_BAND, loss


def test_naml_both_sides_learn(naml_runs):
    for run in naml_runs:
        for side in ("jax", "port"):
            losses, auc = run[side]
            assert losses[-1] < losses[0] - 0.1, (side, losses)
            assert auc > 60, (side, auc)


def test_naml_mean_auc_and_last_epoch_loss_within_the_naml_bands(
        naml_runs):
    def mean(side, pick):
        return float(np.mean([pick(r[side]) for r in naml_runs]))

    auc = {s: mean(s, lambda r: r[1]) for s in ("jax", "port")}
    loss = {s: mean(s, lambda r: r[0][-1]) for s in ("jax", "port")}
    assert abs(auc["port"] - auc["jax"]) <= NAML_AUC_BAND, auc
    assert abs(loss["port"] - loss["jax"]) <= NAML_LOSS_BAND, loss
