"""The port's evaluation (eval/pipeline.py phase 2, EvalSamples,
prepare_testing_data) against the JAX package's on the CPU, on one
synthetic dev corpus and one set of numpy-made params bridged to the
port."""

import os

import jax
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.data import prepare_testing_data as jax_prepare
from newsrecommendation_tpu.data import read_news as jax_read_news
from newsrecommendation_tpu.data.loader import (
    CandidateTruncationError as JaxTruncation,
)
from newsrecommendation_tpu.data.loader import EvalSamples as JaxSamples
from newsrecommendation_tpu.eval import doc_sim_probe as jax_doc_sim
from newsrecommendation_tpu.eval import evaluate_impressions as jax_evaluate
from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu_torch.bridge import params_from_jax
from newsrecommendation_tpu_torch.data import read_news
from newsrecommendation_tpu_torch.data.loader import (
    CandidateTruncationError,
    EvalSamples,
)
from newsrecommendation_tpu_torch.data.prepare import prepare_testing_data
from newsrecommendation_tpu_torch.eval import (
    combine_metric_sums,
    cross_process_sum,
    doc_sim_probe,
    evaluate_impressions,
    make_eval_step,
    summarize_metric_sums,
)
from newsrecommendation_tpu_torch.models import get_model
from tests.test_torch_train_step import port_cfg
from tests.test_torch_cli import one_torch_thread  # noqa: F401

METRICS = ("auc", "mrr", "ndcg5", "ndcg10")


@pytest.fixture
def dev(synthetic_dirs, tiny_cfg):
    """The dev corpus read by both sides, its shard prepared by the port,
    a random news cache and bridged params."""
    _, dev_dir = synthetic_dirs
    jcfg = tiny_cfg.replace(eval_batch_size=8, filter_num=0,
                            max_candidates=16)
    cfg = port_cfg(jcfg)
    corpus = read_news(os.path.join(dev_dir, "news.tsv"), cfg, "test")
    assert corpus.news_index == jax_read_news(
        os.path.join(dev_dir, "news.tsv"), jcfg, "test").news_index
    assert prepare_testing_data(dev_dir, 1) == 60
    rng = np.random.default_rng(0)
    table = rng.normal(size=(30, cfg.word_embedding_dim)).astype(np.float32)
    table[0] = 0.0
    jparams = jax_get_model("NRMS").init(jax.random.PRNGKey(0), jcfg, table)
    scoring = rng.normal(size=(corpus.num_news + 1, cfg.news_dim)).astype(
        np.float32)
    return dict(dir=dev_dir, cfg=cfg, jcfg=jcfg, corpus=corpus,
                jparams=jparams, scoring=scoring,
                params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                       device="cpu"),
                path=os.path.join(dev_dir, "behaviors_0.tsv"))


def test_prepare_testing_data_matches_jax(dev, tmp_path):
    lines = open(os.path.join(dev["dir"], "behaviors.tsv")).read()
    for side, prepare in (("port", prepare_testing_data),
                          ("jax", jax_prepare)):
        d = tmp_path / side
        d.mkdir()
        (d / "behaviors.tsv").write_text(lines)
        assert prepare(str(d), 3) == 60
    for r in range(3):
        name = f"behaviors_{r}.tsv"
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("width", [None, 16, 40])
def test_eval_samples_match_jax(dev, width):
    es = EvalSamples.from_file(dev["path"], dev["corpus"].news_index,
                               dev["cfg"], max_candidates=width)
    js = JaxSamples.from_file(dev["path"], dev["corpus"].news_index,
                              dev["jcfg"], max_candidates=width)
    for k in ("history", "history_mask", "candidates", "labels",
              "candidate_mask"):
        got, want = getattr(es, k), getattr(js, k)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    sizes = [b["num_real"] for b in es.iter_batches(7)]
    assert sum(sizes) == es.num_samples and set(sizes[:-1]) == {7}
    assert all(b["candidates"].shape[0] == 7 for b in es.iter_batches(7))


def test_truncation_raises_where_jax_raises(dev):
    with pytest.raises(JaxTruncation) as jerr:
        JaxSamples.from_file(dev["path"], dev["corpus"].news_index,
                             dev["jcfg"], max_candidates=4)
    with pytest.raises(CandidateTruncationError) as err:
        EvalSamples.from_file(dev["path"], dev["corpus"].news_index,
                              dev["cfg"], max_candidates=4)
    assert str(err.value) == str(jerr.value)
    es = EvalSamples.from_file(dev["path"], dev["corpus"].news_index,
                               dev["cfg"], max_candidates=4,
                               allow_truncation=True)
    assert es.candidates.shape[1] == 4


@pytest.mark.parametrize("user_log_mask", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_evaluate_impressions_matches_jax(dev, user_log_mask, k):
    jcfg = dev["jcfg"].replace(user_log_mask=user_log_mask,
                               eval_steps_per_call=k)
    cfg = port_cfg(jcfg)
    es = EvalSamples.from_file(dev["path"], dev["corpus"].news_index, cfg,
                               max_candidates=cfg.max_candidates)
    js = JaxSamples.from_file(dev["path"], dev["corpus"].news_index, jcfg,
                              max_candidates=jcfg.max_candidates)
    got = evaluate_impressions(get_model("NRMS"), dev["params"], cfg, es,
                               torch.from_numpy(dev["scoring"]),
                               log_every=2)
    want = jax_evaluate(jax_get_model("NRMS"), dev["jparams"], jcfg, js,
                        dev["scoring"])
    assert set(got) == set(want)
    assert got["count"] == want["count"] == 60
    assert got["samples_seen"] == want["samples_seen"] == 60
    for key in METRICS:
        assert got[key] == pytest.approx(want[key], abs=1e-5), key


def test_degenerate_impressions_excluded(dev):
    cfg = dev["cfg"].replace(eval_batch_size=4)
    L, C = cfg.user_log_length, 6
    es = EvalSamples(
        history=np.zeros((3, L), np.int32),
        history_mask=np.zeros((3, L), np.float32),
        candidates=np.ones((3, C), np.int32),
        labels=np.array([[1, 0, 0, 0, 0, 0],
                         [1, 1, 1, 0, 0, 0],   # all-1 among real -> out
                         [0, 0, 0, 0, 0, 0]],  # all-0 -> out
                        np.float32),
        candidate_mask=np.array([[1, 1, 1, 0, 0, 0]] * 3, np.float32))
    scoring = torch.from_numpy(dev["scoring"][:5])
    got = evaluate_impressions(get_model("NRMS"), dev["params"], cfg, es,
                               scoring)
    assert got["count"] == 1 and got["samples_seen"] == 3


def test_eval_steps_per_call_sums_equal(dev):
    """k batches a call (the leftovers one at a time) give the same sums
    as one batch a call, bit for bit."""
    es = EvalSamples.from_file(dev["path"], dev["corpus"].news_index,
                               dev["cfg"])
    scoring = torch.from_numpy(dev["scoring"])
    sums = [evaluate_impressions(
        get_model("NRMS"), dev["params"],
        dev["cfg"].replace(eval_steps_per_call=k, prefetch_depth=d), es,
        scoring, return_sums=True) for k, d in ((1, 2), (3, 2), (4, 0))]
    assert sums[0] == sums[1] == sums[2]
    assert sums[0]["samples_seen"] == 60


def test_eval_step_reads_the_user_encoder_only(dev):
    cfg = dev["cfg"]
    es = EvalSamples.from_file(dev["path"], dev["corpus"].news_index, cfg)
    batch = {k: torch.from_numpy(v) for k, v in next(
        es.iter_batches(8)).items() if k != "num_real"}
    scoring = torch.from_numpy(dev["scoring"])
    step = make_eval_step(get_model("NRMS"), cfg)
    full = step(dev["params"], scoring, batch)
    only = step({"user_encoder": dev["params"]["user_encoder"]}, scoring,
                batch)
    assert {k: float(v) for k, v in full.items()} == {
        k: float(v) for k, v in only.items()}


def test_sharded_eval_equals_one_shard(dev):
    cfg = dev["cfg"]
    scoring = torch.from_numpy(dev["scoring"])
    index = dev["corpus"].news_index
    want = evaluate_impressions(get_model("NRMS"), dev["params"], cfg,
                                EvalSamples.from_file(dev["path"], index,
                                                      cfg), scoring)
    prepare_testing_data(dev["dir"], 3)
    shard_sums = [evaluate_impressions(
        get_model("NRMS"), dev["params"], cfg,
        EvalSamples.from_file(os.path.join(dev["dir"], f"behaviors_{r}.tsv"),
                              index, cfg, max_candidates=cfg.max_candidates),
        scoring, return_sums=True) for r in range(3)]
    total = combine_metric_sums(shard_sums)
    got = summarize_metric_sums(total, total.pop("samples_seen"))
    assert got["count"] == want["count"]
    for key in METRICS:
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    assert cross_process_sum({"auc": 1.5, "count": 3.0}) == {"auc": 1.5,
                                                             "count": 3.0}


@pytest.mark.parametrize("n, pairs", [(50, 2000), (300, 600_000), (2, 10)])
def test_doc_sim_probe_matches_jax(n, pairs):
    rng = np.random.default_rng(n)
    vecs = rng.normal(size=(n, 8)).astype(np.float32)
    vecs[5:9] = vecs[min(4, n - 1)]  # a few collapsed rows
    got = doc_sim_probe(torch.from_numpy(vecs), num_pairs=pairs, seed=3)
    want = jax_doc_sim(vecs, num_pairs=pairs, seed=3)
    if n <= 2:
        assert np.isnan(got) and np.isnan(want)
        return
    assert got == pytest.approx(want, abs=1e-6)
    collapsed = np.tile(vecs[:1], (n, 1))
    assert doc_sim_probe(torch.from_numpy(collapsed), num_pairs=pairs) > 0.95
