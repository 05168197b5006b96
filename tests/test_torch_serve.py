"""The port's serving path (data readers, corpus cache, Recommender, HTTP
server) against the JAX package's, on one synthetic corpus and one set of
params made by the JAX ``nrms.init`` and bridged to the port."""

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.config import Config as JaxConfig
from newsrecommendation_tpu.data import build_news_features as jax_features
from newsrecommendation_tpu.data import read_news as jax_read_news
from newsrecommendation_tpu.data.mind import (
    random_word_embeddings as jax_word_embeddings,
)
from newsrecommendation_tpu.models import nrms as jax_nrms
from newsrecommendation_tpu.serve import Recommender as JaxRecommender
from newsrecommendation_tpu_torch.bridge import params_from_jax
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.data import (
    build_news_features,
    random_word_embeddings,
    read_news,
)
from newsrecommendation_tpu_torch.data.synthetic import generate_corpus
from newsrecommendation_tpu_torch.serve import Recommender
from newsrecommendation_tpu_torch.server import (
    BatchingScorer,
    next_bucket,
    serve,
)

DIMS = dict(num_words_title=8, user_log_length=10, word_embedding_dim=16,
            news_dim=24, news_query_vector_dim=10, user_query_vector_dim=10,
            num_attention_heads=4, filter_num=0)
NUM_NEWS = 300
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    generate_corpus(str(d), num_news=NUM_NEWS, num_users=20,
                    num_impressions=20, title_len=DIMS["num_words_title"],
                    seed=0)
    return str(d / "news.tsv")


def _build(corpus, user_log_mask, **serve_kw):
    jcfg = JaxConfig(**DIMS, user_log_mask=user_log_mask)
    cfg = Config(**DIMS, user_log_mask=user_log_mask)
    jc = jax_read_news(corpus, jcfg)
    c = read_news(corpus, cfg)
    assert c.news_index == jc.news_index and c.word_dict == jc.word_dict
    feats = build_news_features(c, cfg)
    np.testing.assert_array_equal(feats, jax_features(jc, jcfg))
    table = random_word_embeddings(c.word_dict, cfg.word_embedding_dim)
    np.testing.assert_array_equal(
        table, jax_word_embeddings(jc.word_dict, cfg.word_embedding_dim))
    jparams = jax_nrms.init(jax.random.PRNGKey(0), jcfg, table)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jrec = JaxRecommender.from_state(jcfg, jparams, jc.news_index, feats,
                                     **serve_kw)
    rec = Recommender.from_state(cfg, params, c.news_index, feats,
                                 device="cpu", **serve_kw)
    return jrec, rec


@pytest.fixture(scope="module", params=[False, True],
                ids=["pad_doc", "log_mask"])
def recs(request, corpus):
    return _build(corpus, request.param)


def _requests(seed=0, b=6, c=12):
    rng = np.random.default_rng(seed)
    hists, cands = [], []
    for i in range(b):
        n = [0, 3, 10, 14, 1, 7][i % 6]  # empty, short, full, overlong
        hists.append([f"N{j}" for j in rng.integers(1, NUM_NEWS + 1, n)])
        cands.append([f"N{j}" for j in rng.choice(NUM_NEWS, c, replace=False)
                      + 1])
    hists[1].append("unknown-doc")
    cands[2][3] = "unknown-doc"
    return hists, cands


def test_news_cache_matches_jax(recs):
    jrec, rec = recs
    assert rec.news_scoring.shape == tuple(jrec.news_scoring.shape)
    np.testing.assert_allclose(rec.news_scoring.numpy(),
                               np.asarray(jrec.news_scoring), **F32)


@pytest.mark.parametrize("scorer", ["gather", "dense"])
def test_score_batch_matches_jax(recs, scorer):
    jrec, rec = recs
    jrec = JaxRecommender(jrec.model, jrec.params, jrec.cfg, jrec.news_index,
                          jrec.news_scoring, scorer=scorer)
    rec = Recommender(rec.model, rec.params, rec.cfg, rec.news_index,
                      rec.news_scoring, device="cpu", scorer=scorer)
    hists, cands = _requests()
    np.testing.assert_allclose(rec.score_batch(hists, cands),
                               jrec.score_batch(hists, cands), **F32)
    assert rec.rank(hists[2], cands[2]) == jrec.rank(hists[2], cands[2])


def test_recommend_batch_matches_jax(recs):
    jrec, rec = recs
    hists, _ = _requests(seed=1)
    jids, jscores = jrec.recommend_batch(hists, k=8)
    ids, scores = rec.recommend_batch(hists, k=8)
    for a, b, sa, sb in zip(ids, jids, scores, jscores):
        np.testing.assert_allclose(sa, sb, **F32)
        # ties may order differently in torch.topk and lax.top_k
        if len(set(np.round(sb, 4))) == len(sb):
            assert a == b
    assert all("N0" not in r for r in ids)


def test_bf16_cache_matches_jax(corpus):
    jrec, rec = _build(corpus, True, cache_dtype="bfloat16")
    hists, cands = _requests(seed=2)
    np.testing.assert_allclose(rec.score_batch(hists, cands),
                               jrec.score_batch(hists, cands),
                               rtol=5e-2, atol=5e-2)


def test_recommender_contract(recs):
    _, rec = recs
    assert rec.news_scoring.shape[0] % 4096 == 0
    assert rec.corpus_size == NUM_NEWS
    # k clamps to the rows that exist; row 0 and padding rows never return
    ids = rec.recommend(["N1"], k=10_000)
    assert len(ids) == NUM_NEWS and len(set(ids)) == NUM_NEWS
    with pytest.raises(ValueError, match="dense 1-based"):
        Recommender(rec.model, rec.params, rec.cfg, {"N1": 1, "N2": 5},
                    rec.news_scoring, device="cpu")
    # tests/test_torch_server_ckpt.py serves from checkpoints
    with pytest.raises(FileNotFoundError):
        Recommender.from_checkpoint("x.ckpt", rec.cfg, "data", device="cpu")


def test_next_bucket():
    assert next_bucket(1, (8, 32)) == 8
    assert next_bucket(9, (8, 32)) == 32
    assert next_bucket(99, (8, 32)) == 32


def test_batching_matches_direct(recs):
    _, rec = recs
    hists, cands = _requests(seed=3, b=12)
    direct = [rec.score(h, c) for h, c in zip(hists, cands)]
    batcher = BatchingScorer(rec, max_batch=8, max_delay_ms=200.0)
    try:
        out = [None] * len(hists)
        barrier = threading.Barrier(len(hists))

        def work(i):
            barrier.wait()  # near-simultaneous: a 200 ms window coalesces
            out[i] = batcher.score(hists[i], cands[i])

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(hists))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for a, b in zip(out, direct):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert batcher.stats.snapshot()["max_batch_size"] > 1
        ids, scores = batcher.recommend(hists[2], k=5)
        assert ids == rec.recommend(hists[2], k=5) and len(scores) == 5
        with pytest.raises(ValueError):
            batcher.score(["N1"], ["N2"] * 1000)
    finally:
        batcher.close()


class _WedgedRec:
    """A Recommender stand-in whose device call blocks until released."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    def score_batch_async(self, hists, cands, max_candidates):
        self.entered.set()
        self.release.wait(timeout=60)
        return torch.zeros((len(hists), max_candidates))


@pytest.mark.parametrize("pipeline_depth", [0, 2])
def test_close_fails_a_wedged_batch_in_flight(pipeline_depth):
    """A worker wedged in its device call past close()'s deadline: every
    caller gets an error, and close() returns at the deadline."""
    rec = _WedgedRec()
    batcher = BatchingScorer(rec, max_batch=4, max_delay_ms=1.0,
                             pipeline_depth=pipeline_depth,
                             close_join_s=0.3, close_grace_s=0.5)
    errors, threads = [], []

    def work():
        try:
            batcher.score(["N1"], ["N2", "N3"])
        except RuntimeError as e:
            errors.append(str(e))

    try:
        for _ in range(3):
            threads.append(threading.Thread(target=work))
            threads[-1].start()
            if not rec.entered.is_set():
                assert rec.entered.wait(timeout=10)
        t0 = time.monotonic()
        batcher.close()
        took = time.monotonic() - t0
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert len(errors) == 3 and all("closed" in e for e in errors)
        assert any("in flight" in e for e in errors)
        assert took < 0.3 + (0.5 if pipeline_depth else 0) + 2.0
    finally:
        rec.release.set()


def _call(srv, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=30)
    body = None if payload is None else json.dumps(payload)
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read().decode())
    conn.close()
    return resp.status, out


def test_http_routes(recs):
    jrec, rec = recs
    srv = serve(rec, port=0, max_batch=4)
    try:
        status, body = _call(srv, "GET", "/healthz")
        assert status == 200 and body["corpus_size"] == NUM_NEWS
        hist, cands = ["N1", "N2", "N3"], ["N10", "N20", "N30", "N40"]
        status, body = _call(srv, "POST", "/score",
                             {"history": hist, "candidates": cands})
        assert status == 200
        np.testing.assert_allclose(body["scores"], jrec.score(hist, cands),
                                   **F32)
        assert body["ranked"] == rec.rank(hist, cands)
        status, body = _call(srv, "POST", "/recommend",
                             {"history": hist, "k": 4})
        assert status == 200 and body["doc_ids"] == rec.recommend(hist, k=4)
        assert len(body["scores"]) == 4
        status, body = _call(srv, "GET", "/stats")
        assert status == 200 and body["requests"] >= 3
        assert _call(srv, "POST", "/score", {"history": hist})[0] == 400
        assert _call(srv, "POST", "/recommend",
                     {"history": hist, "k": 0})[0] == 400
        assert _call(srv, "GET", "/nope")[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
